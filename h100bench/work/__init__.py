"""The benchmark's yardstick: model FLOPs, the H100's peaks, kernels' least times."""
