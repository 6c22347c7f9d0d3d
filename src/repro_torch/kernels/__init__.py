"""Hand-written kernels of the torch port (sources in ``repro_torch/csrc``)."""
