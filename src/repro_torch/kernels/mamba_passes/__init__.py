"""The Mamba block's elementwise passes: the plain torch version and the Hopper kernels."""
