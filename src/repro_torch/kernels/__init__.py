"""Hand-written Hopper kernels of the port (built with nvcc at first use)."""
