"""PyTorch/CUDA port of the DWDP reproduction (``repro`` is the JAX
reference). Imports torch and numpy only; kernels build at first use."""
