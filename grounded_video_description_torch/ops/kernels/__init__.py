"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Nothing here builds or loads a kernel at import time."""
