"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Kernels are built with nvcc at first use (``_build.py``); nothing
here builds or loads a kernel at import time."""
