"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Importing this package builds and loads nothing: a kernel is
compiled (``ops/cuda/build.py``) the first time a CUDA tensor reaches it."""
