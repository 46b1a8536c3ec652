"""Hand-written GPU kernels of the port, each beside its plain PyTorch
version.  Nothing is compiled when this package is imported: a kernel's
shared library is built from ``csrc/`` on its first CUDA launch."""
