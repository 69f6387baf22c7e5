"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Nothing is built or loaded at import: a kernel is compiled at
its first launch on a CUDA tensor (``_build``)."""
