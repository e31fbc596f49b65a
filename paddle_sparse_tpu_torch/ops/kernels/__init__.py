"""Hand-written CUDA kernels, each beside its plain PyTorch version."""
