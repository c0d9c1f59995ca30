"""Hand-written CUDA kernels for the H100 and their plain PyTorch versions."""
