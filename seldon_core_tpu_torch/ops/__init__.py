"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. A wrapper runs the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises."""
