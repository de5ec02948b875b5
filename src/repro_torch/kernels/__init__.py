"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.  Nothing is built or loaded at import."""
