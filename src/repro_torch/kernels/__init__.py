"""Hand-written Hopper kernels, each beside its plain PyTorch version; a
kernel's wrapper runs the plain version for tensors on the CPU."""
