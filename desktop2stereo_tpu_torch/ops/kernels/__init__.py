"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

A wrapper sends a CPU tensor to the plain version and a CUDA tensor to its
kernel; it raises on anything the kernel does not take, and never falls
back.
"""
