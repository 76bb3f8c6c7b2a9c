"""Hand-written Hopper kernels of the main path, each beside its plain version.

Every wrapper takes tensors on the CPU (it then runs its plain PyTorch
version) or on a CUDA card (it launches its kernel, or raises), and counts
its kernel launches in ``<wrapper>.launches``.
"""
