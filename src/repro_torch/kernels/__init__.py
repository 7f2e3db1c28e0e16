"""Hand-written Hopper kernels, their wrappers and their plain PyTorch
versions (see ``ops`` for dispatch)."""
