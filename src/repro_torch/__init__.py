"""PyTorch/CUDA port of the MoE-Lightning reproduction.

A second package beside the JAX one (``src/repro``), with the same module
names and layout so each counterpart is easy to find.  It imports torch and
numpy, never jax, and nothing of the JAX package.  Every Pallas TPU kernel on
a ported path is a CUDA C++ kernel for Hopper (``kernels/csrc``), each beside
its plain PyTorch version (``kernels/ref.py``).

Entry points (``serving.engine.Engine``, ``models.params.init_params``,
``models.kvcache.init_cache``) run on the CUDA device unless the caller
passes ``device="cpu"``; with no GPU and no ``device="cpu"`` they raise.
"""
