"""PyTorch/CUDA port of the ``repro`` serving and training stack for one
NVIDIA H100.

The package mirrors ``repro``'s layout module for module and imports
nothing of it (nor of JAX): modules that were jax-free there are copied
here. Every Pallas kernel on the ported paths is a hand-written CUDA kernel
under ``csrc/`` (built at first use by ``kernels._build``); its plain
PyTorch version in ``kernels.ref`` serves CPU tensors (and tests that pin
the plain versions on the card).
"""
