"""PyTorch/CUDA port of the ``repro`` serving stack for one NVIDIA H100.

The package mirrors ``repro``'s layout module for module and imports
nothing of it (nor of JAX): modules that were jax-free there are copied
here. Every Pallas kernel on the ported path is a hand-written CUDA kernel
under ``csrc/`` (built at first use by ``kernels._build``); its plain
PyTorch version in ``kernels.ref`` serves CPU tensors only.
"""
