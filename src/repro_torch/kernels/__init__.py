"""Hand-written CUDA kernels for the serving hot path.

  _build — nvcc build of ``csrc/*.cu`` into ``build/repro_torch/``, ctypes load
  ops    — wrappers: CUDA tensor -> kernel (or an error), CPU tensor -> plain
  ref    — the plain PyTorch versions the kernels are held against
"""
