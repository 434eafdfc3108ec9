"""``repro_torch`` — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors the JAX package's module paths and names, but imports
nothing from it: what it needs of the reference it carries as its own copy.
Hot spots that the reference wrote as Pallas TPU kernels are CUDA C++
kernels written for ``sm_90a`` (``repro_torch/kernels/csrc``), built at first
use and bound with ``ctypes``; each has a plain PyTorch version beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; they
never fall back to the CPU on their own (``repro_torch.device``).
"""
