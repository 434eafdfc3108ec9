"""Hand-written Hopper kernels of the port (``csrc/``), each beside its plain
PyTorch version, and the build that compiles them at first use."""
