"""Hand-written Hopper kernels of the port, each with its plain PyTorch twin
and a launch counter (``_build.KERNELS``).  Sources live in ``../csrc``."""
