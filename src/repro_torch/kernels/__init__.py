"""Hand-written Hopper kernels of the selection path, each beside its plain
PyTorch version: ``<name>/ops.py`` is the wrapper (the kernel for a CUDA
tensor, the plain version in ``<name>/ref.py`` for a CPU tensor) and
``csrc/<name>.cu`` the CUDA source, built by `_build` at first use."""
