"""Hand-written CUDA kernels of the ported paths, one subpackage each:
``kernel.py`` (the CUDA wrapper and its launch counter), ``ref.py`` (the
plain PyTorch version) and ``ops.py`` (dispatch: plain version for CPU
tensors, kernel otherwise). ``build.py`` compiles ``csrc/*.cu`` with
``nvcc`` at first use."""
