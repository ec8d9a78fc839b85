"""Hand-written CUDA kernels for Hopper, one subpackage per TPU kernel of ``repro``.

Each subpackage holds the kernel's plain PyTorch version (``ref.py``), the
CUDA kernel with its binding (``<name>.py`` plus ``csrc/``), and the dispatch
(``ops.py``): the plain version for CPU tensors, the kernel for CUDA tensors.
``_nvcc.py`` builds every ``csrc/*.cu`` at its first launch.
"""
