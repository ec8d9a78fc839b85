"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same subpackage layout as ``repro`` (``core``, ``configs``, ``models``,
``kernels``, ``serving``, ``launch``). The port imports torch, numpy and the
stdlib only; the JAX package stays the reference its parity tests compare
against.
"""
