"""PyTorch/CUDA port of the ``repro`` serving system for one NVIDIA H100.

The layout mirrors ``repro`` module for module (``configs``,
``core/quant``, ``kernels``, ``models``, ``runtime``, ``launch``), so
each module's counterpart is found under the same name. The package
imports ``torch`` and never JAX; framework-free modules are kept as
copies of their own. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on a CPU tensor every kernel wrapper takes its
plain PyTorch version, on a CUDA tensor it launches the hand-written
kernel or raises.
"""
