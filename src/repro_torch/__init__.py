"""PyTorch + CUDA port of ``repro``: its sparse device path and its LM
serving path.

``repro_torch`` runs the lowered SpMV program on one NVIDIA H100 with
hand-written CUDA kernels (``csrc/``) for the ell/hyb, seg, split and tile
families, and serves the ten LM architectures of ``repro.configs``
(``models/``, ``configs/``, ``serve/engine.py``, ``launch/serve.py``) in
plain PyTorch.  It imports ``torch`` and ``numpy`` only: no JAX and
nothing of ``repro``, whose host modules it keeps its own copies of under
the same module names.  Entry points run on CUDA unless ``device="cpu"``
is passed.
"""
