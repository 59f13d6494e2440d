"""PyTorch and CUDA port of ``ngp_tpu`` for NVIDIA Hopper.

The layout mirrors ``ngp_tpu/`` module for module (``models/``, ``ops/``,
``geometry/``, ``data/``, ``engines/``); hand-written CUDA sources live in
``csrc/``. The package imports ``torch`` and numpy only: nothing of JAX and
nothing of ``ngp_tpu``. Entry points take an explicit ``device``
(default ``"cuda"``); ``device="cpu"`` runs every kernel's plain PyTorch
twin instead.
"""
