"""PyTorch/CUDA port of ``triton_distributed_tpu`` for one NVIDIA H100.

A standalone package beside the JAX one: it imports torch and numpy,
never jax, and nothing of ``triton_distributed_tpu``. Its layout mirrors
the JAX package's (``models/qwen.py`` ↔ ``models/qwen.py`` and so on);
every Pallas kernel on the ported path has a hand-written CUDA kernel
under ``csrc/``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
