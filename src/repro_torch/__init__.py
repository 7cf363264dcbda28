"""PyTorch/CUDA port of the circulant-collectives system (``repro``).

The JAX package ``repro`` stays the reference; this package imports
``torch`` and nothing of JAX or ``repro``.  Entry points run on the card
unless the caller asks for the CPU (``--device cpu`` / ``device="cpu"``).
"""
