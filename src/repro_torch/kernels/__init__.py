"""Hand-written Hopper kernels of the port, each beside its plain version.

``fused_round`` (``csrc/fused_round.cu``) replaces the Pallas kernel
``repro/kernels/fused_round.py:fused_round``.  The JAX package's other
five Pallas kernels are queued in ROADMAP.md (queue 2).
"""
from . import ref  # noqa: F401
from .fused_round import fused_round, resolve_fused, round_bytes  # noqa: F401
