"""Hand-written Hopper kernels of the port, each beside its plain version.

CUDA C++ in ``src/repro_torch/csrc`` (built by ``build.py``), each
replacing a Pallas TPU kernel of ``repro/kernels``:

``fused_round``     ``csrc/fused_round.cu``     ``fused_round.py:fused_round``
``fused_round_dq``  ``csrc/fused_round_dq.cu``  ``fused_round.py:fused_round_dq``
``quantize``        ``csrc/quantize.cu``        ``quantize.py:quantize``
``dequant_add``     ``csrc/quantize.cu``        ``quantize.py:dequant_add``
``block_reduce``    ``csrc/block_reduce.cu``    ``block_reduce.py:block_reduce``
``permute_rows``    ``csrc/permute_rows.cu``    ``fused_round.py:permute_rows``
"""
from . import ref  # noqa: F401
from .block_reduce import block_reduce  # noqa: F401
from .fused_round import (dq_round_bytes, fused_round,  # noqa: F401
                          fused_round_dq, permute_bytes, permute_rows,
                          quantize_rows, resolve_fused, round_bytes)
from .ops import (dequant_accumulate, dequantize_blocks,  # noqa: F401
                  fused_block_reduce, make_compressors, quantize_blocks)
from .quantize import (DEFAULT_GROUP, dequant_add, pack_wire,  # noqa: F401
                       pad2d, quantize, unpack_wire, wire_ngroups,
                       wire_width)
