"""The port's plain int8-wire versions in the form XLA compiles them to,
for holding them against the JAX package's jitted code.

Under jit, XLA's CPU backend contracts ``a * b + c`` into one fused
multiply-add: so do the Pallas kernels in interpret mode and the jnp
oracles under ``jax.jit`` (a shard_map plan included).  PyTorch rounds
the product and the sum apart, and so do the port's CUDA kernels
(``__fmul_rn`` / ``__fadd_rn``) and the JAX oracles run op by op.  Two
expressions of the wire are affected:

* the dequantized fold ``live + q * s`` (and ``acc + q * s``): the
  contracted result differs from the twice-rounded one by at most one
  rounding of the product, ``2**-24 * |q * s|``, plus one ulp of the
  result;
* the scale ``amax * _INV127 + _EPS``: the contraction can only move a
  product that lies exactly on a rounding tie (``_EPS`` is far below
  half an ulp of any scale above ~1e-23).

The versions here compute each contracted expression once in float64,
where the products are exact (an int8 code or a float32 times a
float32), and round it to float32.  A float64 sum can itself round
before the float32 rounding; that double rounding differs from a true
FMA only on a float32 tie, which these tests' inputs do not hit.
"""
import torch

from repro_torch.kernels import ref as R

F32, F64 = torch.float32, torch.float64
INV127 = float(torch.tensor(R._INV127, dtype=F32))  # float32(1 / 127)
EPS = float(torch.tensor(R._EPS, dtype=F32))        # float32(1e-30)


def quantize(x: torch.Tensor, *, group: int = 512):
    """``ref.quantize_ref`` with ``amax * _INV127 + _EPS`` contracted."""
    rows, cols = x.shape
    g = min(group, cols)
    xp = R._pad_cols(x.to(F32), g)
    xg = xp.reshape(rows, -1, g)
    amax = torch.amax(torch.abs(xg), dim=2)
    scale = (amax.to(F64) * INV127 + EPS).to(F32)
    q = torch.clamp(torch.round(xg / scale[..., None]), -127, 127)
    return q.reshape(rows, xp.shape[1]).to(torch.int8)[:, :cols], scale


def _dequant64(codes, scales, group):
    rows, cols = codes.shape
    g = min(group, cols)
    qp = R._pad_cols(codes.to(F64), g).reshape(rows, -1, g)
    return (qp * scales.to(F64)[..., None]).reshape(rows, -1)[:, :cols]


def dequant_add(acc, codes, scales, *, group: int = 512):
    """``ref.dequant_add_ref`` with ``acc + q * s`` contracted."""
    out = acc.to(F64) + _dequant64(codes, scales, group)
    return out.to(F32).to(acc.dtype)


def fused_round_dq(live, codes, scales, *, nb, next_lo, op="add",
                   group: int = 512):
    """``ref.fused_round_dq_ref`` with the add fold and the requantizing
    scale contracted (a max/min fold has nothing to contract)."""
    lo = live.shape[0]
    if op == "add":
        head = (live[:nb].to(F64) + _dequant64(codes, scales, group)).to(F32)
    else:
        head = R.block_reduce_ref(live[:nb].to(F32),
                                  R.dequant_ref(codes, scales, group=group),
                                  op=op)
    new = torch.cat([head, live[nb:lo].to(F32)], dim=0)
    if next_lo == lo:
        return new, None
    return new[:next_lo], quantize(new[next_lo:lo], group=group)
