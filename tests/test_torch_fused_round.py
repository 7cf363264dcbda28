"""The port's ``fused_round`` against the reference's.

On CPU tensors ``repro_torch.kernels.fused_round`` runs its plain
version, which must be BITWISE equal to the Pallas kernel
``repro.kernels.fused_round`` in interpret mode and to the jnp oracle
``repro.kernels.ref.fused_round_ref``: one ⊕ per element, no
reassociation, so there is no tolerance.  NaN-aware: NaN positions must
agree, and every other element must agree in its bits (NaN payloads are
not pinned across frameworks).  The CUDA kernel itself is checked on the
card (``chip_smoke.py`` and ``test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_round as jax_fused_round
from repro.kernels import ref as jax_ref
from repro_torch.kernels import fused_round, resolve_fused

# (lo, nb, next_lo, cols): nb < next_lo, nb > next_lo, nb == next_lo, and
# final rounds (next_lo == lo); ragged and even column counts.
GEOMETRIES = [(5, 1, 4, 130), (8, 4, 2, 7), (7, 3, 2, 130), (8, 4, 4, 130),
              (3, 2, 3, 7), (1, 1, 1, 130)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}


def _make(rng, shape, dtype, nan):
    if dtype == "int32":  # full range: add must wrap identically
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
            np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":  # exactly representable: conversions are exact
        x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    if nan:
        x[rng.random(shape) < 0.15] = np.nan
    return x


def _bits(a) -> np.ndarray:
    """Bit pattern (as unsigned ints) and NaN mask of an array."""
    a = np.asarray(a)
    if a.dtype == np.int32:
        return a.view(np.uint32), np.zeros(a.shape, bool)
    if a.dtype == np.float32:
        return a.view(np.uint32), np.isnan(a)
    bits = a.view(np.uint16)  # bfloat16 (ml_dtypes)
    return bits, np.isnan(a.astype(np.float32))


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits, np.isnan(t.float().numpy())
    a = t.numpy()
    return a.view(np.uint32), (np.isnan(a) if a.dtype == np.float32
                               else np.zeros(a.shape, bool))


def _assert_same(port, jax_out, what):
    pb, pn = _torch_bits(port)
    jb, jn = _bits(jax_out)
    assert pb.shape == jb.shape, what
    np.testing.assert_array_equal(pn, jn, err_msg=f"NaN positions: {what}")
    np.testing.assert_array_equal(np.where(pn, 0, pb), np.where(jn, 0, jb),
                                  err_msg=what)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_bitwise_equals_reference(dtype, op, geometry):
    lo, nb, next_lo, cols = geometry
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng([len(dtype), ord(op[1]), *geometry])
    nan = op != "add" and dtype != "int32"
    live = _make(rng, (lo, cols), dtype, nan)
    recv = _make(rng, (nb, cols), dtype, nan)
    keep, send = fused_round(torch.from_numpy(live).to(tdt),
                             torch.from_numpy(recv).to(tdt),
                             nb=nb, next_lo=next_lo, op=op)
    jl, jr = jnp.asarray(live, jdt), jnp.asarray(recv, jdt)
    for name, (jk, js) in (
            ("interpret", jax_fused_round(jl, jr, nb=nb, next_lo=next_lo,
                                          op=op, interpret=True)),
            ("ref", jax_ref.fused_round_ref(jl, jr, nb=nb, next_lo=next_lo,
                                            op=op))):
        what = f"{dtype}/{op}/{geometry} vs {name}"
        _assert_same(keep, jk, what + " keep")
        assert (send is None) == (js is None), what
        if send is not None:
            _assert_same(send, js, what + " send")


def test_cpu_tensors_count_no_launch():
    live, recv = torch.ones(4, 3), torch.ones(2, 3)
    before = fused_round.launches
    keep, send = fused_round(live, recv, nb=2, next_lo=2)
    assert fused_round.launches == before
    assert torch.equal(keep, torch.full((2, 3), 2.0))
    assert torch.equal(send, torch.ones(2, 3))


@pytest.mark.parametrize("kw,err", [
    (dict(nb=3, next_lo=2), ValueError),        # received rows != nb
    (dict(nb=2, next_lo=5), ValueError),        # next_lo > lo
    (dict(nb=2, next_lo=2, op="mul"), ValueError),
])
def test_wrapper_validates(kw, err):
    with pytest.raises(err):
        fused_round(torch.ones(4, 3), torch.ones(2, 3), **kw)


def test_resolve_fused_auto_follows_device():
    assert resolve_fused(None, "cuda") is True
    assert resolve_fused(None, torch.device("cpu")) is False
    assert resolve_fused(None) is False
    assert resolve_fused(True, "cpu") is True
    assert resolve_fused(False, "cuda") is False
