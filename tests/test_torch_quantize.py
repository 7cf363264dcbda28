"""The port's int8 wire kernels and ``block_reduce`` against the reference's.

On CPU tensors the port's wrappers (``quantize``, ``dequant_add``,
``fused_round_dq``, ``block_reduce``) run their plain versions
(``repro_torch.kernels.ref``).  The same seeded numpy inputs go through
those, the JAX package's jnp oracles (``repro.kernels.ref``) and its
Pallas kernels in interpret mode.  The CUDA kernels themselves are held
against the plain versions on the card (``chip_smoke.py``,
``test_torch_gpu.py``).

Tolerances, and why:

* ``quantize``, ``block_reduce``, ``pack_wire`` / ``unpack_wire``: bitwise
  against the oracle and the Pallas kernel.  ``block_reduce`` is NaN-aware
  (NaN positions agree; NaN payloads are not pinned across frameworks).
* ``dequant_add`` and the add fold of ``fused_round_dq``: bitwise against
  the jnp oracle run op by op, which rounds ``q * s`` and the sum apart
  as the port does.  The Pallas kernel in interpret mode and the jitted
  oracle are compiled by XLA, whose CPU backend contracts ``acc + q * s``
  into one FMA: there the port's plain version differs by at most
  ``2**-24 * |q * s|`` plus one ulp of the result (observed: up to 1 ulp
  of the result, more relative ulps where the sum cancels).  The test
  states that bound, and also holds the contracted form of the port's
  plain version (``_torch_xla_fma``) bitwise against XLA's, so the
  contraction is shown to be the only difference.  The requantized send
  codes may then differ by one code step where a rounding boundary moves;
  on these inputs none moves, and the codes are held bitwise.
* max/min folds have nothing to contract: bitwise everywhere.
* ``torch.addcmul`` over ``(rows, groups, g)`` views (``chip_smoke.py``'s
  yardstick for ``dequant_add``; the port never calls it): bitwise
  against the jitted oracle (it rounds ``acc + q * s`` once, as XLA's
  FMA does), and within the bound above of the port's plain version.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_xla_fma as XF
from repro.kernels import fused_round_dq as jax_fused_round_dq
from repro.kernels import ops as jax_ops
from repro.kernels import ref as JR
from repro.kernels import quantize as JQ
from repro_torch.kernels import (block_reduce, dequant_accumulate,
                                 dequant_add, dequantize_blocks,
                                 fused_block_reduce, fused_round_dq,
                                 pack_wire, quantize, quantize_blocks,
                                 quantize_rows, unpack_wire, wire_ngroups,
                                 wire_width)
from repro_torch.kernels import ref as TR

# Ragged geometries of tests/test_wire.py: 7 and 515 columns, rows not
# divisible by the reference's row tile, single elements.
RAGGED_SHAPES = [(3, 7), (130, 515), (5, 130), (7, 515), (1, 1), (9, 4)]
# fused_round_dq's (lo, nb, next_lo): nb on either side of next_lo, final
# rounds, one-row buffers.
DQ_GEOMETRIES = [(8, 4, 4), (8, 4, 2), (7, 3, 2), (5, 1, 4), (6, 2, 4),
                 (2, 1, 1), (4, 4, 4), (1, 1, 1)]
OPS = ("add", "max", "min")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _same(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    if want.dtype != np.int8:
        want = want.astype(np.float32)
    got = _np(got)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=what)


def _fma_bound(got: torch.Tensor, want, codes, scales, g: int, what: str):
    """|got - want| <= 2**-24 * |q * s| + one ulp of the result."""
    deq = np.abs(TR.dequant_ref(codes, scales, group=g).double().numpy())
    want = np.asarray(want, np.float64)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    err = np.abs(_np(got).astype(np.float64) - want)
    assert (err <= 2.0**-24 * deq + ulp).all(), (what, err.max())


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", [4, 128, 512])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_quantize_bitwise(shape, group):
    x = (_rng("q", shape, group).standard_normal(shape) * 2).astype(np.float32)
    codes, scales = quantize(_t(x), group=group)
    assert codes.shape == shape
    assert scales.shape == (shape[0], wire_ngroups(shape[1], group))
    jx = jnp.asarray(x)
    for name, (jc, js) in (
            ("ref", JR.quantize_ref(jx, group=group)),
            ("jit ref", jax.jit(functools.partial(JR.quantize_ref,
                                                  group=group))(jx)),
            ("interpret", JQ.quantize(jx, group=group, interpret=True))):
        _same(codes, jc, f"codes {shape} g={group} vs {name}")
        _same(scales, js, f"scales {shape} g={group} vs {name}")


@pytest.mark.parametrize("case", ["bf16", "zero group", "denormal",
                                  "extreme"])
def test_quantize_bf16_zero_and_extreme_inputs(case):
    rng = _rng("qx", case)
    dtype, g = torch.float32, 32
    if case == "bf16":
        x, dtype = _bf16_exact((rng.standard_normal((6, 96)) * 3).astype(
            np.float32)), torch.bfloat16
    elif case == "zero group":
        x = np.zeros((2, 64), np.float32)
        x[1, 40] = 1.5                       # one non-zero group
    elif case == "denormal":                 # scales near _EPS, x/scale denormal
        x = (rng.standard_normal((3, 64)) * 1e-38).astype(np.float32)
        x[0, :8] = np.float32(1e-45)
    else:                                    # near the float32 range
        x = (rng.standard_normal((3, 64)) * 1e37).astype(np.float32)
        x[1, 3] = np.float32(3.4e38)
    codes, scales = quantize(_t(x, dtype), group=g)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else
                     jnp.float32)
    for name, (jc, js) in (("ref", JR.quantize_ref(jx, group=g)),
                           ("interpret", JQ.quantize(jx, group=g,
                                                     interpret=True))):
        _same(codes, jc, f"{case} codes vs {name}")
        _same(scales, js, f"{case} scales vs {name}")
    assert np.isfinite(scales.numpy()).all()
    if case == "zero group":
        assert (codes[0] == 0).all() and float(scales[0, 0]) == XF.EPS


# ---------------------------------------------------------------------------
# dequant_add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_dequant_add(shape, dtype):
    g = 64
    rng = _rng("dqa", shape, dtype)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    acc = (rng.standard_normal(shape) * 2).astype(np.float32)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bfloat16"
                else (torch.float32, jnp.float32))
    if dtype == "bfloat16":
        acc = _bf16_exact(acc)
    jc, js = JR.quantize_ref(jnp.asarray(x), group=g)
    codes, scales = _t(jc), _t(js)
    tacc, jacc = _t(acc, tdt), jnp.asarray(acc, jdt)
    got = dequant_add(tacc, codes, scales, group=g)
    assert got.dtype == tdt and got.shape == shape
    what = f"{shape} {dtype}"
    _same(got, JR.dequant_add_ref(jacc, jc, js, group=g), what + " vs ref")
    contracted = XF.dequant_add(tacc, codes, scales, group=g)
    for name, want in (
            ("jit ref", jax.jit(functools.partial(JR.dequant_add_ref,
                                                  group=g))(jacc, jc, js)),
            ("interpret", jax.jit(functools.partial(
                JQ.dequant_add, group=g, interpret=True))(jacc, jc, js))):
        _same(contracted, want, f"{what} contracted vs {name}")
        if dtype == "float32":
            _fma_bound(got, want, codes, scales, g, f"{what} vs {name}")


@pytest.mark.parametrize("shape,group", [
    ((3, 36), 12), ((2, 10), 5), ((7, 64), 64), ((3, 512), 128),
    ((130, 515), 515), ((4, 8192), 4), ((2, 65536), 512)])
def test_addcmul_is_dequant_add(shape, group):
    """``torch.addcmul`` over ``(rows, groups, g)`` views, the one PyTorch
    call ``chip_smoke.py`` times beside the ``dequant_add`` kernel, is
    ``dequant_add``'s function: bitwise equal to the reference's oracle
    under ``jax.jit`` (both round ``acc + q * s`` once), and so within
    ``2**-24 * |q * s|`` + 1 ulp of the port's twice-rounded plain
    version.  Float32 accumulators whose width divides into groups."""
    rng = _rng("addcmul", shape, group)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    acc = (rng.standard_normal(shape) * 2).astype(np.float32)
    jc, js = JR.quantize_ref(jnp.asarray(x), group=group)
    codes, scales = _t(jc), _t(js)
    rows, cols = shape
    ng = cols // group
    got = torch.addcmul(_t(acc).view(rows, ng, group),
                        codes.view(rows, ng, group),
                        scales.view(rows, ng, 1)).view(rows, cols)
    assert got.dtype == torch.float32
    what = f"addcmul {shape} g={group}"
    _same(got, jax.jit(functools.partial(JR.dequant_add_ref, group=group))(
        jnp.asarray(acc), jc, js), what + " vs jit ref")
    _same(got, XF.dequant_add(_t(acc), codes, scales, group=group),
          what + " vs the contracted plain version")
    _fma_bound(got, TR.dequant_add_ref(_t(acc), codes, scales, group=group),
               codes, scales, group, what + " vs the plain version")


# ---------------------------------------------------------------------------
# fused_round_dq
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("geometry", DQ_GEOMETRIES)
def test_fused_round_dq(geometry, op):
    lo, nb, next_lo = geometry
    for cols, g in ((16, 4), (512, 128)):
        rng = _rng("dq", geometry, op, cols)
        live = rng.standard_normal((lo, cols)).astype(np.float32)
        jc, js = JR.quantize_ref(jnp.asarray(
            (rng.standard_normal((nb, cols)) * 3).astype(np.float32)), group=g)
        codes, scales = _t(jc), _t(js)
        kw = dict(nb=nb, next_lo=next_lo, op=op, group=g)
        keep, send = fused_round_dq(_t(live), codes, scales, **kw)
        assert keep.dtype == torch.float32 and keep.shape == (next_lo, cols)
        assert (send is None) == (next_lo == lo)
        what = f"{geometry} {op} cols={cols} g={g}"
        jl = jnp.asarray(live)
        rk, rs = JR.fused_round_dq_ref(jl, jc, js, **kw)
        _same(keep, rk, what + " keep vs ref")
        if send is not None:
            _same(send[0], rs[0], what + " send codes vs ref")
            _same(send[1], rs[1], what + " send scales vs ref")
        ck, cs = XF.fused_round_dq(_t(live), codes, scales, **kw)
        for name, (wk, ws) in (
                ("jit ref", jax.jit(functools.partial(
                    JR.fused_round_dq_ref, **kw))(jl, jc, js)),
                ("interpret", jax.jit(functools.partial(
                    jax_fused_round_dq, interpret=True, **kw))(jl, jc, js))):
            _same(ck, wk, f"{what} contracted keep vs {name}")
            if op != "add":
                _same(keep, wk, f"{what} keep vs {name}")
            else:  # folded rows within the FMA bound, the others bitwise
                a = min(nb, next_lo)
                _fma_bound(keep[:a], np.asarray(wk)[:a], codes[:a],
                           scales[:a], g, f"{what} keep vs {name}")
                _same(keep[a:], np.asarray(wk)[a:], f"{what} keep vs {name}")
            if send is not None:
                _same(cs[0], ws[0], f"{what} contracted codes vs {name}")
                _same(cs[1], ws[1], f"{what} contracted scales vs {name}")
                _same(send[0], ws[0], f"{what} send codes vs {name}")


def test_fused_round_dq_validates():
    live = torch.zeros(4, 16)
    codes, scales = quantize(torch.ones(2, 16), group=4)
    with pytest.raises(ValueError, match="not divisible by group"):
        fused_round_dq(torch.zeros(4, 15), codes, scales, nb=2, next_lo=2,
                       group=4)
    with pytest.raises(ValueError, match="codes shape"):
        fused_round_dq(live, codes, scales, nb=3, next_lo=2, group=4)
    with pytest.raises(ValueError, match="scales shape"):
        fused_round_dq(live, codes, scales[:, :2], nb=2, next_lo=2, group=4)
    with pytest.raises(ValueError, match="invalid round"):
        fused_round_dq(live, codes, scales, nb=2, next_lo=5, group=4)


# ---------------------------------------------------------------------------
# block_reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_block_reduce_bitwise(dtype, op):
    rng = _rng("br", dtype, op)
    shape = (9, 515)
    if dtype == "int32":  # full range: add must wrap identically
        a, b = (rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
            np.int32) for _ in range(2))
        tdt, jdt = torch.int32, jnp.int32
    else:
        a, b = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        if op != "add":
            a[rng.random(shape) < 0.1] = np.nan
            b[rng.random(shape) < 0.1] = np.nan
        tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bfloat16"
                    else (torch.float32, jnp.float32))
        if dtype == "bfloat16":
            a, b = _bf16_exact(a), _bf16_exact(b)
    got = _np(block_reduce(_t(a, tdt), _t(b, tdt), op=op))
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    for name, want in (("ref", JR.block_reduce_ref(ja, jb, op=op)),
                       ("interpret", jax_ops.fused_block_reduce(ja, jb,
                                                                op=op))):
        want = np.asarray(want)
        want = want if want.dtype == np.int32 else want.astype(np.float32)
        if dtype != "int32":
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                          err_msg=f"NaN positions vs {name}")
            got_b = np.where(np.isnan(got), 0, got)
            want = np.where(np.isnan(want), 0, want)
        else:
            got_b = got
        np.testing.assert_array_equal(got_b.view(np.uint32),
                                      want.view(np.uint32),
                                      err_msg=f"{dtype} {op} vs {name}")


@pytest.mark.parametrize("a,b,kw", [
    ((2, 3), (3, 2), {}),                  # shapes differ
    ((6,), (6,), {}),                      # not 2-D
    ((2, 3), (2, 3), {"op": "mul"}),       # unknown op
], ids=["shapes", "1-D", "op"])
def test_block_reduce_validates(a, b, kw):
    with pytest.raises(ValueError):
        block_reduce(torch.ones(a), torch.ones(b), **kw)


def test_block_reduce_on_the_cpu_launches_nothing():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch."""
    a, b = torch.arange(6.0).view(2, 3), torch.ones(2, 3)
    before = block_reduce.launches
    torch.testing.assert_close(block_reduce(a, b, op="max"),
                               torch.maximum(a, b), rtol=0, atol=0)
    assert block_reduce.launches == before


# ---------------------------------------------------------------------------
# the wire format and the ops wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,group", [((4, 16), 4), ((3, 7), 4),
                                         ((2, 515), 128), ((1, 1), 512),
                                         ((8, 512), 512)])
def test_pack_wire_bitwise(shape, group):
    x = (_rng("w", shape).standard_normal(shape) * 2).astype(np.float32)
    jc, js = JR.quantize_ref(jnp.asarray(x), group=group)
    wire = pack_wire(_t(jc), _t(js))
    assert wire.dtype == torch.int8
    assert wire.shape == (shape[0], wire_width(shape[1], group))
    _same(wire, JQ.pack_wire(jc, js), f"{shape} wire")
    codes, scales = unpack_wire(wire, shape[1], group=group)
    _same(codes, jc, "codes")
    _same(scales, js, "scales")


def test_wire_extreme_scales_and_accounting():
    codes = torch.zeros((1, 8), dtype=torch.int8)
    for val in (1e-30, 1e-38, 1e-45, 3.4e38, 1.0):
        scales = torch.full((1, 1), val, dtype=torch.float32)
        wire = pack_wire(codes, scales)
        _same(wire, JQ.pack_wire(jnp.asarray(codes.numpy()),
                                 jnp.asarray(scales.numpy())), f"{val}")
        assert torch.equal(unpack_wire(wire, 8, group=8)[1].view(torch.int32),
                           scales.view(torch.int32))
    for cols, g in ((4096, 512), (7, 512), (515, 128), (1, 1)):
        assert wire_width(cols, g) == JQ.wire_width(cols, g)
        assert wire_ngroups(cols, g) == JQ.wire_ngroups(cols, g)
    with pytest.raises(ValueError, match="wire has"):
        unpack_wire(torch.zeros((2, 10), dtype=torch.int8), 8, group=8)


@pytest.mark.parametrize("shape", [(3, 4, 7), (515,), (2, 3, 2, 64)])
def test_ops_wrappers_match_reference(shape):
    rng = _rng("ops", shape)
    x, acc, b = ((rng.standard_normal(shape) * 2).astype(np.float32)
                 for _ in range(3))
    g = 16
    payload = quantize_blocks(_t(x), group=g)
    jp = jax_ops.quantize_blocks(jnp.asarray(x), group=g, backend="jnp")
    assert payload["meta"][1:] == jp["meta"][1:]
    _same(payload["codes"], jp["codes"], "codes")
    _same(payload["scales"], jp["scales"], "scales")
    _same(dequantize_blocks(payload), jax_ops.dequantize_blocks(jp),
          "dequantize")
    _same(dequant_accumulate(_t(acc), payload),
          jax_ops.dequant_accumulate(jnp.asarray(acc), jp, backend="jnp"),
          "dequant_accumulate")
    for op in OPS:
        _same(fused_block_reduce(_t(x), _t(b), op=op),
              jax_ops.fused_block_reduce(jnp.asarray(x), jnp.asarray(b),
                                         op=op, backend="jnp"), op)


def test_cpu_tensors_count_no_launch():
    counters = (quantize, dequant_add, fused_round_dq, block_reduce,
                quantize_rows)
    before = [f.launches for f in counters]
    x = torch.randn(2, 8)
    codes, scales = quantize_rows(x, group=4)
    dequant_add(x, codes, scales, group=4)
    fused_round_dq(x, codes[:1], scales[:1], nb=1, next_lo=1, group=4)
    block_reduce(x, x)
    assert [f.launches for f in counters] == before
