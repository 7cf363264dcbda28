"""The port's serving stack against the reference's (``repro.serve`` and the
cache paths of ``repro.models``), the reference run in process on one CPU
device.

Same seeded inputs through both packages, the reference's weights
carried across with ``convert.params_from_numpy``, everything scaled
down and in float32:

* ``decode_mask`` (scalar and ``(B,)`` positions, with a window): exact;
  ``decode_self_attention``: outputs and written caches within 1e-5;
* ``init_cache``: shapes and dtypes equal; ``prefill`` (one case above
  ``FLASH_THRESHOLD``) and ``decode_step`` (scalar and per-row
  positions) for qwen3-1.7b and phi-3.5-MoE (global and rowwise):
  caches and logits within 1e-5, MoE 2e-5 (``test_torch_moe.py``'s);
  in the port, prefill + decode equals ``forward_logits`` within 1e-5;
* ``BlockAllocator`` the reference's block for block; ``PagedKVCache``
  gather / write bitwise the reference's;
* ``eos_done_mask`` exact; ``generate``: greedy tokens equal to the
  reference's and eos freezing as ``tests/test_serve.py`` holds it;
  temperature sampling by shape, range and seed;
* ``Scheduler``: tokens bitwise a one-shot ``generate`` in the port and
  equal to the reference's ``Scheduler``, under staggered arrivals, late
  submissions with eos, and a queue waiting for blocks;
* the launcher's ``main`` on the CPU, one-shot and ``--max-batch``.

Greedy tokens of the two packages are compared while the reference's
top-2 logit margin stays above 100x the logits tolerance: below it the
two may pick different tokens within tolerance, and the comparison stops
at that step (the test says so in its assertion message).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as rserve
from repro.configs import get_config
from repro.models import attention as ref_attn
from repro.models import build
from repro_torch.configs import get_config as port_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import bootstrap
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as attn
from repro_torch.models import build as port_build
from repro_torch.serve import (BlockAllocator, PagedKVCache, Scheduler,
                               ServeEngine, blocks_per_request,
                               eos_done_mask)

QWEN, PHI = "qwen3-1.7b", "phi3.5-moe-42b-a6.6b"
#: case -> (arch, scale-down overrides)
MODELS = {"qwen3": (QWEN, {}), "phi_global": (PHI, {}),
          "phi_rowwise": (PHI, {"moe_dispatch": "rowwise"})}
TOL = {"qwen3": 1e-5, "phi_global": 2e-5, "phi_rowwise": 2e-5}
MAX_LEN = 24


def _scaled(getter, name, **kw):
    return getter(name).scaled_down(n_layers=2, vocab_size=64, **kw)


@pytest.fixture(scope="module")
def models():
    """case -> (reference model, reference params, port model, port
    params), the same weights on both sides."""
    out = {}
    for case, (name, kw) in MODELS.items():
        rm = build(_scaled(get_config, name, **kw), recipe=None, remat=False)
        rp = jax.jit(rm.init)(jax.random.PRNGKey(0))
        pcfg = _scaled(port_config, name, **kw)
        pm = port_build(pcfg, remat=False)
        pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg)
        out[case] = (rm, rp, pm, pp)
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


def _tokens_agree(got, want, margins, tol, what=""):
    """Greedy tokens equal while the reference's top-2 margin (per row and
    step) is at least 100x ``tol``; past the first row-step below it the
    row is not compared."""
    got, want = np.asarray(got), np.asarray(want)
    for b in range(want.shape[0]):
        low = np.nonzero(margins[b] < 100 * tol)[0]
        stop = int(low[0]) if low.size else want.shape[1]
        if stop < want.shape[1]:
            warnings.warn(f"{what} row {b}: tokens compared up to step "
                          f"{stop} of {want.shape[1]} (the reference's top-2 "
                          f"margin is below {100 * tol:g} there)")
        np.testing.assert_array_equal(got[b, :stop], want[b, :stop],
                                      err_msg=f"{what} row {b}")


# ---------------------------------------------------------------------------
# Attention cache paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_decode_mask_matches_reference(kind, window):
    pos = np.asarray(5 if kind == "scalar" else [0, 5, 11], np.int64)
    want = np.asarray(ref_attn.decode_mask(12, jnp.asarray(pos), window))
    got = attn.decode_mask(12, _t(pos), window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == ((1, 12) if kind == "scalar" else (3, 1, 1, 1, 12))


def _attn_inputs(cfg, b, s_max, seed):
    rng = np.random.default_rng(seed)
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.standard_normal((d, h, dh)) / 8,
         "wk": rng.standard_normal((d, hkv, dh)) / 8,
         "wv": rng.standard_normal((d, hkv, dh)) / 8,
         "wo": rng.standard_normal((h, dh, d)) / 8,
         "q_norm": 1 + rng.standard_normal((dh,)) / 10,
         "k_norm": 1 + rng.standard_normal((dh,)) / 10}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, s_max, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s_max, hkv, dh)).astype(np.float32)
    return p, x, k, v


@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_decode_self_attention_matches_reference(kind):
    """One-token decode against a cache of random (stale) rows: the new
    row is written at ``pos``, the rows past it get zero probability."""
    rcfg = get_config(QWEN).scaled_down()
    pcfg = port_config(QWEN).scaled_down()
    p, x, k, v = _attn_inputs(rcfg, 3, 12, 7)
    pos = np.asarray(6 if kind == "scalar" else [0, 6, 11], np.int32)
    out, kv = ref_attn.decode_self_attention(
        {n: jnp.asarray(a) for n, a in p.items()}, rcfg, jnp.asarray(x),
        ref_attn.KVCache(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(pos))
    cache = attn.KVCache(_t(k), _t(v))
    got, new = attn.decode_self_attention(
        {n: _t(a) for n, a in p.items()}, pcfg, _t(x), cache,
        _t(pos).long())
    assert new.k is cache.k and new.v is cache.v       # written in place
    _close(got, out, 1e-5, "out")
    _close(new.k, kv.k, 1e-5, "k")
    _close(new.v, kv.v, 1e-5, "v")
    # rows other than the written ones are untouched
    rows = np.ones((3, 12), bool)
    rows[np.arange(3), np.broadcast_to(pos, (3,))] = False
    np.testing.assert_array_equal(new.k.numpy()[rows], k[rows])


# ---------------------------------------------------------------------------
# Transformer cache paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [QWEN, PHI])
def test_init_cache_matches_reference(name):
    """Shapes and dtypes of the full-width configs' caches (bf16) and the
    scaled-down ones' (f32), all zero."""
    from repro.models import transformer as rtr
    from repro_torch.models import transformer as ptr
    for rcfg, pcfg in ((get_config(name), port_config(name)),
                       (get_config(name).scaled_down(),
                        port_config(name).scaled_down())):
        want = rtr.init_cache(rcfg, 2, 8)
        got = ptr.init_cache(pcfg, 2, 8)
        assert set(got) == set(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).split(".")[-1] == \
                str(want[key].dtype)
            assert not got[key].any()


def _ref_run(rm, rp, tokens, max_len, steps, vector=False):
    """The reference's prefill, then ``steps`` decodes of the greedy
    tokens: (caches, logits) after each call, and the tokens fed."""
    prefill = jax.jit(rm.prefill, static_argnums=2)
    decode = jax.jit(rm.decode_step)
    cache, logits = prefill(rp, jnp.asarray(tokens), max_len)
    out = [(jax.tree.map(np.asarray, cache), np.asarray(logits))]
    fed = []
    s = tokens.shape[1]
    for i in range(steps):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(nxt))
        pos = jnp.full((tokens.shape[0],), s + i, jnp.int32) if vector \
            else jnp.asarray(s + i, jnp.int32)
        cache, logits = decode(rp, cache, nxt, pos)
        out.append((jax.tree.map(np.asarray, cache), np.asarray(logits)))
    return out, fed


#: case -> (model case, batch, prompt length, per-row positions?)
CACHE_CASES = {"qwen3": ("qwen3", 2, 8, False),
               "qwen3_vector": ("qwen3", 2, 8, True),
               "phi_global": ("phi_global", 2, 8, False),
               "phi_rowwise": ("phi_rowwise", 2, 8, True)}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_prefill_and_decode_match_reference(models, case):
    mcase, b, s, vector = CACHE_CASES[case]
    rm, rp, pm, pp = models[mcase]
    tol = TOL[mcase]
    tokens = np.random.default_rng(11).integers(0, 64, (b, s)).astype(
        np.int32)
    want, fed = _ref_run(rm, rp, tokens, MAX_LEN, 3, vector)
    cache, logits = pm.prefill(pp, _t(tokens), MAX_LEN)
    # decode writes the cache in place: keep a copy of each call's
    got = [({k: v.clone() for k, v in cache.items()}, logits)]
    for i, nxt in enumerate(fed):
        pos = torch.full((b,), s + i) if vector else s + i
        cache, logits = pm.decode_step(pp, cache, _t(nxt), pos)
        got.append(({k: v.clone() for k, v in cache.items()}, logits))
    for i, ((gc, gl), (wc, wl)) in enumerate(zip(got, want)):
        _close(gl, wl, tol, f"logits after call {i}")
        for key in ("k", "v"):
            _close(gc[key], wc[key], tol, f"cache {key} after call {i}")


def test_flash_prefill_matches_reference():
    """A prompt above ``FLASH_THRESHOLD`` (chunked flash attention): the
    compact GQA k/v seed the cache; then one decode step."""
    rcfg = get_config(QWEN).scaled_down(n_layers=1, vocab_size=64)
    pcfg = port_config(QWEN).scaled_down(n_layers=1, vocab_size=64)
    rm = build(rcfg, recipe=None, remat=False)
    rp = jax.jit(rm.init)(jax.random.PRNGKey(1))
    pm = port_build(pcfg, remat=False)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg)
    s = attn.FLASH_THRESHOLD + 8
    tokens = np.random.default_rng(12).integers(0, 64, (1, s)).astype(
        np.int32)
    want, fed = _ref_run(rm, rp, tokens, s + 8, 1)
    cache, logits = pm.prefill(pp, _t(tokens), s + 8)
    _close(logits, want[0][1], 1e-5, "prefill logits")
    _close(cache["k"], want[0][0]["k"], 1e-5, "k")
    _close(cache["v"], want[0][0]["v"], 1e-5, "v")
    cache, logits = pm.decode_step(pp, cache, _t(fed[0]), s)
    _close(logits, want[1][1], 1e-5, "decode logits")


@pytest.mark.parametrize("case", sorted(MODELS))
def test_prefill_plus_decode_equals_forward(case):
    """Prefill + greedy decode == ``forward_logits`` over the sequence, in
    the port, at every step (scalar positions, then per-row).  It holds
    where no token is dropped: a MoE forward pools B·S tokens and drops
    above capacity, a decode step's pool of B never does, so the MoE
    cases take capacity factor 4 (capacity N·K: no drop)."""
    name, kw = MODELS[case]
    if name == PHI:
        kw = dict(kw, capacity_factor=4.0)
    cfg = _scaled(port_config, name, **kw)
    pm = port_build(cfg, remat=False)
    pp = pm.init(torch.Generator().manual_seed(5))
    tokens = np.random.default_rng(13).integers(0, 64, (2, 9)).astype(
        np.int32)
    seq = _t(tokens)
    cache, logits = pm.prefill(pp, seq, MAX_LEN)
    for i in range(4):
        full = pm.forward_logits(pp, seq)
        full = full[0] if isinstance(full, tuple) else full
        _close(logits, full[:, -1].detach(), TOL[case], f"step {i}")
        nxt = torch.argmax(logits, -1).to(torch.int32)
        pos = seq.shape[1] if i < 2 else torch.full((2,), seq.shape[1])
        cache, logits = pm.decode_step(pp, cache, nxt, pos)
        seq = torch.cat([seq, nxt[:, None]], 1)


def test_ep_cache_paths_refuse_single_pool_configs(models):
    from repro_torch.models import transformer as ptr
    _, _, pm, pp = models["phi_global"]
    with pytest.raises(ValueError):
        ptr.prefill_ep([pp], pm.cfg, [_t(np.zeros((1, 4), np.int32))], 8,
                       None)


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------

def _allocator_trace(cls) -> list:
    al = cls(7)                     # block 0 = scratch -> 6 usable
    a, b = al.alloc(3), al.alloc(2)
    al.free(a)
    log = [a, b, al.alloc(4)]       # reuses a's blocks, never b's
    for bad in (lambda: al.alloc(3), lambda: al.free([log[2][0]] * 2),
                lambda: al.free([0])):
        try:
            bad()
            log.append("no error")
        except (ValueError, RuntimeError) as e:
            log.append(f"{type(e).__name__}: {e}")
    return log + [al.num_free]


def test_block_allocator_matches_reference():
    """The same operations give the same blocks, the same errors (out of
    blocks, double free, freeing scratch) and the same free count."""
    got = _allocator_trace(BlockAllocator)
    assert got == _allocator_trace(rserve.BlockAllocator)
    assert got[3].startswith("OutOfBlocks") and "double free" in got[4]
    assert "scratch" in got[5]
    assert not set(got[2]) & set(got[1]) and 0 not in got[0] + got[1]
    with pytest.raises(ValueError):
        BlockAllocator(1)


def test_paged_cache_gather_and_writes_match_reference(models):
    """Prefill rows through shuffled block tables, then single-token
    writes at per-slot offsets: pools and gathered views bitwise the
    reference's, the gather bitwise the dense prefill cache."""
    rm, rp, pm, pp = models["qwen3"]
    max_len, bs = 16, 4
    nb = blocks_per_request(max_len, bs)
    tokens = np.random.default_rng(2).integers(0, 64, (2, 9)).astype(
        np.int32)
    dense, _ = pm.prefill(pp, _t(tokens), max_len)
    tables = np.asarray([[3, 1, 4, 2], [7, 5, 8, 6]], np.int32)
    ref = rserve.PagedKVCache.create(rm.cfg, 1 + 2 * nb, bs)
    kv = PagedKVCache.create(pm.cfg, 1 + 2 * nb, bs)
    for b in range(2):
        d = {"k": dense["k"][:, b], "v": dense["v"][:, b]}
        kv = kv.write_prefill(tables[b], d)
        ref = ref.write_prefill(tables[b], {k: jnp.asarray(v.numpy())
                                            for k, v in d.items()})
    got, want = kv.gather(tables), ref.gather(tables)
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(got[key].numpy(), dense[key].numpy())
    rng = np.random.default_rng(3)
    upd = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in got.items()}
    pos = np.asarray([9, 14], np.int32)
    kv = kv.write_token(tables, {k: _t(v) for k, v in upd.items()}, pos)
    ref = ref.write_token(tables, {k: jnp.asarray(v) for k, v in upd.items()},
                          pos)
    np.testing.assert_array_equal(kv.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(kv.v.numpy(), np.asarray(ref.v))
    got = kv.gather(tables)
    changed = np.nonzero((got["k"].numpy() != dense["k"].numpy())
                         .any(axis=(0, 3, 4)))
    np.testing.assert_array_equal(changed[0], [0, 1])
    np.testing.assert_array_equal(changed[1], pos)
    with pytest.raises(ValueError):
        blocks_per_request(18, 4)


# ---------------------------------------------------------------------------
# Engine: eos masks, generate, sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eos", [None, 5, [5, 7, -1]])
def test_eos_done_mask_matches_reference(eos):
    nxt = np.asarray([5, 7, 9], np.int32)
    done = np.asarray([False, True, False])
    rn, rd = rserve.eos_done_mask(
        jnp.asarray(nxt), jnp.asarray(done),
        None if eos is None else jnp.asarray(eos, jnp.int32))
    pn, pd = eos_done_mask(_t(nxt), _t(done), eos)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))


def _ref_margins(rm, rp, prompts, n):
    """Per row and step, the reference's top-2 margin of the logits its
    greedy tokens came from."""
    out, _ = _ref_run(rm, rp, prompts, MAX_LEN, n - 1)
    top = [np.sort(lg, -1)[:, -2:] for _, lg in out]
    return np.stack([t[:, 1] - t[:, 0] for t in top], 1)


@pytest.mark.parametrize("case", ["qwen3", "phi_global"])
def test_generate_greedy_matches_reference(models, case):
    rm, rp, pm, pp = models[case]
    prompts = np.random.default_rng(0).integers(0, 64, (2, 8)).astype(
        np.int32)
    want = rserve.ServeEngine(model=rm, params=rp, max_len=MAX_LEN).generate(
        prompts, 6)
    eng = ServeEngine(pm, pp, MAX_LEN)
    got = eng.generate(prompts, 6)
    assert got.shape == (2, 6) and got.dtype == np.int32
    _tokens_agree(got, want, _ref_margins(rm, rp, prompts, 6), TOL[case],
                  case)
    assert len(eng.timings["step_s"]) == 5 and eng.timings["ttft_s"] > 0


def test_generate_eos_freezes_rows(models):
    """``tests/test_serve.py``'s eos case on the port: row 0 stops at its
    first eos and stays frozen to it, other rows run unchanged until
    theirs; the result equals the reference's."""
    rm, rp, pm, pp = models["qwen3"]
    eng = ServeEngine(pm, pp, 32)
    prompts = np.random.default_rng(1).integers(0, 64, (2, 8)).astype(
        np.int32)
    ref = eng.generate(prompts, 8)
    eos = int(ref[0, 2])
    out = eng.generate(prompts, 8, eos_id=eos)
    assert out.shape == ref.shape
    for b in range(2):
        hits = np.nonzero(ref[b] == eos)[0]
        stop = int(hits[0]) if hits.size else ref.shape[1] - 1
        np.testing.assert_array_equal(out[b, :stop + 1], ref[b, :stop + 1])
        assert (out[b, stop:] == eos).all() or not hits.size
    want = rserve.ServeEngine(model=rm, params=rp, max_len=32).generate(
        prompts, 8, eos_id=eos)
    np.testing.assert_array_equal(out, want)


def test_generate_all_rows_eos_exits_early(models):
    """When every row has hit its eos the loop stops decoding and pads
    the output with eos."""
    _, _, pm, pp = models["qwen3"]
    eng = ServeEngine(pm, pp, 32)
    prompts = np.zeros((1, 8), np.int32)
    ref = eng.generate(prompts, 8)
    out = eng.generate(prompts, 8, eos_id=int(ref[0, 1]))
    stop = int(np.nonzero(ref[0] == ref[0, 1])[0][0])
    assert (out[0, stop:] == ref[0, 1]).all()
    assert len(eng.timings["step_s"]) == stop


def test_generate_temperature_and_cache_bounds(models):
    _, _, pm, pp = models["qwen3"]
    eng = ServeEngine(pm, pp, 16, temperature=1.0)
    prompts = np.zeros((3, 8), np.int32)
    a = eng.generate(prompts, 8,
                     generator=torch.Generator().manual_seed(1))
    b = eng.generate(prompts, 8,
                     generator=torch.Generator().manual_seed(1))
    c = eng.generate(prompts, 8,
                     generator=torch.Generator().manual_seed(2))
    assert a.shape == (3, 8) and (a >= 0).all() and (a < 64).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError):
        eng.generate(prompts, 9)


# ---------------------------------------------------------------------------
# Scheduler: tokens bitwise one-shot, and the reference's
# ---------------------------------------------------------------------------

def _engines(models, max_len=MAX_LEN):
    rm, rp, pm, pp = models["qwen3"]
    return (rserve.ServeEngine(model=rm, params=rp, max_len=max_len),
            ServeEngine(pm, pp, max_len))


def test_scheduler_parity_staggered_arrivals(models):
    """4 requests through 2 decode slots: admissions and evictions are
    staggered and freed blocks reused; every request's tokens are bitwise
    the port's one-shot ``generate`` and equal to the reference
    scheduler's."""
    reng, eng = _engines(models)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in (8, 5, 11, 7)]
    maxnew = [4, 6, 3, 5]
    refs = [eng.generate(p[None], m)[0] for p, m in zip(prompts, maxnew)]
    out = []
    for e, cls in ((eng, Scheduler), (reng, rserve.Scheduler)):
        sched = cls(e, max_batch=2, kv_block_size=4)
        rids = [sched.submit(p, m) for p, m in zip(prompts, maxnew)]
        got = sched.run()
        out.append([got[r] for r in rids])
        assert sched.n_decode_steps < sum(maxnew)
        assert sched.alloc.num_free == 2 * sched.blocks_per_req
        assert not sched.alloc._live
    for mine, theirs, one in zip(out[0], out[1], refs):
        np.testing.assert_array_equal(mine, one)
        np.testing.assert_array_equal(mine, theirs)


def test_scheduler_late_submissions_and_eos(models):
    """A request submitted after decoding started joins at the next
    boundary; an eos-terminated request evicts early, its stream the
    one-shot's up to its first eos; both equal the reference's."""
    reng, eng = _engines(models)
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, 64, (6,)).astype(np.int32)
    p1 = rng.integers(0, 64, (9,)).astype(np.int32)
    ref0 = eng.generate(p0[None], 6)[0]
    eos = int(ref0[2])
    stop = int(np.nonzero(ref0 == eos)[0][0])
    ref1 = eng.generate(p1[None], 5)[0]
    results = []
    for e, cls in ((eng, Scheduler), (reng, rserve.Scheduler)):
        sched = cls(e, max_batch=2, kv_block_size=4)
        r0 = sched.submit(p0, 6, eos_id=eos)
        sched.step()
        sched.step()
        r1 = sched.submit(p1, 5)
        got = sched.run()
        results.append((got[r0], got[r1]))
    np.testing.assert_array_equal(results[0][0], ref0[:stop + 1])
    if not (ref1 == eos).any():
        np.testing.assert_array_equal(results[0][1], ref1)
    for a, b in zip(results[0], results[1]):
        np.testing.assert_array_equal(a, b)


def test_scheduler_queue_waits_for_blocks(models):
    """With a pool sized for ONE request the second stays queued until the
    first finishes and its blocks return to the free list."""
    reng, eng = _engines(models)
    rng = np.random.default_rng(4)
    pa = rng.integers(0, 64, (8,)).astype(np.int32)
    pb = rng.integers(0, 64, (8,)).astype(np.int32)
    refa, refb = (eng.generate(p[None], 3)[0] for p in (pa, pb))
    nb = eng.max_len // 8
    for e, cls in ((eng, Scheduler), (reng, rserve.Scheduler)):
        sched = cls(e, max_batch=2, kv_block_size=8, num_blocks=1 + nb)
        ra, rb = sched.submit(pa, 3), sched.submit(pb, 3)
        sched.step()
        assert sched.in_flight == 1 and len(sched.waiting) == 1
        got = sched.run()
        np.testing.assert_array_equal(got[ra], refa)
        np.testing.assert_array_equal(got[rb], refb)


def test_scheduler_refuses_ep_engine_and_oversized_requests(models):
    """An ep engine is taken (it was refused before the scheduler kept
    one paged cache per rank): two ranks, two caches; an oversized
    request is refused."""
    from repro_torch.comm import LocalComm
    cfg = dataclasses.replace(_scaled(port_config, PHI), moe_dispatch="ep")
    pm = port_build(cfg, remat=False, ep_comm=LocalComm(2))
    pp = models["phi_global"][3]
    ep = Scheduler(ServeEngine(pm, pp, MAX_LEN), max_batch=2, kv_block_size=4)
    assert len(ep.kvs) == 2 and ep.kv is ep.kvs[0]
    _, eng = _engines(models)
    sched = Scheduler(eng, max_batch=2, kv_block_size=4)
    with pytest.raises(ValueError):
        sched.submit(np.zeros(20, np.int32), 5)


# ---------------------------------------------------------------------------
# The launcher and the session builder
# ---------------------------------------------------------------------------

def test_serve_cli_one_shot_and_scheduler_on_cpu(capsys):
    """``main`` one-shot and with ``--max-batch``: the same prompts (drawn
    from ``default_rng(0)``, as the reference draws them) give the same
    tokens both ways."""
    argv = ["--arch", QWEN, "--scale-down", "--device", "cpu", "--batch",
            "3", "--prompt-len", "8", "--max-new", "4"]
    one = serve_cli.main(argv)
    sched = serve_cli.main(argv + ["--max-batch", "2", "--kv-block-size",
                                   "4"])
    want = np.random.default_rng(0).integers(0, 128, (3, 8))
    np.testing.assert_array_equal(one.prompts, want)
    assert one.tokens.shape == (3, 4) and one.steady_seconds > 0
    for b in range(3):
        np.testing.assert_array_equal(sched.tokens[b], one.tokens[b])
    assert sched.scheduler.n_prefills == 3
    text = capsys.readouterr().out
    assert "time to first token" in text and "decode boundaries" in text


@pytest.mark.parametrize("extra", [
    ["--moe-dispatch", "ep", "--ep-devices", "0"],
    ["--moe-dispatch", "ep", "--arch", QWEN],
    ["--max-batch", "2", "--kv-block-size", "5"]])
def test_serve_cli_refusals(extra):
    argv = ["--arch", PHI, "--scale-down", "--device", "cpu", "--batch",
            "2", "--prompt-len", "8", "--max-new", "4"]
    with pytest.raises(SystemExit):
        serve_cli.main(argv + extra)


def test_build_serve_session_on_cpu():
    sess = bootstrap.build_serve_session(arch=QWEN, max_len=16,
                                         scale_down=True, device="cpu",
                                         n_layers=1, replicas=2)
    assert sess.cfg.n_layers == 1 and sess.ep_comm is None
    assert sess.push_stats["exchanges"] == sess.push_stats["n_leaves"]
    assert sess.engine is sess.replica_set.engines[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bootstrap.build_serve_session(arch=QWEN, max_len=16,
                                          scale_down=True)
