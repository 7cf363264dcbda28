"""Shared cases of ``test_torch_archs.py`` and ``test_torch_archs_mm.py``:
every architecture of ``repro.configs.ALIASES``, scaled down, through the
reference and the port from the same weights and inputs.

Sizes reach what ``scaled_down()`` alone hides: the hybrid at 6 layers
with global layers (0, 3, 5) and a sequence of 24 (window 8, three Mamba
chunks of 8), the xLSTM at 12 layers (a list of more than 10 layers,
where JAX's index order and a string sort differ), the VLM at 10 layers
(two groups; its cross layers' ``tanh`` gates, zero at init, are set to
0.5 so the image path reaches the outputs).  ``reference(arch)`` runs
the reference once (jitted) and
returns numpy results; ``port(arch, params)`` runs the port on the
reference's weights.  Each holds: the loss and its gradients, the
forward logits, the prefill cache and last-token logits of a prompt of
``PROMPT`` tokens, and ``DECODE`` teacher-forced decode steps after it
(their logits, and the cache after the last).

The test functions below are collected by both test files, each of
which defines the module fixture ``case`` over its architectures.
Tolerances: the loss within 1e-5; gradients within ``rtol=1e-4,
atol=1e-6`` (``GRAD_ATOL``: hymba and xLSTM 1e-5); logits and caches
within 1e-5 absolute (MoE 2e-5; ``SCALED_STATES``: the xLSTM's states,
whose sLSTM normalizer grows to ~90, within 1e-5 of each leaf's largest
magnitude).  The
hybrid's and the xLSTM's mixers differ from the reference's in more than
summation order (the Mamba scan's association, XLA's FMA contraction,
16-step recurrences), and their scaled-down embedding gradients reach
2-8 where the dense family's stay below 1: observed at most 7.3e-6 apart
(xLSTM ``embed``, at a value of 0.06) against 1e-6, and the xLSTM's
states at most 3.8e-5 apart in a leaf whose largest magnitude is 80
(mLSTM ``C``: 2.7e-5 at 20).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build
from repro.models.layers import cross_entropy_loss
from repro_torch.configs import get_config as port_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build as port_build, value_and_grad

OVERRIDES = {"hymba-1.5b": dict(n_layers=6, global_attn_layers=(0, 3, 5)),
             "xlstm-125m": dict(n_layers=12),
             "llama-3.2-vision-90b": dict(n_layers=10)}
B, SEQ, PROMPT = 2, 24, 20
DECODE = SEQ - PROMPT
MAX_LEN = SEQ + 4


def scaled(arch: str, port: bool = False):
    cfg = (port_config if port else get_config)(arch)
    return cfg.scaled_down(**OVERRIDES.get(arch, {}))


def make_batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(
             np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, SEQ, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def extras_of(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k in ("frames", "image_embeds")}


def cache_leaves(cache) -> list:
    """A cache's arrays in JAX's flatten order (dicts by sorted key,
    lists and state tuples in order), as numpy."""
    if isinstance(cache, dict):
        return [x for k in sorted(cache) for x in cache_leaves(cache[k])]
    if isinstance(cache, (list, tuple)):
        return [x for c in cache for x in cache_leaves(c)]
    if isinstance(cache, torch.Tensor):
        return [cache.detach().numpy().copy()]
    return [np.asarray(cache)]


def reference(arch: str) -> dict:
    return _reference(dataclasses.replace(scaled(arch), name=""))


@functools.lru_cache(maxsize=None)
def _reference(cfg) -> dict:
    """The reference's results for a scaled-down config, computed once
    per config (grok and phi-3.5-MoE, and the two qwen3 sizes, scale down
    to the same one)."""
    model = build(cfg, recipe=None, remat=False)
    params = jax.tree.map(np.asarray,
                          jax.jit(model.init)(jax.random.PRNGKey(0)))
    if cfg.family == "vlm":  # zero-initialized gates hide the image path
        for gate in ("gate_attn", "gate_ffn"):
            params["cross_layers"][gate] = np.full_like(
                params["cross_layers"][gate], 0.5)
    batch = make_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ex = extras_of(jb)

    def loss_and_logits(p, b):
        # model.loss's expression, with its logits kept: one compiled
        # program for the loss, the gradients and the logits
        logits, aux = model.forward_logits(p, b["tokens"], **extras_of(b))
        return cross_entropy_loss(logits, b["targets"]) + aux, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(params, jb)
    cache, plog = jax.jit(
        lambda p, t, e: model.prefill(p, t, MAX_LEN, **e))(
        params, jb["tokens"][:, :PROMPT], ex)
    out = {"params": params, "loss": float(loss),
           "grads": jax.tree.map(np.asarray, grads),
           "logits": np.asarray(logits), "prefill_logits": np.asarray(plog),
           "prefill_cache": cache_leaves(cache)}
    step = jax.jit(model.decode_step)
    dec = []
    for t in range(PROMPT, SEQ):
        cache, lg = step(params, cache, jb["tokens"][:, t],
                         jnp.asarray(t, jnp.int32))
        dec.append(np.asarray(lg))
    out["decode_logits"] = dec
    out["decode_cache"] = cache_leaves(cache)
    return out


def port(arch: str, np_params: dict) -> dict:
    cfg = scaled(arch, port=True)
    model = port_build(cfg, remat=True)
    params = params_from_numpy(np_params, cfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    ex = extras_of(batch)
    loss, grads = value_and_grad(model.loss)(params, batch)
    with torch.no_grad():
        logits = model.forward_logits(params, batch["tokens"], **ex)
    if cfg.is_moe:
        logits = logits[0]
    cache, plog = model.prefill(params, batch["tokens"][:, :PROMPT], MAX_LEN,
                                **ex)
    out = {"params": params, "loss": float(loss),
           "grads": params_to_numpy(grads), "logits": logits.numpy(),
           "prefill_logits": plog.numpy(),
           "prefill_cache": cache_leaves(cache)}
    dec = []
    for t in range(PROMPT, SEQ):
        cache, lg = model.decode_step(params, cache, batch["tokens"][:, t], t)
        dec.append(lg.numpy())
    out["decode_logits"] = dec
    out["decode_cache"] = cache_leaves(cache)
    return out


def tol(cfg) -> float:
    """Absolute tolerance of logits and caches: 1e-5, MoE 2e-5."""
    return 2e-5 if cfg.is_moe else 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread: at these widths torch's thread
    pool only spins (8x the CPU time for the same wall time), which slows
    every other test worker on the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAD_ATOL = {"hymba-1.5b": 1e-5, "xlstm-125m": 1e-5}
SCALED_STATES = {"xlstm-125m"}


def load_case(arch: str):
    """``(arch, scaled reference config, reference results, port
    results)``, the module fixture ``case`` of both test files."""
    ref = reference(arch)
    return arch, scaled(arch), ref, port(arch, ref["params"])


def _jax_path(path) -> tuple:
    return tuple(k.idx if isinstance(k, jax.tree_util.SequenceKey)
                 else k.key for k in path)


# ---------------------------------------------------------------------------
# The properties of tests/test_archs.py, held against the reference
# ---------------------------------------------------------------------------

def test_full_config_matches_reference(case):
    """The full config is the reference's: its fields, its analytic
    parameter count, and the parameter tree of the reference's init at
    full size (``jax.eval_shape``: no memory) leaf by leaf, shape and
    dtype, in the same order."""
    from repro_torch import tree as T
    from repro_torch.models import leaf_dtype, param_shapes
    arch = case[0]
    full, pfull = get_config(arch), port_config(arch)
    assert vars(pfull) == vars(full)
    n = pfull.param_count()
    assert n == full.param_count() and n > 1e7
    assert pfull.active_param_count() == full.active_param_count()
    if full.is_moe:
        assert pfull.active_param_count() < n
    shapes = jax.eval_shape(build(full, recipe=None).init,
                            jax.random.PRNGKey(0))
    want = [(_jax_path(p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(p, tuple(s), str(leaf_dtype(pfull, p)).removeprefix("torch."))
           for p, s in T.flatten(param_shapes(pfull))]
    assert got == want


def test_leaf_order_matches_jax(case):
    """``tree.flatten`` walks the parameters in JAX's order (a list by
    index: the 12-layer xLSTM's ``layers`` 0, 1, 2, ..., 10, 11), for the
    tree carried from the reference and for the port's own init."""
    from repro_torch import tree as T
    arch, cfg, ref, got = case
    want = [_jax_path(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(ref["params"])[0]]
    assert [p for p, _ in T.flatten(got["params"])] == want
    pcfg = scaled(arch, port=True)
    own = port_build(pcfg).init(torch.Generator().manual_seed(0))
    assert [p for p, _ in T.flatten(own)] == want
    for (_, a), (_, b) in zip(T.flatten(own), T.flatten(got["params"])):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_loss_and_grads_match_reference(case):
    from repro_torch import tree as T
    arch, cfg, ref, got = case
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - ref["loss"]) <= 1e-5, (got["loss"], ref["loss"])
    flat = T.flatten(got["grads"])
    assert [p for p, _ in flat] == [p for p, _ in T.flatten(ref["grads"])]
    total = 0.0
    for (path, b), (_, a) in zip(flat, T.flatten(ref["grads"])):
        assert np.all(np.isfinite(b)), path
        total += float(np.abs(b).sum())
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=GRAD_ATOL.get(arch, 1e-6),
                                   err_msg=".".join(map(str, path)))
    assert total > 0


def test_logits_match_reference(case):
    arch, cfg, ref, got = case
    assert got["logits"].shape == (B, SEQ, cfg.vocab_size)
    assert np.all(np.isfinite(got["logits"]))
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=0,
                               atol=tol(cfg))


def _close_caches(got, want, arch, cfg, what):
    assert [a.shape for a in got] == [a.shape for a in want], what
    for i, (a, b) in enumerate(zip(want, got)):
        scale = max(1.0, float(np.abs(a).max())) if arch in SCALED_STATES \
            else 1.0
        np.testing.assert_allclose(b, a, rtol=0, atol=tol(cfg) * scale,
                                   err_msg=f"{what} leaf {i}")


def test_prefill_and_decode_match_reference(case):
    """The prompt's cache and last-token logits, then each teacher-forced
    decode step's logits and the cache after the last."""
    arch, cfg, ref, got = case
    np.testing.assert_allclose(got["prefill_logits"], ref["prefill_logits"],
                               rtol=0, atol=tol(cfg))
    _close_caches(got["prefill_cache"], ref["prefill_cache"], arch, cfg,
                  "prefill cache")
    for i, (a, b) in enumerate(zip(ref["decode_logits"],
                                   got["decode_logits"])):
        np.testing.assert_allclose(b, a, rtol=0, atol=tol(cfg),
                                   err_msg=f"decode step {i}")
    _close_caches(got["decode_cache"], ref["decode_cache"], arch, cfg,
                  "decode cache")


def test_prefill_plus_decode_equals_forward(case):
    """In the port, prefill and each teacher-forced decode step give the
    logits ``forward_logits`` gives at that position.  It holds where no
    token is dropped: a MoE forward pools B·S tokens and drops above
    capacity, a decode step's pool of B never does, so a MoE config
    takes capacity factor 4 here (capacity N·K: no drop)."""
    arch, cfg, ref, got = case
    if cfg.is_moe:
        pcfg = dataclasses.replace(scaled(arch, port=True),
                                   capacity_factor=4.0)
        model = port_build(pcfg, remat=False)
        params = params_from_numpy(ref["params"], pcfg)
        batch = {k: torch.from_numpy(v) for k, v in make_batch(pcfg).items()}
        with torch.no_grad():
            logits = model.forward_logits(params, batch["tokens"])[0].numpy()
        cache, plog = model.prefill(params, batch["tokens"][:, :PROMPT],
                                    MAX_LEN)
        dec = []
        for t in range(PROMPT, SEQ):
            cache, lg = model.decode_step(params, cache,
                                          batch["tokens"][:, t], t)
            dec.append(lg.numpy())
        plog = plog.numpy()
    else:
        logits, plog, dec = (got["logits"], got["prefill_logits"],
                             got["decode_logits"])
    np.testing.assert_allclose(plog, logits[:, PROMPT - 1], rtol=0,
                               atol=tol(cfg))
    for i, lg in enumerate(dec):
        np.testing.assert_allclose(lg, logits[:, PROMPT + i], rtol=0,
                                   atol=tol(cfg), err_msg=f"step {i}")
