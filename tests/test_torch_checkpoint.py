"""The port's checkpoint manager: the reference's nine
``tests/test_checkpoint.py`` cases (atomic save/restore, async
double-buffering, retention, elastic resharding, crash-leftover
sweeping, corruption fallback, transient-IO faults, exact-resume
training) on the port's manager and model, and its on-disk layout held
against the reference manager's.

The layout tests save the same converted qwen3-1.7b scaled-down
parameters (float32, and cast to bfloat16) through both managers: the
``arrays.npz`` files must hold the same ``p_*`` / ``opt_*`` keys, shapes,
dtypes and bytes (a bfloat16 leaf is two raw bytes per element, ``V2``,
in both), the manifests the same fields and values, and each manager
must read the other's checkpoint back bitwise.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as ref_config
from repro.models import build as ref_build
from repro_torch import tree as T
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    reshard_flat)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import for_model
from repro_torch.ft import CheckpointIOError
from repro_torch.models import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import build_single


def _model(n_layers=1):
    cfg = get_config("qwen3-1.7b").scaled_down(n_layers=n_layers,
                                               vocab_size=64)
    model = build(cfg, remat=False)
    return cfg, model


@pytest.fixture()
def setup(tmp_path):
    cfg, model = _model()
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params, str(tmp_path / "ckpt")


def _equal_trees(a, b):
    for (pa, x), (pb, y) in zip(T.flatten(a), T.flatten(b)):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa


def test_save_restore_roundtrip(setup):
    cfg, model, params, d = setup
    mgr = CheckpointManager(d)
    opt_flat = {"m": np.arange(10.0), "v": np.ones(10), "step": np.int32(7)}
    mgr.save(7, params, opt_flat, {"data_cursor": 7})
    step, params2, opt2, manifest = mgr.restore(None, params)
    assert step == 7 and manifest["data_cursor"] == 7
    _equal_trees(params, params2)
    np.testing.assert_array_equal(opt2["m"], opt_flat["m"])


def test_async_save_and_retention(setup):
    cfg, model, params, d = setup
    mgr = CheckpointManager(d, keep_last=2)
    for s in [1, 2, 3, 4]:
        mgr.save_async(s, params, {"step": np.int32(s)})
    mgr.wait()
    assert mgr.completed_steps() == [3, 4]
    assert mgr.last_write["step"] == 4 and mgr.last_write["bytes"] > 0


def test_restore_rejects_config_mismatch(setup):
    cfg, model, params, d = setup
    mgr = CheckpointManager(d)
    mgr.save(1, params, {})
    _, other_model = _model(n_layers=2)
    other = other_model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError):
        mgr.restore(1, other)


def test_elastic_reshard_flat():
    full = np.arange(100.0)
    # 4-way shards reassemble exactly into 2-way shards
    four = [reshard_flat(full, 4, r) for r in range(4)]
    two = [reshard_flat(full, 2, r) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(four), np.concatenate(two))
    # padded case
    odd = np.arange(7.0)
    shards = [reshard_flat(odd, 4, r) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(shards)[:7], odd)


def test_sweep_stale_crash_leftovers(setup):
    """A crash mid-write leaves step_<N>.tmp (or a manifest-less final
    dir); a fresh manager sweeps both."""
    cfg, model, params, d = setup
    CheckpointManager(d).save(3, params, {})
    os.makedirs(os.path.join(d, "step_5.tmp"))
    os.makedirs(os.path.join(d, "step_7"))  # no manifest.json inside
    mgr = CheckpointManager(d)
    assert mgr.completed_steps() == [3]
    assert not os.path.exists(os.path.join(d, "step_5.tmp"))
    assert not os.path.exists(os.path.join(d, "step_7"))


def test_background_save_error_surfaces_on_next_call(setup):
    """An async write failure is never swallowed: the NEXT save/wait
    raises CheckpointError carrying the FAILED step."""
    cfg, model, params, d = setup
    boom = [True]

    def hook(step):
        if boom[0]:
            boom[0] = False
            raise CheckpointIOError(f"injected at step {step}")

    mgr = CheckpointManager(d, io_hook=hook)
    mgr.save_async(4, params, {})
    with pytest.raises(CheckpointError) as ei:
        mgr.wait()
    assert ei.value.step == 4
    mgr.save(5, params, {})  # error consumed; manager still usable
    assert mgr.latest_step() == 5


def test_restore_falls_back_on_corrupt_newest(setup):
    """restore(None) skips a truncated newest checkpoint (with a warning)
    and restores the previous one; an explicit step never falls back."""
    cfg, model, params, d = setup
    mgr = CheckpointManager(d)
    mgr.save(1, params, {"tag": np.int32(1)}, {"data_cursor": 1})
    mgr.save(2, params, {"tag": np.int32(2)}, {"data_cursor": 2})
    with open(os.path.join(d, "step_2", "arrays.npz"), "wb") as f:
        f.write(b"not a zip file")  # truncation/corruption stand-in
    with pytest.warns(RuntimeWarning, match="step_2 is unreadable"):
        step, _, opt, man = mgr.restore(None, params)
    assert step == 1 and int(opt["tag"]) == 1 and man["data_cursor"] == 1
    with pytest.raises(Exception):
        mgr.restore(2, params)  # explicit step: surface the corruption


def test_restore_transient_io_fault_propagates_not_falls_back(setup):
    """A transient io_hook failure during restore is retryable: it must
    propagate, not silently fall back to an older step."""
    cfg, model, params, d = setup
    mgr = CheckpointManager(d)
    mgr.save(1, params, {})
    mgr.save(2, params, {})
    flaky = [True]

    def hook(step):
        if flaky[0]:
            flaky[0] = False
            raise CheckpointIOError("flaky mount")

    mgr.io_hook = hook
    with pytest.raises(CheckpointIOError):
        mgr.restore(None, params)
    step, _, _, _ = mgr.restore(None, params)  # the retry succeeds
    assert step == 2  # ...at the NEWEST step, not a fallback


def test_exact_resume_trajectory(tmp_path):
    """Train 6 steps; separately train 3, checkpoint, restore, train 3
    more: the same losses (exact resume, the restart drill's core)."""
    cfg, model = _model()
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    pipe = for_model(cfg, seq_len=8, global_batch=4)
    built = build_single(model, opt_cfg)

    def run(params, opt, lo, hi):
        losses = []
        for s in range(lo, hi):
            batch = {k: torch.from_numpy(v)
                     for k, v in pipe.batch_at(s).items()}
            params, opt, m = built.step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
        return params, opt, losses

    def fresh():
        return model.init(torch.Generator().manual_seed(1), "cpu")

    p0 = fresh()
    _, _, straight = run(p0, built.init_opt(p0), 0, 6)
    p1 = fresh()
    p1, o1, first = run(p1, built.init_opt(p1), 0, 3)
    mgr = CheckpointManager(str(tmp_path / "resume"))
    leaves = T.leaves(o1.m) + T.leaves(o1.v) + [np.int32(o1.step)]
    mgr.save(3, p1, {f"leaf_{i}": l for i, l in enumerate(leaves)},
             {"data_cursor": 3})
    step, p2, opt2, man = mgr.restore(None, fresh())
    n = len(T.leaves(p2))
    paths = [p for p, _ in T.flatten(p2)]
    o2 = type(o1)(
        m=T.unflatten(zip(paths, [torch.from_numpy(opt2[f"leaf_{i}"])
                                  for i in range(n)])),
        v=T.unflatten(zip(paths, [torch.from_numpy(opt2[f"leaf_{n + i}"])
                                  for i in range(n)])),
        step=int(opt2[f"leaf_{2 * n}"]))
    _, _, second = run(p2, o2, man["data_cursor"], 6)
    np.testing.assert_allclose(first + second, straight, rtol=1e-6)


# ---------------------------------------------------------------------------
# The on-disk layout against the reference manager's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shared_params():
    """qwen3-1.7b scaled down, the reference's init, as numpy."""
    model = ref_build(ref_config("qwen3-1.7b").scaled_down(), recipe=None)
    return jax.tree.map(np.asarray,
                        jax.jit(model.init)(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_matches_reference_manager(tmp_path, shared_params, dtype):
    cfg = get_config("qwen3-1.7b").scaled_down(dtype=dtype)
    port_params = params_from_numpy(shared_params, cfg)
    ref_params = jax.tree.map(
        lambda a, t: jnp.asarray(a, jnp.bfloat16 if t.dtype == torch.bfloat16
                                 else a.dtype),
        shared_params, port_params)
    opt = {"leaf_0": np.arange(12.0, dtype=np.float32).reshape(3, 4),
           "leaf_1": np.int32(5)}
    extra = {"data_cursor": 5, "world": 3, "arch": "qwen3-1.7b"}
    CheckpointManager(str(tmp_path / "port")).save(5, port_params, opt,
                                                   extra)
    RefManager(str(tmp_path / "ref")).save(5, ref_params, opt, extra)

    def read(which):
        d = tmp_path / which / "step_5"
        with open(d / "manifest.json") as f:
            man = json.load(f)
        z = np.load(d / "arrays.npz")
        return man, {k: z[k] for k in z.files}

    pman, parr = read("port")
    rman, rarr = read("ref")
    assert pman == rman
    assert sorted(parr) == sorted(rarr)
    assert any(k.startswith("p_") for k in parr)
    for k in rarr:
        assert parr[k].shape == rarr[k].shape, k
        assert parr[k].dtype == rarr[k].dtype, k
        assert parr[k].tobytes() == rarr[k].tobytes(), k

    # each manager reads the other's checkpoint back bitwise
    _, got, gopt, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        5, port_params)
    _equal_trees(got, port_params)
    np.testing.assert_array_equal(gopt["leaf_0"], opt["leaf_0"])
    if dtype == "float32":  # the reference cannot cast raw V2 bytes back
        _, rgot, _, _ = RefManager(str(tmp_path / "port")).restore(
            5, ref_params)
        for a, b in zip(jax.tree.leaves(rgot), jax.tree.leaves(ref_params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
