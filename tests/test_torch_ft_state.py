"""The ZeRO-1 state across a world resize, against the reference's:

* ``resize_zero1_state`` is bitwise the reference's on the same numpy
  global state, p -> p' for (4, 3), (3, 4), (2, 5), (5, 2), without and
  with EF residuals, and p -> p' -> p is lossless (EF: mass conserved);
* ``ft.active_specs`` are the data role's specs of the step;
* the launcher's restart drill (``--ckpt-dir --ckpt-every
  --fail-at-step``) resumes on the uninterrupted run's trajectory.

(The controller's scenarios: ``test_torch_ft.py``; the drills:
``test_torch_ft_drill.py``.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim.zero1 as ref_zero1
import repro_torch.ft as port_ft
import repro_torch.optim.zero1 as port_zero1
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train

REF, PORT = "ref", "port"


def test_active_specs_are_the_data_role_specs():
    from repro_torch.train.steps import collective_specs
    sync = port_zero1.GradSyncConfig()
    assert set(port_ft.active_specs(sync)) == {
        sp for role, sp in collective_specs(sync) if role == "data"}


# ---------------------------------------------------------------------------
# resize_zero1_state: bitwise the reference's on the same global state
# ---------------------------------------------------------------------------

SHAPES = {"big": (10, 128), "tiny": (4,), "scalar": ()}


def _global_state(world, with_ef, min_numel=1024):
    """A synthetic GLOBAL state at ``world`` as numpy trees: zero leaves
    padded to the world multiple with zero rows, EF one row per rank."""
    rng = np.random.default_rng(world)

    def mv(shape):
        arr = rng.normal(size=shape).astype(np.float32)
        if port_zero1.is_zero_leaf(shape, world, min_numel):
            pad = (-shape[0]) % world
            arr = np.concatenate([arr, np.zeros((pad, *shape[1:]),
                                                np.float32)])
        return arr

    m = {k: mv(s) for k, s in SHAPES.items()}
    v = {k: mv(s) for k, s in SHAPES.items()}
    ef = None
    if with_ef:
        ef = {k: rng.normal(size=(world if port_zero1.is_zero_leaf(
            s, world, min_numel) else 1, *s)).astype(np.float32)
            for k, s in SHAPES.items()}
    return m, v, ef


def _resize(pkg, m, v, ef, world, sync_kw):
    zero1 = ref_zero1 if pkg is REF else port_zero1
    sync = zero1.GradSyncConfig(**sync_kw)
    if pkg is REF:
        params = {k: jnp.zeros(s) for k, s in SHAPES.items()}
        state = ref_zero1.Zero1State(
            m={k: jnp.asarray(a) for k, a in m.items()},
            v={k: jnp.asarray(a) for k, a in v.items()},
            step=jnp.asarray(7, jnp.int32),
            ef=None if ef is None else {k: jnp.asarray(a)
                                        for k, a in ef.items()})
    else:
        params = {k: torch.zeros(s) for k, s in SHAPES.items()}
        state = port_zero1.Zero1State(m=m, v=v, step=7, ef=ef)
    out = zero1.resize_zero1_state(state, params, world, sync)
    conv = lambda t: None if t is None else {  # noqa: E731
        k: np.asarray(a) for k, a in t.items()}
    return conv(out.m), conv(out.v), conv(out.ef), int(out.step)


def _same(a, b):
    assert (a is None) == (b is None)
    for k in a or {}:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("ef", [False, True], ids=["f32", "ef"])
@pytest.mark.parametrize("p,p2", [(4, 3), (3, 4), (2, 5), (5, 2)])
def test_resize_matches_reference_and_round_trips(p, p2, ef):
    sync_kw = dict(wire_dtype="int8") if ef else {}
    m, v, e = _global_state(p, ef)
    got = _resize(PORT, m, v, e, p2, sync_kw)
    want = _resize(REF, m, v, e, p2, sync_kw)
    for a, b in zip(got[:3], want[:3]):
        _same(a, b)
    assert got[3] == want[3] == 7
    assert got[0]["big"].shape[0] % p2 == 0
    back = _resize(PORT, *got[:3], p, sync_kw)
    _same(back[0], m)
    _same(back[1], v)
    if ef:
        for k in e:  # mass conserved into row 0, at p' and back at p
            np.testing.assert_array_equal(got[2][k].sum(0), e[k].sum(0))
            np.testing.assert_array_equal(got[2][k][1:], 0.0)
            np.testing.assert_array_equal(back[2][k].sum(0), e[k].sum(0))


def test_resize_refuses_to_drop_ef_mass():
    m, v, e = _global_state(4, True)
    with pytest.raises(ValueError):
        _resize(PORT, m, v, e, 2, {})


# ---------------------------------------------------------------------------
# The launcher's restart drill
# ---------------------------------------------------------------------------

def test_launcher_restart_drill(tmp_path):
    argv = ["--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
            "--mesh", "3x1", "--mode", "zero1", "--steps", "6",
            "--seq-len", "16", "--global-batch", "3", "--wire-dtype", "int8"]
    straight = train.main(argv)
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    with pytest.raises(port_ft.SimulatedFailure):
        train.main(argv + ck + ["--fail-at-step", "5"])
    assert CheckpointManager(str(tmp_path / "ck")).completed_steps() == [
        2, 4]
    tail = train.main(argv + ck)
    assert tail.first_step == 4 and len(tail.losses) == 2
    assert tail.losses == straight.losses[4:]
