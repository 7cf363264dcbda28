"""The port's ZeRO-1 training against the reference's.

The reference's ``zero1_step`` is driven directly under
``repro.compat.shard_map`` on 3 fake CPU devices (subprocess worker
``_torch_zero1_ref.py``); its initial weights are carried into the port
with ``repro_torch.convert``, and the port trains the same 4 steps at
p = 3 on a ``LocalComm``, with the fused round on (its plain version on
the CPU) and off.

Tolerances: per-step losses within 1e-5 absolute and parameters after
step 4 within ``rtol=1e-5``.  The reduce-scatter folds are bitwise equal
to the reference's (``test_torch_collectives.py``), but the gradients
come from different float32 matmul and reduction orders (CPU torch vs
XLA), tiny leaves go through an all-reduce whose summation order the
reference does not pin, and AdamW divides by ``sqrt(v)``.  ``atol=1e-9``
covers the few parameters that sit within ~1e-5 of zero, where an
update's last-bit difference is a large relative one (observed: 1 of
8192 elements, 1.7e-10 apart).

The int8 wire with error feedback (``wire_dtype="int8"``) is held the
same way against the reference's int8 run: losses within 1e-5, params
within ``rtol=1e-5`` and ``atol=6e-6``.  Beyond the float32 sources of
difference above, the reference's jitted reduce-scatter contracts each
round's ``live + q * s`` into one FMA (``test_torch_collectives.py``),
and every gradient is quantized, so an ulp-level difference can move an
int8 code by a step.  AdamW's early updates are about ``lr * sign(g)``,
so ``atol`` is a tenth of the last step's learning rate (6e-5): small
enough that a code that moved a step and flipped an update would fail
(observed: 8 of the 90,496 parameters beyond ``rtol``, at most 8.5e-7
apart).  Within the port, the int8+EF losses stay within 0.05 of the
exact run's, the reference's own gate (``tests/_zero1_checks.py``).

A bfloat16 reduce-scatter payload (``rs_dtype="bfloat16"``, exact sync)
is held against the reference's run with it: losses within 1e-5,
params within ``rtol=1e-5`` and ``atol=1e-6``.  Rounding each gradient
to bfloat16 turns a last-bit float32 difference into a whole bfloat16
step (2**-8 relative) where it moves the rounding, so more parameters
leave ``rtol`` than in the exact run; ``atol`` is a sixtieth of the last
step's learning rate, below any flipped update (observed: 2,763 of the
90,496 parameters beyond ``rtol``, at most 3.0e-7 apart).

The reference's other grad-sync modes are held the same way, each
against the reference's run of the same mode, with the tolerance of its
exact or int8 counterpart above: the bucketed, pipelined sync
(``bucket_bytes``, buckets that split the larger leaves) exact and on
the int8 wire with error feedback, and the ``ring``, ``xla`` and
``allreduce`` impls.  Within the port, the bucketed exact sync is
bitwise the per-leaf one (the fold order of every element depends only
on its block index); on the int8 wire the quantization groups differ.
``plan_grad_buckets`` is the reference's, on the model's shapes and on
its edge cases.

The exact sync is also held at p = 2 and p = 4 (global batch p).  At
p = 5 (not tested here) a scratch run of this recipe found one element
of the 90,496 outside ``rtol=1e-5``: ``layers.attn.wq``, 1.83e-7 apart
at a value of 0.007, 2.55x the bound, appearing after step 0 and not
growing.  That is 1.2 % of step 0's learning rate (1.5e-5), which
would fit AdamW's first step amplifying a gradient near ``eps``; the
cause is not confirmed.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.comm import LocalComm
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels.quantize import MAX_GROUP
from repro_torch.launch import bootstrap
from repro_torch.optim.zero1 import (GradSyncConfig, ef_quantize,
                                     init_zero1_state, is_zero_leaf,
                                     local_rows, plan_grad_buckets)
from repro_torch.train.steps import build_zero1

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 4


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero1") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable,
                           os.path.join(HERE, "_torch_zero1_ref.py"), str(out)],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    z = np.load(out)

    def tree(prefix):
        return T.unflatten((tuple(k[len(prefix):].split("/")), z[k])
                           for k in z.files if k.startswith(prefix))

    runs = {pre: (z[pre + "losses"], tree(pre + "final/"))
            for pre in ("bucket_", "bucket_int8_", "ring_", "xla_",
                        "allreduce_", "p2_", "p4_")}
    return (tree("init/"), z["losses"], tree("final/"), z["int8_losses"],
            tree("int8_final/"), z["bf16_losses"], tree("bf16_final/"), runs)


#: bucket size of the bucketed runs (= _torch_zero1_ref.BUCKET).
BUCKET = 30_000


def _train(init, mode, fused=None, wire=None, rs_dtype="float32", dp=None,
           arch="qwen3-1.7b", steps=STEPS, **kw):
    dp = dp or (3 if mode == "zero1" else 1)
    sess = bootstrap.build_session(
        arch=arch, scale_down=True, steps=steps, seq_len=16,
        global_batch=dp if mode == "zero1" else 3, dp=dp, mode=mode,
        use_fused_kernel=fused, wire_dtype=wire, device="cpu",
        init_state=False, **kw)
    if rs_dtype != sess.sync.rs_dtype:  # no launcher flag sets it
        sess.sync = dataclasses.replace(sess.sync, rs_dtype=rs_dtype)
        sess.built = build_zero1(sess.model, sess.comm, sess.opt_cfg,
                                 sess.sync, sess.device)
    params = params_from_numpy(init, sess.cfg)
    sess.params = ([params] + [T.map_leaves(torch.clone, params)
                               for _ in range(dp - 1)]
                   if mode == "zero1" else params)
    sess.opt = sess.built.init_opt(sess.params)
    losses = [float(bootstrap.run_step(sess, s)["loss"])
              for s in range(steps)]
    return sess, losses


def _assert_params_close(got: dict, want: dict, atol: float = 1e-9):
    assert [p for p, _ in T.flatten(got)] == [p for p, _ in T.flatten(want)]
    for (path, a), (_, b) in zip(T.flatten(got), T.flatten(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol,
                                   err_msg=".".join(map(str, path)))


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_zero1_trajectory_matches_reference(reference, fused):
    init, ref_losses, ref_final = reference[:3]
    sess, losses = _train(init, "zero1", fused)
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    finals = [params_to_numpy(p) for p in sess.params]
    for final in finals:
        _assert_params_close(final, ref_final)
    for final in finals[1:]:  # the allgather replicates bitwise
        for a, b in zip(T.leaves(final), T.leaves(finals[0])):
            np.testing.assert_array_equal(a, b)
    # ceil(log2 3) = 2 exchanges per RS and per AG, per zero leaf per step
    n_zero = sum(is_zero_leaf(a.shape, 3, 1024) for a in T.leaves(init))
    assert sess.comm.exchanges == STEPS * n_zero * 2 * 2


def test_zero1_equals_single(reference):
    """Within the port, ZeRO-1 at p = 3 trains like one rank on the whole
    batch (same tolerance: only summation orders differ)."""
    init = reference[0]
    z1, z_losses = _train(init, "zero1", False)
    single, s_losses = _train(init, "single")
    np.testing.assert_allclose(z_losses, s_losses, rtol=0, atol=1e-5)
    _assert_params_close(params_to_numpy(z1.params[0]),
                         params_to_numpy(single.params))


def test_zero1_state_is_sharded():
    sync = GradSyncConfig()
    params = {"big": torch.zeros(28, 64), "tiny": torch.zeros(5)}
    st = init_zero1_state(params, 3, sync)
    assert tuple(st.m["big"].shape) == (10, 64)   # ceil(28 / 3) rows
    assert tuple(st.m["tiny"].shape) == (5,)
    x = torch.arange(28.0)[:, None]
    shards = [local_rows(x, r, 3) for r in range(3)]
    assert torch.equal(torch.cat(shards)[:28], x)
    assert torch.equal(shards[2][8:], torch.zeros(2, 1))  # padding rows


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_zero1_int8_ef_trajectory_matches_reference(reference, fused):
    init, f32_losses, _, ref_losses, ref_final = reference[:5]
    sess, losses = _train(init, "zero1", fused, wire="int8")
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    assert np.abs(np.asarray(losses) - f32_losses).max() < 0.05
    finals = [params_to_numpy(p) for p in sess.params]
    for final in finals:
        _assert_params_close(final, ref_final, atol=6e-6)
    for final in finals[1:]:
        for a, b in zip(T.leaves(final), T.leaves(finals[0])):
            np.testing.assert_array_equal(a, b)
    # the EF state is real: per rank, full-leaf for zero leaves, non-zero
    n_zero = 0
    for opt in sess.opt:
        for (path, e), (_, p) in zip(T.flatten(opt.ef), T.flatten(init)):
            assert tuple(e.shape) == p.shape
            if is_zero_leaf(p.shape, 3, 1024):
                n_zero += 1
                assert float(e.abs().max()) > 0, path
    assert sess.comm.exchanges == STEPS * (n_zero // 3) * 2 * 2
    _, losses_f32 = _train(init, "zero1", fused)
    assert np.abs(np.asarray(losses) - np.asarray(losses_f32)).max() < 0.05


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_zero1_bf16_rs_trajectory_matches_reference(reference, fused):
    """``rs_dtype="bfloat16"``: each gradient is rounded to bfloat16 before
    the exact reduce-scatter, folded in bfloat16 and averaged there, as
    the reference's run does."""
    init, ref_losses, ref_final = reference[0], *reference[5:7]
    sess, losses = _train(init, "zero1", fused, rs_dtype="bfloat16")
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    finals = [params_to_numpy(p) for p in sess.params]
    for final in finals:
        _assert_params_close(final, ref_final, atol=1e-6)
    for final in finals[1:]:
        for a, b in zip(T.leaves(final), T.leaves(finals[0])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw,err", [
    (dict(wire_dtype="int8", rs_dtype="bfloat16"), ValueError),
    (dict(rs_dtype="float16"), ValueError),
    (dict(impl="xla"), None),
    (dict(impl="allreduce"), None),
    (dict(bucket_bytes=0), ValueError),
    (dict(impl="ring"), None),
    (dict(impl="ring", bucket_bytes=1 << 20), ValueError),
    (dict(bucket_bytes=1 << 20), None)])
def test_unported_sync_fields_raise(kw, err):
    """The config's refusals, and for every impl and ``bucket_bytes``
    the reference's behaviour: its specs, its error-feedback rule, and
    its ``ValueError`` for ``bucket_bytes <= 0`` or with an impl other
    than circulant.  (The impls and ``bucket_bytes`` raised
    ``NotImplementedError`` before they were ported.)"""
    from repro.optim.zero1 import GradSyncConfig as RefConfig
    if err is not None:
        with pytest.raises(err) as mine:
            GradSyncConfig(**kw)
        if "rs_dtype" not in kw:  # the reference does not check rs_dtype
            with pytest.raises(err) as ref:
                RefConfig(**kw)
            assert str(mine.value) == str(ref.value)
        return
    mine, ref = GradSyncConfig(**kw), RefConfig(**kw)
    fields = ("kind", "schedule", "op", "wire_dtype", "wire_group",
              "use_fused_kernel", "counts")
    for a, b in ((mine.rs_spec(), ref.rs_spec()),
                 (mine.ag_spec(), ref.ag_spec())):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
    assert mine.uses_error_feedback == ref.uses_error_feedback
    wired = dict(kw, wire_dtype="int8")
    assert GradSyncConfig(**wired).uses_error_feedback == \
        RefConfig(**wired).uses_error_feedback
    params = {"big": torch.zeros(28, 64), "tiny": torch.zeros(5)}
    st = init_zero1_state(params, 3, GradSyncConfig(**kw))
    full = kw.get("impl") == "allreduce"  # no ZeRO: full moments
    assert tuple(st.m["big"].shape) == ((28, 64) if full else (10, 64))


def _assert_run_matches(sess, losses, ref, atol=1e-9):
    ref_losses, ref_final = ref
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    finals = [params_to_numpy(p) for p in sess.params]
    for final in finals:
        _assert_params_close(final, ref_final, atol=atol)
    for final in finals[1:]:  # the allgather replicates bitwise
        for a, b in zip(T.leaves(final), T.leaves(finals[0])):
            np.testing.assert_array_equal(a, b)


def _zero_shapes(init, world):
    return [a.shape for a in T.leaves(init)
            if is_zero_leaf(a.shape, world, 1024)]


def test_plan_grad_buckets_equal_reference(reference):
    from repro.optim.zero1 import plan_grad_buckets as ref_buckets
    init = reference[0]
    cases = [(_zero_shapes(init, w), w, b, i)
             for w in (2, 3, 4) for b in (1, 4096, BUCKET, 1 << 30)
             for i in (2, 4)]
    cases += [
        ([(10, 4), (3, 4)], 3, 192, 4),  # exact fit: 4 rows x 48 B
        ([(1000,)], 2, 400, 4),         # leaf larger than a bucket: split
        ([(6, 100)], 3, 100, 4),        # row (1200 B) larger than a bucket
        ([(3, 5), (7, 2), (2, 9)], 3, 60, 4)]  # leaves sharing buckets
    for shapes, world, bb, itemsize in cases:
        mine = plan_grad_buckets(shapes, world, bb, itemsize)
        assert mine == ref_buckets(shapes, world, bb, itemsize), \
            (shapes, world, bb)
        for li, shape in enumerate(shapes):  # each leaf covered once
            segs = [(lo, hi) for b in mine for l2, lo, hi in b if l2 == li]
            rows = -(-shape[0] // world)
            assert segs[0][0] == 0 and segs[-1][1] == rows
            assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert plan_grad_buckets([(10, 4), (3, 4)], 3, 192, 4) == \
        [[(0, 0, 4)], [(1, 0, 1)]]  # a full bucket closes at once
    with pytest.raises(ValueError, match="positive"):
        plan_grad_buckets([(10, 4)], 3, 0)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("wire", [None, "int8"], ids=["f32", "int8"])
def test_bucketed_trajectory_matches_reference(reference, wire, fused):
    init, runs = reference[0], reference[7]
    sess, losses = _train(init, "zero1", fused, wire=wire,
                          bucket_bytes=BUCKET)
    pre = "bucket_int8_" if wire else "bucket_"
    _assert_run_matches(sess, losses, runs[pre],
                        atol=6e-6 if wire else 1e-9)
    buckets = plan_grad_buckets(_zero_shapes(init, 3), 3, BUCKET)
    leaves = [[li for li, _, _ in b] for b in buckets]
    assert max(map(len, leaves)) > 1  # a bucket holds several leaves
    assert len({li for b in leaves for li in b}) < sum(map(len, leaves))
    # ceil(log2 3) = 2 exchanges per bucket's RS and AG, per step
    assert sess.comm.exchanges == STEPS * len(buckets) * 2 * 2
    if wire is None:  # bitwise the per-leaf sync, every rank
        one, one_losses = _train(init, "zero1", fused)
        assert losses == one_losses
        for a, b in zip(sess.params, one.params):
            for x, y in zip(T.leaves(a), T.leaves(b)):
                assert torch.equal(x, y)


@pytest.mark.parametrize("impl", ["ring", "xla", "allreduce"])
def test_baseline_impl_trajectory_matches_reference(reference, impl):
    init, runs = reference[0], reference[7]
    sess, losses = _train(init, "zero1", grad_sync=impl)
    _assert_run_matches(sess, losses, runs[impl + "_"])
    n_zero = len(_zero_shapes(init, 3))
    # ring: p - 1 = 2 rounds per RS and the circulant AG's 2; xla and
    # allreduce: native calls only
    want = STEPS * n_zero * (2 + 2) if impl == "ring" else 0
    assert sess.comm.exchanges == want
    assert sess.comm.natives > 0
    m = T.leaves(sess.opt[0].m)
    big = [a for a in T.leaves(init) if is_zero_leaf(a.shape, 3, 1024)][0]
    assert any(tuple(x.shape) == (big.shape if impl == "allreduce" else
                                  (-(-big.shape[0] // 3), *big.shape[1:]))
               for x in m)


@pytest.mark.parametrize("p", [2, 4])
def test_zero1_trajectory_other_worlds(reference, p):
    """The exact sync at p = 2 and 4, global batch p (see the module
    docstring for p = 5)."""
    init, runs = reference[0], reference[7]
    sess, losses = _train(init, "zero1", dp=p)
    _assert_run_matches(sess, losses, runs[f"p{p}_"])


def test_wire_sync_config():
    sync = GradSyncConfig(wire_dtype="int8", quant_group=64)
    assert sync.wire == "int8" and sync.uses_error_feedback
    assert sync.rs_spec().wired and sync.rs_spec().wire_group == 64
    assert not sync.ag_spec().wired       # parameters reassemble exactly
    assert not GradSyncConfig(wire_dtype="int8",
                              error_feedback=False).uses_error_feedback
    assert not GradSyncConfig().uses_error_feedback
    with pytest.warns(DeprecationWarning):
        legacy = GradSyncConfig(compress="int8")
    assert legacy.wire == "int8" and legacy.rs_spec().wired
    params = {"big": torch.zeros(28, 64), "tiny": torch.zeros(5)}
    st = init_zero1_state(params, 3, sync)
    assert tuple(st.ef["big"].shape) == (28, 64)   # one full leaf per rank
    assert tuple(st.ef["tiny"].shape) == (5,)      # dummy, never read
    assert init_zero1_state(params, 3, GradSyncConfig()).ef is None
    g, res = torch.randn(28, 64), torch.randn(28, 64) * 1e-3
    q, err = ef_quantize(g, res, 64)
    assert torch.equal(q + err, g + res)           # the error is carried


def test_oversized_wire_group_fails_at_build_time():
    """The card kernels take groups of at most ``MAX_GROUP``: a larger
    ``quant_group`` is refused when the step is built for a card (or the
    kernels are asked for explicitly), not at the first launch."""
    sess = bootstrap.build_session(
        arch="qwen3-1.7b", scale_down=True, dp=3, global_batch=3,
        wire_dtype="int8", device="cpu", init_state=False)
    big = GradSyncConfig(wire_dtype="int8", quant_group=MAX_GROUP + 1)
    build_zero1(sess.model, sess.comm, sess.opt_cfg, big, "cpu")  # plain
    with pytest.raises(ValueError, match="wire_group"):
        build_zero1(sess.model, sess.comm, sess.opt_cfg, big, "cuda")
    fused = dataclasses.replace(big, use_fused_kernel=True)
    with pytest.raises(ValueError, match="wire_group"):
        build_zero1(sess.model, sess.comm, sess.opt_cfg, fused, "cpu")
    ok = dataclasses.replace(big, quant_group=MAX_GROUP)
    build_zero1(sess.model, sess.comm, sess.opt_cfg, ok, "cuda")


def test_a_step_leaves_no_reference_cycles():
    """A step's old parameters, moments and residuals are freed as soon as
    they are replaced, without waiting for the cyclic collector (which
    runs by object counts, not device memory): flattening a tree must not
    build a reference cycle, and the step must hold no old leaf."""
    import gc
    import weakref
    x = torch.ones(3)
    T.flatten({"a": {"b": x}})
    ref = weakref.ref(x)
    del x
    assert ref() is None
    sess = bootstrap.build_session(
        arch="qwen3-1.7b", scale_down=True, steps=2, seq_len=16,
        global_batch=2, dp=2, wire_dtype="int8", device="cpu")
    bootstrap.run_step(sess, 0)  # first calls import lazily inside torch
    gc.collect()
    zero = [is_zero_leaf(tuple(p.shape), 2, 1024)
            for p in T.leaves(sess.params[0])]
    old = [weakref.ref(t) for tree in (sess.params[0], sess.opt[0].m,
                                       sess.opt[0].v, sess.opt[0].ef)
           for t, z in zip(T.leaves(tree), zero)
           if z or tree is not sess.opt[0].ef]  # tiny leaves' EF: a dummy
    gc.disable()
    try:
        bootstrap.run_step(sess, 1)
        assert all(r() is None for r in old)
    finally:
        gc.enable()


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        bootstrap.build_session(arch="qwen3-1.7b", scale_down=True, dp=3,
                                global_batch=3, device="cuda")
    assert LocalComm(3).p == 3
