"""The port's ZeRO-1 grad-sync modes against the reference's: the
bucketed, pipelined sync and the baseline impls (the exact, int8 and
bfloat16 circulant runs: ``test_torch_zero1.py``, whose docstring gives
the tolerances' reasons; the two files share ``_torch_zero1_cases.py``).

The reference's other grad-sync modes are held the same way, each
against the reference's run of the same mode, with the tolerance of its
exact or int8 counterpart in ``test_torch_zero1.py``: the bucketed, pipelined sync
(``bucket_bytes``, buckets that split the larger leaves) exact and on
the int8 wire with error feedback, and the ``ring``, ``xla`` and
``allreduce`` impls.  Within the port, the bucketed exact sync is
bitwise the per-leaf one (the fold order of every element depends only
on its block index); on the int8 wire the quantization groups differ.
The config's refusals and every impl's specs are the reference's.
"""
import pytest
import torch

import _torch_zero1_cases as C
from repro_torch import tree as T
from repro_torch.optim.zero1 import (GradSyncConfig, init_zero1_state,
                                     is_zero_leaf, plan_grad_buckets)

#: the reference's runs this file reads (``_torch_zero1_ref.RUNS``)
RUNS = ("bucket_", "bucket_int8_", "ring_", "xla_", "allreduce_")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return C.reference(tmp_path_factory.mktemp("zero1_sync"), RUNS)


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


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("wire", [None, "int8"], ids=["f32", "int8"])
def test_bucketed_trajectory_matches_reference(reference, wire, fused):
    init, runs = reference["init"], reference
    sess, losses = C.train(init, "zero1", fused, wire=wire,
                          bucket_bytes=C.BUCKET)
    pre = "bucket_int8_" if wire else "bucket_"
    C.assert_run_matches(sess, losses, runs[pre],
                        atol=6e-6 if wire else 1e-9)
    buckets = plan_grad_buckets(C.zero_shapes(init, 3), 3, C.BUCKET)
    leaves = [[li for li, _, _ in b] for b in buckets]
    assert max(map(len, leaves)) > 1  # a bucket holds several leaves
    assert len({li for b in leaves for li in b}) < sum(map(len, leaves))
    # ceil(log2 3) = 2 exchanges per bucket's RS and AG, per step
    assert sess.comm.exchanges == C.STEPS * len(buckets) * 2 * 2
    if wire is None:  # bitwise the per-leaf sync, every rank
        one, one_losses = C.train(init, "zero1", fused)
        assert losses == one_losses
        for a, b in zip(sess.params, one.params):
            for x, y in zip(T.leaves(a), T.leaves(b)):
                assert torch.equal(x, y)


@pytest.mark.parametrize("impl", ["ring", "xla", "allreduce"])
def test_baseline_impl_trajectory_matches_reference(reference, impl):
    init, runs = reference["init"], reference
    sess, losses = C.train(init, "zero1", grad_sync=impl)
    C.assert_run_matches(sess, losses, runs[impl + "_"])
    n_zero = len(C.zero_shapes(init, 3))
    # ring: p - 1 = 2 rounds per RS and the circulant AG's 2; xla and
    # allreduce: native calls only
    want = C.STEPS * n_zero * (2 + 2) if impl == "ring" else 0
    assert sess.comm.exchanges == want
    assert sess.comm.natives > 0
    m = T.leaves(sess.opt[0].m)
    big = [a for a in T.leaves(init) if is_zero_leaf(a.shape, 3, 1024)][0]
    assert any(tuple(x.shape) == (big.shape if impl == "allreduce" else
                                  (-(-big.shape[0] // 3), *big.shape[1:]))
               for x in m)
