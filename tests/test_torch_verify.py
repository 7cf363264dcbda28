"""The port's static plan verifier against the reference's.

* every plan of the port's spec registry verifies clean at p in {2, 3,
  5, 8, 16}, and the registry equals the reference's spec for spec;
* each of the reference's six seeded corruptions (``tests/test_analysis.py``:
  dropped skip, swapped row-table entries, inflated non-uniform width,
  inflated alltoallv width, duplicated send, self-send), applied alike to
  the port's plan and the reference's, is flagged under the SAME set of
  rule names by both verifiers, and ``assert_verified`` raises;
* ``run_elastic_replan(p)`` returns the reference's dict;
* a corrupted plan planted in the plan cache makes ``build_zero1`` and
  ``run_broadcast`` refuse, and ``build_zero1`` verifies every plan it
  compiles;
* the CLI (``python -m repro_torch.analysis --verify``) reports OK.

Both verifiers run in process: plan verification needs no device.
"""
import dataclasses

import numpy as np
import pytest

from repro.analysis import verify as ref_verify
from repro.core import conformance as ref_conf
from repro.core.plan import plan as ref_plan
from repro.core.spec import CollectiveSpec as RefSpec
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import verify
from repro_torch.comm import LocalComm
from repro_torch.core import conformance
from repro_torch.core.plan import _PLAN_CACHE, plan
from repro_torch.core.spec import CollectiveSpec
from repro_torch.launch import bootstrap
from repro_torch.train.steps import build_zero1, collective_specs

PS = (2, 3, 5, 8, 16)
FIELDS = [f.name for f in dataclasses.fields(CollectiveSpec)]


def _key(spec):
    return tuple(getattr(spec, f) for f in FIELDS)


def _rules(findings):
    return {f.rule for f in findings}


@pytest.fixture()
def clean_cache():
    """Evict every cached plan before and after (planted mutants must not
    leak into other tests)."""
    plan.invalidate()
    yield
    plan.invalidate()


def test_run_is_clean():
    assert verify.run(PS) == []


@pytest.mark.parametrize("p", PS)
def test_registry_matches_reference_and_verifies(p):
    got, want = verify.registry_specs(p), ref_verify.registry_specs(p)
    assert [_key(s) for s in got] == [_key(s) for s in want]
    for spec in got:
        assert verify.verify(spec, p=p) == [], spec.label
        pl = plan(spec, p=p)
        assert verify.assert_verified(pl) is pl


# ---------------------------------------------------------------------------
# The reference's six mutants, applied alike to both packages' plans
# ---------------------------------------------------------------------------

def _dropped_skip(pl):
    return dataclasses.replace(
        pl, skips=pl.skips[:-1], rs_rounds=pl.rs_rounds[:-1],
        rs_send_blocks=pl.rs_send_blocks[:-1],
        rs_recv_blocks=pl.rs_recv_blocks[:-1],
        ag_rounds=pl.ag_rounds[1:], ag_send_blocks=pl.ag_send_blocks[1:],
        ag_recv_blocks=pl.ag_recv_blocks[1:])


def _swapped_rows(pl):
    tab = pl.rs_row_tables[0].copy()
    sent = pl.layout.total
    for c1 in range(tab.shape[1]):
        for c2 in range(tab.shape[1]):
            a, b = tab[0, c1], tab[1, c2]
            if a != sent and b != sent and a != b:
                tab[0, c1], tab[1, c2] = b, a
                return dataclasses.replace(
                    pl, rs_row_tables=(tab,) + pl.rs_row_tables[1:])
    raise AssertionError("no entries to swap")


def _inflated_width(pl):
    tab = pl.rs_row_tables[0]
    wide = np.concatenate(
        [tab, np.full((tab.shape[0], 1), pl.layout.total, tab.dtype)], axis=1)
    return dataclasses.replace(pl, rs_row_tables=(wide,)
                               + pl.rs_row_tables[1:])


def _inflated_a2a_width(pl):
    tab = pl.a2a.round_tables[0]
    wide = np.concatenate(
        [tab, np.full((tab.shape[0], 1), pl.a2a.total, tab.dtype)], axis=1)
    return dataclasses.replace(pl, a2a=dataclasses.replace(
        pl.a2a, round_tables=(wide,) + pl.a2a.round_tables[1:]))


def _duplicated_send(pl):
    win = list(pl.rs_send_blocks[0])
    dup = (win[0],) + tuple(win[:-1])  # repeat one block, drop one
    return dataclasses.replace(pl, rs_send_blocks=(dup,)
                               + pl.rs_send_blocks[1:])


def _self_send(pl):
    bad = dataclasses.replace(pl.rs_rounds[0], skip=0, lo=0)
    return dataclasses.replace(pl, skips=(0,) + pl.skips[1:],
                               rs_rounds=(bad,) + pl.rs_rounds[1:])


A2A_COUNTS = tuple(tuple((i + 2 * j + 1) % 3 for j in range(5))
                   for i in range(5))
#: name -> (spec kwargs, p, mutation, a rule the reference's test expects)
MUTANTS = {
    "dropped_skip": ({}, 8, _dropped_skip,
                     {"theorem1-partition", "round-count",
                      "schedule-invalid"}),
    "swapped_rows": (dict(counts=(3, 1, 6, 4, 2)), 5, _swapped_rows,
                     {"duplicate-contribution", "incomplete-reduction",
                      "duplicate-send"}),
    "inflated_width": (dict(counts=(3, 1, 6, 4, 2)), 5, _inflated_width,
                       {"width-bound"}),
    "inflated_a2a_width": (dict(counts=A2A_COUNTS), 5, _inflated_a2a_width,
                           {"width-bound"}),
    "duplicated_send": ({}, 8, _duplicated_send,
                        {"duplicate-send", "theorem1-partition",
                         "window-mismatch"}),
    "self_send": ({}, 8, _self_send, {"self-send", "schedule-invalid"}),
}


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_mutant_flags_the_reference_rules(name):
    kw, p, mutate, expected = MUTANTS[name]
    got = verify.verify_plan(mutate(plan(CollectiveSpec(**kw), p=p)))
    want = ref_verify.verify_plan(mutate(ref_plan(RefSpec(**kw), p=p,
                                                  axis_name="x")))
    assert got and _rules(got) == _rules(want), (_rules(got), _rules(want))
    assert _rules(got) & expected
    assert [f.where for f in got] == [f.where for f in want]
    with pytest.raises(AssertionError):
        verify.assert_verified(mutate(plan(CollectiveSpec(**kw), p=p)))


@pytest.mark.parametrize("p", (2, 3, 5, 8))
def test_elastic_replan_matches_reference(p):
    assert conformance.run_elastic_replan(p) == ref_conf.run_elastic_replan(p)


# ---------------------------------------------------------------------------
# The pre-flight: build_zero1 and run_broadcast refuse a corrupted plan
# ---------------------------------------------------------------------------

def _zero1_model(**kw):
    sess = bootstrap.build_session(arch="qwen3-1.7b", scale_down=True,
                                   steps=1, seq_len=8, global_batch=3, dp=3,
                                   mode="zero1", device="cpu",
                                   init_state=False, **kw)
    return sess.model, sess.opt_cfg, sess.sync


@pytest.mark.parametrize("wire", [None, "int8"])
def test_build_zero1_verifies_every_plan(clean_cache, wire):
    model, opt_cfg, sync = _zero1_model(wire_dtype=wire)
    before = verify.assert_verified.calls
    build_zero1(model, LocalComm(3), opt_cfg, sync, "cpu")
    assert verify.assert_verified.calls - before == len(
        collective_specs(sync, model.cfg))


@pytest.mark.parametrize("role", ["rs", "ag"])
def test_build_zero1_refuses_corrupted_plan(clean_cache, role):
    model, opt_cfg, sync = _zero1_model(wire_dtype="int8")
    spec = sync.rs_spec() if role == "rs" else sync.ag_spec()
    _PLAN_CACHE._data[(spec, 3)] = _dropped_skip(plan(spec, p=3))
    with pytest.raises(AssertionError, match="static verification"):
        build_zero1(model, LocalComm(3), opt_cfg, sync, "cpu")


def test_build_zero1_refuses_corrupted_bucket_partition(monkeypatch):
    from repro_torch.train import steps
    model, opt_cfg, sync = _zero1_model(bucket_bytes=30_000)
    build_zero1(model, LocalComm(3), opt_cfg, sync, "cpu")  # clean
    good = steps.plan_grad_buckets
    monkeypatch.setattr(steps, "plan_grad_buckets",
                        lambda *a: good(*a)[:-1])  # a leaf's rows missing
    with pytest.raises(ValueError, match="bucket partition covers"):
        build_zero1(model, LocalComm(3), opt_cfg, sync, "cpu")
    monkeypatch.setattr(steps, "plan_grad_buckets",
                        lambda *a: good(*a) + [[]])
    with pytest.raises(ValueError, match="empty bucket"):
        build_zero1(model, LocalComm(3), opt_cfg, sync, "cpu")


@pytest.mark.parametrize("p", (3, 8))
def test_run_broadcast_refuses_corrupted_plan(clean_cache, p):
    spec = CollectiveSpec(kind="broadcast", schedule="halving")
    _PLAN_CACHE._data[(spec, p)] = _dropped_skip(plan(spec, p=p))
    with pytest.raises(AssertionError, match="static verification"):
        conformance.run_broadcast(p, device="cpu")


def test_build_zero1_verifies_ep_plans(clean_cache):
    sess = bootstrap.build_session(
        arch="phi3.5-moe-42b-a6.6b", scale_down=True, steps=1, seq_len=8,
        global_batch=2, dp=2, mp=2, mode="zero1", moe_dispatch="ep",
        device="cpu", init_state=False)
    specs = collective_specs(sess.sync, sess.cfg, 2)
    assert [r for r, _ in specs] == ["data", "data", "ep", "ep"]
    before = verify.assert_verified.calls
    build_zero1(sess.model, sess.comm, sess.opt_cfg, sess.sync, "cpu",
                ep_world=2)
    assert verify.assert_verified.calls - before == 4
    a2a = specs[3][1]
    _PLAN_CACHE._data[(a2a, 2)] = _inflated_a2a_width(plan(a2a, p=2))
    with pytest.raises(AssertionError, match="width-bound"):
        build_zero1(sess.model, sess.comm, sess.opt_cfg, sess.sync, "cpu",
                    ep_world=2)


def test_cli_reports_ok(capsys, tmp_path):
    out = tmp_path / "report.json"
    assert cli.main(["--verify", "--p", "2,3,5", "--json", str(out)]) == 0
    assert "findings=0 OK" in capsys.readouterr().out
    assert '"ok": true' in out.read_text()
