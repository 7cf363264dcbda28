"""The port's simulator and α-β-γ cost model against the reference's.

``repro.core.simulator`` and ``repro.core.cost_model`` import no JAX
themselves; the port keeps its own copies (``repro_torch.core``).  Same
seeded numpy inputs through both: the RS / AG / AR simulators' outputs
and ``CommStats`` (rounds, blocks, reductions, the send trace), the
one-shot ``ref_*`` oracles, ``nonuniform_round_widths`` and every
``t_*`` formula must be EXACTLY equal, for the five schedules and
p ≤ 64, on uniform and ragged block columns.  The reference's
simulators take no ``group``, so the ``two_level`` schedule is compared
with the reference's schedule functions bound to the group.
"""
import numpy as np
import pytest

import repro.core.cost_model as RCM
import repro.core.schedule as RS
import repro.core.simulator as RSIM
from repro_torch.core import cost_model as CM
from repro_torch.core import simulator as SIM
from repro_torch.core.conformance import two_level_group

SCHEDULES = ("halving", "power2", "fully_connected", "sqrt", "two_level")
PS = tuple(range(1, 65))
OPS = (np.add, np.maximum, np.minimum)


def _columns(p: int, rng, ragged: bool, dtype):
    """inputs[r][i]: rank r's block for column i; ragged columns differ
    in size (zero-row columns included), equal across ranks."""
    sizes = (rng.integers(0, 4, p) if ragged else np.full(p, 2))
    if dtype == np.int32:
        return [[rng.integers(-99, 99, (int(n), 2)).astype(np.int32)
                 for n in sizes] for _ in range(p)]
    return [[rng.standard_normal((int(n), 2)).astype(np.float32)
             for n in sizes] for _ in range(p)]


def _stats_equal(a, b):
    assert (a.rounds, a.blocks_sent, a.blocks_recv, a.reductions,
            a.send_events) == (b.rounds, b.blocks_sent, b.blocks_recv,
                               b.reductions, b.send_events)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _same(x, y)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.fixture
def ref_sim(monkeypatch):
    """The reference simulator, with ``two_level`` bound to ``group``."""
    def bind(p, schedule):
        if schedule == "two_level":
            g = two_level_group(p)
            monkeypatch.setattr(RSIM, "reduce_scatter_plan",
                                lambda p, s: RS.reduce_scatter_plan(p, s, g))
            monkeypatch.setattr(RSIM, "allgather_plan",
                                lambda p, s: RS.allgather_plan(p, s, g))
            return g
        monkeypatch.setattr(RSIM, "reduce_scatter_plan",
                            RS.reduce_scatter_plan)
        monkeypatch.setattr(RSIM, "allgather_plan", RS.allgather_plan)
        return None
    return bind


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_simulators_equal_reference(ref_sim, schedule, ragged):
    rng = np.random.default_rng(64 + len(schedule) + ragged)
    for p in PS:
        group = ref_sim(p, schedule)
        dtype = np.int32 if p % 3 == 0 else np.float32
        inputs = _columns(p, rng, ragged, dtype)
        op = OPS[p % 3]
        W, st = SIM.simulate_reduce_scatter(inputs, op, schedule, group)
        Wr, str_ = RSIM.simulate_reduce_scatter(inputs, op, schedule)
        _same(W, Wr)
        _stats_equal(st, str_)
        _same(SIM.ref_reduce_scatter(inputs, op),
              RSIM.ref_reduce_scatter(inputs, op))
        _same(SIM.ref_allreduce(inputs, op), RSIM.ref_allreduce(inputs, op))
        A, sa = SIM.simulate_allreduce(inputs, op, schedule, group)
        Ar, sar = RSIM.simulate_allreduce(inputs, op, schedule)
        _same(A, Ar)
        _stats_equal(sa, sar)
        G, sg = SIM.simulate_allgather(W, schedule, group)
        Gr, sgr = RSIM.simulate_allgather(Wr, schedule)
        _same(G, Gr)
        _stats_equal(sg, sgr)
        q = len(RS.get_skips(p, schedule, group=group))
        assert (st.rounds, sa.rounds) == (q, 2 * q)
        assert st.blocks_sent == [p - 1] * p
        if schedule in ("halving", "power2"):
            st.assert_theorem1(p)
            sa.assert_theorem2(p)


def test_simulator_refuses_like_reference():
    good = [[np.zeros(2)] * 2, [np.zeros(2)] * 2]
    for bad in ([[np.zeros(2)], [np.zeros(2)] * 2],          # block count
                [[np.zeros(2), np.zeros(3)], [np.zeros(3), np.zeros(3)]]):
        for mod in (SIM, RSIM):
            with pytest.raises(ValueError):
                mod.simulate_reduce_scatter(bad)
    for mod in (SIM, RSIM):
        with pytest.raises(ValueError):                       # needs group
            mod.simulate_reduce_scatter(good, schedule="two_level")
    for mod in (CM, RCM):  # the t_* formulas take no group either
        with pytest.raises(ValueError):
            mod.t_reduce_scatter(1.0, 4, mod.CommModel(1, 1, 1), "two_level")


def _models():
    return [(CM.CommModel(*a), RCM.CommModel(*a)) for a in
            ((1e-6, 4e-11, 7.3e-12), (2.5e-5, 1e-9, 0.0), (0.0, 3e-12, 1e-12),
             (1e-6, 4e-11, 7.3e-12, 2.0))] + [
        (CM.CommModel.tpu_v5e(), RCM.CommModel.tpu_v5e())]


@pytest.mark.parametrize("schedule", SCHEDULES[:4])
def test_cost_model_equals_reference(schedule):
    for mine, ref in _models():
        assert (mine.alpha, mine.beta, mine.gamma, mine.elem_bytes) == (
            ref.alpha, ref.beta, ref.gamma, ref.elem_bytes)
        for p in PS:
            for m in (1.0, 4096.0, 3.7e6, 1.245e9):
                for torus in (False, True):
                    for wire in (None, "int8"):
                        kw = dict(torus=torus, wire_dtype=wire)
                        for fn in ("t_reduce_scatter", "t_allgather",
                                   "t_allreduce"):
                            assert getattr(CM, fn)(m, p, mine, schedule,
                                                   **kw) == \
                                getattr(RCM, fn)(m, p, ref, schedule, **kw)
                    for nb in (1, 3, 16):
                        assert CM.t_bucketed_allreduce(
                            m, p, mine, nb, schedule, torus=torus,
                            overlap=0.5) == RCM.t_bucketed_allreduce(
                            m, p, ref, nb, schedule, torus=torus,
                            overlap=0.5)
                    assert CM.t_alltoall(m, p, mine, schedule,
                                         torus=torus) == \
                        RCM.t_alltoall(m, p, ref, schedule, torus=torus)
                assert CM.optimal_bucket_count(m, p, mine, schedule) == \
                    RCM.optimal_bucket_count(m, p, ref, schedule)
                for fn in ("t_corollary1", "t_corollary3_bound",
                           "t_ring_reduce_scatter", "t_ring_allreduce",
                           "t_bcast_reduce_allreduce"):
                    assert getattr(CM, fn)(m, p, mine) == \
                        getattr(RCM, fn)(m, p, ref)
        for p in (2, 3, 8, 13):
            assert CM.crossover_m(p, mine) == RCM.crossover_m(p, ref)
    for g in (64, 512):
        assert CM.wire_bytes_per_elem(4, "int8", g) == \
            RCM.wire_bytes_per_elem(4, "int8", g)
    with pytest.raises(ValueError):
        CM.wire_bytes_per_elem(4, "fp8")
    with pytest.raises(ValueError):
        CM.t_bucketed_allreduce(1.0, 2, CM.CommModel(1, 1, 1), 0)


def test_corollary1_is_halving_reduce_scatter():
    mdl = CM.CommModel(1e-6, 4e-11, 7.3e-12)
    for p in (2, 4, 8, 16, 64):
        m = 1024.0 * p
        assert CM.t_corollary1(m, p, mdl) == pytest.approx(
            CM.t_reduce_scatter(m, p, mdl, "halving"), rel=1e-12)


@pytest.mark.parametrize("phase", ["rs", "ag"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_nonuniform_round_widths_equal_reference(schedule, phase):
    rng = np.random.default_rng(11 + len(schedule))
    for p in range(2, 65):
        group = two_level_group(p) if schedule == "two_level" else None
        for counts in (tuple(int(c) for c in rng.integers(0, 9, p)),
                       (0,) * (p - 1) + (5,), (3,) * p):
            mine = CM.nonuniform_round_widths(counts, schedule, group,
                                              phase=phase)
            assert mine == RCM.nonuniform_round_widths(
                counts, schedule, group, phase=phase)
            assert all(w >= 1 for w in mine)
        mat = tuple(tuple(int(c) for c in row)
                    for row in rng.integers(0, 4, (p, p)))
        assert CM.alltoallv_round_widths(mat, schedule, group) == \
            RCM.alltoallv_round_widths(mat, schedule, group)
        assert CM.a2a_round_entries(p, schedule, group) == \
            RCM.a2a_round_entries(p, schedule, group)
