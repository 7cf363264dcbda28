"""The port's skip schedules equal the reference's.

``repro_torch.core.schedule`` is a framework-free copy of
``repro.core.schedule``; for the five schedules and every p <= 64 the
skips and both phases' round plans must be identical (exact integers, no
tolerance).
"""
import pytest

from repro.core import schedule as ref
from repro_torch.core import schedule as port

PS = range(1, 65)


def _two_level_groups(p):
    return [g for g in range(1, p + 1) if p % g == 0]


def _rounds(mod, fn, *args):
    """Round tuples, or the exception type when the schedule is invalid
    (both packages must refuse the same schedules)."""
    try:
        return [(r.skip, r.lo, r.hi) for r in getattr(mod, fn)(*args)]
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("schedule", ["halving", "power2", "fully_connected",
                                      "sqrt"])
def test_schedules_match_reference(schedule):
    for p in PS:
        assert port.get_skips(p, schedule) == ref.get_skips(p, schedule), p
        assert port.ceil_log2(p) == ref.ceil_log2(p)
        rs = port.reduce_scatter_plan(p, schedule)
        assert [(r.skip, r.lo, r.hi) for r in rs] == [
            (r.skip, r.lo, r.hi) for r in ref.reduce_scatter_plan(p, schedule)]
        assert [(r.skip, r.lo, r.hi) for r in port.allgather_plan(p, schedule)] \
            == [(r.skip, r.lo, r.hi) for r in ref.allgather_plan(p, schedule)]


def test_two_level_matches_reference():
    for p in PS:
        for g in _two_level_groups(p):
            assert port.get_skips(p, "two_level", group=g) == \
                ref.get_skips(p, "two_level", group=g), (p, g)
            for fn in ("reduce_scatter_plan", "allgather_plan"):
                assert _rounds(port, fn, p, "two_level", g) == \
                    _rounds(ref, fn, p, "two_level", g), (p, g, fn)


def test_theorem1_block_volume():
    """Each rank sends exactly p-1 blocks in ceil(log2 p) rounds."""
    for p in PS:
        rs = port.reduce_scatter_plan(p)
        assert sum(r.nblocks for r in rs) == p - 1
        assert len(rs) == port.ceil_log2(p)


def test_schedule_errors_match_reference():
    for bad in ("nope", "two_level"):
        with pytest.raises(ValueError):
            ref.get_skips(6, bad)
        with pytest.raises(ValueError):
            port.get_skips(6, bad)
