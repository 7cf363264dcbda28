"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline``, in process (neither needs a device):

* every analytic term (``forward_flops_global``, ``cell_flops_per_chip``,
  ``cell_hbm_bytes_per_chip``, ``analytic_cell`` and the per-token
  helpers) is the reference's float exactly (``==``) for the ten configs
  × the reference dry run's four shapes × the 1-pod and 2-pod meshes, and
  for the cells the card runs;
* ``Roofline.as_dict`` equals the reference's key by key, with the
  reference's module constants set to the H100's (``monkeypatch``; no
  file of the reference changes), and ``model_flops`` is equal;
* the sync bytes, exchanges and native calls counted from the plans
  (``sync_counts``) equal ``comm.bytes``, ``comm.exchanges`` and
  ``comm.natives`` of a scaled-down ZeRO-1 step on the CPU, at p in
  {2, 3, 5}, in every sync mode the launcher runs, and the four-card
  counts of the full-width main path;
* ``report.render`` equals the reference's table on the same rows, but
  for the fit mark at the H100's 80 GiB.
"""
import json

import pytest
import torch

from repro.configs import ALIASES, get_config
from repro.roofline import analysis as ref_analysis
from repro.roofline import analytic as ref_analytic
from repro.roofline import report as ref_report
from repro_torch.configs import get_config as port_config
from repro_torch.launch import bootstrap
from repro_torch.optim.zero1 import GradSyncConfig
from repro_torch.roofline import analysis, analytic, report

#: the reference dry run's shapes (``repro/launch/dryrun.py:41``; the
#: module is not imported here: it sets a 512-device XLA flag on import)
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
#: the production meshes: (n_chips, tp, dp_world)
MESHES = {"1pod": (256, 16, 16), "2pod": (512, 16, 32)}
#: the card's cells (chip_smoke.py phase 13): arch, kind, seq, batch,
#: ranks, remat
CARD = [("qwen3-1.7b", "train", 2048, 3, 3, True),
        ("qwen3-1.7b", "train", 2048, 2, 2, True),
        ("qwen3-1.7b", "train", 2048, 4, 4, True),
        ("qwen3-1.7b", "prefill", 2048, 8, 1, True),
        ("qwen3-1.7b", "decode", 2176, 8, 1, True),
        ("hymba-1.5b", "train", 2048, 3, 3, True),
        ("xlstm-125m", "train", 1024, 3, 3, True),
        ("whisper-small", "train", 1500, 3, 3, True),
        ("qwen3-1.7b", "train", 2048, 3, 3, False)]
#: every sync mode the launcher runs (build_session's keywords)
MODES = [dict(), dict(wire_dtype="int8"),
         dict(wire_dtype="int8", error_feedback=False),
         dict(bucket_bytes=20000), dict(bucket_bytes=20000, wire_dtype="int8"),
         dict(grad_sync="ring"), dict(grad_sync="xla"),
         dict(grad_sync="allreduce")]


def _cells():
    """(arch, reference cell, port cell) of every config × shape × mesh,
    then the card's cells."""
    for arch in sorted(ALIASES):
        for info in SHAPES.values():
            for n, tp, dp in MESHES.values():
                kw = dict(info, n_chips=n, tp=tp, dp_world=dp)
                yield (arch, ref_analytic.CellSpec(**kw),
                       analytic.CellSpec(**kw))
    for arch, kind, seq, batch, p, remat in CARD:
        kw = dict(kind=kind, seq=seq, batch=batch, n_chips=p, tp=1,
                  dp_world=p, remat=remat)
        yield arch, ref_analytic.CellSpec(**kw), analytic.CellSpec(**kw)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_analytic_terms_equal_reference(mesh):
    n, tp, dp = MESHES[mesh]
    for arch in sorted(ALIASES):
        ref, port = get_config(arch), port_config(arch)
        for info in SHAPES.values():
            kw = dict(info, n_chips=n, tp=tp, dp_world=dp)
            rc, pc = ref_analytic.CellSpec(**kw), analytic.CellSpec(**kw)
            want = ref_analytic.analytic_cell(ref, rc)
            got = analytic.analytic_cell(port, pc)
            assert got == want, (arch, info)
            assert type(got["flops_per_chip"]) is \
                type(want["flops_per_chip"])
            assert analytic.forward_flops_global(
                port, pc.seq, pc.batch, pc.kind) == \
                ref_analytic.forward_flops_global(ref, rc.seq, rc.batch,
                                                  rc.kind)


def test_analytic_card_cells_and_helpers_equal_reference():
    """The card's cells (virtual ranks on one card, the four-card world,
    serving's prefill and decode, remat off), and every helper at each
    config and several contexts."""
    for arch, kind, seq, batch, p, remat in CARD:
        kw = dict(kind=kind, seq=seq, batch=batch, n_chips=p, tp=1,
                  dp_world=p, remat=remat)
        ref, port = get_config(arch), port_config(arch)
        assert analytic.cell_flops_per_chip(port, analytic.CellSpec(**kw)) \
            == ref_analytic.cell_flops_per_chip(ref,
                                                ref_analytic.CellSpec(**kw))
        assert analytic.cell_hbm_bytes_per_chip(
            port, analytic.CellSpec(**kw)) == \
            ref_analytic.cell_hbm_bytes_per_chip(ref,
                                                 ref_analytic.CellSpec(**kw))
    for arch in sorted(ALIASES):
        ref, port = get_config(arch), port_config(arch)
        for name in ("_attn_proj_flops", "_ffn_flops", "_moe_flops",
                     "_mamba_flops", "_mlstm_flops", "_slstm_flops",
                     "_param_bytes"):
            assert getattr(analytic, name)(port) == \
                getattr(ref_analytic, name)(ref), (arch, name)
        for s in (1, 448, 1500, 2048, 32768):
            for name in ("_attn_score_flops", "_layer_flops_per_token",
                         "_cross_layer_flops_per_token",
                         "_mem_kv_proj_flops"):
                assert getattr(analytic, name)(port, s) == \
                    getattr(ref_analytic, name)(ref, s), (arch, name, s)


#: phase 15's and 16's cells (chip_smoke.py phase 13 rows 15a, 15d,
#: 15e, 16a-16e): arch, layers, the global batch, seq, and (n_chips, tp,
#: dp_world)
CARD_TP = {"15a": ("phi3.5-moe-42b-a6.6b", 2, 2, 2048, (4, 2, 2)),
           "15d": ("grok-1-314b", 3, 2, 2048, (4, 2, 2)),
           "15e": ("llama-3.2-vision-90b", 20, 2, 2048, (4, 2, 2)),
           "16a": ("hymba-1.5b", 3, 2, 2048, (4, 2, 2)),
           "16b": ("xlstm-125m", 12, 2, 64, (4, 2, 2)),
           "16c": ("whisper-small", 12, 2, 1500, (4, 2, 2)),
           "16d": ("hymba-1.5b", 16, 2, 2048, (4, 2, 2)),
           "16e": ("whisper-small", 12, 2, 1500, (4, 2, 2))}


@pytest.mark.parametrize("label", sorted(CARD_TP))
def test_analytic_tp_card_cells_equal_reference(label):
    """Phase 15's and 16's tensor-parallel cells at their depths: FLOPs
    and HBM bytes a chip, and the roofline's terms, bound and ``mfu`` at
    a measured time, the reference's (its constants the H100's)."""
    import dataclasses
    arch, layers, batch, seq, (n, tp, dp) = CARD_TP[label]
    ref = dataclasses.replace(get_config(arch), n_layers=layers)
    port = dataclasses.replace(port_config(arch), n_layers=layers)
    kw = dict(kind="train", seq=seq, batch=batch, n_chips=n, tp=tp,
              dp_world=dp)
    cell, rcell = analytic.CellSpec(**kw), ref_analytic.CellSpec(**kw)
    assert analytic.cell_flops_per_chip(port, cell) == \
        ref_analytic.cell_flops_per_chip(ref, rcell)
    assert analytic.cell_hbm_bytes_per_chip(port, cell) == \
        ref_analytic.cell_hbm_bytes_per_chip(ref, rcell)
    rl = analysis.analyze(port, cell, measured_s=1.0)
    assert rl.t_bound == max(rl.t_compute, rl.t_memory, rl.t_collective)
    # the reference's dry run counts an encoder-decoder's decoder tokens
    dec = min(port.dec_len, seq) if port.family == "encdec" else seq
    assert rl.mfu == analysis.model_flops(
        port, batch * dec / n, True) / analysis.PEAK_FLOPS


@pytest.fixture()
def h100_reference(monkeypatch):
    """The reference's roofline module with the H100's constants."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref_analysis, name, getattr(analysis, name))
    return ref_analysis


def test_roofline_as_dict_equals_reference(h100_reference):
    """Every cell's terms through both ``Roofline``s, the reference's
    built as its dry run builds it; the port's ``analyze`` without a
    sync gives the same record."""
    assert analysis.PEAK_FLOPS == 989.4e12 and analysis.HBM_BW == 3.35e12
    assert analysis.LINK_BW == 450e9
    for arch, rc, pc in _cells():
        ref, port = get_config(arch), port_config(arch)
        ana = ref_analytic.analytic_cell(ref, rc)
        tokens = analysis.tokens_global(port, pc)
        mf = h100_reference.model_flops(ref, tokens / rc.n_chips,
                                        rc.kind == "train")
        want = h100_reference.Roofline(
            flops_per_chip=ana["flops_per_chip"],
            hbm_bytes_per_chip=ana["hbm_bytes_per_chip"],
            collective_bytes_per_chip=0.0, model_flops_per_chip=mf)
        got = analysis.analyze(port, pc)
        assert got.as_dict() == want.as_dict(), (arch, pc)
        assert list(got.as_dict()) == list(want.as_dict())


def test_roofline_collectives_and_measured_fields(h100_reference):
    """With collective stats the record gains the reference's three
    keys, equal; a measured time adds ``measured_s``, ``bound_s``,
    ``measured_over_bound`` and ``mfu``, and nothing else changes."""
    from repro.analysis.hlo_budget import CollectiveStats as RefStats
    kw = dict(ops={"collective-permute": 56, "all-gather": 2},
              bytes_by_op={"collective-permute": 9142829568,
                           "all-gather": 24},
              raw_bytes_by_op={"collective-permute": 9142829568,
                               "all-gather": 8},
              raw_bytes_by_dtype={"f32": 6095219720, "bf16": 3047609856})
    terms = dict(flops_per_chip=3.1e13, hbm_bytes_per_chip=4.2e10,
                 collective_bytes_per_chip=9142829592.0,
                 model_flops_per_chip=2.5e13)
    want = h100_reference.Roofline(**terms, collectives=RefStats(**kw))
    got = analysis.Roofline(**terms, collectives=analysis.CollectiveStats(
        **kw))
    assert got.as_dict() == want.as_dict()
    measured = analysis.Roofline(**terms, measured_s=1.25).as_dict()
    extra = {k: v for k, v in measured.items() if k not in want.as_dict()}
    bound = max(measured["t_compute_s"], measured["t_memory_s"],
                measured["t_collective_s"])
    assert extra == {"measured_s": 1.25, "bound_s": bound,
                     "measured_over_bound": 1.25 / bound,
                     "mfu": (2.5e13 / 989.4e12) / 1.25}
    assert "mfu" not in got.as_dict()


def test_model_flops_equal_reference():
    for arch in sorted(ALIASES):
        for tokens in (1, 8, 6144, 1048576 / 256):
            for training in (True, False):
                assert analysis.model_flops(port_config(arch), tokens,
                                            training) == \
                    ref_analysis.model_flops(get_config(arch), tokens,
                                             training)


@pytest.mark.parametrize("p", [2, 3, 5])
def test_sync_counts_equal_comm_counters(p):
    """One ZeRO-1 step of scaled-down qwen3 over p virtual ranks in every
    sync mode: the counts from the plans equal what the communicator
    counted, exactly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for kw in MODES:
            sess = bootstrap.build_session(
                arch="qwen3-1.7b", scale_down=True, steps=2, seq_len=8,
                global_batch=p, dp=p, device="cpu", **kw)
            c = sess.comm
            before = (c.bytes, c.exchanges, c.natives)
            bootstrap.run_step(sess, 0)
            got = (c.bytes - before[0], c.exchanges - before[1],
                   c.natives - before[2])
            sc = analysis.sync_counts(sess.cfg, sess.sync, p,
                                      ranks=len(c.ranks))
            assert (sc.bytes, sc.exchanges, sc.natives) == got, (p, kw)
            assert sc.stats.ops.get("collective-permute", 0) == sc.exchanges
            assert sum(sc.stats.raw_bytes_by_dtype.values()) == \
                sc.bytes + sum(v for k, v in sc.stats.raw_bytes_by_op.items()
                               if k != "collective-permute")
    finally:
        torch.set_num_threads(n)


def test_sync_counts_full_width():
    """qwen3-1.7b at full width: the four-card main path's counts a rank
    a step (9,142,829,568 bytes, 56 exchanges at p = 4) and the int8 wire
    with EF at p = 3 (4,276,245,492 bytes), the wire's codes and scales
    apart; the xla sync's native volumes are the paper's p - 1 blocks."""
    cfg = port_config("qwen3-1.7b")
    exact = analysis.sync_counts(cfg, GradSyncConfig(), 4)
    assert (exact.bytes, exact.exchanges, exact.natives) == \
        (9142829568, 56, 2)
    # the gradients' float32 reduce-scatter, the bf16 parameters'
    # allgather, and the two float32 scalar folds (grad norm, loss)
    assert exact.stats.raw_bytes_by_dtype == {"f32": 6095219712 + 8,
                                              "bf16": 3047609856}
    assert exact.native_bytes == 2 * 3 * 4
    wire = analysis.sync_counts(cfg, GradSyncConfig(wire_dtype="int8"), 3)
    assert (wire.bytes, wire.exchanges) == (4276245492, 56)
    assert wire.stats.bytes_by_op["collective-permute"] == wire.bytes
    # the wire's codes (one byte an element) and its scales (four bytes
    # a group of 512)
    assert wire.stats.raw_bytes_by_dtype == {"s8": 1421714432,
                                             "f32": 1421714432 // 128 + 8,
                                             "bf16": 2843423916}
    three = analysis.sync_counts(cfg, GradSyncConfig(), 3, ranks=3)
    assert three.bytes == 3 * analysis.sync_counts(
        cfg, GradSyncConfig(), 3).bytes
    xla = analysis.sync_counts(cfg, GradSyncConfig(impl="xla"), 4)
    assert (xla.bytes, xla.exchanges, xla.natives) == (0, 0, 30)
    assert xla.stats.ops == {"reduce-scatter": 14, "all-gather": 16}
    assert xla.stats.bytes_by_op == {
        "reduce-scatter": 3 * 8126959616 / 4,
        "all-gather": 3 * 1015869952 + 2 * 3 * 4}
    assert xla.link_bytes == exact.link_bytes


def test_analyze_one_card_and_one_rank_per_card():
    """Virtual ranks on one card: p times one rank's compute and memory,
    the sync's bytes read and written in HBM, no collective term; one
    rank a card: one rank's terms and the sync on the link."""
    cfg = port_config("qwen3-1.7b")
    cell = analytic.CellSpec(kind="train", seq=2048, batch=3, n_chips=3,
                             tp=1, dp_world=3)
    one = analytic.analytic_cell(cfg, cell)
    sync = analysis.sync_counts(cfg, GradSyncConfig(), 3, ranks=3)
    card = analysis.analyze(cfg, cell, sync=sync, local=True, measured_s=3.0)
    assert card.flops_per_chip == 3 * one["flops_per_chip"]
    assert card.hbm_bytes_per_chip == \
        3 * one["hbm_bytes_per_chip"] + 2 * sync.link_bytes
    assert card.t_collective == 0.0
    assert card.model_flops_per_chip == analysis.model_flops(
        cfg, 3 * 2048, True)
    assert card.mfu == card.model_flops_per_chip / analysis.PEAK_FLOPS / 3.0
    rank = analysis.analyze(
        cfg, cell, sync=analysis.sync_counts(cfg, GradSyncConfig(), 3))
    assert rank.flops_per_chip == one["flops_per_chip"]
    assert rank.collective_bytes_per_chip == sync.link_bytes / 3
    assert rank.t_collective == sync.link_bytes / 3 / 450e9
    assert rank.as_dict()["collective_ops"]["collective-permute"] == \
        sync.exchanges


def _rows():
    """Report records: OK rows with peaks on both sides of 16 GiB and
    80 GiB, a SKIP and an ERROR."""
    rows = []
    for i, (arch, rc, pc) in enumerate(_cells()):
        if i % 7:
            continue
        rl = analysis.analyze(port_config(arch), pc).as_dict()
        peak = (3 + i) * 2**30 if i % 2 else (i // 3) * 2**30
        rows.append({"arch": arch, "shape": f"s{i}", "mode": "zero1",
                     "status": "OK", "roofline": rl,
                     "memory": {"argument_bytes": peak // 2,
                                "temp_bytes": peak - peak // 2}})
    rows.append({"arch": "xlstm-125m", "shape": "long_500k", "status":
                 "SKIP(full-attention: 500k decode needs sub-quadratic arch)"})
    rows.append({"arch": "grok-1-314b", "shape": "train_4k", "mode": "zero1",
                 "status": "ERROR: RuntimeError: out of memory"})
    return rows


def test_report_render_equals_reference_but_the_fit_mark(tmp_path):
    """The same rows render the reference's table, written as records
    and loaded back; only rows above 16 GiB and up to 80 GiB differ, by
    the reference's fit mark."""
    rows = _rows()
    for r in rows:
        with open(tmp_path / f"{r['arch']}_{r['shape']}_h100.json", "w") as f:
            json.dump(r, f)
    (tmp_path / "other_x_1pod.json").write_text("{}")
    loaded = report.load(str(tmp_path), "h100")
    assert loaded == ref_report.load(str(tmp_path), "h100")
    assert len(loaded) == len(rows)
    got = report.render(loaded).splitlines()
    want = ref_report.render(loaded).splitlines()
    assert len(got) == len(want)
    marked = 0
    for g, w in zip(got, want):
        if g != w:
            assert w == g.replace(
                f"{g.split(' | ')[4]} |", f"{g.split(' | ')[4]} ⚠ |", 1)
            marked += 1
    assert marked >= 1
    assert report.fmt_bytes(3 * 2**30) == ref_report.fmt_bytes(3 * 2**30)


def test_report_fit_mark_and_measured_columns(tmp_path, capsys):
    """One row pins the 80 GiB mark (40 GiB: marked by the reference, not
    by the port; 90 GiB: both); measured rows fill ``measured s`` and
    ``mfu``, unmeasured rows leave them empty; the CLI prints the
    table."""
    cfg = port_config("qwen3-1.7b")
    cell = analytic.CellSpec(kind="train", seq=2048, batch=3, n_chips=3,
                             tp=1, dp_world=3)
    rl = analysis.analyze(cfg, cell, local=True, measured_s=2.5).as_dict()
    plain = analysis.analyze(cfg, cell, local=True).as_dict()
    rows = [{"arch": "qwen3-1.7b", "shape": "phase4", "mode": "zero1",
             "status": "OK", "roofline": rl,
             "memory": {"argument_bytes": 40 * 2**30, "temp_bytes": 0}},
            {"arch": "qwen3-1.7b", "shape": "phase4x", "mode": "zero1",
             "status": "OK", "roofline": plain,
             "memory": {"argument_bytes": 90 * 2**30, "temp_bytes": 0}}]
    table = report.render(rows).splitlines()
    assert table[0].endswith("| roofline frac | measured s | mfu |")
    assert table[2].startswith("| qwen3-1.7b | phase4 | zero1 | OK | 40.0 |")
    assert table[2].endswith(f"| {2.5:.4f} | {rl['mfu']:.4f} |")
    assert "| 90.0 ⚠ |" in table[3] and table[3].endswith("| | |")
    assert "40.0 ⚠" in ref_report.render(rows[:1])
    for r in rows:
        with open(tmp_path / f"{r['arch']}_{r['shape']}_h100.json", "w") as f:
            json.dump(r, f)
    report.main(["--dir", str(tmp_path)])
    assert capsys.readouterr().out.strip() == report.render(rows)


#: the tensor-parallel steps of ``test_tp_counts_equal_comm_counters``
TP_STEPS = {
    "zero1": [dict(dp=2, mp=2), dict(dp=2, mp=2, wire_dtype="int8"),
              dict(dp=2, mp=2, bucket_bytes=30_000),
              dict(dp=1, mp=4, sequence_parallel=True)],
    "fsdp_auto": [dict(dp=2, mp=2), dict(dp=2, mp=2, arch="qwen1.5-110b"),
                  dict(dp=1, mp=4, arch="qwen1.5-110b",
                       sequence_parallel=True)],
}


@pytest.mark.parametrize("mode", sorted(TP_STEPS))
def test_tp_counts_equal_comm_counters(mode):
    """One tensor-parallel step (zero1 on a ``D x M`` mesh: exact, int8 +
    EF, bucketed, sequence-parallel; fsdp_auto, ``tp`` and ``tp_fsdp``):
    ``tp_counts`` equals ``comm.bytes``, ``comm.exchanges`` and
    ``comm.natives`` of the data axis and of the model axis, exactly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for kw in TP_STEPS[mode]:
            kw = {"arch": "qwen3-1.7b", **kw}
            sess = bootstrap.build_session(
                scale_down=True, steps=2, seq_len=8, global_batch=4,
                device="cpu", mode=mode, **kw)
            comms = {"data": sess.comm, "model": sess.tp.axis.comm}
            before = {a: (c.bytes, c.exchanges, c.natives)
                      for a, c in comms.items()}
            bootstrap.run_step(sess, 0)
            pc = analysis.tp_counts(sess.cfg, sess.tp.layout, mode=mode,
                                    batch=4, seq=8, sync=sess.sync,
                                    ranks=len(sess.comm.ranks))
            for axis, c in comms.items():
                got = tuple(x - y for x, y in zip(
                    (c.bytes, c.exchanges, c.natives), before[axis]))
                want = pc[axis]
                assert (want.bytes, want.exchanges, want.natives) == got, \
                    (axis, kw)
                assert sum(want.stats.ops.values()) == \
                    want.exchanges + want.natives
    finally:
        torch.set_num_threads(n)


#: the MoE and VLM families' tensor-parallel steps (scaled down; grok-1
#: and the VLM train ``tp_fsdp`` under fsdp_auto, grok-1's global
#: dispatch pooling both data ranks' tokens)
TP_FAMILY_STEPS = {
    "moe_zero1_2x2": ("zero1", dict(arch="phi3.5-moe-42b-a6.6b", dp=2,
                                    mp=2)),
    "moe_zero1_1x4_sp": ("zero1", dict(arch="phi3.5-moe-42b-a6.6b", dp=1,
                                       mp=4, sequence_parallel=True)),
    "moe_rowwise_2x2": ("zero1", dict(arch="phi3.5-moe-42b-a6.6b", dp=2,
                                      mp=2, moe_dispatch="rowwise")),
    "grok_fsdp_2x2": ("fsdp_auto", dict(arch="grok-1-314b", dp=2, mp=2)),
    "vlm_zero1_2x2": ("zero1", dict(arch="llama-3.2-vision-90b", dp=2,
                                    mp=2)),
    "vlm_fsdp_1x2_sp": ("fsdp_auto", dict(arch="llama-3.2-vision-90b",
                                          dp=1, mp=2,
                                          sequence_parallel=True)),
}


def _tp_counts_equal_comm_counters(mode: str, kw: dict, model=None):
    """One step of a scaled-down tensor-parallel session (``model``: a
    ``_torch_tp_cases.MODELS`` key whose config overrides apply):
    ``tp_counts`` equals ``comm.bytes``, ``comm.exchanges`` and
    ``comm.natives`` of both axes, exactly."""
    import _torch_tp_cases as C
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with C.configured(model):
            sess = bootstrap.build_session(
                scale_down=True, steps=2, seq_len=8, global_batch=4,
                device="cpu", mode=mode, **kw)
        comms = {"data": sess.comm, "model": sess.tp.axis.comm}
        before = {a: (c.bytes, c.exchanges, c.natives)
                  for a, c in comms.items()}
        bootstrap.run_step(sess, 0)
        pc = analysis.tp_counts(sess.cfg, sess.tp.layout, mode=mode,
                                batch=4, seq=8, sync=sess.sync,
                                ranks=len(sess.comm.ranks))
        for axis, c in comms.items():
            got = tuple(x - y for x, y in zip(
                (c.bytes, c.exchanges, c.natives), before[axis]))
            want = pc[axis]
            assert (want.bytes, want.exchanges, want.natives) == got, axis
        return pc
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(TP_FAMILY_STEPS))
def test_tp_counts_of_moe_and_vlm_equal_comm_counters(name):
    """``tp_counts`` of the MoE (global, rowwise, pooled over the data
    axis under fsdp_auto) and VLM steps equals ``comm.bytes``,
    ``comm.exchanges`` and ``comm.natives`` of both axes over one step,
    exactly: the model run on ``meta`` tensors makes the calls the step
    makes."""
    _tp_counts_equal_comm_counters(*TP_FAMILY_STEPS[name])


#: the hybrid, xLSTM and encoder-decoder families' tensor-parallel steps
#: (scaled down; ``model``: hymba with heads and vocab relocated onto
#: d_model, whisper with such a vocab, ``_torch_tp_cases.MODELS``)
TP_MORE_STEPS = {
    "hybrid_zero1_2x2": ("zero1", dict(arch="hymba-1.5b", dp=2, mp=2),
                         "hymba-1.5b~relocated"),
    "hybrid_zero1_1x4_sp": ("zero1", dict(arch="hymba-1.5b", dp=1, mp=4,
                                          sequence_parallel=True)),
    "xlstm_zero1_2x2": ("zero1", dict(arch="xlstm-125m", dp=2, mp=2)),
    "xlstm_fsdp_1x4_sp": ("fsdp_auto", dict(arch="xlstm-125m", dp=1, mp=4,
                                            sequence_parallel=True)),
    "encdec_zero1_2x2": ("zero1", dict(arch="whisper-small", dp=2, mp=2),
                         "whisper-small~v129"),
    "encdec_fsdp_1x4_sp": ("fsdp_auto", dict(arch="whisper-small", dp=1,
                                             mp=4, sequence_parallel=True)),
}


@pytest.mark.parametrize("name", sorted(TP_MORE_STEPS))
def test_tp_counts_of_hybrid_xlstm_encdec_equal_comm_counters(name):
    """``tp_counts`` of the hybrid (the Mamba heads' all-to-all of ``[x |
    z]`` and the one all-reduce of their ``dt`` / ``B`` / ``C`` partial
    sums), xLSTM and encoder-decoder steps, relocated and
    sequence-parallel layouts among them, equals ``comm.bytes``,
    ``comm.exchanges`` and ``comm.natives`` of both axes over one step,
    exactly."""
    pc = _tp_counts_equal_comm_counters(*TP_MORE_STEPS[name])
    if name.startswith("hybrid"):
        assert pc["model"].stats.ops["all-to-all"] > 0


def test_tp_counts_full_width_per_layer():
    """qwen3-1.7b at full width (4 of its 28 layers) on 2x2, seq 256: the
    model axis makes one
    all-reduce for the embedding, per layer two in the forward (after
    ``wo`` and ``w_down``), one more in remat's recompute (which stops at
    the last tensor the backward needs, before ``w_down``'s sum) and four
    in the backward (the copies of the two normed inputs and of the two
    qk-norm gains), one for the head's input, the loss's allgather of
    maxima and all-reduce, and the grad norm's fold: 5 + 7 L.  The data
    axis syncs every block: 2 ceil(log2 2) exchanges a zero leaf.  (At
    28 layers: 201 model-axis calls, phase 14 (a) of ``chip_smoke.py``.)"""
    import dataclasses
    from repro_torch.models import ShardingRecipe
    from repro_torch.models import sharding as shd
    cfg = dataclasses.replace(port_config("qwen3-1.7b"), n_layers=4)
    lay = shd.tp_layout(cfg, ShardingRecipe(tp_size=2), (2, 2))
    pc = analysis.tp_counts(cfg, lay, mode="zero1", batch=2, seq=256,
                            sync=GradSyncConfig())
    assert pc["model"].natives == 5 + 7 * cfg.n_layers
    assert pc["model"].stats.ops == {"all-reduce": 3 + 7 * cfg.n_layers,
                                     "all-gather": 2}
    # 12 zero leaves (4 layers of q / k norm gains, 512 elements each,
    # stay whole: folded) and the grad norm's and the loss's folds
    assert pc["data"].exchanges == 2 * 12 and pc["data"].natives == 2 + 2
