"""Tensor parallelism of the port (``--mesh DxM``: ZeRO-1 over the data
axis, TP over the model axis) against the reference's own TP step.

The reference side is ``repro.train.steps.build("zero1", ...)`` with a
``ShardingRecipe`` on a ``jax.sharding.Mesh`` of 4 fake CPU devices
(subprocess worker ``_torch_tp_ref.py``, one spawn for this file); both
sides start from the port's launcher's seed-0 parameters (scaled-down
qwen3-1.7b, the launcher's scale-down: 2 layers, vocab 128, 4 heads, 2
kv heads), seq 16, global batch 4, 4 steps.  Cases: (2, 2) plain; (1,
4) with ``tp_size=4, expand_gqa=True`` (kv heads do not divide the
axis, so ``wk`` / ``wv`` are split on d_model by ``sanitize_spec`` and
their matmuls end in a sum); (2, 2) on the int8 wire with error
feedback.  Sequence parallelism and QKV bias (qwen1.5-110b) are held
against the reference in ``test_torch_fsdp.py``'s runs (each reference
run compiles for ~10 s, so the two files share the cases), and here by
their gradients.

Tolerances, those of ``test_torch_zero1.py``: losses and grad norms
within 1e-5; the parameters after step 4, gathered whole, within
``rtol=1e-5`` / ``atol=5e-9`` (QKV bias's ``bk``: ``1e-7``;
``_torch_tp_cases.py`` says why).  The int8 wire keeps its own
``atol=6e-6`` (losses and grad norms 1e-5): the leaves whose blocks
would round other quantization groups or other data blocks than the
reference's global rows (``embed``, split on its rows; the projections
whose blocks are not whole groups of 512 at this width) are synced
whole (``optim.zero1.wire_needs_whole``), so both wires round the same
groups.  It is also held within the reference's own int8 gate against
the exact run (losses 0.05).  Every leaf not split over the model axis is bitwise the same on
every model rank after every step.  One backward of each layout holds
every rank's gradient blocks against the unsharded model's gradients
within ``rtol=1e-4`` / ``atol=1e-6``.  The launcher's CLI (``--mesh
2x2``) prints the reference's losses within 1e-5, and checkpoints the
hybrid, xLSTM and encoder-decoder archs on a model axis (the checkpoints'
layout and resharding: ``test_torch_tp_ckpt.py``,
``test_torch_tp_reshard.py``; the other families:
``test_torch_tp_moe.py``, ``test_torch_tp_vlm.py``,
``test_torch_tp_hybrid.py``, ``test_torch_tp_xlstm.py``,
``test_torch_tp_encdec.py``).
"""
import pytest

import _torch_tp_cases as C
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch import tree as T
from repro_torch.launch import train
from repro_torch.models import param_shapes

RUNS = ("zero1_2x2", "zero1_1x4_gqa", "zero1_2x2_int8")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return C.reference(tmp_path_factory.mktemp("tp"), RUNS)


#: the int8 run's bounds: ``test_torch_zero1.py``'s int8 + EF ones
INT8 = dict(atol=6e-6, loss_tol=1e-5, gnorm_tol=1e-5)


@pytest.mark.parametrize("run", RUNS)
def test_tp_zero1_matches_reference(ref, run, one_torch_thread):  # noqa: F811
    C.assert_run_matches(ref, run, **(INT8 if "int8" in run else {}))


def test_tp_int8_within_the_reference_gate_of_exact(ref):
    """The reference's own gate of the int8 wire (``tests/
    _zero1_checks.py``): its losses within 0.05 of the exact run's; the
    port's TP int8 run against the reference's exact TP run."""
    _, losses, _ = C.train("zero1_2x2_int8", C.tree(ref, "qwen3-1.7b/init/"))
    assert max(abs(a - b) for a, b in
               zip(losses, ref["zero1_2x2/losses"])) < 0.05


@pytest.mark.parametrize("run", ("zero1_2x2", "zero1_1x4_sp",
                                 "zero1_1x4_gqa", "zero1_2x2_bias"))
def test_tp_grads_match_unsharded(run, one_torch_thread):  # noqa: F811
    C.assert_grads_match(run)


def test_cli_mesh_2x2_prints_reference_losses(ref, capsys,
                                              one_torch_thread):  # noqa: F811
    out = train.main(["--arch", "qwen3-1.7b", "--scale-down", "--device",
                      "cpu", "--mesh", "2x2", "--steps", "3", "--seq-len",
                      str(C.SEQ), "--global-batch", str(C.BATCH),
                      "--log-every", "1"])
    want = ref["zero1_2x2/losses"][:3]
    assert max(abs(a - b) for a, b in zip(out.losses, want)) < 1e-5
    printed = [float(line.split()[3]) for line in
               capsys.readouterr().out.splitlines()
               if line.startswith("step")]
    assert printed == [round(x, 4) for x in out.losses]


@pytest.mark.parametrize("arch", ("hymba-1.5b", "xlstm-125m",
                                  "whisper-small"))
def test_model_axis_refused_for_other_families(arch, tmp_path,
                                              one_torch_thread):  # noqa: F811
    """The hybrid, xLSTM and encoder-decoder families train on a model
    axis (``test_torch_tp_hybrid.py``, ``_xlstm.py``, ``_encdec.py``),
    and a checkpoint directory with it is no longer refused: one step of
    ``--mesh 1x2 --ckpt-dir`` writes every leaf whole (the config's
    shapes) and the moments and step of the data world of 1 (resharding:
    ``test_torch_tp_reshard.py``)."""
    from repro_torch.launch.bootstrap import resolve_cfg
    train.main(["--arch", arch, "--scale-down", "--device", "cpu", "--mesh",
                "1x2", "--steps", "1", "--seq-len", "8", "--global-batch",
                "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    z, man = C.checkpoint(tmp_path, 1)
    shapes = [s for _, s in T.flatten(param_shapes(
        resolve_cfg(arch, scale_down=True)))]
    assert (man["world"], man["mesh"]) == (1, "1x2")
    assert [z[f"p_{i}"].shape for i in range(len(shapes))] == shapes
    n = len(shapes)
    assert [z[f"opt_leaf_{i}"].shape for i in range(2 * n)] == shapes * 2
    assert int(z[f"opt_leaf_{2 * n}"]) == 1
