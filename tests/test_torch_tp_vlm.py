"""Tensor parallelism and fsdp_auto of the port's VLM family
(llama-3.2-vision-90b) against the reference's own steps.

The reference side is ``repro.train.steps.build("zero1" | "fsdp_auto",
...)`` with a ``ShardingRecipe`` on a ``jax.sharding.Mesh`` of 4 fake
CPU devices (subprocess worker ``_torch_tp_ref.py``, one spawn for this
file), both sides from the port's launcher's seed-0 parameters (scaled
down: one group of 4 self layers and 1 gated cross layer, d_model 64, 4
heads, 2 kv heads, 8 image tokens), seq 16, global batch 4 (the batch's
image embeddings each data rank's, shared by its model ranks), 4 steps:
zero1 on (2, 2) and fsdp_auto ``tp_fsdp`` on (2, 2).  The self layers
run as the dense family's TP layer; a cross layer projects the image
K/V on each rank's heads and gates the summed attention and FFN outputs
with ``tanh``.

Tolerances, ``test_torch_tp.py``'s: losses and grad norms within 1e-5,
the parameters after step 4 gathered whole within ``rtol=1e-5`` /
``atol=5e-9`` (fsdp_auto: ``2e-7``, for one element whose first
gradient sits near AdamW's eps; ``_torch_tp_cases.py`` says why); every
leaf not split over the model axis (the gates
among them) bitwise the same on every model rank after every step.  One
backward of each layout, and of sequence-parallel (1, 4) (kv heads do
not divide the axis there: ``wk`` / ``wv`` split on d_model), holds
every rank's gradient blocks against the unsharded model's within
``rtol=1e-4`` / ``atol=1e-6``.  The launcher's CLI prints the
reference's losses within 1e-5 in both modes.
"""
import pytest

import _torch_tp_cases as C
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch.launch import train

RUNS = ("vlm_zero1_2x2", "vlm_fsdp_2x2")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return C.reference(tmp_path_factory.mktemp("tp_vlm"), RUNS)


@pytest.mark.parametrize("run", RUNS)
def test_tp_vlm_matches_reference(ref, run, one_torch_thread):  # noqa: F811
    C.assert_run_matches(ref, run, **({"atol": C.VLM_FSDP_ATOL}
                                      if "fsdp" in run else {}))


@pytest.mark.parametrize("run", (*RUNS, "vlm_zero1_1x4_sp"))
def test_tp_vlm_grads_match_unsharded(run, one_torch_thread):  # noqa: F811
    C.assert_grads_match(run)


@pytest.mark.parametrize("mode", ("zero1", "fsdp_auto"))
def test_cli_prints_reference_losses(ref, mode, capsys,
                                     one_torch_thread):  # noqa: F811
    out = train.main(["--arch", C.VLM, "--scale-down", "--device", "cpu",
                      "--mesh", "2x2", "--mode", mode, "--steps", "3",
                      "--seq-len", str(C.SEQ), "--global-batch",
                      str(C.BATCH), "--log-every", "1"])
    run = "vlm_zero1_2x2" if mode == "zero1" else "vlm_fsdp_2x2"
    want = ref[f"{run}/losses"][:3]
    assert max(abs(a - b) for a, b in zip(out.losses, want)) < 1e-5
    printed = [float(line.split()[3]) for line in
               capsys.readouterr().out.splitlines()
               if line.startswith("step")]
    assert printed == [round(x, 4) for x in out.losses]
