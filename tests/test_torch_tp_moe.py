"""Tensor parallelism and fsdp_auto of the port's MoE family against the
reference's own steps.

The reference side is ``repro.train.steps.build("zero1" | "fsdp_auto",
...)`` with a ``ShardingRecipe`` on a ``jax.sharding.Mesh`` of 4 fake
CPU devices (subprocess worker ``_torch_tp_ref.py``, one spawn for this
file); both sides start from the port's launcher's seed-0 parameters
(scaled down: 2 layers, 4 experts, top-2, d_model 64, vocab 128), seq
16, global batch 4, 4 steps.  Runs: phi-3.5-MoE zero1 under the global
dispatch on (2, 2) and sequence-parallel on (1, 4), under ``rowwise``
on (2, 2); grok-1-314b fsdp_auto ``tp_fsdp`` on (2, 2), whose global
dispatch pools both data ranks' tokens (the reference's data axis is
GSPMD's there: its pool is the global batch).  Each model rank runs the
slots of its own experts; the router, the tables and the aux loss run on
every rank on the tokens whole.

Tolerances, ``test_torch_tp.py``'s: losses and grad norms within 1e-5,
the parameters after step 4 gathered whole within ``rtol=1e-5`` /
``atol=5e-9``; every leaf not split over the model axis bitwise the
same on every model rank after every step.  One backward of each layout
(and of grok-1's sequence-parallel (1, 4)) holds every rank's gradient
blocks against the unsharded model's within ``rtol=1e-4`` /
``atol=1e-6``.  The launcher's CLI prints the reference's losses within
1e-5 for each run.
"""
import pytest

import _torch_tp_cases as C
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch.launch import train

RUNS = ("moe_zero1_2x2", "moe_zero1_1x4_sp", "moe_zero1_2x2_rowwise",
        "grok_fsdp_2x2")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return C.reference(tmp_path_factory.mktemp("tp_moe"), RUNS)


@pytest.mark.parametrize("run", RUNS)
def test_tp_moe_matches_reference(ref, run, one_torch_thread):  # noqa: F811
    C.assert_run_matches(ref, run)


@pytest.mark.parametrize("run", (*RUNS, "grok_fsdp_1x4_sp"))
def test_tp_moe_grads_match_unsharded(run, one_torch_thread):  # noqa: F811
    C.assert_grads_match(run)


#: run -> the launcher's flags beyond the arch's
CLI = {"moe_zero1_2x2": ["--mesh", "2x2"],
       "moe_zero1_2x2_rowwise": ["--mesh", "2x2", "--moe-dispatch",
                                 "rowwise"],
       "grok_fsdp_2x2": ["--mesh", "2x2", "--mode", "fsdp_auto"]}


@pytest.mark.parametrize("run", sorted(CLI))
def test_cli_prints_reference_losses(ref, run, capsys,
                                     one_torch_thread):  # noqa: F811
    out = train.main(["--arch", C.RUNS[run]["arch"], "--scale-down",
                      "--device", "cpu", "--steps", "3", "--seq-len",
                      str(C.SEQ), "--global-batch", str(C.BATCH),
                      "--log-every", "1", *CLI[run]])
    want = ref[f"{run}/losses"][:3]
    assert max(abs(a - b) for a, b in zip(out.losses, want)) < 1e-5
    printed = [float(line.split()[3]) for line in
               capsys.readouterr().out.splitlines()
               if line.startswith("step")]
    assert printed == [round(x, 4) for x in out.losses]

