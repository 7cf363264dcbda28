"""Tensor parallelism and fsdp_auto of the port's xLSTM family
(xlstm-125m: alternating mLSTM and sLSTM blocks) against the
reference's own steps.

The reference side is ``repro.train.steps.build("zero1", ...)`` with a
``ShardingRecipe`` on a ``jax.sharding.Mesh`` of 4 fake CPU devices
(subprocess worker ``_torch_tp_ref.py``, one spawn and one run for this
file: each run compiles for ~15 s), both sides from the port's
launcher's seed-0 parameters (scaled down: an mLSTM and an sLSTM layer,
d_model 64, 4 heads of 16, vocab 128), seq 16, global batch 4, 4 steps
of zero1 on (2, 2).  fsdp_auto sequence-parallel on (1, 4)
(xlstm-125m is not in ``FSDP_ARCHS``: recipe mode ``tp``; one head a
rank) is held by its gradients and by the CLI.  Every rank runs the
recurrences of its own heads; the replicated gate biases enter as each
rank's slice, so their gradients are the whole leaf's on every model
rank.

Tolerances, ``test_torch_tp.py``'s: losses within 1e-5 and the
parameters after step 4 gathered whole within ``rtol=1e-5`` /
``atol=5e-9``, but for what the family's mixers give on their own.
Grad norms (about 39) within ``GNORM_TOL``: step 0's ends 1.14e-5 (3
float32 ulps) from the reference's (on (2, 2) and on (1, 4) alike), the
sLSTM's gradient summed in another order over the heads split.
Parameters within ``ATOL`` (``test_torch_zero1_archs.py``'s for the
xLSTM): 55-56 of the sLSTM's zero-initialized ``bias``'s 256 elements
end past 5e-9, at most 2.4e-7 apart (without the model axis, fsdp_auto
on (4, 1): 52-53, at most 1.4e-7): each is a sum of about ``±lr``
updates that nearly cancel, where ``rtol`` bounds nothing.  Every leaf
not split over the model axis is bitwise the same on every model rank
after every step.  One backward of each layout holds every rank's
gradient blocks against the unsharded model's within ``rtol=1e-4`` /
``atol=1e-6``.  The launcher's CLI (``--mesh 2x2``, zero1 and
fsdp_auto) prints the reference's losses within 1e-5.
"""
import pytest

import _torch_tp_cases as C
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch.launch import train

#: the reference's run (one: each compiles for ~15 s), and the layouts
#: held by their gradients and the CLI
RUNS = ("xlstm_zero1_2x2",)
LAYOUTS = (*RUNS, "xlstm_fsdp_1x4_sp")
#: the grad norms' tolerance and the parameters' ``atol`` (module
#: docstring)
GNORM_TOL, ATOL = 2e-5, 1e-6


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return C.reference(tmp_path_factory.mktemp("tp_xlstm"), RUNS)


@pytest.mark.parametrize("run", RUNS)
def test_tp_xlstm_matches_reference(ref, run, one_torch_thread):  # noqa: F811
    C.assert_run_matches(ref, run, atol=ATOL, gnorm_tol=GNORM_TOL)


@pytest.mark.parametrize("run", LAYOUTS)
def test_tp_xlstm_grads_match_unsharded(run, one_torch_thread):  # noqa: F811
    C.assert_grads_match(run)


@pytest.mark.parametrize("mode", ("zero1", "fsdp_auto"))
def test_cli_prints_reference_losses(ref, mode, capsys,
                                     one_torch_thread):  # noqa: F811
    out = train.main(["--arch", C.XLSTM, "--scale-down", "--device", "cpu",
                      "--mesh", "2x2", "--mode", mode, "--steps", "3",
                      "--seq-len", str(C.SEQ), "--global-batch",
                      str(C.BATCH), "--log-every", "1"])
    want = ref["xlstm_zero1_2x2/losses"][:3]
    assert max(abs(a - b) for a, b in zip(out.losses, want)) < 1e-5
    printed = [float(line.split()[3]) for line in
               capsys.readouterr().out.splitlines()
               if line.startswith("step")]
    assert printed == [round(x, 4) for x in out.losses]
