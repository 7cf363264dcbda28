"""Tensor parallelism and fsdp_auto of the port's encoder-decoder family
(whisper-small) against the reference's own steps.

The reference side is ``repro.train.steps.build("fsdp_auto", ...)``
with a ``ShardingRecipe`` on a ``jax.sharding.Mesh`` of 4 fake CPU
devices (subprocess worker ``_torch_tp_ref.py``, one spawn and one run
for this file: each run compiles for ~15-20 s), both sides from the
port's launcher's seed-0 parameters (scaled down: 2 encoder and 2
decoder layers, d_model 64, 4 heads, 2 kv heads), 16 frames a row
(each data rank's, shared by its model ranks) and 8 decoder tokens,
global batch 4, 4 steps of fsdp_auto on (2, 2) (whisper-small is not in
``FSDP_ARCHS``: recipe mode ``tp``).  zero1 on (2, 2) with a vocab of
129 (``_torch_tp_cases.MODELS``: it does not divide the axis, as
whisper-small's 51865 does not, so ``embed`` and ``lm_head`` relocate
onto d_model; ``test_torch_tp_hybrid.py`` holds that path against the
reference's steps) and sequence-parallel (1, 4) are held by their
gradients, zero1 on (2, 2) by the CLI too.  The encoder runs non-causal
self attention on the frames; each decoder layer's cross attention
projects its heads of the memory.

Tolerances, ``test_torch_tp.py``'s: losses and grad norms within 1e-5,
the parameters after step 4 gathered whole within ``rtol=1e-5`` /
``atol=5e-9`` (here ``FSDP_ATOL``: one ``enc_layers.ffn.w_gate``
element of 16,384 ends 1.8e-8 from the reference's; its step-0 gradient,
3.4e-8, is the leaf's smallest and near AdamW's eps (1e-8), so its first
update takes its size from that gradient's float32 noise; the same run
without the model axis, fsdp_auto on (4, 1), ends one ``w_up`` element
4.8e-8 from it); every leaf not split over the model axis bitwise the
same on every model rank after every step.  One backward of each layout
(sequence-parallel: frames and tokens split between layers) holds every
rank's gradient blocks against the unsharded model's within
``rtol=1e-4`` / ``atol=1e-6``.  The launcher's CLI (``--mesh 2x2``,
zero1 and fsdp_auto) prints the reference's fsdp_auto losses within
1e-5.
"""
import pytest

import _torch_tp_cases as C
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch.launch import train

#: the reference's run (one: each compiles for ~15-20 s), and the layouts
#: held by their gradients and the CLI
RUNS = ("encdec_fsdp_2x2",)
LAYOUTS = ("encdec_zero1_2x2", *RUNS, "encdec_zero1_1x4_sp")
#: fsdp_auto's parameters' ``atol`` (module docstring)
FSDP_ATOL = 1e-7


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return C.reference(tmp_path_factory.mktemp("tp_encdec"), RUNS)


@pytest.mark.parametrize("run", RUNS)
def test_tp_encdec_matches_reference(ref, run, one_torch_thread):  # noqa: F811
    C.assert_run_matches(ref, run, atol=FSDP_ATOL)


@pytest.mark.parametrize("run", LAYOUTS)
def test_tp_encdec_grads_match_unsharded(run, one_torch_thread):  # noqa: F811
    C.assert_grads_match(run)


@pytest.mark.parametrize("mode", ("zero1", "fsdp_auto"))
def test_cli_prints_reference_losses(ref, mode, capsys,
                                     one_torch_thread):  # noqa: F811
    out = train.main(["--arch", C.ENCDEC, "--scale-down", "--device", "cpu",
                      "--mesh", "2x2", "--mode", mode, "--steps", "3",
                      "--seq-len", str(C.SEQ), "--global-batch",
                      str(C.BATCH), "--log-every", "1"])
    want = ref["encdec_fsdp_2x2/losses"][:3]
    assert max(abs(a - b) for a, b in zip(out.losses, want)) < 1e-5
    printed = [float(line.split()[3]) for line in
               capsys.readouterr().out.splitlines()
               if line.startswith("step")]
    assert printed == [round(x, 4) for x in out.losses]
