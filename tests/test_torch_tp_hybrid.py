"""Tensor parallelism and fsdp_auto of the port's hybrid family
(hymba-1.5b: attention and Mamba heads on the same normed input) against
the reference's own steps.

The reference side is ``repro.train.steps.build("zero1", ...)`` with a
``ShardingRecipe`` on a ``jax.sharding.Mesh`` of 4 fake CPU devices
(subprocess worker ``_torch_tp_ref.py``, one spawn for this file), both
sides from the port's launcher's seed-0 parameters (scaled down: 2
layers, layer 0 global and layer 1 a window of 8, d_model 64, d_inner
128, state 16), seq 16, global batch 4, 4 steps.  Runs: zero1 on (2, 2)
with 5 heads, 5 kv heads and a vocab of 129 (``_torch_tp_cases.MODELS``:
neither divides the axis, as hymba-1.5b's 25, 5 and 32001 do not, so
``sanitize_spec`` relocates ``wq`` / ``wk`` / ``wv`` / ``wo``, ``embed``
and ``lm_head`` onto d_model: the attention's projections are partial
sums, the embedding and head take their d_model path), and zero1
sequence-parallel on (1, 4) at the launcher's scale-down (4 heads, 2 kv
heads: ``wk`` / ``wv`` relocated).  Every rank's Mamba heads run its own
channels: ``w_in``'s block is a run of the ``[x | z]`` columns, one
all-to-all brings each rank its channels of both halves.

Tolerances, ``test_torch_tp.py``'s: losses within 1e-5, grad norms
within 1e-5 and the parameters after step 4 gathered whole within
``rtol=1e-5`` / ``atol=5e-9``, but for what the hybrid's mixers give on
their own: the Mamba scan associates its products otherwise than XLA's
``associative_scan`` (``test_torch_zero1_archs.py`` holds hymba's ZeRO-1
at ``atol=1e-6`` for it), and the same config trained without a model
axis (fsdp_auto on (4, 1)) ends as far from the reference.  So grad
norms (about 12.4) within ``GNORM_TOL``: measured 1.6e-5 at step 2 of
(2, 2), 2.7e-5 without the model axis; parameters within
``ATOL``: one element of ``attn.wk``, ``mamba.w_C`` and ``mamba.w_out``
past 5e-9 on (2, 2), at most 2.4e-7, and of ``ffn.w_down`` and
``mamba.w_out`` on (1, 4), at most 7.3e-7 (without the model axis: 2.7e-7
and 4.7e-7 in the same leaves).  Every leaf not split over the model
axis is bitwise the same on every model rank after every step.  One
backward of each layout holds every rank's gradient blocks against the
unsharded model's within ``rtol=1e-4`` / ``atol=1e-6``, but ``embed``
within ``EMBED_GRAD_ATOL``: its gradient reaches 5 (every position's
cotangent through the Mamba scan), and its float32 sums are that far
from exact in either order (on (1, 4) the two 2.9e-5 apart at an element
of 0.049; on (2, 2) at the launcher's scale-down, against the unsharded
model's gradient in float64, the unsharded float32 one up to 7.9e-5 off
and the tensor-parallel one 3.3e-5).  fsdp_auto, whose blocks are those
of zero1 on the same mesh, is held by the launcher's CLI: ``--mesh
2x2`` in zero1 and fsdp_auto prints the reference's losses of the same
config (its (1, 4) run) within 1e-5.
"""
import pytest

import _torch_tp_cases as C
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch.launch import train

RUNS = ("hybrid_zero1_2x2", "hybrid_zero1_1x4_sp")
#: the grad norms' tolerance, the parameters' ``atol`` and ``embed``'s
#: gradient ``atol`` (module docstring)
GNORM_TOL, ATOL, EMBED_GRAD_ATOL = 4e-5, 1e-6, 5e-5


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return C.reference(tmp_path_factory.mktemp("tp_hybrid"), RUNS)


@pytest.mark.parametrize("run", RUNS)
def test_tp_hybrid_matches_reference(ref, run, one_torch_thread):  # noqa: F811
    C.assert_run_matches(ref, run, atol=ATOL, gnorm_tol=GNORM_TOL)


@pytest.mark.parametrize("run", RUNS)
def test_tp_hybrid_grads_match_unsharded(run, one_torch_thread):  # noqa: F811
    C.assert_grads_match(run, atol={"embed": EMBED_GRAD_ATOL})


@pytest.mark.parametrize("mode", ("zero1", "fsdp_auto"))
def test_cli_prints_reference_losses(ref, mode, capsys,
                                     one_torch_thread):  # noqa: F811
    out = train.main(["--arch", C.HYBRID, "--scale-down", "--device", "cpu",
                      "--mesh", "2x2", "--mode", mode, "--steps", "3",
                      "--seq-len", str(C.SEQ), "--global-batch",
                      str(C.BATCH), "--log-every", "1"])
    want = ref["hybrid_zero1_1x4_sp/losses"][:3]
    assert max(abs(a - b) for a, b in zip(out.losses, want)) < 1e-5
    printed = [float(line.split()[3]) for line in
               capsys.readouterr().out.splitlines()
               if line.startswith("step")]
    assert printed == [round(x, 4) for x in out.losses]


@pytest.mark.parametrize("p", (2, 3, 4))
def test_pieces_regroups_a_split_concatenation(p):
    """``sharding.pieces`` of ``[x | z]`` split over p ranks gives every
    rank its own block of each half (one all-to-all a call, in the
    forward and in the backward), exactly; its backward sends each
    cotangent back to the rank that held the column."""
    import torch
    from repro_torch.comm import LocalComm
    from repro_torch.models import ShardingRecipe
    from repro_torch.models import sharding as shd
    comm = LocalComm(p)
    ax = shd.ModelAxis(comm, ShardingRecipe(tp_size=p))
    gen = torch.Generator().manual_seed(p)
    whole = torch.randn(2, 3, 4 * p, generator=gen)
    blocks = [b.clone().requires_grad_(True) for b in whole.chunk(p, -1)]
    xs, zs = shd.pieces(ax, shd.Act(blocks, "btx", "x"), "x", 2, "i")
    assert comm.natives == 1 and xs.layout == zs.layout == "i"
    for half, got in zip(whole.chunk(2, -1), (xs, zs)):
        for r, g in enumerate(got.xs):
            assert torch.equal(g, half.chunk(p, -1)[r])
    cot = torch.randn(2, 3, 4 * p, generator=gen)
    x_cot, z_cot = cot.chunk(2, -1)
    total = sum((g * c).sum() for got, half in ((xs, x_cot), (zs, z_cot))
                for g, c in zip(got.xs, half.chunk(p, -1)))
    total.backward()
    assert comm.natives == 2
    for b, c in zip(blocks, cot.chunk(p, -1)):
        assert torch.equal(b.grad, c)
