"""``--mode fsdp_auto`` of the port against the reference's
``build_fsdp_auto``.

The reference side is ``repro.train.steps.build("fsdp_auto", ...)`` on
a ``jax.sharding.Mesh`` of 4 fake CPU devices, its parameters placed by
their sanitized ``param_specs`` (subprocess worker ``_torch_tp_ref.py``,
one spawn for this file), from the port's launcher's seed-0 parameters.
Scaled-down qwen1.5-110b, which fsdp_auto trains ``tp_fsdp`` by the
reference's rule (its QKV bias, every weight also split over the data
axis on its FSDP dim and gathered a layer at a time), on (2, 2), and on
(1, 4) sequence-parallel; seq 16, global batch 4, 4 steps.  Tolerances
as ``test_torch_tp.py``'s: losses and grad norms 1e-5, the parameters
gathered whole ``rtol=1e-5`` / ``atol=5e-9`` (QKV bias's ``bk``: ``1e-7``; ``_torch_tp_cases.py`` says why), replicated leaves bitwise
across model ranks after every step, one backward's gradient blocks
against the unsharded model's (the data ranks' sum for a leaf split over
them) ``rtol=1e-4`` / ``atol=1e-6``.  The launcher's ``--mode
fsdp_auto`` on qwen3-1.7b (recipe mode ``tp``) prints the reference's
losses, and runs at ``--mesh 2x1``; ``--ckpt-dir`` with it is refused,
citing ROADMAP item 11.2.
"""
import pytest

import _torch_tp_cases as C
from _torch_arch_cases import one_torch_thread  # noqa: F401
from repro_torch.launch import train

RUNS = ("fsdp_2x2_tp_fsdp", "fsdp_1x4_tp_fsdp")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return C.reference(tmp_path_factory.mktemp("fsdp"), RUNS)


@pytest.mark.parametrize("run", RUNS)
def test_fsdp_auto_matches_reference(ref, run, one_torch_thread):  # noqa: F811
    C.assert_run_matches(ref, run)


@pytest.mark.parametrize("run", RUNS)
def test_fsdp_grads_match_unsharded(run, one_torch_thread):  # noqa: F811
    C.assert_grads_match(run)


def test_fsdp_auto_gathers_each_layer_again_under_remat(
        one_torch_thread):  # noqa: F811
    """The data axis's allgathers of one step: every data-split leaf's
    block gathered in the forward and again in its layer's recompute,
    each gather's backward one reduce-scatter."""
    sess = C.session("fsdp_2x2_tp_fsdp")
    sess.params = sess.model.init(__import__("torch").Generator()
                                  .manual_seed(0), sess.device)
    sess.opt = sess.built.init_opt(sess.params)
    from repro_torch import tree as T
    lls = T.flatten(sess.tp.layout.leaves)
    top = sum(ll.data is not None for p, ll in lls if p[0] != "layers")
    per_layer = sum(ll.data is not None for p, ll in lls
                    if p[0] == "layers")
    assert top and per_layer
    n0 = sess.comm.natives
    from repro_torch.launch import bootstrap
    bootstrap.run_step(sess, 0)
    # gathers: top once, layers twice (forward, recompute); their
    # backwards: one reduce-scatter each; then the all-reduces of the
    # leaves not split over data, the norm's fold and the loss's
    not_split = sum(ll.data is None for _, ll in lls)
    layers = sess.cfg.n_layers
    want = (top + 2 * per_layer * layers) + (top + per_layer * layers) \
        + not_split + 2
    assert sess.comm.natives - n0 == want


def test_cli_fsdp_auto_prints_reference_losses(ref, one_torch_thread):  # noqa: F811
    """qwen3-1.7b fsdp_auto (recipe mode ``tp``) on 2x2 and 2x1: the
    reference's TP losses of qwen1.5-110b do not apply, so the launcher's
    zero1 run of the same argv is the yardstick, itself held against the
    reference in ``test_torch_tp.py``."""
    argv = ["--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
            "--steps", "3", "--seq-len", str(C.SEQ), "--global-batch",
            str(C.BATCH)]
    zero1 = train.main(argv + ["--mesh", "2x2"]).losses
    for mesh in ("2x2", "2x1"):
        got = train.main(argv + ["--mesh", mesh, "--mode", "fsdp_auto"])
        assert max(abs(a - b) for a, b in zip(got.losses, zero1)) < 1e-5


def test_ckpt_with_fsdp_auto_refused(tmp_path):
    with pytest.raises(SystemExit, match="item 11.2"):
        train.build(["--arch", "qwen3-1.7b", "--scale-down", "--device",
                     "cpu", "--mesh", "2x1", "--mode", "fsdp_auto",
                     "--ckpt-dir", str(tmp_path)])
