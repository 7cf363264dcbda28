"""The port's per-sequence MoE dispatch (``moe_dispatch="rowwise"``)
against the reference's ``moe_ffn_rowwise``.

Same seeded numpy inputs through both packages (the reference in
process: its stages under ``jax.vmap`` need no mesh).  Tolerances are
``test_torch_moe.py``'s, for the same reasons (float32 router softmax
and expert matmuls sum in different orders in torch and XLA): outputs
within ``2e-5``, aux losses within ``1e-6``, gradients within ``rtol=1e-4,
atol=1e-6``, the scaled-down model's loss within 1e-5.  Within the port,
each sequence's rows are bitwise ``moe_ffn_global`` applied to that
sequence alone (the pools are the sequences), and a batch of one is
bitwise the global dispatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import for_model
from repro.models import build
from repro.models import dispatch as ref_dispatch
from repro.models.config import ModelConfig as RefConfig
from repro_torch import tree as T
from repro_torch.configs import get_config as port_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import train
from repro_torch.models import build as port_build, value_and_grad
from repro_torch.models import dispatch
from repro_torch.models.config import ModelConfig

LEAVES = ("router", "w_gate", "w_up", "w_down")
D, FF, E, S = 16, 32, 4, 24
#: case -> (batch, capacity factor); 0.5 drops tokens in every sequence
CASES = {"b1": (1, 4.0), "b3": (3, 4.0), "b1_drops": (1, 0.5),
         "b3_drops": (3, 0.5)}


def _cfg(cls, cf):
    return cls(name="t", family="moe", n_layers=1, d_model=D, n_heads=2,
               n_kv_heads=2, d_ff=FF, vocab_size=64, head_dim=8, n_experts=E,
               experts_per_token=2, capacity_factor=cf, dtype="float32",
               moe_dispatch="rowwise")


def _inputs(case):
    b, _ = CASES[case]
    rng = np.random.default_rng(300 + sorted(CASES).index(case))
    params = {"router": 0.5 * rng.standard_normal((D, E)),
              "w_gate": rng.standard_normal((E, D, FF)) / 4,
              "w_up": rng.standard_normal((E, D, FF)) / 4,
              "w_down": rng.standard_normal((E, FF, D)) / 6}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((b, S, D)).astype(np.float32)
    w = rng.standard_normal((b, S, D)).astype(np.float32)
    return params, x, w


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _reference(case):
    params, x, w = _inputs(case)
    cfg = _cfg(RefConfig, CASES[case][1])

    def f(p, x):
        o, a = ref_dispatch.moe_ffn_rowwise(p, cfg, x)
        return jnp.sum(o * w) + a, (o, a)

    (_, (o, a)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return (np.asarray(o), float(a),
            {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx))


@pytest.mark.parametrize("case", sorted(CASES))
def test_rowwise_matches_reference(case):
    params, x, w = _inputs(case)
    cfg = _cfg(ModelConfig, CASES[case][1])
    ps = {k: _t(v, True) for k, v in params.items()}
    xt = _t(x, True)
    o, a = dispatch.moe_ffn_rowwise(ps, cfg, xt)
    ((o * _t(w)).sum() + a).backward()
    jo, ja, jgp, jgx = _reference(case)
    np.testing.assert_allclose(o.detach().numpy(), jo, rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(a.detach()), ja, rtol=0, atol=1e-6)
    for k in LEAVES:
        np.testing.assert_allclose(ps[k].grad.numpy(), jgp[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), jgx, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rowwise_is_global_per_sequence(case):
    """Each sequence is its own pool: its rows are bitwise the global
    dispatch of that sequence alone (capacity ``capacity(cfg, S)``), and
    the drop cases really drop."""
    params, x, _ = _inputs(case)
    b, cf = CASES[case]
    cfg = _cfg(ModelConfig, cf)
    ps = {k: _t(v) for k, v in params.items()}
    o, a = dispatch.moe_ffn_rowwise(ps, cfg, _t(x))
    cap = dispatch.capacity(cfg, S)
    dropped = 0
    for i in range(b):
        g, _ = dispatch.moe_ffn_global(ps, cfg, _t(x[i:i + 1]))
        assert torch.equal(o[i:i + 1], g), i
        _, idx, _ = dispatch.route(ps["router"], cfg, _t(x[i]))
        dropped += int(torch.clamp(torch.bincount(idx.reshape(-1),
                                                  minlength=E) - cap,
                                   min=0).sum())
    assert (dropped > 0) == (cf < 1), dropped
    if b == 1:
        assert a == dispatch.moe_ffn_global(ps, cfg, _t(x))[1]


def test_scaled_down_model_loss_and_grads_match_reference():
    name = "phi3.5-moe-42b-a6.6b"
    cfg = get_config(name).scaled_down(moe_dispatch="rowwise")
    model = build(cfg, recipe=None)
    np_params = jax.tree.map(np.asarray,
                             jax.jit(model.init)(jax.random.PRNGKey(0)))
    data = for_model(cfg, seq_len=16, global_batch=3).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        jax.tree.map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in data.items()})
    pcfg = port_config(name).scaled_down(moe_dispatch="rowwise")
    tl, tg = value_and_grad(port_build(pcfg).loss)(
        params_from_numpy(np_params, pcfg),
        {k: torch.from_numpy(v) for k, v in data.items()})
    assert abs(float(tl) - float(loss)) <= 1e-5, (float(tl), float(loss))
    for (path, a), (_, b) in zip(T.flatten(jax.tree.map(np.asarray, grads)),
                                 T.flatten(params_to_numpy(tg))):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                   err_msg=".".join(path))


def test_launcher_trains_rowwise_in_zero1():
    """``--moe-dispatch rowwise`` is no longer refused: two sequences per
    rank on a 2x1 mesh, zero1."""
    run = train.main(["--arch", "phi3.5-moe-42b-a6.6b", "--scale-down",
                      "--device", "cpu", "--mesh", "2x1", "--mode", "zero1",
                      "--moe-dispatch", "rowwise", "--steps", "2",
                      "--seq-len", "16", "--global-batch", "4"])
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
