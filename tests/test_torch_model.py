"""The port's dense decoder against the reference's.

Weights are initialized by the JAX package and carried across with
``repro_torch.convert``; ``qwen3-1.7b`` scaled down, float32.
Tolerances: loss within 1e-5 absolute, gradients within ``rtol=1e-4,
atol=1e-6`` — the two sides compute the same expressions but their
float32 matmuls and reductions sum in different orders.  Flash attention
(chunked online softmax, plain code on both sides) is held at a sequence
length above ``FLASH_THRESHOLD`` with small widths and chunks, forward
within 2e-6 and its input gradients within ``rtol=1e-4, atol=1e-6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import for_model
from repro.models import build
from repro.models.flash import flash_attention as jax_flash
from repro_torch import tree as T
from repro_torch.configs import get_config as port_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build as port_build, value_and_grad
from repro_torch.models.attention import FLASH_THRESHOLD
from repro_torch.models.flash import flash_attention
from repro_torch.models.transformer import init_params, param_shapes


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-1.7b").scaled_down()
    model = build(cfg, recipe=None)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    return cfg, model, jax.tree.map(np.asarray, params)


def _both(setup, seq, batch):
    cfg, model, np_params = setup
    data = for_model(cfg, seq_len=seq, global_batch=batch).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        jax.tree.map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in data.items()})
    pcfg = port_config("qwen3-1.7b").scaled_down()
    tp = params_from_numpy(np_params, pcfg)
    tl, tg = value_and_grad(port_build(pcfg).loss)(
        tp, {k: torch.from_numpy(v) for k, v in data.items()})
    return float(loss), jax.tree.map(np.asarray, grads), float(tl), tg


def test_config_is_the_reference_config():
    assert vars(port_config("qwen3-1.7b")) == vars(get_config("qwen3-1.7b"))
    small = get_config("qwen3-1.7b").scaled_down()
    assert vars(port_config("qwen3-1.7b").scaled_down()) == vars(small)
    assert port_config("qwen3-1.7b").param_count() == \
        get_config("qwen3-1.7b").param_count()


def test_param_tree_matches_reference(setup):
    cfg, _, np_params = setup
    want = {p: a.shape for p, a in T.flatten(np_params)}
    got = dict(T.flatten(param_shapes(port_config("qwen3-1.7b").scaled_down())))
    assert got == want


@pytest.mark.parametrize("seq,batch", [(16, 2), (FLASH_THRESHOLD + 64, 1)],
                         ids=["sdpa", "flash"])
def test_loss_and_grads_match_reference(setup, seq, batch):
    loss, grads, tl, tg = _both(setup, seq, batch)
    assert abs(tl - loss) <= 1e-5, (tl, loss)
    for (path, a), (_, b) in zip(T.flatten(grads),
                                 T.flatten(params_to_numpy(tg))):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                   err_msg=".".join(path))


@pytest.mark.parametrize("window", [0, 300])
def test_flash_attention_matches_reference(window):
    rng = np.random.default_rng(7)
    s = FLASH_THRESHOLD + 512
    q = rng.standard_normal((1, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, s, 2, 16)).astype(np.float32)
    w = rng.standard_normal((1, s, 4, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, chunk_q=256, chunk_k=512)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, **kw) * w)

    jout = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=2e-6)
    tgrads = torch.autograd.grad((tout * torch.from_numpy(w)).sum(),
                                 (tq, tk, tv))
    for a, b in zip(jgrads, tgrads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6)


def test_port_init_statistics():
    """The port's own initializers (used on the card, where JAX is absent)
    follow the reference's: ones for norms, N(0, 0.02) embedding,
    truncated normal with std fan_in**-0.5 (per-layer fan-in), cut at 2
    std."""
    cfg = port_config("qwen3-1.7b").scaled_down(d_model=256, d_ff=512)
    gen = torch.Generator().manual_seed(0)
    p = init_params(cfg, gen)
    assert torch.equal(p["layers"]["norm1"], torch.ones(2, 256))
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    wq = p["layers"]["attn"]["wq"]          # (L, d, H, dh): fan-in d
    std = 256 ** -0.5 * 0.8796              # std of N(0,1) cut at +-2
    assert abs(wq.std().item() - std) < 0.05 * std
    assert wq.abs().max().item() <= 2 * 256 ** -0.5 + 1e-6
    wo = p["layers"]["attn"]["wo"]          # (L, H, dh, d): fan-in H
    assert wo.abs().max().item() <= 2 * cfg.n_heads ** -0.5 + 1e-6
