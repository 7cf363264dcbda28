"""The port's sequence mixers (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), float32: Mamba here, the xLSTM's
mLSTM and sLSTM in ``test_torch_ssm_xlstm.py`` (on this file's helpers).

The same seeded numpy weights, inputs, incoming states and output
cotangents go through both.  Mamba's forward is held with S a multiple
of the chunk (16 over chunks of 8), below the chunk (5) and odd (15,
where ``_pick_chunk`` falls to chunks of 5), each with and without an
incoming state; its decode step, and the mLSTM's and sLSTM's forward
(chunked over two chunks, and below one) and decode, likewise.  Outputs
and final states within 1e-5 absolute; the gradients of ``mean(out *
cotangent)`` (a loss's scale: the models' losses are means over tokens)
with respect to the input, the parameters and the incoming state within
``rtol=1e-4, atol=1e-6``.  The two sides' scans associate
differently (the port's log-depth scan is Hillis-Steele, XLA's
``associative_scan`` odd-even), and XLA contracts ``a2*b1 + b2`` into an
FMA, so agreement is to a tolerance, not bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import ssm as rssm
from repro_torch.models import ssm as pssm
from _torch_arch_cases import one_torch_thread  # noqa: F401

HYMBA = get_config("hymba-1.5b").scaled_down()
XLSTM = get_config("xlstm-125m").scaled_down()
B = 2


def _params(init, cfg, seed=0):
    p = init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    # perturb the constant leaves so every parameter's gradient matters
    return {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in p.items()}


def _state(cls, shapes, seed):
    rng = np.random.default_rng(seed)
    return cls(*(rng.standard_normal(s).astype(np.float32) for s in shapes))


def _both(ref_fn, port_fn, params, x, state, cot_seed=1):
    """Outputs, final states and gradients (input, params, state) of
    ``mean(out * cotangent)`` on both sides."""
    rng = np.random.default_rng(cot_seed)

    def ref_loss(p, xx, st):
        out, new = ref_fn(p, xx, st)
        return jnp.mean(out * cot), (out, new)

    out_shape = jax.eval_shape(
        lambda p, xx, st: ref_fn(p, xx, st)[0],
        params, x, state).shape
    cot = rng.standard_normal(out_shape).astype(np.float32)
    (_, (r_out, r_new)), r_grads = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        None if state is None else jax.tree.map(jnp.asarray, state))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    tst = None if state is None else type(state)(
        *(torch.tensor(np.asarray(s), requires_grad=True) for s in state))
    p_out, p_new = port_fn(tp, tx, tst)
    (p_out * torch.from_numpy(cot)).mean().backward()
    p_grads = ({k: v.grad for k, v in tp.items()}, tx.grad,
               None if tst is None else [s.grad for s in tst])
    return (r_out, r_new, r_grads), (p_out, p_new, p_grads)


def _check(ref, port):
    (r_out, r_new, (rgp, rgx, rgs)), (p_out, p_new, (pgp, pgx, pgs)) = \
        ref, port
    np.testing.assert_allclose(p_out.detach().numpy(), np.asarray(r_out),
                               rtol=0, atol=1e-5)
    for name, a, b in zip(r_new._fields, r_new, p_new):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(pgx.numpy(), np.asarray(rgx), rtol=1e-4,
                               atol=1e-6, err_msg="d input")
    for k in rgp:
        np.testing.assert_allclose(pgp[k].numpy(), np.asarray(rgp[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    if pgs is not None:
        for name, a, b in zip(r_new._fields, rgs, pgs):
            if b is None:   # a field the output does not depend on
                assert not np.any(np.asarray(a)), name
                continue
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-6, err_msg=f"d state.{name}")


def _x(s, seed=2, cfg=HYMBA):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


def _mamba_state(seed=3):
    d_in = HYMBA.ssm_expand * HYMBA.d_model
    return _state(rssm.MambaState, [(B, d_in, HYMBA.ssm_state),
                                    (B, HYMBA.ssm_conv - 1, d_in)], seed)


@pytest.mark.parametrize("s", [16, 5, 15], ids=["chunks", "below", "odd"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "state"])
def test_mamba_forward_matches_reference(s, with_state):
    assert pssm._pick_chunk(s, 8) == rssm._pick_chunk(s, 8)
    params = _params(rssm.init_mamba, HYMBA)
    state = _mamba_state() if with_state else None
    _check(*_both(
        lambda p, x, st: rssm.mamba_forward(p, HYMBA, x, chunk=8, state=st),
        lambda p, x, st: pssm.mamba_forward(p, HYMBA, x, chunk=8, state=st),
        params, _x(s), state))


def test_mamba_decode_step_matches_reference():
    params = _params(rssm.init_mamba, HYMBA)
    _check(*_both(
        lambda p, x, st: rssm.mamba_decode_step(p, HYMBA, x, st),
        lambda p, x, st: pssm.mamba_decode_step(p, HYMBA, x, st),
        params, _x(1), _mamba_state()))


def test_mamba_scan_chunk_is_the_sequential_recurrence():
    """The log-depth scan equals ``h_t = a_t h_{t-1} + b_t`` step by step
    (float64, so only the association differs), at lengths that are and
    are not powers of two."""
    rng = np.random.default_rng(0)
    for L in (1, 2, 7, 8, 13):
        a = torch.from_numpy(rng.uniform(0.2, 1.0, (2, L, 3, 4)))
        b = torch.from_numpy(rng.standard_normal((2, L, 3, 4)))
        h0 = torch.from_numpy(rng.standard_normal((2, 3, 4)))
        h_all, h_last = pssm._ssm_scan_chunk(a, b, h0)
        h = h0
        for t in range(L):
            h = a[:, t] * h + b[:, t]
            torch.testing.assert_close(h_all[:, t], h, rtol=1e-12,
                                       atol=1e-12)
        assert torch.equal(h_last, h_all[:, -1])


@pytest.mark.parametrize("name", ["mamba", "mlstm", "slstm"])
def test_shapes_and_init_states_match_reference(name):
    cfg = HYMBA if name == "mamba" else XLSTM
    ref = getattr(rssm, f"init_{name}")(jax.random.PRNGKey(0), cfg,
                                        jnp.float32)
    shapes = getattr(pssm, f"{name}_shapes")(cfg)
    assert shapes == {k: v.shape for k, v in ref.items()}
    r_state = getattr(rssm, f"{name}_init_state")(cfg, B)
    p_state = getattr(pssm, f"{name}_init_state")(cfg, B)
    assert type(p_state)._fields == type(r_state)._fields
    for a, b in zip(r_state, p_state):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
