"""The port's MoE (dispatch stages, global and expert-parallel layers,
scaled-down phi-3.5-MoE) against the reference's.

Same seeded numpy inputs through both packages.  Tolerances, and why:

* integer tables (capacity, expert choice, dispatch slots, owner, pad and
  grid tables) and pure data movement (gather, combine's two adds into
  zero per token) must be EXACT;
* float32 arithmetic (router softmax, expert matmuls) sums in different
  orders in torch and XLA: outputs within ``2e-5`` (the reference's own
  ep-vs-global tolerance, ``tests/_a2a_checks.py``), aux losses within
  ``1e-6``, gradients within ``rtol=1e-4, atol=1e-6`` (as the dense
  model's, ``test_torch_model.py``), the model loss within 1e-5.

The expert-parallel layer runs in the reference under
``repro.compat.shard_map`` on fake CPU devices (one subprocess worker,
``_torch_moe_ref.py``), differentiated inside the region: each device's
gradient is that of the sum of all devices' values.  The port's
``moe_ffn_ep`` runs on a ``LocalComm``, eager and fused (``permute_rows``'s
plain version on the CPU), with one backward of the same sum.
"""
import dataclasses
import os
import subprocess
import sys

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
from repro_torch.comm import DistComm, LocalComm
from repro_torch.configs import get_config as port_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import ceil_log2
from repro_torch.kernels import permute_rows
from repro_torch.models import build as port_build, value_and_grad
from repro_torch.models import dispatch
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params, param_shapes

HERE = os.path.dirname(os.path.abspath(__file__))
LEAVES = ("router", "w_gate", "w_up", "w_down")
D, FF = 16, 32
#: case -> (pe, experts, capacity factor, tokens (B, S), identical ranks)
CASES = {"pe2e3": (2, 3, 8.0, (1, 6), False),   # ragged ownership 2/1
         "pe4e5": (4, 5, 0.5, (2, 16), False),  # ragged 2/1/1/1, drops
         "same2": (2, 4, 8.0, (1, 8), True)}    # ranks see the same tokens


def _cfg(cls, e, cf, ep):
    return cls(name="t", family="moe", n_layers=1, d_model=D, n_heads=2,
               n_kv_heads=2, d_ff=FF, vocab_size=64, head_dim=8, n_experts=e,
               experts_per_token=2, capacity_factor=cf, dtype="float32",
               moe_dispatch="ep" if ep else "global", ep_axis="x")


def _case_inputs(case):
    pe, e, cf, (b, s), same = CASES[case]
    rng = np.random.default_rng(100 + sorted(CASES).index(case))
    params = {"router": 0.5 * rng.standard_normal((D, e)),
              "w_gate": rng.standard_normal((e, D, FF)) / 4,
              "w_up": rng.standard_normal((e, D, FF)) / 4,
              "w_down": rng.standard_normal((e, FF, D)) / 6}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((pe, b, s, D)).astype(np.float32)
    if same:
        x[:] = x[0]
    w = rng.standard_normal((pe, b, s, D)).astype(np.float32)
    return params, x, w


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    inputs = {}
    for case, (pe, e, cf, _, _) in CASES.items():
        params, x, w = _case_inputs(case)
        inputs[f"{case}/cfg"] = np.asarray([pe, e, cf, D, FF], np.float64)
        inputs.update({f"{case}/{k}": v for k, v in params.items()})
        inputs[f"{case}/x"], inputs[f"{case}/w"] = x, w
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the JAX worker sets its own device count
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_moe_ref.py"),
         str(d / "in.npz"), str(d / "out.npz")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Stages and tables
# ---------------------------------------------------------------------------

def test_stages_match_reference():
    rng = np.random.default_rng(3)
    e, n = 5, 24
    rcfg, pcfg = _cfg(RefConfig, e, 0.5, False), _cfg(ModelConfig, e, 0.5,
                                                     False)
    for tokens in (1, 2, 7, 24, 100, 4096):
        assert dispatch.capacity(pcfg, tokens) == \
            ref_dispatch.capacity(rcfg, tokens)
    x = rng.standard_normal((n, D)).astype(np.float32)
    router = rng.standard_normal((D, e)).astype(np.float32)
    jg, ji, jp = ref_dispatch.route(jnp.asarray(router), rcfg, jnp.asarray(x))
    g, i, p = dispatch.route(_t(router), pcfg, _t(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        float(dispatch.aux_loss(pcfg, _t(np.asarray(jp)), i)),
        float(ref_dispatch.aux_loss(rcfg, jp, ji)), rtol=0, atol=1e-7)
    cap = dispatch.capacity(pcfg, n)   # 8 slots for ~10 tokens: drops
    jst, jsg, jr = ref_dispatch.dispatch_tables(rcfg, ji, jg, cap)
    st, sg, r = dispatch.dispatch_tables(pcfg, _t(np.asarray(ji)),
                                         _t(np.asarray(jg)), cap)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(sg.numpy(), np.asarray(jsg))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert r.dtype == torch.int32 and int(r.max()) == cap
    h = dispatch.gather_tokens(_t(x), st, e, cap)
    jh = ref_dispatch.gather_tokens(jnp.asarray(x), jst, e, cap)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    w = {k: rng.standard_normal(s).astype(np.float32) / 4 for k, s in (
        ("w_gate", (e, D, FF)), ("w_up", (e, D, FF)), ("w_down", (e, FF, D)))}
    y = dispatch.expert_ffn({k: _t(v) for k, v in w.items()}, h)
    jy = ref_dispatch.expert_ffn({k: jnp.asarray(v) for k, v in w.items()},
                                 jh)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=2e-5)
    out = dispatch.combine(_t(np.asarray(jy)), st, sg, n)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref_dispatch.combine(jy, jst, jsg, n)))


def test_owner_and_grid_tables_match_reference():
    for e in range(1, 17):
        for pe in range(1, 9):
            own = dispatch.expert_owners(e, pe)
            assert own == ref_dispatch.expert_owners(e, pe)
            assert np.array_equal(
                dispatch._ep_pad_table(own, pe, max(own)),
                ref_dispatch._ep_pad_table(own, pe, max(own)))
            for a, b in zip(dispatch._ep_expert_grid(own, e),
                            ref_dispatch._ep_expert_grid(own, e)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            pcfg, rcfg = (_cfg(c, e, 1.25, True) for c in (ModelConfig,
                                                            RefConfig))
            got = dispatch.ep_collective_specs(pcfg, pe)
            want = ref_dispatch.ep_collective_specs(rcfg, pe)
            assert got[0].counts is None and want[0].counts is None
            assert got[1].counts == want[1].counts


def test_moe_ffn_global_matches_reference():
    params, x, _ = _case_inputs("pe4e5")
    rcfg, pcfg = (_cfg(c, 5, 0.5, False) for c in (RefConfig, ModelConfig))
    jo, ja = ref_dispatch.moe_ffn_global(
        {k: jnp.asarray(v) for k, v in params.items()}, rcfg,
        jnp.asarray(x[0]))
    o, a = dispatch.moe_ffn_global({k: _t(v) for k, v in params.items()},
                                   pcfg, _t(x[0]))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(a), float(ja), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The scaled-down model (global dispatch)
# ---------------------------------------------------------------------------

def test_config_and_param_tree_match_reference():
    name = "phi3.5-moe-42b-a6.6b"
    assert vars(port_config(name)) == vars(get_config(name))
    assert vars(port_config(name).scaled_down()) == \
        vars(get_config(name).scaled_down())
    model = build(get_config(name).scaled_down(), recipe=None)
    ref = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): (leaf.shape, str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    cfg = port_config(name).scaled_down(dtype="bfloat16")
    got = {p: s for p, s in T.flatten(param_shapes(cfg))}
    assert got == {p: s for p, (s, _) in want.items()}
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    assert params["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    # the router keeps float32 through the conversion as well
    tp = params_from_numpy(params_to_numpy(params), cfg)
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    assert tp["embed"].dtype == torch.bfloat16


def test_scaled_down_loss_and_grads_match_reference():
    name = "phi3.5-moe-42b-a6.6b"
    cfg = get_config(name).scaled_down()
    model = build(cfg, recipe=None)
    np_params = jax.tree.map(np.asarray,
                             jax.jit(model.init)(jax.random.PRNGKey(0)))
    data = for_model(cfg, seq_len=16, global_batch=2).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        jax.tree.map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in data.items()})
    pcfg = port_config(name).scaled_down()
    tl, tg = value_and_grad(port_build(pcfg).loss)(
        params_from_numpy(np_params, pcfg),
        {k: torch.from_numpy(v) for k, v in data.items()})
    assert abs(float(tl) - float(loss)) <= 1e-5, (float(tl), float(loss))
    for (path, a), (_, b) in zip(T.flatten(jax.tree.map(np.asarray, grads)),
                                 T.flatten(params_to_numpy(tg))):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                   err_msg=".".join(path))


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------

def _port_ep(case, fused):
    pe, e, cf, _, _ = CASES[case]
    params, x, w = _case_inputs(case)
    cfg = _cfg(ModelConfig, e, cf, True)
    ps = [{k: _t(v).clone().requires_grad_(True) for k, v in params.items()}
          for _ in range(pe)]
    xs = [_t(a).clone().requires_grad_(True) for a in x]
    comm = LocalComm(pe)
    before = permute_rows.launches
    outs, auxs = dispatch.moe_ffn_ep(ps, cfg, xs, comm,
                                     use_fused_kernel=fused)
    fwd_exchanges = comm.exchanges
    total = sum((o * _t(c)).sum() + a for o, c, a in zip(outs, w, auxs))
    total.backward()
    assert permute_rows.launches == before  # plain version on the CPU
    return outs, auxs, ps, xs, fwd_exchanges, comm.exchanges


@pytest.mark.parametrize("case", sorted(CASES))
def test_ep_matches_reference_and_global(reference, case):
    pe, e, cf, _, _ = CASES[case]
    params, x, _ = _case_inputs(case)
    q = ceil_log2(pe)
    runs = {f: _port_ep(case, f) for f in (False, True)}
    for fused, (outs, auxs, ps, xs, fwd, total) in runs.items():
        # forward: alltoallv + alltoall out + back; backward: the two
        # float alltoalls' reverse shifts (the int counts take no grad)
        assert (fwd, total) == (3 * q, 5 * q), (fused, fwd, total)
        for r in range(pe):
            np.testing.assert_allclose(
                outs[r].detach().numpy(), reference[f"{case}/out"][r],
                rtol=0, atol=2e-5)
            np.testing.assert_allclose(float(auxs[r].detach()),
                                       reference[f"{case}/aux"][r],
                                       rtol=0, atol=1e-6)
    # eager and fused are the same computation, bit for bit
    (o0, a0, p0, x0, _, _), (o1, a1, p1, x1, _, _) = runs[False], runs[True]
    for r in range(pe):
        assert torch.equal(o0[r], o1[r]) and torch.equal(a0[r], a1[r])
        assert torch.equal(x0[r].grad, x1[r].grad)
        for k in LEAVES:
            assert torch.equal(p0[r][k].grad, p1[r][k].grad)
    # ep equals global: each rank's tokens as one pool (capacity is per
    # rank's pool), and the aux loss of all ranks' tokens as one pool
    gcfg = _cfg(ModelConfig, e, cf, False)
    tparams = {k: _t(v) for k, v in params.items()}
    for r in range(pe):
        want, _ = dispatch.moe_ffn_global(tparams, gcfg, _t(x[r]))
        np.testing.assert_allclose(o0[r].detach().numpy(), want.numpy(),
                                   rtol=0, atol=2e-5)
    _, aux_all = dispatch.moe_ffn_global(
        tparams, gcfg, _t(x.reshape(-1, *x.shape[2:])))
    for r in range(pe):
        np.testing.assert_allclose(float(a0[r].detach()), float(aux_all),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ep_grads_match_reference(reference, case):
    pe = CASES[case][0]
    _, _, ps, xs, _, _ = _port_ep(case, True)
    for r in range(pe):
        np.testing.assert_allclose(xs[r].grad.numpy(),
                                   reference[f"{case}/g_x"][r],
                                   rtol=1e-4, atol=1e-6, err_msg=f"x r={r}")
        for k in LEAVES:
            np.testing.assert_allclose(ps[r][k].grad.numpy(),
                                       reference[f"{case}/g_{k}"][r],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k} r={r}")


def test_ep_owner_grads_with_identical_ranks(reference):
    """What the reference computes on a mesh's model axis, whose ranks see
    the same tokens: each owner receives pe identical copies of its slots,
    so its experts' gradients are those of ONE pool whose output feeds
    every rank's loss (pe times one rank's when, as in training, the
    ranks' losses agree), while the copies of experts it does not own get
    exactly zero (never read)."""
    pe, e, cf, _, _ = CASES["same2"]
    params, x, w = _case_inputs("same2")
    _, _, ps, _, _, _ = _port_ep("same2", False)
    gcfg = _cfg(ModelConfig, e, cf, False)
    tp = {k: _t(v).clone().requires_grad_(True) for k, v in params.items()}
    out, aux = dispatch.moe_ffn_global(tp, gcfg, _t(x[0]))
    ((out * _t(w[0])).sum() + (out * _t(w[1])).sum() + 2 * aux).backward()
    own = dispatch.expert_owners(e, pe)
    off = np.concatenate([[0], np.cumsum(own)])
    for r in range(pe):
        mine = slice(int(off[r]), int(off[r + 1]))
        for k in ("w_gate", "w_up", "w_down"):
            g = ps[r][k].grad
            want = reference[f"same2/g_{k}"][r]
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(g[mine].numpy(),
                                       tp[k].grad[mine].numpy(),
                                       rtol=1e-4, atol=1e-6)
            others = torch.ones(e, dtype=torch.bool)
            others[mine] = False
            assert not g[others].any(), (r, k)


def test_ep_refuses_dist_comm_and_single_rank_loss():
    """A ``DistComm`` needs a process world (``moe_ffn_ep`` over one,
    a rank per process, is held on gloo in
    ``test_torch_dist_train.py``); an ep model's ranks are coupled, so
    the single-rank loss raises, and an ep config needs its
    communicator."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        DistComm()
    model = port_build(dataclasses.replace(
        port_config("phi3.5-moe-42b-a6.6b").scaled_down(),
        moe_dispatch="ep"), ep_comm=LocalComm(2))
    with pytest.raises(ValueError):
        model.loss({}, {})
    with pytest.raises(ValueError):
        port_build(dataclasses.replace(
            port_config("phi3.5-moe-42b-a6.6b").scaled_down(),
            moe_dispatch="ep"))
