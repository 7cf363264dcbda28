"""The xLSTM's mixers (mLSTM, sLSTM) of the port against the reference's,
float32, with ``test_torch_ssm.py``'s inputs, helpers and tolerances:
forward with S over two chunks and below one, each with and without an
incoming state, and the decode steps.
"""
import pytest

from repro.models import ssm as rssm
from repro_torch.models import ssm as pssm
from _torch_arch_cases import one_torch_thread  # noqa: F401
from test_torch_ssm import B, XLSTM, _both, _check, _params, _state, _x


def _mlstm_state(seed=4):
    h, dh = XLSTM.n_heads, XLSTM.head_dim
    return _state(rssm.MLSTMState, [(B, h, dh, dh), (B, h, dh)], seed)


def _slstm_state(seed=5):
    shp = (B, XLSTM.n_heads, XLSTM.head_dim)
    return _state(rssm.SLSTMState, [shp] * 4, seed)


@pytest.mark.parametrize("s", [16, 5], ids=["chunks", "below"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "state"])
def test_mlstm_forward_matches_reference(s, with_state):
    params = _params(rssm.init_mlstm, XLSTM)
    state = _mlstm_state() if with_state else None
    _check(*_both(
        lambda p, x, st: rssm.mlstm_forward(p, XLSTM, x, state=st),
        lambda p, x, st: pssm.mlstm_forward(p, XLSTM, x, state=st),
        params, _x(s, cfg=XLSTM), state))


@pytest.mark.parametrize("s", [16, 5], ids=["long", "short"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "state"])
def test_slstm_forward_matches_reference(s, with_state):
    params = _params(rssm.init_slstm, XLSTM)
    state = _slstm_state() if with_state else None
    _check(*_both(
        lambda p, x, st: rssm.slstm_forward(p, XLSTM, x, state=st),
        lambda p, x, st: pssm.slstm_forward(p, XLSTM, x, state=st),
        params, _x(s, cfg=XLSTM), state))


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_xlstm_decode_steps_match_reference(mixer):
    init = getattr(rssm, f"init_{mixer}")
    state = _mlstm_state() if mixer == "mlstm" else _slstm_state()
    ref_fn = getattr(rssm, f"{mixer}_decode_step")
    port_fn = getattr(pssm, f"{mixer}_decode_step")
    _check(*_both(lambda p, x, st: ref_fn(p, XLSTM, x, st),
                  lambda p, x, st: port_fn(p, XLSTM, x, st),
                  _params(init, XLSTM), _x(1, cfg=XLSTM), state))
