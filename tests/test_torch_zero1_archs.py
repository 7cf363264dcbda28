"""The port's ZeRO-1 training of the other architecture families against
the reference's.

The reference's ``zero1_step`` is driven directly under
``repro.compat.shard_map`` on 3 fake CPU devices (subprocess worker
``_torch_zero1_archs_ref.py``, the recipe of ``_torch_zero1_ref.py``);
its initial weights are carried into the port with
``repro_torch.convert``, and the port trains the same 3 steps at p = 3
on a ``LocalComm`` through the launcher's session builder: the hybrid
(hymba), xLSTM and encoder-decoder (whisper, whose batches carry
``frames``) families, scaled down, exact circulant sync.

Tolerances: losses within 1e-5, params within ``rtol=1e-5``; whisper
within ``test_torch_zero1.py``'s exact run's ``atol=1e-9``, hymba and
xLSTM within ``atol=1e-6``, a 45th of the last step's learning rate,
below any flipped update.  Their recurrent mixers differ from the
reference's in more than summation order (the Mamba scan's association,
the sLSTM's 16 sequential steps); both sides' step-0 gradients agree
within 1.1e-7 at 1e-3 magnitudes, but where a gradient element is small
AdamW's ``m / sqrt(v)`` magnifies that, and leaves that start at zero
(the biases) end as sums of about ``±lr`` updates that nearly cancel,
where ``rtol`` bounds nothing.  Observed beyond ``atol=1e-9``: xLSTM 61
of 62,472 elements, all in the sLSTM's zero-initialized ``bias``, at
most 9.3e-8 apart; hymba 2 of 153,920, one in ``dt_bias``
(zero-initialized, 2.6e-9 apart) and one in ``w_B`` (1.05e-8 apart at
3.0e-4); whisper none.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import tree as T
from repro_torch.convert import params_to_numpy
from repro_torch.optim.zero1 import is_zero_leaf
from test_torch_zero1 import _assert_params_close, _train
from _torch_arch_cases import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
#: (= _torch_zero1_archs_ref.ARCHS, STEPS)
ARCHS, STEPS = ("hymba-1.5b", "xlstm-125m", "whisper-small"), 3
#: params' ``atol`` per family (see the module docstring)
ATOL = {"hymba-1.5b": 1e-6, "xlstm-125m": 1e-6, "whisper-small": 1e-9}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero1_archs") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_zero1_archs_ref.py"),
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    z = np.load(out)

    def tree(prefix):
        return T.unflatten(
            (tuple(int(x) if x.isdigit() else x
                   for x in k[len(prefix):].split("/")), z[k])
            for k in z.files if k.startswith(prefix))

    return {arch: (tree(f"{arch}/init/"), z[f"{arch}/losses"],
                   tree(f"{arch}/final/")) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_trajectory_matches_reference(reference, arch):
    """3 steps at p = 3: losses, every rank's params (the ranks bitwise
    equal), ``ceil_log2(3) = 2`` exchanges per RS and per AG of every
    zero leaf per step."""
    init, ref_losses, ref_final = reference[arch]
    sess, losses = _train(init, "zero1", arch=arch, steps=STEPS)
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-5)
    finals = [params_to_numpy(p) for p in sess.params]
    for final in finals:
        _assert_params_close(final, ref_final, atol=ATOL[arch])
    for final in finals[1:]:
        for a, b in zip(T.leaves(final), T.leaves(finals[0])):
            np.testing.assert_array_equal(a, b)
    n_zero = sum(is_zero_leaf(a.shape, 3, 1024) for a in T.leaves(init))
    assert n_zero > 0
    assert sess.comm.exchanges == STEPS * n_zero * 2 * 2
