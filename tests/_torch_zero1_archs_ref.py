"""Subprocess worker: the reference's ZeRO-1 trajectories of the other
architecture families for ``test_torch_zero1_archs.py``.

The recipe of ``_torch_zero1_ref.py`` (``zero1_step`` driven directly
under ``repro.compat.shard_map`` on a ``("data",)`` mesh of 3 fake CPU
devices, ``recipe=None``, ``check_vma=False``, the launcher's AdamW
defaults, the exact circulant sync on the jnp backend), for
``hymba-1.5b``, ``xlstm-125m`` and ``whisper-small``, each scaled down,
seq 16 (whisper: 16 frames, 8 decoder tokens), global batch 3, ``STEPS``
steps.  Writes ``<out.npz>``: per arch its initial parameters
(``<arch>/init/<path>``, a list index a path key of its own), per-step
losses (``<arch>/losses``) and the parameters after the last step
(``<arch>/final/<path>``).

Run: python tests/_torch_zero1_archs_ref.py <out.npz>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_zero1_ref import _flat, train  # noqa: E402  (sets XLA_FLAGS)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import build  # noqa: E402
from repro.optim.zero1 import GradSyncConfig  # noqa: E402

#: (= test_torch_zero1_archs.ARCHS, STEPS)
ARCHS, STEPS = ("hymba-1.5b", "xlstm-125m", "whisper-small"), 3


def main(dst):
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).scaled_down()
        model = build(cfg, recipe=None)
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        out.update(_flat(f"{arch}/init/", params))
        losses, final = train(model, cfg, params,
                              GradSyncConfig(use_fused_kernel=False), 3,
                              steps=STEPS)
        out.update(_flat(f"{arch}/final/", final))
        out[f"{arch}/losses"] = np.asarray(losses, np.float64)
        print("REFERENCE OK", arch, losses)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1])
