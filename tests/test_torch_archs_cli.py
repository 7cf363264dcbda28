"""The launchers on the other architecture families, on the CPU, in
process: ``python -m repro_torch.launch.train`` trains the hybrid, the
encoder-decoder, the xLSTM and the VLM families in zero1 over 3 virtual
ranks (the VLM's one group stacks its leaves ``(1, ...)``: ZeRO-1 pads
that dim to 3 as the reference does), and
``python -m repro_torch.launch.serve`` serves the xLSTM, the
encoder-decoder with encoder frames and the VLM with image embeddings,
drawn after the prompts from ``default_rng(0)`` as the reference's
launcher draws them.  The refusals the reference makes stay: prefill
extras with ``--max-batch`` or ``--replicas``, and the paged scheduler
over a cache that is not attention-only (the hybrid's Mamba state, the
xLSTM's recurrent states).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.launch import bootstrap, serve, train
from repro_torch.serve import Scheduler
from _torch_arch_cases import one_torch_thread  # noqa: F401

TRAIN = ["--scale-down", "--device", "cpu", "--mesh", "3x1", "--mode",
         "zero1", "--steps", "2", "--seq-len", "16", "--global-batch", "3",
         "--log-every", "1"]
SERVE = ["--scale-down", "--device", "cpu", "--batch", "2", "--prompt-len",
         "8", "--max-new", "4"]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-small",
                                  "xlstm-125m", "llama-3.2-vision-90b"])
def test_train_cli_other_families(arch):
    seen = []
    run = train.main(["--arch", arch, *TRAIN],
                     on_step=lambda step, sess, m: seen.append(
                         sorted(sess.pipe.batch_at(step))))
    assert len(run.losses) == 2
    assert all(math.isfinite(x) for x in run.losses)
    assert all(x > 0 for x in run.sync_exchanges)
    if arch == "whisper-small":
        assert seen[0] == ["frames", "targets", "tokens"]
    if arch == "llama-3.2-vision-90b":
        assert seen[0] == ["image_embeds", "targets", "tokens"]


@pytest.mark.parametrize("arch,extra", [
    ("xlstm-125m", None), ("whisper-small", "frames"),
    ("llama-3.2-vision-90b", "image_embeds")])
def test_serve_cli_other_families(arch, extra):
    run = serve.main(["--arch", arch, *SERVE])
    cfg = run.session.cfg
    assert run.tokens.shape == (2, 4)
    assert run.tokens.min() >= 0 and run.tokens.max() < cfg.vocab_size
    prompts, extras = serve.prompts_and_extras(cfg, 2, 8)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(prompts,
                                  rng.integers(0, cfg.vocab_size, (2, 8)))
    np.testing.assert_array_equal(run.prompts, prompts)
    if extra is None:
        assert not extras
    else:
        rows = 8 if extra == "frames" else cfg.n_image_tokens
        assert list(extras) == [extra]
        np.testing.assert_array_equal(
            extras[extra],
            rng.standard_normal((2, rows, cfg.d_model)).astype(np.float32))
    # the launcher's tokens are the engine's greedy tokens on those inputs
    again = run.session.engine.generate(prompts, 4, extras=extras)
    np.testing.assert_array_equal(again, run.tokens)
    assert run.session.engine.timings["cache_bytes"] > 0


@pytest.mark.parametrize("arch,extra", [
    ("whisper-small", ["--max-batch", "2", "--kv-block-size", "4"]),
    ("llama-3.2-vision-90b", ["--replicas", "2"])])
def test_serve_cli_refuses_extras_with_scheduler_or_replicas(arch, extra):
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, *SERVE, *extra])


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_scheduler_refuses_non_attention_caches(arch):
    sess = bootstrap.build_serve_session(arch=arch, max_len=12,
                                         scale_down=True, device="cpu")
    with pytest.raises(NotImplementedError):
        sched = Scheduler(sess.engine, max_batch=2, kv_block_size=4)
        sched.submit(np.zeros(8, np.int32), 4)
        sched.run()


def test_serve_session_extras_reach_prefill():
    """``ServeEngine.prefill_fn`` hands ``frames`` to the model's prefill
    on the parameters' device."""
    sess = bootstrap.build_serve_session(arch="whisper-small", max_len=12,
                                         scale_down=True, device="cpu")
    cfg = sess.cfg
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    frames = np.ones((1, 8, cfg.d_model), np.float32)
    cache, logits = sess.engine.prefill_fn(sess.params, tokens,
                                           {"frames": frames})
    assert logits.shape == (1, cfg.vocab_size)
    assert tuple(cache["mem_k"].shape[:3]) == (cfg.n_layers, 1, 8)
