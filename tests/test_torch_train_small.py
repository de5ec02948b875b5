"""``examples/train_small_torch.py`` against the JAX demo
``examples/train_small.py`` on the CPU.

The port's demo starts from the JAX demo's own weights
(``M.init_params(cfg, jax.random.key(0))``, carried across through
``repro_torch.models.bridge``), trains on the same zipfian batches with
the same schedule, two microbatches and CE chunks, and its first five
losses must match the JAX demo's within 1e-4 (float32).  A resume from
the checkpoint gives the loss the state in memory gives on the resumed
run's batch, and the configs are the reference's.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.training import (
    AdamWConfig as JAdamW,
    TrainStepConfig as JTrainStepConfig,
    init_opt_state as j_init_opt_state,
    make_train_step as j_make_train_step,
    wsd_schedule as j_wsd_schedule,
)
from repro_torch.models.bridge import params_from_jax
from repro_torch.training._tree import leaves, unflatten

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import train_small as J  # noqa: E402  the JAX demo
import train_small_torch as T  # noqa: E402  its twin

STEPS, BATCH, SEQ = 60, 8, 128  # the JAX demo's defaults
FIRST = 5
TOL = 1e-4


def jax_losses(n: int):
    """The JAX demo's first ``n`` losses (its loop, ``train_small.py:
    69-110``), and its initial weights as numpy."""
    cfg = J.model_config(False)
    params = JM.init_params(cfg, jax.random.key(0))
    start = jax.tree.map(np.asarray, params)
    opt = j_init_opt_state(params)
    tcfg = JTrainStepConfig(adamw=JAdamW(lr=6e-4), microbatches=2,
                            ce_chunk=min(128, SEQ))
    sched = j_wsd_schedule(STEPS // 10 + 1, STEPS // 2, STEPS // 2, 6e-4)
    step = jax.jit(j_make_train_step(cfg, tcfg, sched))
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        base = rng.zipf(1.5, (BATCH, SEQ)).clip(1, cfg.vocab_size - 1)
        toks = jnp.asarray(base, jnp.int32)
        labels = jnp.roll(toks, -1, 1).at[:, -1].set(-100)
        params, opt, m = step(params, opt, {"tokens": toks,
                                            "labels": labels})
        out.append(float(m["loss"]))
    return out, start


@pytest.fixture(scope="module")
def reference():
    return jax_losses(FIRST)


def test_configs_are_the_reference_demos():
    for full in (False, True):
        want = dataclasses.asdict(J.model_config(full))
        got = dataclasses.asdict(T.model_config(full))
        assert got == want, full
    assert T.model_config(False).head_dim == 32
    assert T.model_config(False).dtype == "float32"


def test_first_losses_match_the_jax_demo(reference):
    """The demo's step (its 60-step schedule) on its batches."""
    want, start = reference
    cfg = T.model_config(False)
    step = T.make_step(cfg, STEPS, SEQ)
    params = params_from_jax(start, device="cpu")
    opt = T.init_opt_state(params)
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(FIRST):
        params, opt, m = step(params, opt, T.zipf_batch(
            rng, BATCH, SEQ, cfg.vocab_size, "cpu"))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=0, atol=TOL)
    assert losses[-1] < losses[0]


def test_a_resume_continues_from_the_checkpoint(reference, tmp_path):
    """Three steps, then a resumed run of four: its step 4 is the step
    the in-memory state takes on the batch the resumed run draws (the
    first of a fresh ``default_rng(1)``, as in the reference demo)."""
    _, start = reference
    cfg = T.model_config(False)
    ck = str(tmp_path / "ck")
    logged = []
    params, opt, first = T.train(cfg, params_from_jax(start, device="cpu"),
                                 steps=3, batch=4, seq=64, ckpt_dir=ck,
                                 device="cpu", log=logged.append)
    assert len(first) == 3
    kept = [t.clone() for t in leaves(params) + leaves(opt)]
    _, _, resumed = T.train(cfg, params_from_jax(start, device="cpu"),
                            steps=4, batch=4, seq=64, ckpt_dir=ck,
                            device="cpu", log=logged.append)
    assert "resumed from checkpoint at step 3" in logged
    assert len(resumed) == 1
    n = len(leaves(params))
    p, o = unflatten(params, kept[:n]), unflatten(opt, kept[n:])
    step = T.make_step(cfg, 4, 64)
    batch = T.zipf_batch(np.random.default_rng(1), 4, 64, cfg.vocab_size,
                         "cpu")
    _, _, m = step(p, o, batch)
    assert float(m["loss"]) == resumed[0]


def test_main_runs_on_the_cpu(tmp_path, capsys):
    T.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "demo-8m" in out and "done; checkpoints retained: [2]" in out


def test_the_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "ck")])
