"""Parity probes shared by the port's serving tests
(``test_torch_serving.py``, ``test_torch_mamba.py``): a run compared bit
for bit in everything the control plane computes, and the near-argmax
replay of served tokens through the JAX model."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import model as M
from repro_torch.serving.realengine import _bucket


def assert_same_run(reqs_a, m_a, reqs_b, m_b, streams=True):
    """Everything the control plane computes, compared bit for bit (stream
    lengths too, unless one side is the token-less Sim backend)."""
    assert len(reqs_a) == len(reqs_b)
    for a, b in zip(reqs_a, reqs_b):
        assert a.rid == b.rid
        assert a.t_prefill_start == b.t_prefill_start
        assert a.t_first_token == b.t_first_token
        assert a.t_join_decode == b.t_join_decode
        assert a.t_finish == b.t_finish
        assert a.max_itl_s == b.max_itl_s
        assert a.prefill_instance == b.prefill_instance
        assert a.decode_instance == b.decode_instance
        assert a.preemptions == b.preemptions
        assert a.restarts == b.restarts
        if streams:
            assert len(a.output_tokens) == len(b.output_tokens)
    assert [e.name for e in m_a.instances] == [e.name for e in m_b.instances]
    for ea, eb in zip(m_a.instances, m_b.instances):
        assert ea.busy_j == eb.busy_j and ea.busy_s == eb.busy_s
    assert m_a.energy_j() == m_b.energy_j()
    # compile telemetry is per backend, not a control-plane output
    sa, sb = m_a.summary(), m_b.summary()
    sa.pop("recompiles", None)
    sb.pop("recompiles", None)
    assert sa == sb


def replay_near_argmax(rc, params, reqs, max_len, margin=0.05):
    """Each emitted token's reference logit (the JAX model ``rc`` with
    ``params``, the served weights) lies within ``margin`` of the
    reference max (tests/test_perf_invariants.py:206-239)."""
    prefill = jax.jit(partial(M.prefill, cfg=rc, max_len=max_len))
    decode = jax.jit(partial(M.decode_step, cfg=rc))
    for r in reqs:
        toks = jnp.asarray(r.prompt_tokens, jnp.int32)[None]
        pad = _bucket(toks.shape[1], hi=max_len)
        buf = jnp.zeros((1, pad), jnp.int32).at[:, : toks.shape[1]].set(toks)
        logits, cache = prefill(params, tokens=buf,
                                lengths=jnp.asarray([toks.shape[1]],
                                                    jnp.int32))
        pos = jnp.asarray([toks.shape[1]], jnp.int32)
        for i, tok in enumerate(r.output_tokens):
            row = np.asarray(logits[0], np.float64)
            assert row[tok] >= row.max() - margin, (
                f"rid {r.rid} token {i}: id {tok} has reference logit "
                f"{row[tok]:.4f} vs max {row.max():.4f}")
            logits, cache = decode(params, tokens=jnp.asarray([tok],
                                                              jnp.int32),
                                   cache=cache, lengths=pos)
            pos = pos + 1
