"""Parity probes shared by the port's serving tests
(``test_torch_serving.py``, ``test_torch_mamba.py``,
``test_torch_mesh.py``): a run compared bit for bit in everything the
control plane computes, the near-argmax replay of served tokens through
the JAX model, and the log of speculative acceptances.  JAX is imported
where a replay runs, so the spawned ranks of ``_mesh_worlds.py`` can use
:func:`recording` without it."""
from functools import partial

import numpy as np

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
    import jax
    import jax.numpy as jnp

    from repro.models import model as M

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


def recording(factory):
    """Wrap a factory so each speculative iteration's (rid, accepted)
    pairs are logged in dispatch order."""
    log = []

    def wrapped(kind, idx, hw, seed, tp=None):
        be = factory(kind, idx, hw, seed, tp=tp)
        if be.spec_k:
            inner = be._real_spec_step

            def step(reqs, k, accepts):
                log.extend((r.rid, a) for r, a in zip(reqs, accepts))
                return inner(reqs, k, accepts)

            be._real_spec_step = step
        return be

    return wrapped, log


def token_kinds(reqs, log):
    """Per request, which model chose each emitted token: the prefill's
    first token and each verify pass's bonus/correction token are the
    target's argmax, accepted draft tokens the drafter's."""
    kinds = {r.rid: ["target"] for r in reqs}
    for rid, a in log:
        kinds[rid] += ["draft"] * a + ["target"]
    return kinds


def replay_by_kind(models, reqs, kinds, max_len, margin=0.05):
    """Each emitted token within ``margin`` of the max logit of the JAX
    model that chose it: ``models`` maps "target" and "draft" to
    (cfg, params) of the served weights."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as M

    fns = {name: (jax.jit(partial(M.prefill, cfg=c, max_len=max_len)),
                  jax.jit(partial(M.decode_step, cfg=c)))
           for name, (c, _) in models.items()}
    for r in reqs:
        assert len(kinds[r.rid]) == len(r.output_tokens), r.rid
        toks = np.asarray(r.prompt_tokens, np.int32)
        pad = np.zeros((1, _bucket(len(toks), hi=max_len)), np.int32)
        pad[0, : len(toks)] = toks
        rows = {}
        for name, (_, params) in models.items():
            prefill, decode = fns[name]
            logits, cache = prefill(params, tokens=jnp.asarray(pad),
                                    lengths=jnp.asarray([len(toks)],
                                                        jnp.int32))
            pos = jnp.asarray([len(toks)], jnp.int32)
            rows[name] = []
            for tok in r.output_tokens:
                rows[name].append(np.asarray(logits[0], np.float64))
                logits, cache = decode(params,
                                       tokens=jnp.asarray([tok], jnp.int32),
                                       cache=cache, lengths=pos)
                pos = pos + 1
        for i, (tok, kind) in enumerate(zip(r.output_tokens, kinds[r.rid])):
            row = rows[kind][i]
            assert row[tok] >= row.max() - margin, (
                f"rid {r.rid} token {i} ({kind}): id {tok} has logit "
                f"{row[tok]:.4f} vs max {row.max():.4f}")
