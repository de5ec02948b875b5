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


def forward_script(rc, paged=True):
    """Inputs of the mesh forward parity (tests/test_mesh_parity.py:229,
    272): dense prefill then 3 decode steps; with ``paged``, paged
    prefill at a page-exact and a page+1 length, 2 decode steps (the
    second crosses a boundary) and a 3-token verify window.  Next tokens
    are fixed, not argmaxes, so both sides attend the same K/V (and scan
    the same inputs) whatever a near-tie does."""
    rng = np.random.default_rng(7)
    toks = np.zeros((2, 32), np.int32)
    toks[0, :24] = rng.integers(1, rc.vocab_size, 24)
    toks[1, :32] = rng.integers(1, rc.vocab_size, 32)
    ptoks = np.zeros((2, 32), np.int32)
    ptoks[0, :16] = rng.integers(1, rc.vocab_size, 16)
    ptoks[1, :17] = rng.integers(1, rc.vocab_size, 17)
    bt = np.full((2, 4), -1, np.int32)
    bt[0, :3] = [0, 2, 4]
    bt[1, :3] = [1, 3, 5]

    def nxt():
        return rng.integers(1, rc.vocab_size, 2).astype(np.int32)

    s = dict(toks=toks, lens=np.array([24, 32], np.int32), max_len=64,
             dense_next=[nxt() for _ in range(3)])
    if paged:
        s.update(ptoks=ptoks, plens=np.array([16, 17], np.int32), ps=16,
                 pool_pages=12, bt=bt, paged_next=[nxt() for _ in range(2)],
                 vtoks=rng.integers(1, rc.vocab_size, (2, 3)).astype(
                     np.int32))
    return s


def jax_forward(M, rc, params, s):
    """:func:`_mesh_worlds.run_forward_script` through the JAX model
    ``M``."""
    import jax.numpy as jnp

    j = jnp.asarray
    out = []
    logits, cache = M.prefill(params, rc, j(s["toks"]), j(s["lens"]),
                              max_len=s["max_len"])
    out.append(np.asarray(logits))
    pos = s["lens"].copy()
    for nxt in s["dense_next"]:
        logits, cache = M.decode_step(params, rc, j(nxt), cache, j(pos))
        out.append(np.asarray(logits))
        pos += 1
    if "ptoks" not in s:
        return out
    cache = M.init_paged_cache(rc, s["pool_pages"], s["ps"])
    logits, cache = M.prefill_paged(
        params, rc, j(s["ptoks"]), j(s["plens"]), jnp.zeros(2, jnp.int32),
        j(s["bt"]), cache)
    out.append(np.asarray(logits))
    pos = s["plens"].copy()
    for nxt in s["paged_next"]:
        logits, cache = M.decode_step_paged(params, rc, j(nxt), cache,
                                            j(pos), j(s["bt"]))
        out.append(np.asarray(logits))
        pos += 1
    logits, _ = M.verify_step_paged(params, rc, j(s["vtoks"]), cache, j(pos),
                                    j(s["bt"]))
    out.append(np.asarray(logits))
    return out


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
