"""The port's dense model against ``repro.models.model`` on the same
weights (carried across with ``params_from_jax``), reduced llama-3.1-8b.

Mirrors tests/test_models.py:54: prefill logits and the cache's valid
slots match, then 16+ decode steps — each fed the JAX model's own token,
so a near-tie cannot make the runs diverge — stay within tolerance.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY
from repro.models import model as M
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.models import model as TM
from repro_torch.models.bridge import params_from_jax

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:18
MAX_LEN = 64


def _cfgs(dtype):
    return (dataclasses.replace(REGISTRY["llama-3.1-8b"].reduced(),
                                dtype=dtype),
            dataclasses.replace(TREG["llama-3.1-8b"].reduced(), dtype=dtype))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    rc, trc = _cfgs(request.param)
    params = M.init_params(rc, jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return request.param, rc, trc, params, tparams


def _close(j, t, dtype, what=""):
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype], err_msg=what,
    )


def test_bridge_is_leaf_for_leaf(pair):
    dtype, rc, trc, params, tparams = pair
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == sum(1 for _ in _leaves(tparams))
    for path, leaf in flat:
        t = tparams
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype) == f"torch.{leaf.dtype}"
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_init_params_matches_jax_layout_and_scale():
    """Same tree, shapes, dtypes and standard deviations as M.init_params
    (the draws themselves differ: torch and JAX generators)."""
    rc, trc = _cfgs("float32")
    jp = jax.tree_util.tree_flatten_with_path(
        M.init_params(rc, jax.random.key(0)))[0]
    tp = TM.init_params(trc, torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in jp:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype) == f"torch.{leaf.dtype}", path
        want = float(np.std(np.asarray(leaf)))
        assert float(t.float().std(unbiased=False)) == pytest.approx(
            want, rel=0.2, abs=1e-9), path


def test_forward_matches(pair):
    dtype, rc, trc, params, tparams = pair
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 40))
    hj, _ = M.forward(params, rc, tokens=jnp.asarray(toks, jnp.int32))
    ht, _ = TM.forward(tparams, trc, torch.from_numpy(toks))
    _close(hj, ht, dtype)
    _close(M.lm_logits(params, rc, hj), TM.lm_logits(tparams, trc, ht),
           dtype)


def test_prefill_then_decode_matches(pair):
    dtype, rc, trc, params, tparams = pair
    rng = np.random.default_rng(2)
    B, S, steps = 2, 32, 16
    toks = rng.integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    lengths = np.array([21, 32], np.int32)  # ragged: right-padded row 0
    decode = jax.jit(partial(M.decode_step, cfg=rc))
    lj, cj = M.prefill(params, rc, jnp.asarray(toks), jnp.asarray(lengths),
                       max_len=MAX_LEN)
    lt, ct = TM.prefill(tparams, trc, torch.from_numpy(toks),
                        torch.from_numpy(lengths), max_len=MAX_LEN)
    assert lt.dtype == torch.float32 and lt.shape == (B, rc.vocab_size)
    _close(lj, lt, dtype, "prefill logits")
    pos_j = np.asarray(cj["layer_0"]["pos"])
    np.testing.assert_array_equal(ct["layer_0"]["pos"].numpy(), pos_j)
    valid = pos_j >= 0  # (n, B, C)
    for key in ("k", "v"):
        _close(np.asarray(cj["layer_0"][key], np.float32)[valid],
               ct["layer_0"][key][torch.from_numpy(valid)], dtype,
               f"prefill cache {key}")
    pos = lengths.copy()
    tok = np.array(jnp.argmax(lj, -1), np.int32)
    for t in range(steps):
        lj, cj = decode(params, tokens=jnp.asarray(tok), cache=cj,
                        lengths=jnp.asarray(pos))
        lt, ct = TM.decode_step(tparams, trc, torch.from_numpy(tok), ct,
                                torch.from_numpy(pos))
        _close(lj, lt, dtype, f"decode step {t}")
        # feed both models the JAX model's own token
        tok = np.array(jnp.argmax(lj, -1), np.int32)
        pos = pos + 1


def test_greedy_entry_points_and_plain_path_agree():
    """prefill_greedy / decode_step_greedy return int32 ids equal to the
    argmax of the logits entry points, and the plain-attention path (the
    layers the JAX model calls) equals the kernel-wrapper path."""
    _, trc = _cfgs("float32")
    tp = TM.init_params(trc, torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, trc.vocab_size, (1, 32),
                         generator=torch.Generator().manual_seed(4))
    lengths = torch.tensor([27])
    ids, cache = TM.prefill_greedy(tp, trc, toks, lengths, max_len=MAX_LEN)
    logits, cache_p = TM.prefill(tp, trc, toks, lengths, max_len=MAX_LEN,
                                 plain_attention=True)
    assert ids.dtype == torch.int32
    assert int(ids[0]) == int(logits.argmax(-1)[0])
    pos = lengths.clone()
    for _ in range(4):
        nxt, cache = TM.decode_step_greedy(tp, trc, ids, cache, pos)
        logits, cache_p = TM.decode_step(tp, trc, ids, cache_p, pos,
                                         plain_attention=True)
        assert int(nxt[0]) == int(logits.argmax(-1)[0])
        ids, pos = nxt, pos + 1


def test_decode_after_prefill_matches_forward():
    """tests/test_models.py:54 within the port: decode_step after prefill
    reproduces the full-sequence forward logits token by token."""
    _, trc = _cfgs("float32")
    tp = TM.init_params(trc, torch.Generator().manual_seed(5), device="cpu")
    B, P, G = 2, 24, 4
    toks = torch.randint(0, trc.vocab_size, (B, P + G),
                         generator=torch.Generator().manual_seed(6))
    h, _ = TM.forward(tp, trc, toks)
    ref = TM.lm_logits(tp, trc, h)
    lengths = torch.full((B,), P)
    logits, cache = TM.prefill(tp, trc, toks[:, :P], lengths,
                               max_len=P + G)
    torch.testing.assert_close(logits, ref[:, P - 1], rtol=2e-3, atol=2e-3)
    pos = lengths
    for t in range(G):
        logits, cache = TM.decode_step(tp, trc, toks[:, P + t], cache, pos)
        torch.testing.assert_close(logits, ref[:, P + t], rtol=2e-3,
                                   atol=2e-3)
        pos = pos + 1


# ---------------------------------------------------------------------------
# Paged pool and speculative verify (tests/test_models.py:86-236)
# ---------------------------------------------------------------------------


def _fp32_pair(seed=0):
    rc, trc = _cfgs("float32")
    params = M.init_params(rc, jax.random.key(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return rc, trc, params, tparams


def _close_paged_caches(cj, ct, what):
    for name, entry in cj.items():
        for key, leaf in entry.items():
            _close(leaf, ct[name][key], "float32", f"{what} {name}.{key}")


def test_paged_prefill_decode_matches_jax():
    """tests/test_models.py:86 held against the JAX functions: paged
    prefill, then decode steps growing the tables page by page, on
    non-contiguous pages; logits and the whole pool agree at every step."""
    rc, trc, params, tparams = _fp32_pair()
    rng = np.random.default_rng(7)
    B, P_len, G_len, ps, num_pages, Pmax = 2, 24, 6, 8, 16, 4
    toks = rng.integers(0, rc.vocab_size, (B, P_len + G_len)).astype(np.int32)
    cj = M.init_paged_cache(rc, num_pages, ps)
    ct = TM.init_paged_cache(trc, num_pages, ps, device="cpu")
    assert ct["layer_0"]["k"].shape == cj["layer_0"]["k"].shape
    n = -(-P_len // ps)
    bt = np.full((B, Pmax), -1, np.int32)
    bt[0, :n] = np.arange(n)
    bt[1, :n] = np.arange(n) + 6  # non-contiguous on purpose
    lengths = np.full((B,), P_len, np.int32)
    zeros = np.zeros((B,), np.int32)
    lj, cj = M.prefill_paged(params, rc, jnp.asarray(toks[:, :P_len]),
                             jnp.asarray(lengths), jnp.asarray(zeros),
                             jnp.asarray(bt), cj)
    lt, ct = TM.prefill_paged(tparams, trc, torch.from_numpy(toks[:, :P_len]),
                              torch.from_numpy(lengths),
                              torch.from_numpy(zeros), torch.from_numpy(bt),
                              ct)
    _close(lj, lt, "float32", "paged prefill logits")
    _close_paged_caches(cj, ct, "after prefill")
    pos = lengths.copy()
    for t in range(G_len):
        need = -(-(P_len + t + 1) // ps)
        bt[0, :need] = np.arange(need)
        bt[1, :need] = np.arange(need) + 6
        lj, cj = M.decode_step_paged(params, rc,
                                     jnp.asarray(toks[:, P_len + t]), cj,
                                     jnp.asarray(pos), jnp.asarray(bt))
        lt, ct = TM.decode_step_paged(tparams, trc,
                                      torch.from_numpy(toks[:, P_len + t]),
                                      ct, torch.from_numpy(pos),
                                      torch.from_numpy(bt))
        _close(lj, lt, "float32", f"paged decode step {t}")
        pos = pos + 1
    _close_paged_caches(cj, ct, "after decode")


def test_paged_prefill_decode_matches_forward():
    """tests/test_models.py:86 within the port: pool pages and block
    tables are an invisible re-layout of the full forward."""
    _, trc = _cfgs("float32")
    tp = TM.init_params(trc, torch.Generator().manual_seed(5), device="cpu")
    B, P_len, G_len, ps = 2, 24, 4, 8
    toks = torch.randint(0, trc.vocab_size, (B, P_len + G_len),
                         generator=torch.Generator().manual_seed(2))
    h, _ = TM.forward(tp, trc, toks)
    ref = TM.lm_logits(tp, trc, h)
    cache = TM.init_paged_cache(trc, 16, ps, device="cpu")
    bt = torch.full((B, 4), -1, dtype=torch.int32)
    bt[0, :3] = torch.tensor([0, 1, 2])
    bt[1, :3] = torch.tensor([6, 7, 8])
    lengths = torch.full((B,), P_len, dtype=torch.int32)
    logits, cache = TM.prefill_paged(tp, trc, toks[:, :P_len], lengths,
                                     torch.zeros(B, dtype=torch.int32), bt,
                                     cache)
    torch.testing.assert_close(logits, ref[:, P_len - 1], rtol=2e-3,
                               atol=2e-3)
    bt[0, 3], bt[1, 3] = 3, 9
    pos = lengths
    for t in range(G_len):
        logits, cache = TM.decode_step_paged(tp, trc, toks[:, P_len + t],
                                             cache, pos, bt)
        torch.testing.assert_close(logits, ref[:, P_len + t], rtol=2e-3,
                                   atol=2e-3)
        pos = pos + 1


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_verify_step_paged_matches_jax_and_sequential_decode(plain):
    """tests/test_models.py:129: the k-token verify forward against the
    JAX one, and against k+1 sequential paged decode steps in the port
    (rows equal to float32 tolerance: the batched GEMMs sum in another
    order than PyTorch's single-row ones)."""
    rc, trc, params, tparams = _fp32_pair()
    rng = np.random.default_rng(3)
    B, P_len, ps, T, num_pages, Pmax = 2, 20, 8, 4, 16, 4
    toks = rng.integers(0, rc.vocab_size, (B, P_len)).astype(np.int32)
    bt = np.stack([np.arange(Pmax), np.arange(Pmax) + 8]).astype(np.int32)
    lengths = np.full((B,), P_len, np.int32)
    zeros = np.zeros((B,), np.int32)
    cj = M.init_paged_cache(rc, num_pages, ps)
    ct = TM.init_paged_cache(trc, num_pages, ps, device="cpu")
    lj, cj = M.prefill_paged(params, rc, jnp.asarray(toks),
                             jnp.asarray(lengths), jnp.asarray(zeros),
                             jnp.asarray(bt), cj)
    _, ct = TM.prefill_paged(tparams, trc, torch.from_numpy(toks),
                             torch.from_numpy(lengths),
                             torch.from_numpy(zeros), torch.from_numpy(bt),
                             ct, plain_attention=plain)
    chain = rng.integers(0, rc.vocab_size, (B, T)).astype(np.int32)
    vj, cj = M.verify_step_paged(params, rc, jnp.asarray(chain), cj,
                                 jnp.asarray(lengths), jnp.asarray(bt))
    seq_cache = {n: {k: v.clone() for k, v in e.items()}
                 for n, e in ct.items()}
    vt, ct = TM.verify_step_paged(tparams, trc, torch.from_numpy(chain), ct,
                                  torch.from_numpy(lengths),
                                  torch.from_numpy(bt),
                                  plain_attention=plain)
    assert vt.shape == (B, T, rc.vocab_size)
    _close(vj, vt, "float32", "verify logits")
    _close_paged_caches(cj, ct, "after verify")
    for j in range(T):
        lg, seq_cache = TM.decode_step_paged(
            tparams, trc, torch.from_numpy(chain[:, j]), seq_cache,
            torch.from_numpy(lengths + j), torch.from_numpy(bt),
            plain_attention=plain)
        torch.testing.assert_close(vt[:, j], lg, atol=2e-5, rtol=2e-5)
    for name, entry in ct.items():
        for key in entry:
            torch.testing.assert_close(entry[key], seq_cache[name][key],
                                       atol=2e-5, rtol=2e-5)


def test_verify_rows_past_the_table_go_to_scratch():
    """model.py:859-864: a speculation window past the table's coverage
    scatters its overflow rows to the scratch page, never onto the
    clamped last page; the logits of covered rows still match JAX."""
    rc, trc, params, tparams = _fp32_pair()
    rng = np.random.default_rng(4)
    ps, num_pages, Pmax, T = 8, 6, 2, 3
    C = ps * Pmax
    toks = rng.integers(0, rc.vocab_size, (1, C - 1)).astype(np.int32)
    bt = np.array([[2, 4]], np.int32)
    cj = M.init_paged_cache(rc, num_pages, ps)
    ct = TM.init_paged_cache(trc, num_pages, ps, device="cpu")
    args = (np.array([C - 1], np.int32), np.zeros(1, np.int32), bt)
    _, cj = M.prefill_paged(params, rc, jnp.asarray(toks),
                            *map(jnp.asarray, args), cj)
    _, ct = TM.prefill_paged(tparams, trc, torch.from_numpy(toks),
                             *map(torch.from_numpy, args), ct)
    last_page = ct["layer_0"]["k"][:, 4].clone()
    chain = rng.integers(0, rc.vocab_size, (1, T)).astype(np.int32)
    pos = np.array([C - 1], np.int32)  # rows at C-1 (covered), C, C+1
    vj, cj = M.verify_step_paged(params, rc, jnp.asarray(chain), cj,
                                 jnp.asarray(pos), jnp.asarray(bt))
    vt, ct = TM.verify_step_paged(tparams, trc, torch.from_numpy(chain), ct,
                                  torch.from_numpy(pos), torch.from_numpy(bt))
    _close(vj[:, 0], vt[:, 0], "float32", "covered verify row")
    # the last page changed only at its final offset (position C-1)
    torch.testing.assert_close(ct["layer_0"]["k"][:, 4, :-1],
                               last_page[:, :-1])
    _close_paged_caches({n: {k: v[:, :-1] for k, v in e.items()}
                         for n, e in cj.items()},
                        {n: {k: v[:, :-1] for k, v in e.items()}
                         for n, e in ct.items()}, "pool pages")


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_paged_prefill_resumes_from_resident_prefix(plain):
    """tests/test_models.py:183 against JAX: a suffix prefill over
    resident prefix pages (the q-offset flash path) equals the JAX one
    and the whole-prompt prefill; the resident pages are read, not
    rewritten."""
    rc, trc, params, tparams = _fp32_pair()
    ps, L, ctx = 8, 21, 16
    toks = np.random.default_rng(9).integers(0, rc.vocab_size,
                                             (1, L)).astype(np.int32)
    bt = np.array([[0, 1, 2, -1]], np.int32)
    whole = TM.init_paged_cache(trc, 8, ps, device="cpu")
    ref, whole = TM.prefill_paged(tparams, trc, torch.from_numpy(toks),
                                  torch.tensor([L]), torch.tensor([0]),
                                  torch.from_numpy(bt), whole)
    split = TM.init_paged_cache(trc, 8, ps, device="cpu")
    _, split = TM.prefill_paged(tparams, trc, torch.from_numpy(toks[:, :ctx]),
                                torch.tensor([ctx]), torch.tensor([0]),
                                torch.tensor([[0, 1, -1, -1]]), split)
    suffix = np.pad(toks[:, ctx:], ((0, 0), (0, 3)))  # padded suffix
    got, split = TM.prefill_paged(tparams, trc, torch.from_numpy(suffix),
                                  torch.tensor([L - ctx]),
                                  torch.tensor([ctx]), torch.from_numpy(bt),
                                  split, plain_attention=plain)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    for name, entry in whole.items():
        for key in entry:  # the scratch page absorbs pad writes
            torch.testing.assert_close(split[name][key][:, :-1],
                                       entry[key][:, :-1], rtol=1e-5,
                                       atol=1e-5)
    cj = M.init_paged_cache(rc, 8, ps)
    _, cj = M.prefill_paged(params, rc, jnp.asarray(toks[:, :ctx]),
                            jnp.array([ctx]), jnp.array([0]),
                            jnp.asarray([[0, 1, -1, -1]], jnp.int32), cj)
    want, cj = M.prefill_paged(params, rc, jnp.asarray(suffix),
                               jnp.array([L - ctx]), jnp.array([ctx]),
                               jnp.asarray(bt), cj)
    _close(want, got, "float32", "suffix prefill logits")


def test_accept_prefix_sampling():
    """tests/test_models.py:170, and the JAX function on the same ids."""
    draft = np.array([[5, 6, 7], [5, 6, 7], [1, 2, 3], [9, 9, 9]], np.int32)
    target = np.array([[5, 6, 7, 8], [5, 0, 7, 8], [0, 2, 3, 4],
                       [9, 9, 0, 4]], np.int32)
    got = TM.accept_prefix(torch.from_numpy(draft), torch.from_numpy(target))
    assert got.dtype == torch.int32
    assert got.tolist() == [3, 1, 0, 2]
    np.testing.assert_array_equal(
        np.asarray(M.accept_prefix(jnp.asarray(draft), jnp.asarray(target))),
        got.numpy())


def test_draft_step_matches_jax_on_bridged_draft_params():
    """The drafter (make_draft_config) carried across with
    params_from_jax: leaf for leaf, and draft_step's proposals and logits
    equal the JAX function's over a few steps."""
    from repro.serving.realengine import make_draft_config
    from repro_torch.serving.realengine import make_draft_config as t_mdc

    rc, trc = _cfgs("float32")
    dc, tdc = make_draft_config(rc), t_mdc(trc)
    assert (tdc.n_layers, tdc.d_model, tdc.n_heads, tdc.n_kv_heads,
            tdc.head_dim, tdc.d_ff, tdc.vocab_size) == (
        dc.n_layers, dc.d_model, dc.n_heads, dc.n_kv_heads, dc.head_dim,
        dc.d_ff, dc.vocab_size)
    dparams = M.init_params(dc, jax.random.key(1))
    tdp = params_from_jax(jax.tree.map(np.asarray, dparams), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(dparams)[0]
    assert len(flat) == sum(1 for _ in _leaves(tdp))
    for path, leaf in flat:
        t = tdp
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    rng = np.random.default_rng(8)
    toks = rng.integers(0, dc.vocab_size, (2, 16)).astype(np.int32)
    lengths = np.array([16, 11], np.int32)
    _, cj = M.prefill(dparams, dc, jnp.asarray(toks), jnp.asarray(lengths),
                      max_len=32)
    _, ct = TM.prefill(tdp, tdc, torch.from_numpy(toks),
                       torch.from_numpy(lengths), max_len=32)
    tok, pos = toks[:, 0].copy(), lengths.copy()
    for _ in range(4):
        pj, lj, cj = M.draft_step(dparams, dc, jnp.asarray(tok), cj,
                                  jnp.asarray(pos))
        pt, lt, ct = TM.draft_step(tdp, tdc, torch.from_numpy(tok), ct,
                                   torch.from_numpy(pos))
        assert pt.dtype == torch.int32
        _close(lj, lt, "float32", "draft logits")
        assert pt.tolist() == [int(x) for x in np.asarray(pj)]
        tok, pos = np.array(pj, np.int32), pos + 1


def test_paged_cache_rejects_unsupported_configs():
    """tests/test_models.py:217: ValueError, not assert."""
    # the port's registry holds llama only; the check reads the config's
    # fields, so the JAX package's jamba config stands in
    with pytest.raises(ValueError, match="Mamba"):
        TM.init_paged_cache(REGISTRY["jamba-v0.1-52b"].reduced(), 8, 8,
                            device="cpu")
    int8_kv = dataclasses.replace(TREG["llama-3.1-8b"].reduced(),
                                  kv_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        TM.init_paged_cache(int8_kv, 8, 8, device="cpu")


def test_paged_greedy_entry_points():
    _, trc = _cfgs("float32")
    tp = TM.init_params(trc, torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, trc.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(4))
    lengths = torch.tensor([16, 9], dtype=torch.int32)
    zeros = torch.zeros(2, dtype=torch.int32)
    bt = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    c1 = TM.init_paged_cache(trc, 8, 8, device="cpu")
    c2 = TM.init_paged_cache(trc, 8, 8, device="cpu")
    ids, c1 = TM.prefill_paged_greedy(tp, trc, toks, lengths, zeros, bt, c1)
    lg, c2 = TM.prefill_paged(tp, trc, toks, lengths, zeros, bt, c2)
    assert ids.dtype == torch.int32 and ids.tolist() == lg.argmax(-1).tolist()
    nxt, c1 = TM.decode_step_paged_greedy(tp, trc, ids, c1, lengths, bt)
    lg, c2 = TM.decode_step_paged(tp, trc, ids, c2, lengths, bt)
    assert nxt.tolist() == lg.argmax(-1).tolist()
    chain = torch.stack([nxt, ids], dim=1)
    vids, c1 = TM.verify_step_paged_greedy(tp, trc, chain, c1, lengths + 1,
                                           bt)
    lg, c2 = TM.verify_step_paged(tp, trc, chain, c2, lengths + 1, bt)
    assert vids.shape == (2, 2) and vids.tolist() == lg.argmax(-1).tolist()
