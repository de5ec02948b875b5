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
