"""The dense family in the port against ``repro.models.model``: the
reduced configs of ministral-3b, qwen3-32b, phi4-mini-3.8b, minicpm-2b,
chameleon-34b and command-r-plus-104b, on the same weights (carried
across with ``params_from_jax``).

``reduced()`` keeps each config's q/k norm and tied head but gives it
four q heads over two kv heads (G = 2; minicpm's MHA keeps G = 1), so
variants at the real groups run too: six q heads over two (G = 3:
ministral, phi4-mini) and twelve over one (G = 12: command-r-plus), each
on a qk-norm config and on one without.  Every norm leaf, ``q_norm`` and
``k_norm`` included, is moved away from its zero init, so a dropped or
misplaced norm fails.

Each case runs forward, prefill + 16 decode steps (each fed the JAX
model's own token, as tests/test_torch_model.py does) and paged prefill
+ decode over non-contiguous pages, to the JAX suite's tolerances.
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
DENSE = ("ministral-3b", "qwen3-32b", "phi4-mini-3.8b", "minicpm-2b",
         "chameleon-34b", "command-r-plus-104b")
# (arch, q heads, kv heads): the reduced configs, then the real groups
CASES = [pytest.param((a, None, None), id=a) for a in DENSE] + [
    pytest.param(("ministral-3b", 6, 2), id="ministral-3b-G3"),
    pytest.param(("qwen3-32b", 6, 2), id="qwen3-32b-G3"),
    pytest.param(("phi4-mini-3.8b", 6, 2), id="phi4-mini-3.8b-G3"),
    pytest.param(("qwen3-32b", 12, 1), id="qwen3-32b-G12"),
    pytest.param(("command-r-plus-104b", 12, 1),
                 id="command-r-plus-104b-G12"),
]


def _cfgs(arch, n_heads, n_kv_heads, dtype):
    kw = dict(dtype=dtype)
    if n_heads is not None:
        kw.update(n_heads=n_heads, n_kv_heads=n_kv_heads)
    return (dataclasses.replace(REGISTRY[arch].reduced(), **kw),
            dataclasses.replace(TREG[arch].reduced(), **kw))


def _perturb_norms(tree, rng):
    """Every ``*norm`` leaf moved off its zero init (numpy, in place)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_norms(v, rng)
        elif k.endswith("norm"):
            tree[k] = (np.asarray(v, np.float32)
                       + rng.normal(0.0, 0.5, v.shape)).astype(v.dtype)


def _pair(arch, n_heads, n_kv_heads, dtype, seed=0):
    rc, trc = _cfgs(arch, n_heads, n_kv_heads, dtype)
    np_params = jax.tree.map(np.asarray,
                             M.init_params(rc, jax.random.key(seed)))
    _perturb_norms(np_params, np.random.default_rng(seed))
    params = jax.tree.map(jnp.asarray, np_params)
    return rc, trc, params, params_from_jax(np_params, device="cpu")


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return _pair(*request.param, "float32")


def _close(j, t, dtype="float32", what=""):
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype], err_msg=what,
    )


def test_registry_serves_the_dense_family():
    for arch in DENSE:
        # the copy rule rewrites "repro." in minicpm's notes too
        port = repr(dataclasses.asdict(TREG[arch]))
        assert port.replace("repro_torch.", "repro.") == \
            repr(dataclasses.asdict(REGISTRY[arch]))
        TM.check_supported(TREG[arch])
    assert {"ministral-3b", "qwen3-32b", "llama-3.1-8b"} <= set(TREG)


def test_the_cases_cover_the_family_features(case):
    rc, trc, params, tparams = case
    assert trc.n_heads % trc.n_kv_heads == 0
    blk = tparams["blocks"]["layer_0"]["attn"]
    assert ("q_norm" in blk) == rc.qk_norm
    assert ("lm_head" in tparams) == (not rc.tie_embeddings)
    for name in ("q_norm", "k_norm", "norm"):
        if name in blk:
            assert float(blk[name].abs().max()) > 0.1, name


def test_forward_matches(case):
    rc, trc, params, tparams = case
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 40))
    hj, _ = M.forward(params, rc, tokens=jnp.asarray(toks, jnp.int32))
    ht, _ = TM.forward(tparams, trc, torch.from_numpy(toks))
    _close(hj, ht, what="hidden")
    _close(M.lm_logits(params, rc, hj), TM.lm_logits(tparams, trc, ht),
           what="logits")


@pytest.mark.parametrize("arch,n_heads,n_kv_heads", [
    pytest.param("qwen3-32b", 12, 1, id="qwen3-32b-G12"),
    pytest.param("command-r-plus-104b", 6, 2, id="command-r-plus-104b-G3"),
])
def test_forward_matches_in_bfloat16(arch, n_heads, n_kv_heads):
    rc, trc, params, tparams = _pair(arch, n_heads, n_kv_heads, "bfloat16")
    toks = np.random.default_rng(2).integers(0, rc.vocab_size, (2, 40))
    hj, _ = M.forward(params, rc, tokens=jnp.asarray(toks, jnp.int32))
    ht, _ = TM.forward(tparams, trc, torch.from_numpy(toks))
    _close(hj, ht, "bfloat16", "hidden")
    _close(M.lm_logits(params, rc, hj), TM.lm_logits(tparams, trc, ht),
           "bfloat16", "logits")


def test_prefill_then_decode_matches(case):
    rc, trc, params, tparams = case
    rng = np.random.default_rng(2)
    B, S, steps = 2, 32, 16
    toks = rng.integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    lengths = np.array([21, 32], np.int32)  # ragged: right-padded row 0
    decode = jax.jit(partial(M.decode_step, cfg=rc))
    lj, cj = M.prefill(params, rc, jnp.asarray(toks), jnp.asarray(lengths),
                       max_len=MAX_LEN)
    lt, ct = TM.prefill(tparams, trc, torch.from_numpy(toks),
                        torch.from_numpy(lengths), max_len=MAX_LEN)
    _close(lj, lt, what="prefill logits")
    valid = np.asarray(cj["layer_0"]["pos"]) >= 0
    for key in ("k", "v"):
        _close(np.asarray(cj["layer_0"][key], np.float32)[valid],
               ct["layer_0"][key][torch.from_numpy(valid)],
               what=f"prefill cache {key}")
    pos = lengths.copy()
    tok = np.array(jnp.argmax(lj, -1), np.int32)
    for t in range(steps):
        lj, cj = decode(params, tokens=jnp.asarray(tok), cache=cj,
                        lengths=jnp.asarray(pos))
        lt, ct = TM.decode_step(tparams, trc, torch.from_numpy(tok), ct,
                                torch.from_numpy(pos))
        _close(lj, lt, what=f"decode step {t}")
        tok = np.array(jnp.argmax(lj, -1), np.int32)
        pos = pos + 1


def test_paged_prefill_decode_matches(case):
    """tests/test_models.py:86 against JAX: paged prefill, then decode
    steps growing the tables page by page on non-contiguous pages; the
    logits and the whole pool agree at every step."""
    rc, trc, params, tparams = case
    rng = np.random.default_rng(7)
    B, P_len, G_len, ps, num_pages, Pmax = 2, 24, 6, 8, 16, 4
    toks = rng.integers(0, rc.vocab_size, (B, P_len + G_len)).astype(np.int32)
    cj = M.init_paged_cache(rc, num_pages, ps)
    ct = TM.init_paged_cache(trc, num_pages, ps, device="cpu")
    n = -(-P_len // ps)
    bt = np.full((B, Pmax), -1, np.int32)
    bt[0, :n] = np.arange(n)
    bt[1, :n] = np.arange(n) + 6
    lengths = np.full((B,), P_len, np.int32)
    zeros = np.zeros((B,), np.int32)
    lj, cj = M.prefill_paged(params, rc, jnp.asarray(toks[:, :P_len]),
                             jnp.asarray(lengths), jnp.asarray(zeros),
                             jnp.asarray(bt), cj)
    lt, ct = TM.prefill_paged(tparams, trc, torch.from_numpy(toks[:, :P_len]),
                              torch.from_numpy(lengths),
                              torch.from_numpy(zeros), torch.from_numpy(bt),
                              ct)
    _close(lj, lt, what="paged prefill logits")
    decode = jax.jit(partial(M.decode_step_paged, cfg=rc))
    pos = lengths.copy()
    for t in range(G_len):
        need = -(-(P_len + t + 1) // ps)
        bt[0, :need] = np.arange(need)
        bt[1, :need] = np.arange(need) + 6
        lj, cj = decode(params, tokens=jnp.asarray(toks[:, P_len + t]),
                        cache=cj, lengths=jnp.asarray(pos),
                        block_tables=jnp.asarray(bt))
        lt, ct = TM.decode_step_paged(tparams, trc,
                                      torch.from_numpy(toks[:, P_len + t]),
                                      ct, torch.from_numpy(pos),
                                      torch.from_numpy(bt))
        _close(lj, lt, what=f"paged decode step {t}")
        pos = pos + 1
    for name, entry in cj.items():
        for key, leaf in entry.items():
            _close(leaf, ct[name][key], what=f"pool {name}.{key}")


@pytest.mark.parametrize("leaf", ["q_norm", "k_norm"])
def test_a_dropped_qk_norm_fails_the_check(leaf):
    """The perturbed norms make the checks see q/k norm: the port with
    one of them back at its init misses the JAX logits by far more than
    the tolerance."""
    rc, trc, params, tparams = _pair("qwen3-32b", None, None, "float32")
    tparams["blocks"]["layer_0"]["attn"][leaf].zero_()
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 40))
    hj, _ = M.forward(params, rc, tokens=jnp.asarray(toks, jnp.int32))
    ht, _ = TM.forward(tparams, trc, torch.from_numpy(toks))
    gap = np.abs(ht.numpy() - np.asarray(hj, np.float32)).max()
    assert gap > 100 * TOL["float32"], gap
