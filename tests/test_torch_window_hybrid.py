"""Sliding-window attention (gemma2) and the hybrid Mamba2 + attention +
MoE stack (jamba) in the port against the JAX package.

``reduced()`` keeps gemma2's 4,096-token window, which no CPU-sized
prompt reaches, so the window is set to 16 here and the prompts run past
it: the banded plain form (``sliding_attention``) then runs on whole
bands, the flash path masks the window itself, and the local ring (16
slots) is shorter than the prompt.  Each case runs ``_arch_parity``'s
model checks (jamba's paged entry points raise, as the JAX model's do)
and a served cluster against the JAX package's cluster, whose decode
slots take rings of two capacities (gemma2) or a ring beside Mamba2
states (jamba).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as JS
import repro_torch.serving as TS
from repro.configs.registry import REGISTRY
from repro.core.power import A100
from repro.models import layers as JL
from repro.models import model as M
from repro.serving.cluster import build_predictor
from repro.serving.realengine import make_real_backend_factory
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.core.power import A100 as TA100
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.cluster import build_predictor as t_build_predictor
from repro_torch.serving.realengine import make_real_backend_factory as \
    t_factory
import _arch_parity as AP
from _port_parity import assert_same_run, replay_near_argmax

WINDOW = 16
MAX_LEN = 96


@pytest.mark.parametrize("S,window,softcap,pad", [
    (128, 32, None, False), (128, 32, 50.0, True), (64, 16, 30.0, True),
    (32, 64, None, True),  # shorter than the window: plain causal
])
def test_sliding_attention_matches_jax_and_the_windowed_mask(S, window,
                                                             softcap, pad):
    rng = np.random.default_rng(S + window)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, S, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, S, 2, 16)).astype(np.float32)
    valid = np.ones((2, S), bool)
    if pad:
        valid[0, S - 10:] = False
    oj = JL.sliding_attention(*map(jnp.asarray, (q, k, v)), window=window,
                              softcap=softcap, kv_valid=jnp.asarray(valid),
                              q_chunk=16)
    ot = TL.sliding_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window, softcap=softcap,
                              kv_valid=torch.from_numpy(valid), q_chunk=16)
    AP.close(oj, ot, what="sliding_attention")
    full = TL.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window, softcap=softcap,
                                kv_valid=torch.from_numpy(valid),
                                q_chunk=16, k_chunk=16)
    AP.close(full.numpy(), ot, what="against the windowed mask")


def test_sliding_attention_needs_whole_bands():
    x = torch.zeros((1, 48, 2, 16))
    with pytest.raises(ValueError, match="window must divide"):
        TL.sliding_attention(x, x, x, window=32)


ARCHS = [pytest.param(("gemma2-27b", WINDOW), id="gemma2"),
         pytest.param(("jamba-v0.1-52b", None), id="jamba")]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch, window = request.param
    rc, trc = AP.configs(arch, window=window)
    params, tparams = AP.pair(rc, trc)
    return rc, trc, params, tparams


def test_the_cases_bind_their_features(case):
    rc, trc, _, _ = case
    if rc.name.startswith("gemma2"):
        assert [s.window for s in trc.block_pattern] == [WINDOW, None]
        assert trc.attn_softcap == 50.0 and trc.logit_softcap == 30.0
        assert trc.tie_embeddings and trc.act == "gelu"
    else:
        assert [s.mixer for s in trc.block_pattern].count("mamba") == 7
        assert [s.ffn for s in trc.block_pattern].count("moe") == 4


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_forward_matches(case, plain):
    rc, trc, params, tparams = case
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 64))
    AP.check_forward(rc, trc, params, tparams, toks.astype(np.int32))
    if plain:  # the plain path (sliding_attention) gives the same
        ht, _ = TM.forward(tparams, trc, torch.from_numpy(toks))
        hp, _ = TM.forward(tparams, trc, torch.from_numpy(toks),
                           plain_attention=True)
        AP.close(ht.numpy(), hp, what="plain path")


def test_prefill_with_short_rings_then_decode_matches(case):
    """max_len 48 < S = 64: gemma2's local ring (16 slots) and global ring
    (48) keep the last positions of each row at slot pos % cap, and
    decode wraps them; jamba's one attention layer likewise, beside the
    Mamba2 states."""
    rc, trc, params, tparams = case
    toks = np.random.default_rng(2).integers(
        0, rc.vocab_size, (2, 64)).astype(np.int32)
    ct = AP.check_prefill_decode(rc, trc, params, tparams, toks,
                                 np.array([40, 64], np.int32), max_len=48)
    caps = sorted({e["k"].shape[2] for e in ct.values() if "k" in e})
    assert caps == ([WINDOW, 48] if rc.name.startswith("gemma2") else [48])


def test_paged_prefill_decode_verify_match(case):
    rc, trc, params, tparams = case
    if not rc.has_mamba:
        AP.check_paged(rc, trc, params, tparams)
        return
    for fn in (M.init_paged_cache, TM.init_paged_cache):
        with pytest.raises(ValueError, match="hybrid models with paged=False"):
            fn(rc if fn is M.init_paged_cache else trc, 8, 8)


def test_forward_matches_in_bfloat16():
    rc, trc = AP.configs("gemma2-27b", "bfloat16", window=WINDOW)
    params, tparams = AP.pair(rc, trc)
    toks = np.random.default_rng(3).integers(0, rc.vocab_size, (2, 64))
    AP.check_forward(rc, trc, params, tparams, toks.astype(np.int32),
                     "bfloat16")


def test_jamba_layers_and_logits_match_in_bfloat16():
    """jamba in bf16: every layer on the JAX model's own input to it, and
    the logits of the whole forward.  Its hidden state is not held at
    the bf16 tolerance through all eight layers: XLA rounds a fused bf16
    chain once where PyTorch rounds each op, a unit in the last place
    here and there (the in_proj product, y + D x), and seven Mamba2
    layers compound those into differences of a few units of 2e-2 in
    about 3% of the hidden elements."""
    rc, trc = AP.configs("jamba-v0.1-52b", "bfloat16")
    params, tparams = AP.pair(rc, trc)
    toks = np.random.default_rng(3).integers(
        0, rc.vocab_size, (2, 64)).astype(np.int32)
    AP.check_layers(rc, trc, params, tparams, toks)
    hj, _ = M.forward(params, rc, tokens=jnp.asarray(toks))
    ht, _ = TM.forward(tparams, trc, torch.from_numpy(toks))
    AP.close(M.lm_logits(params, rc, hj), TM.lm_logits(tparams, trc, ht),
             "bfloat16", "logits")


def _workload(pkg, vocab, seed=21):
    tiny = pkg.DatasetDist("tiny", prefill=pkg.LengthDist(40.0, 10.0, hi=64),
                           decode=pkg.LengthDist(10.0, 3.0, hi=24))
    reqs = pkg.poisson_workload(tiny, 2.5, 3.0, seed=seed)
    return pkg.attach_tokens(reqs, vocab, seed=seed + 1)


def test_cluster_matches_jax_cluster(case):
    """Served dense by the port and by the JAX package: the same run, and
    every token near the JAX model's argmax.  The handoff puts each
    prefill's rings (gemma2: 16 and 96 slots; jamba: a ring and the
    Mamba2 conv tails and states) into a decode slot; decode wraps the
    local ring."""
    rc, trc, params, tparams = case
    arch = rc.name.replace("-reduced", "")
    runs = []
    for pkg, cfg, factory, pred in (
            (JS, REGISTRY[arch],
             make_real_backend_factory(rc, params, slots=8, max_len=MAX_LEN),
             build_predictor(REGISTRY[arch], A100, A100.freq_levels_2,
                             kv_cap=400_000)),
            (TS, TREG[arch],
             t_factory(trc, tparams, slots=8, max_len=MAX_LEN, device="cpu"),
             t_build_predictor(TREG[arch], TA100, TA100.freq_levels_2,
                               kv_cap=400_000))):
        reqs = _workload(pkg, rc.vocab_size)
        m = pkg.PDCluster(pkg.ClusterConfig(
            model=cfg, chip=A100 if pkg is JS else TA100, n_prefill=1,
            n_decode=1, policy="voltana", predictor=pred,
            kv_capacity_tokens=400_000, online_adapt=False,
            decode_max_running=8, seed=4, noise_sigma=0.0,
            backend_factory=factory)).run(reqs)
        assert m.finished_frac() == 1.0
        runs.append((reqs, m))
    (ra, ma), (rb, mb) = runs
    assert_same_run(ra, ma, rb, mb)
    assert max(r.prompt_len + r.decode_len for r in rb) > 2 * WINDOW
    replay_near_argmax(rc, params, rb, MAX_LEN)
