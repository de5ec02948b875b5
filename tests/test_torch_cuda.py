"""The port on the card: each Hopper kernel against its plain PyTorch
version, the model's kernel path against its plain-attention path, and
served clusters (dense, and paged with speculation) that launch every
kernel.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import REGISTRY
from repro_torch.core.power import A100
from repro_torch.kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_verify_attention,
)
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_verify_attention_ref,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import model as TM
from repro_torch.serving import ClusterConfig, PDCluster, poisson_workload
from repro_torch.serving.cluster import build_predictor
from repro_torch.serving.realengine import (
    make_draft_config,
    make_real_backend_factory,
)
from repro_torch.serving.request import Request
from repro_torch.serving.workload import DatasetDist, LengthDist, attach_tokens

TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:18
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build and run there")
    # plain float32 references in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,kv_len,window,softcap", [
    (16, None, None, None), (96, 70, None, None), (200, 150, 64, 50.0),
])
def test_flash_kernel_matches_plain(card, dtype, S, kv_len, window, softcap):
    g = torch.Generator(device=card).manual_seed(S)
    dt = getattr(torch, dtype)
    q = torch.randn((2, S, 8, 128), generator=g, device=card).to(dt)
    k = torch.randn((2, S, 2, 128), generator=g, device=card).to(dt)
    v = torch.randn((2, S, 2, 128), generator=g, device=card).to(dt)
    kl = None if kv_len is None else torch.tensor(
        [kv_len, 1], dtype=torch.int32, device=card)
    kw = dict(causal=True, window=window, softcap=softcap, kv_len=kl)
    n0 = fops.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fops.launches == n0 + 1
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain(card, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    dt = getattr(torch, dtype)
    B, C = 4, 1000  # C not a multiple of the 32-slot tile
    q = torch.randn((B, 32, 128), generator=g, device=card).to(dt)
    k = torch.randn((B, C, 8, 128), generator=g, device=card).to(dt)
    v = torch.randn((B, C, 8, 128), generator=g, device=card).to(dt)
    filled = torch.tensor([C, 500, 1, 0], device=card)  # last row empty
    slots = torch.arange(C, device=card)
    slot_pos = torch.where(slots[None] < filled[:, None], slots[None],
                           -1).to(torch.int32)
    q_pos = torch.clamp(filled - 1, min=0).to(torch.int32)
    n0 = dops.launches
    got = decode_attention(q, k, v, slot_pos, q_pos, softcap=30.0)
    torch.cuda.synchronize()
    assert dops.launches == n0 + 1
    want = decode_attention_ref(q, k, v, slot_pos, q_pos, softcap=30.0)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_drafter_shape_g1_dh16(card, dtype):
    """The drafter's shape (make_draft_config at full width): one q head
    per kv head (G = 1) and head_dim 16."""
    g = torch.Generator(device=card).manual_seed(1)
    dt = getattr(torch, dtype)
    B, C = 8, 1024
    q = torch.randn((B, 2, 16), generator=g, device=card).to(dt)
    k = torch.randn((B, C, 2, 16), generator=g, device=card).to(dt)
    v = torch.randn((B, C, 2, 16), generator=g, device=card).to(dt)
    filled = torch.tensor([C, 700, 300, 33, 17, 2, 1, 0], device=card)
    slots = torch.arange(C, device=card)
    slot_pos = torch.where(slots[None] < filled[:, None], slots[None],
                           -1).to(torch.int32)
    q_pos = torch.clamp(filled - 1, min=0).to(torch.int32)
    got = decode_attention(q, k, v, slot_pos, q_pos)
    want = decode_attention_ref(q, k, v, slot_pos, q_pos)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,q_start,window,softcap", [
    (512, [0, 256, 496], None, None), (96, [16, 0, 48], None, None),
    (40, [64, 5, 0], 32, 30.0),
])
def test_flash_q_offset_matches_plain(card, dtype, S, q_start, window,
                                      softcap):
    """Query row i at position q_start + i over the gathered view of a
    paged table (keys at 0..Skv-1), kv_len = q_start + new tokens."""
    g = torch.Generator(device=card).manual_seed(S + 7)
    dt = getattr(torch, dtype)
    B, Skv = 3, 1024
    qs = torch.tensor(q_start, dtype=torch.int32, device=card)
    new = torch.tensor([S, S // 2 + 1, 1], dtype=torch.int32, device=card)
    q = torch.randn((B, S, 32, 128), generator=g, device=card).to(dt)
    k = torch.randn((B, Skv, 8, 128), generator=g, device=card).to(dt)
    v = torch.randn((B, Skv, 8, 128), generator=g, device=card).to(dt)
    kw = dict(causal=True, window=window, softcap=softcap, kv_len=qs + new,
              q_start=qs)
    n0, m0 = fops.launches, fops.q_offset_launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fops.launches, fops.q_offset_launches) == (n0 + 1, m0 + 1)
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_flash_q_start_zero_is_bit_exact_with_no_offset(card):
    g = torch.Generator(device=card).manual_seed(3)
    q = torch.randn((2, 200, 32, 128), generator=g, device=card)
    k = torch.randn((2, 200, 8, 128), generator=g, device=card)
    v = torch.randn((2, 200, 8, 128), generator=g, device=card)
    kl = torch.tensor([150, 200], dtype=torch.int32, device=card)
    zero = torch.zeros(2, dtype=torch.int32, device=card)
    a = flash_attention(q, k, v, kv_len=kl)
    b = flash_attention(q, k, v, kv_len=kl, q_start=zero)
    assert torch.equal(a, b)


def _paged_inputs(card, dtype, B, T, Hq, Hkv, Dh, ps, Pmax, lengths, seed):
    """A pool of (2B + 8) * Pmax pages plus scratch, shuffled disjoint
    tables with -1 past each row's last page."""
    g = torch.Generator(device=card).manual_seed(seed)
    dt = getattr(torch, dtype)
    P = (2 * B + 8) * Pmax + 1
    q = torch.randn((B, T, Hq, Dh), generator=g, device=card).to(dt)
    kp = torch.randn((P, ps, Hkv, Dh), generator=g, device=card).to(dt)
    vp = torch.randn((P, ps, Hkv, Dh), generator=g, device=card).to(dt)
    perm = torch.randperm(P - 1, generator=g, device=card)
    bt = torch.full((B, Pmax), -1, dtype=torch.int32, device=card)
    for b, n in enumerate(lengths):
        pages = -(-n // ps)
        bt[b, :pages] = perm[b * Pmax: b * Pmax + pages].to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    return q, kp, vp, bt, ln


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,window,softcap", [
    (1, None, None), (3, None, None), (5, None, None), (3, 24, 30.0),
])
def test_paged_kernel_matches_plain(card, dtype, T, window, softcap):
    lengths = [1024, 700, 513, 512, 100, 17, T + 1, 16]
    q, kp, vp, bt, ln = _paged_inputs(card, dtype, 8, T, 32, 8, 128, 16, 64,
                                      lengths, seed=T)
    kw = dict(window=window, softcap=softcap)
    n0 = dops.paged_launches.get(T, 0)
    got = paged_verify_attention(q, kp, vp, bt, ln, **kw)
    torch.cuda.synchronize()
    assert dops.paged_launches[T] == n0 + 1
    want = paged_verify_attention_ref(q, kp, vp, bt, ln, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_paged_kernel_length_zero_row_is_zero(card):
    q, kp, vp, bt, ln = _paged_inputs(card, "bfloat16", 3, 3, 8, 2, 64, 16,
                                      4, [40, 0, 17], seed=9)
    got = paged_verify_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    want = paged_verify_attention_ref(q, kp, vp, bt, ln)
    torch.testing.assert_close(got[[0, 2]].float(), want[[0, 2]].float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_t1_is_bit_exact_with_paged_decode(card, dtype):
    q, kp, vp, bt, ln = _paged_inputs(card, dtype, 8, 1, 32, 8, 128, 16, 64,
                                      [1000, 1, 16, 17, 300, 64, 65, 999],
                                      seed=4)
    ver = paged_verify_attention(q, kp, vp, bt, ln)
    dec = paged_decode_attention(q[:, 0].contiguous(), kp, vp, bt, ln)
    assert torch.equal(ver[:, 0], dec)


def test_paged_matches_ring_decode_on_the_same_cache(card):
    """tests/test_kernels.py:194: the paged and ring layouts are two views
    of one cache."""
    g = torch.Generator(device=card).manual_seed(5)
    ps, n_pages, C = 16, 8, 128
    q = torch.randn((1, 8, 64), generator=g, device=card)
    k = torch.randn((1, C, 2, 64), generator=g, device=card)
    v = torch.randn((1, C, 2, 64), generator=g, device=card)
    L = 77
    slot_pos = torch.where(torch.arange(C, device=card) < L,
                           torch.arange(C, device=card), -1)[None]
    ring = decode_attention(q, k, v, slot_pos.to(torch.int32),
                            torch.tensor([L - 1], dtype=torch.int32,
                                         device=card))
    bt = torch.arange(n_pages, dtype=torch.int32, device=card)[None]
    paged = paged_decode_attention(
        q, k.reshape(n_pages, ps, 2, 64), v.reshape(n_pages, ps, 2, 64), bt,
        torch.tensor([L], dtype=torch.int32, device=card))
    torch.testing.assert_close(paged, ring, atol=2e-5, rtol=2e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    q = torch.zeros((1, 16, 4, 48), device=card)  # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 16, 4, 64), device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    q = torch.zeros((1, 16, 4, 64), device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)


def test_model_kernel_path_matches_plain_path(card):
    """Reduced llama in float32 on the card: prefill and 8 decode steps
    through the kernels agree with the plain-attention path."""
    cfg = dataclasses.replace(REGISTRY["llama-3.1-8b"].reduced(),
                              dtype="float32")
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    lengths = torch.tensor([48, 30], dtype=torch.int32, device=card)
    lk, ck = TM.prefill(params, cfg, toks, lengths, max_len=64)
    lp, cp = TM.prefill(params, cfg, toks, lengths, max_len=64,
                        plain_attention=True)
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    tok, pos = lk.argmax(-1).to(torch.int32), lengths.clone()
    for _ in range(8):
        lk, ck = TM.decode_step(params, cfg, tok, ck, pos)
        lp, cp = TM.decode_step(params, cfg, tok, cp, pos,
                                plain_attention=True)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        tok, pos = lk.argmax(-1).to(torch.int32), pos + 1


def test_served_cluster_launches_both_kernels(card):
    base = REGISTRY["llama-3.1-8b"]
    cfg = dataclasses.replace(base.reduced(), dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    reqs = attach_tokens(poisson_workload(
        DatasetDist("tiny", LengthDist(24.0, 10.0, hi=60),
                    LengthDist(6.0, 3.0, hi=12)), 2.0, 4.0, seed=3),
        cfg.vocab_size, seed=4)
    pred = build_predictor(base, A100, A100.freq_levels_2, kv_cap=400_000)
    fops.launches = dops.launches = 0
    m = PDCluster(ClusterConfig(
        model=base, chip=A100, n_prefill=1, n_decode=2, policy="voltana",
        predictor=pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=8, seed=2,
        backend_factory=make_real_backend_factory(cfg, params, slots=8,
                                                  max_len=128),
    )).run(reqs)
    assert m.finished_frac() == 1.0
    assert fops.launches > 0 and dops.launches > 0
    for r in reqs:
        assert len(r.output_tokens) == r.decode_len + 1


def _multiturn(vocab, n_convs=2, n_turns=3, system_len=48):
    """Turns that each extend the last, after a shared system prompt."""
    g = torch.Generator().manual_seed(11)
    system = torch.randint(0, vocab, (system_len,), generator=g).tolist()
    hist = {c: list(system) for c in range(n_convs)}
    reqs, rid = [], 0
    for turn in range(n_turns):
        for c in range(n_convs):
            prompt = hist[c] + torch.randint(0, vocab, (8,),
                                             generator=g).tolist()
            r = Request(rid, 2.0 * turn + 0.3 * c, prompt_len=len(prompt),
                        decode_len=6, conv_id=c, turn=turn)
            r.prompt_tokens = list(prompt)
            reqs.append(r)
            rid += 1
            hist[c] = prompt + [0] * 6
    return reqs


def test_served_paged_and_spec_clusters_launch_their_kernels(card):
    """Reduced llama in bf16: a paged cluster with a radix prefix cache
    launches paged decode (T = 1) and the q-offset prefill; a paged +
    speculative one launches the verify pass at T = k + 1 = 3."""
    base = REGISTRY["llama-3.1-8b"]
    cfg = dataclasses.replace(base.reduced(), dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    dcfg = make_draft_config(cfg)
    dparams = TM.init_params(dcfg,
                             torch.Generator(device=card).manual_seed(1),
                             device=card)
    pred = build_predictor(base, A100, A100.freq_levels_2, kv_cap=400_000,
                           spec_k=2)
    for spec_k in (0, 2):
        reqs = _multiturn(cfg.vocab_size)
        fops.launches = fops.q_offset_launches = 0
        dops.paged_launches.clear()
        cl = PDCluster(ClusterConfig(
            model=base, chip=A100, n_prefill=1, n_decode=1,
            policy="voltana", predictor=pred, kv_capacity_tokens=400_000,
            online_adapt=False, decode_max_running=8, seed=2,
            prefill_chunk_tokens=64, prefix_cache=True,
            prefix_cache_capacity=2_048, paged=True, kv_page_size=16,
            spec_decode=spec_k > 0, spec_k=max(spec_k, 1),
            backend_factory=make_real_backend_factory(
                cfg, params, slots=8, max_len=128, paged=True, page_size=16,
                pool_pages=256, spec_k=spec_k, draft_cfg=dcfg,
                draft_params=dparams),
        ))
        m = cl.run(reqs)
        assert m.finished_frac() == 1.0
        for r in reqs:
            assert len(r.output_tokens) == r.decode_len + 1
            assert all(0 <= t < cfg.vocab_size for t in r.output_tokens)
        assert cl.prefill[0].backend.reused_tokens > 0
        assert fops.q_offset_launches > 0
        cl.decode[0].backend.pool.assert_empty()
        if spec_k:
            assert m.spec_iterations() > 0
            assert dops.paged_launches.get(3, 0) > 0
        else:
            assert dops.paged_launches.get(1, 0) > 0
