"""The port on the card: each Hopper kernel against its plain PyTorch
version, the model's kernel path against its plain-attention path, and a
served cluster that launches both kernels.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import REGISTRY
from repro_torch.core.power import A100
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import model as TM
from repro_torch.serving import ClusterConfig, PDCluster, poisson_workload
from repro_torch.serving.cluster import build_predictor
from repro_torch.serving.realengine import make_real_backend_factory
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
