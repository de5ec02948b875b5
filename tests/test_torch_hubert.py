"""hubert-xlarge's bidirectional encoder in the port against the JAX
package.

- The prefill attention without the causal mask (``causal=False``) at
  head dim 80 (hubert's) and 16 (the reduced config's): the wrapper (its
  plain version on the CPU) against the JAX ``attention_ref`` and the
  Pallas kernel in interpret mode (S = 64, within its block rule), and
  with a per-row ``kv_len`` (padded frames mask keys) against
  ``L.chunked_attention(kv_valid=)``.
- The reduced hubert's ``forward`` on frame embeddings with ragged
  lengths (the reference's ``valid = arange(S) < lengths``), in float32
  and bfloat16, on the kernel path and the plain path, at the reduced
  head dim 16 and at 80; its ``prefill`` with ``inputs_embeds`` (logits
  and cache).  Forcing ``causal=True`` on the port side misses the JAX
  model by more than 100 times the tolerance.
- The flash kernel's head-dim switch names ``_build.FLASH_HEAD_DIMS``,
  and the decode kernels' switches ``_build.HEAD_DIMS``, so a call the
  wrapper lets through launches.
- Serving refuses hubert (it has no decode phase) with the reason.
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (
    attention_ref as jax_attention_ref,
    flash_attention as pallas_flash,
)
from repro.models import layers as JL
from repro.models import model as M
from repro_torch.core.hwmodel import HardwareModel
from repro_torch.core.power import A100
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import model as TM
from repro_torch.serving.realengine import (
    RealBackend,
    make_real_backend_factory,
)
import _arch_parity as AP

ARCH = "hubert-xlarge"
TOL = AP.TOL


def _pair(x, dtype):
    x = np.asarray(x, np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _qkv(rng, B, S, H, Dh, dtype):
    return [_pair(rng.normal(size=(B, S, H, Dh)), dtype) for _ in range(3)]


# ---------------------------------------------------------------------------
# The kernel's plain version, bidirectional
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Dh", [80, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bidirectional_matches_jax_ref_and_pallas(Dh, dtype):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 64, 4, Dh, dtype)
    got = flash_attention(qt, kt, vt, causal=False)
    AP.close(jax_attention_ref(qj, kj, vj, causal=False), got, dtype,
             "attention_ref")
    AP.close(pallas_flash(qj, kj, vj, causal=False, block_q=64, block_k=64,
                          interpret=True), got, dtype, "Pallas")
    # and it is not the causal result
    causal = flash_attention(qt, kt, vt, causal=True)
    assert float((causal - got).abs().max()) > 100 * TOL[dtype]


@pytest.mark.parametrize("Dh", [80, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bidirectional_kv_len_matches_chunked_attention(Dh, dtype):
    """Padded frames: keys at and past each row's length are masked, for
    every query row (pad rows included), and a row of length 0 averages
    V, as ``L.chunked_attention`` does."""
    rng = np.random.default_rng(1)
    B, S = 3, 72
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, B, S, 4, Dh, dtype)
    lens = np.array([S, 29, 0], np.int32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = JL.chunked_attention(
        qj, kj, vj, causal=False, q_positions=pos, kv_positions=pos,
        kv_valid=jnp.asarray(np.arange(S)[None] < lens[:, None]))
    got = flash_attention(qt, kt, vt, causal=False,
                          kv_len=torch.from_numpy(lens))
    AP.close(want, got, dtype)


def test_kernel_switches_name_the_wrappers_head_dims():
    """A head dim the wrapper lets through is one its kernel's switch
    instantiates: flash takes 80 besides the decode kernels' dims."""
    def cases(name):
        text = (_build.CSRC / f"{name}.cu").read_text()
        return tuple(int(n) for n in re.findall(
            r"case (\d+): err = launch<\1>", text))

    assert cases("flash_prefill") == _build.FLASH_HEAD_DIMS
    assert 80 in _build.FLASH_HEAD_DIMS
    for name in ("ring_decode", "paged_attention"):
        assert cases(name) == _build.HEAD_DIMS
    assert 80 not in _build.HEAD_DIMS


# ---------------------------------------------------------------------------
# The reduced encoder
# ---------------------------------------------------------------------------


def _hubert(dtype="float32", head_dim=None, seed=0):
    rc, trc = AP.configs(ARCH, dtype)
    if head_dim is not None:
        rc, trc = (dataclasses.replace(c, head_dim=head_dim)
                   for c in (rc, trc))
    assert not trc.causal and not trc.use_rope and not trc.embed_inputs
    params, tparams = AP.pair(rc, trc, seed)
    return rc, trc, params, tparams


def _frames(rc, B=2, S=48, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, rc.d_model)).astype(np.float32)
    lengths = np.array([S, S - 19], np.int32)[:B]
    return x, lengths


def _jax_forward(params, rc, x, lengths):
    S = x.shape[1]
    valid = jnp.asarray(np.arange(S)[None] < lengths[:, None])
    hj, _ = M.forward(params, rc, inputs_embeds=jnp.asarray(x), valid=valid)
    return hj, M.lm_logits(params, rc, hj)


def _port_forward(tparams, trc, x, lengths, plain=False):
    ht, _ = TM.forward(tparams, trc, inputs_embeds=torch.from_numpy(x),
                       lengths=torch.from_numpy(lengths),
                       plain_attention=plain)
    return ht, TM.lm_logits(tparams, trc, ht)


@pytest.mark.parametrize("head_dim", [None, 80], ids=["Dh16", "Dh80"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_forward_matches(dtype, head_dim, plain):
    rc, trc, params, tparams = _hubert(dtype, head_dim)
    assert "embed" not in tparams and set(tparams) == set(params)
    assert tparams["lm_head"].shape == (rc.d_model, rc.vocab_size)
    x, lengths = _frames(rc)
    hj, lj = _jax_forward(params, rc, x, lengths)
    ht, lt = _port_forward(tparams, trc, x, lengths, plain)
    assert ht.dtype == getattr(torch, dtype)
    AP.close(hj, ht, dtype, "hidden")
    AP.close(lj, lt, dtype, "logits")


def test_forward_without_lengths_matches():
    rc, trc, params, tparams = _hubert()
    x, _ = _frames(rc)
    hj, _ = M.forward(params, rc, inputs_embeds=jnp.asarray(x))
    ht, _ = TM.forward(tparams, trc, inputs_embeds=torch.from_numpy(x))
    AP.close(hj, ht, what="hidden")


def test_prefill_with_inputs_embeds_matches():
    rc, trc, params, tparams = _hubert(head_dim=80)
    x, lengths = _frames(rc)
    lj, cj = M.prefill(params, rc, None, jnp.asarray(lengths),
                       inputs_embeds=jnp.asarray(x), max_len=64)
    lt, ct = TM.prefill(tparams, trc, None, torch.from_numpy(lengths),
                        inputs_embeds=torch.from_numpy(x), max_len=64)
    AP.close(lj, lt, what="prefill logits")
    AP.close_tree(cj, ct, "prefill cache")


def test_a_causal_mask_misses_the_reference():
    """The mutation check: the port forced causal misses the
    bidirectional JAX model by far more than the tolerance, so the
    forward tests can tell the two apart."""
    rc, trc, params, tparams = _hubert(head_dim=80)
    x, lengths = _frames(rc)
    hj, lj = _jax_forward(params, rc, x, lengths)
    ht, lt = _port_forward(tparams, dataclasses.replace(trc, causal=True),
                           x, lengths)
    gap = float(np.abs(lt.numpy() - np.asarray(lj)).max())
    assert gap > 100 * TOL["float32"], gap


def test_forward_needs_frame_embeddings():
    _, trc, _, tparams = _hubert()
    with pytest.raises(ValueError, match="inputs_embeds"):
        TM.forward(tparams, trc, torch.zeros((1, 8), dtype=torch.int32))


def test_serving_refuses_hubert_for_its_missing_decode_phase():
    cfg = TREG[ARCH]
    assert "no decode phase" in cfg.notes
    rc = cfg.reduced()
    with pytest.raises(ValueError, match="no decode phase"):
        RealBackend(HardwareModel(cfg, A100), rc, {}, device="cpu")
    with pytest.raises(ValueError, match="no decode phase"):
        make_real_backend_factory(rc, {}, device="cpu")


def test_registry_equals_the_reference_and_passes_the_model_check():
    """The copied registry holds every config of the reference's,
    hubert-xlarge included, equal field for field under the copy rule,
    and the model's check passes each one off a mesh."""
    from repro.configs.registry import ASSIGNED, REGISTRY

    from repro_torch.configs.registry import ASSIGNED as TASSIGNED

    assert set(TREG) == set(REGISTRY) and set(TASSIGNED) == set(ASSIGNED)
    for arch, cfg in REGISTRY.items():
        port = repr(dataclasses.asdict(TREG[arch]))
        assert port.replace("repro_torch.", "repro.") == \
            repr(dataclasses.asdict(cfg)), arch
        TM.check_supported(TREG[arch])
