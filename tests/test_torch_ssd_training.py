"""Mamba2 and hybrid training in the port against the JAX package, on the
CPU.

- The SSD scan's gradient: the port's plain backward
  (``ssd_backward_ref``), autograd through ``ssd_scan`` and through its
  autograd Function ``_SSDScan`` (on the CPU both take the plain scan; on
  the card the Function runs ``ssd_backward.cu``, held in
  ``test_torch_cuda.py``) against ``jax.vjp`` of the JAX ``ssd_ref`` and
  of ``L.ssd_chunked``, at ``tests/test_kernels.py:237-240``'s shapes,
  with and without a cotangent on the final state, and at a shape with
  dt and A under the model's law (``init_params``: dt in [1e-3, 0.1],
  -A in [1, 16]).  At the sweep's dt of about 0.7 XLA's gradient of the
  JAX ``L.ssd_chunked`` has NaN in ddt and dA: it takes
  ``jnp.where(tri, jnp.exp(seg), 0)``, whose exp overflows above the
  diagonal, and 0 x inf is NaN.  There the port is held to ``ssd_ref``'s
  gradient alone for those two (and must be finite); under the model's
  law every gradient of both is finite and held.
- The equations ``ssd_backward.cu`` implements, sub-chunk by sub-chunk,
  in a float64 numpy mirror held against the plain backward.
- A planted fault: the Function with one of its five gradients zeroed
  fails the comparison.
- The train step on reduced mamba2 (one layer, S=64: two chunks of 32)
  and reduced jamba (8 layers: 7 Mamba2, one attention, MoE) against
  ``jax.value_and_grad`` of ``JT.make_loss_fn``, remat on and off, and
  mamba2 with two microbatches; and ``launch/train.py --arch
  mamba2-2.7b`` with a checkpoint and a resume.

Tolerances, float32: 2e-5 relative to each gradient's max (the JAX
suite's float32 tolerance, ``tests/test_kernels.py:18``), 1e-5 relative
on a loss.  The train steps use ``_mamba_weights.live_state``: under the
Mamba2 init the scan's share of y is about 1e-8 of ``D * x``, so only
rescaled x/B/C projections let the scan's gradient reach the weights.
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training as JT
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models import layers as JL
from repro.models import model as JM
import repro_torch.training as TT
from repro_torch.kernels.ssd import ops as sops
from repro_torch.kernels.ssd import ssd_backward_ref, ssd_scan
from repro_torch.models.bridge import params_from_jax
from repro_torch.training import trainstep as TS
from repro_torch.training._tree import leaves
import _arch_parity as AP
from _mamba_weights import live_state

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 2e-5
LOSS_TOL = 1e-5
LR = 1e-3
NAMES = ("dx", "ddt", "dA", "dB", "dC")

SHAPES = [  # tests/test_kernels.py:237-240: (B, S, H, P, N, chunk, law)
    pytest.param(2, 256, 4, 64, 128, 64, False, id="B2-S256-N128"),
    pytest.param(1, 512, 8, 32, 64, 128, False, id="B1-S512-N64"),
    pytest.param(2, 128, 2, 64, 32, 128, False, id="B2-S128-chunk=S"),
    pytest.param(2, 256, 4, 64, 128, 64, True, id="B2-S256-model-law"),
]
# XLA's gradient of L.ssd_chunked is NaN in these where exp(seg) overflows
# above the diagonal (see the module docstring)
CHUNKED_OVERFLOWS = ("ddt", "dA")
DSTATE = [pytest.param(False, id="y-only"), pytest.param(True, id="dstate")]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as ``test_torch_workloads.py``'s fixture: the
    plain scan is a token loop of small ops, and beside other test
    workers torch's thread pool oversubscribes the cores (the plain
    backward at B=2 S=256 ran about 100x slower in a 6-worker run than
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rel_err(want, got):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              or 1.0)


@functools.lru_cache(maxsize=None)
def _case(B, S, H, P, N, chunk, law, dstate):
    """Inputs as tests/test_kernels.py:244-249 draws them, with numpy (with
    ``law``, dt and A as ``init_params`` draws them), and the cotangents;
    then jax.vjp of the JAX ssd_ref and of L.ssd_chunked at them, in
    float32."""
    rng = np.random.default_rng(S + N + 7 * dstate + 11 * law)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    if law:
        dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), size=(H,)))
        dt = np.log1p(np.exp(np.log(np.expm1(dt0))
                             + 0.1 * rng.normal(size=(B, S, H))))
        A = -rng.uniform(1.0, 16.0, size=(H,))
    else:
        dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
        A = -np.exp(rng.normal(size=(H,)) * 0.3)
    dt, A = dt.astype(np.float32), A.astype(np.float32)
    Bm = (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    ds = (rng.normal(size=(B, H, P, N)).astype(np.float32) if dstate
          else np.zeros((B, H, P, N), np.float32))
    got = _jax_vjps(tuple(map(jnp.asarray, (x, dt, A, Bm, Cm))),
                    (jnp.asarray(dy), jnp.asarray(ds)), chunk=chunk)
    want = {name: [np.asarray(g) for g in grads]
            for name, grads in got.items()}
    inputs = (x, dt, A, Bm, Cm, dy, ds if dstate else None)
    return inputs, want


@functools.partial(jax.jit, static_argnames=("chunk",))
def _jax_vjps(args, cots, chunk):
    """jax.vjp of the JAX ssd_ref and L.ssd_chunked at ``cots``: one
    compile per shape, shared by the cases with and without a final-state
    cotangent (a zero one) and by the model-law case."""
    return {name: jax.vjp(fn, *args)[1](cots) for name, fn in (
        ("ssd_ref", jax_ssd_ref),
        ("ssd_chunked", functools.partial(JL.ssd_chunked, chunk=chunk)))}


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _assert_grads(want, got, what, law=True):
    for ref, wv in want.items():
        for name, w, g in zip(NAMES, wv, got):
            assert bool(torch.isfinite(g).all()), (what, name)
            if not np.isfinite(w).all():
                assert ref == "ssd_chunked" and name in CHUNKED_OVERFLOWS \
                    and not law, (what, name, ref, "JAX's is not finite")
                continue
            err = _rel_err(w, g)
            assert err <= GRAD_TOL, (what, name, ref, err)


# ---------------------------------------------------------------------------
# The scan's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dstate", DSTATE)
@pytest.mark.parametrize("B,S,H,P,N,chunk,law", SHAPES)
def test_plain_backward_matches_jax(B, S, H, P, N, chunk, law, dstate):
    (x, dt, A, Bm, Cm, dy, ds), want = _case(B, S, H, P, N, chunk, law,
                                             dstate)
    got = ssd_backward_ref(*map(_torch, (x, dt, A, Bm, Cm, dy, ds)))
    assert all(g.dtype == torch.float32 for g in got)
    _assert_grads(want, got, "ssd_backward_ref", law)


def test_the_wrappers_cpu_backward_is_the_plain_one():
    (x, dt, A, Bm, Cm, dy, ds), _ = _case(2, 128, 2, 64, 32, 128, False,
                                          True)
    args = tuple(map(_torch, (x, dt, A, Bm, Cm, dy)))
    got = sops.ssd_backward(*args, None, _torch(ds))
    for a, b in zip(got, ssd_backward_ref(*args, _torch(ds))):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("path", ["ssd_scan", "_SSDScan"])
@pytest.mark.parametrize("dstate", DSTATE)
@pytest.mark.parametrize("B,S,H,P,N,chunk,law", SHAPES)
def test_autograd_through_the_scan_matches_jax(B, S, H, P, N, chunk, law,
                                               dstate, path):
    """The wrapper under autograd (the plain scan, on the CPU) and its
    autograd Function (the card's route: forward, then ``ssd_backward``),
    at y's cotangent and, with ``dstate``, the final state's."""
    (x, dt, A, Bm, Cm, dy, ds), want = _case(B, S, H, P, N, chunk, law,
                                             dstate)
    live = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    if path == "ssd_scan":
        y, state = ssd_scan(*live, chunk=chunk)
    else:
        y, state = sops._SSDScan.apply(*live)
    outs, cots = [y], [torch.from_numpy(dy)]
    if ds is not None:
        outs.append(state)
        cots.append(torch.from_numpy(ds))
    got = torch.autograd.grad(outs, live, cots)
    _assert_grads(want, got, path, law)


@pytest.mark.parametrize("zeroed", range(5), ids=NAMES)
def test_a_dropped_gradient_of_the_function_fails(monkeypatch, zeroed):
    """Planted fault: ``_SSDScan`` whose backward zeroes one of its five
    gradients; the comparison against JAX must catch each."""
    real = sops.ssd_backward

    def faulty(*args, **kw):
        out = list(real(*args, **kw))
        out[zeroed] = torch.zeros_like(out[zeroed])
        return tuple(out)

    monkeypatch.setattr(sops, "ssd_backward", faulty)
    (x, dt, A, Bm, Cm, dy, ds), want = _case(2, 256, 4, 64, 128, 64, True,
                                             True)
    live = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    y, state = sops._SSDScan.apply(*live)
    got = torch.autograd.grad((y, state), live, (torch.from_numpy(dy),
                                                 torch.from_numpy(ds)))
    with pytest.raises(AssertionError, match=NAMES[zeroed]):
        _assert_grads(want, got, "_SSDScan with a dropped gradient")


def test_an_unused_final_state_costs_no_cotangent():
    """With the final state unused the Function's backward receives None
    for it (``set_materialize_grads(False)``) and passes no dstate."""
    seen = []
    real = sops.ssd_backward

    def spy(*args, **kw):
        seen.append(args[7] if len(args) > 7 else kw.get("dstate"))
        return real(*args, **kw)

    (x, dt, A, Bm, Cm, dy, _), want = _case(2, 256, 4, 64, 128, 64, True,
                                            False)
    live = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    try:
        sops.ssd_backward = spy
        y, _ = sops._SSDScan.apply(*live)
        got = torch.autograd.grad(y, live, torch.from_numpy(dy))
    finally:
        sops.ssd_backward = real
    assert seen == [None]
    _assert_grads(want, got, "_SSDScan, y only")


def test_a_training_forward_saves_no_output_it_discards():
    """What a training forward drops holds no memory through the graph:
    no tensor saved for the backward is the Function's final state (it
    saves its inputs and the forward's states) or the mixer's conv
    tail."""
    from repro_torch.models import model as TM

    def saved_by(fn):
        ptrs = []

        def pack(t):
            ptrs.append(t.data_ptr())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return fn(), ptrs

    (x, dt, A, Bm, Cm, _, _), _ = _case(2, 128, 2, 64, 32, 128, False,
                                        False)
    live = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    (y, state), ptrs = saved_by(lambda: sops._SSDScan.apply(*live))
    assert ptrs and state.data_ptr() not in ptrs

    cfg = AP.configs("mamba2-2.7b")[1]
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    lp = {k: v[0].detach().requires_grad_()
          for k, v in params["blocks"]["layer_0"]["mamba"].items()}
    h = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    (out, (_, tail)), ptrs = saved_by(
        lambda: TM._mamba_full(lp, cfg, h, None, plain=False))
    assert ptrs and out.grad_fn is not None
    assert tail.data_ptr() not in ptrs


# ---------------------------------------------------------------------------
# The kernel's equations, in float64
# ---------------------------------------------------------------------------


def _kernel_mirror(x, dt, A, Bm, Cm, dy, dstate, L=sops.SUB_CHUNK,
                   G=sops.HEAD_GROUP):
    """``ssd_backward.cu``'s algebra in numpy float64, in its bf16 body's
    decomposition.  The walk: per (b, h) the forward's state entering each
    L-row sub-chunk, and the state gradient walked from the last sub-chunk
    to the first.  The sub-chunks: per (b, sub-chunk) and group of G heads
    in head order, each head's dx, ddt and term of dA, the heads' state
    terms of dC and dB summed into the group's, W summed over the group's
    heads and multiplied by B and C once, after its last head; then the
    groups' partials summed in group order.  exp is taken only at
    arguments <= 0."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    n_sub = -(-S // L)
    pad = n_sub * L - S

    def padded(a):
        a = a.astype(np.float64)
        return np.concatenate(
            [a, np.zeros((a.shape[0], pad) + a.shape[2:])], 1) if pad else a

    x, dt, Bm, Cm, dy = map(padded, (x, dt, Bm, Cm, dy))
    tri = np.tril(np.ones((L, L), bool))

    def vectors(b, c, h):
        d = dt[b, c * L:(c + 1) * L, h]
        cum = np.cumsum(d * A[h])
        el = np.exp(cum[-1] - cum)
        E = np.where(tri, np.exp(np.where(tri, cum[:, None] - cum[None, :],
                                          0)), 0)
        return d, np.exp(cum), el, el * d, E

    # the walk
    s_in = np.zeros((Bsz, n_sub, H, P, N))
    dS = np.zeros_like(s_in)
    for b in range(Bsz):
        for h in range(H):
            st = np.zeros((P, N))
            for c in range(n_sub):
                r = slice(c * L, (c + 1) * L)
                s_in[b, c, h] = st
                _, ecum, _, w, _ = vectors(b, c, h)
                st = ecum[-1] * st + (x[b, r, h] * w[:, None]).T @ Bm[b, r]
            g = (np.zeros((P, N)) if dstate is None
                 else dstate[b, h].astype(np.float64))
            for c in reversed(range(n_sub)):
                r = slice(c * L, (c + 1) * L)
                dS[b, c, h] = g
                ecum = vectors(b, c, h)[1]
                g = ecum[-1] * g + (dy[b, r, h] * ecum[:, None]).T @ Cm[b, r]
    # the sub-chunks, a group of heads at a time
    n_groups = -(-H // G)
    dx, ddt = np.zeros_like(x), np.zeros_like(dt)
    dAp = np.zeros((Bsz, n_sub, H))
    dBp = np.zeros((Bsz, n_sub * L, n_groups, N))
    dCp = np.zeros_like(dBp)
    for b in range(Bsz):
        for c in range(n_sub):
            r = slice(c * L, (c + 1) * L)
            Bc, Cc = Bm[b, r], Cm[b, r]
            cb = Cc @ Bc.T
            for grp in range(n_groups):
                dCg, dBg, Wsum = np.zeros((L, N)), np.zeros((L, N)), 0.0
                for h in range(grp * G, min(H, (grp + 1) * G)):
                    d, ecum, el, w, E = vectors(b, c, h)
                    X, DY = x[b, r, h], dy[b, r, h]
                    Si, So = s_in[b, c, h], dS[b, c, h]
                    dx[b, r, h] = ((cb * E) * d[None, :]).T @ DY \
                        + w[:, None] * (Bc @ So.T)
                    D = DY @ X.T
                    G_ = cb * E * D
                    Wsum = Wsum + D * E * d[None, :]
                    q, rr = DY @ Si, X @ So
                    dCg += ecum[:, None] * q
                    dBg += w[:, None] * rr
                    u, v = (q * Cc).sum(1), (rr * Bc).sum(1)
                    dcum = (G_ * d[None, :]).sum(1) - d * G_.sum(0) \
                        + ecum * u - w * v
                    dcum[-1] += ecum[-1] * (So * Si).sum() + (w * v).sum()
                    da = np.cumsum(dcum[::-1])[::-1]
                    ddt[b, r, h] = G_.sum(0) + el * v + A[h] * da
                    dAp[b, c, h] = (d * da).sum()
                dCp[b, r, grp] = dCg + Wsum @ Bc
                dBp[b, r, grp] = dBg + Wsum.T @ Cc
    dB, dC = np.zeros((Bsz, n_sub * L, N)), np.zeros((Bsz, n_sub * L, N))
    for grp in range(n_groups):  # the sums, in group order
        dB += dBp[:, :, grp]
        dC += dCp[:, :, grp]
    dA = np.zeros(H)
    for b in range(Bsz):  # over (b, sub-chunk) in index order
        for c in range(n_sub):
            dA += dAp[b, c]
    return dx[:, :S], ddt[:, :S], dA, dB[:, :S], dC[:, :S]


@pytest.mark.parametrize("B,S,H,P,N,dstate", [
    (2, 130, 3, 16, 16, True),  # a ragged last sub-chunk
    (1, 192, 2, 32, 32, False),
    (2, 64, 2, 16, 128, True),  # one sub-chunk
    (1, 70, 11, 16, 16, True),  # two groups of heads, the last of 3
])
def test_kernel_equations_match_the_plain_backward(B, S, H, P, N, dstate):
    rng = np.random.default_rng(B * S + N)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    ds = rng.normal(size=(B, H, P, N)).astype(np.float32) if dstate else None
    want = ssd_backward_ref(*map(_torch, (x, dt, A, Bm, Cm, dy, ds)))
    got = _kernel_mirror(x, dt, A, Bm, Cm, dy, ds)
    for name, w, g in zip(NAMES, want, got):
        assert _rel_err(w.numpy(), g) <= GRAD_TOL, name


@pytest.mark.parametrize("H,code,groups", [
    (80, 1, 10), (80, 0, 80), (11, 1, 2), (3, 1, 1), (8, 1, 1), (9, 0, 9),
])
def test_backward_scratch_holds_a_partial_per_head_group(H, code, groups):
    """The bf16 body sums dB and dC over groups of ``HEAD_GROUP`` heads
    (the last group short where 8 does not divide H), the float32 body
    writes a partial a head; the group never depends on the batch."""
    assert sops.HEAD_GROUP == 8
    for B in (1, 4):
        states, dbp, dcp, dap = sops.backward_scratch_shapes(
            B, 200, H, 64, 128, code)
        assert states == sops.states_shape(B, 200, H, 64, 128)
        assert dbp == dcp == (B, 200, groups, 128)
        assert dap == (B, 4, H)


def _bf16_parts(a, k):
    """A float32 tensor as a sum of k bf16 tensors, each holding what
    rounding to the parts before it lost (``mma_bf16.cuh``
    ``split_bf16x2``)."""
    parts, rest = [], a
    for _ in range(k):
        part = rest.to(torch.bfloat16)
        parts.append(part)
        rest = rest - part.float()
    return parts


@pytest.mark.parametrize("product,m,k,n,float_left", [
    ("W B (dC)", 64, 64, 128, True),
    ("dy S_in (q)", 64, 64, 128, False),
    ("(exp(cum) dy)^T C (the walk)", 64, 64, 128, True),
    ("B dS_out^T (dx)", 64, 128, 64, False),
])
def test_three_bf16_parts_keep_float32_precision(product, m, k, n,
                                                 float_left):
    """The bf16 body's precision rule, emulated on the CPU at the
    backward's products: a float32 operand split into three bf16 parts,
    each multiplied by an exact bf16 operand with float32 accumulation
    (the tensor cores' bf16 products are exact in float32, their sums
    float32), smallest part first, lies within 1e-6 of the float32
    product, relative to its largest magnitude; two parts do not."""
    rng = np.random.default_rng(m * k + n + float_left)
    fshape, bshape = ((m, k), (k, n)) if float_left else ((k, n), (m, k))
    # float32 values over several magnitudes, as exp(cum) spreads them
    f = torch.from_numpy((rng.normal(size=fshape) * np.exp(
        rng.uniform(-6, 0, size=fshape))).astype(np.float32))
    if product.startswith("W"):
        f = torch.tril(f)  # W is 0 above the diagonal
    bf = torch.from_numpy(rng.normal(size=bshape).astype(np.float32)).to(
        torch.bfloat16)

    def mm(a, b):
        return a @ b if float_left else b @ a

    want = mm(f, bf.float())
    errs = {}
    for n_parts in (2, 3):
        got = torch.zeros_like(want)
        for part in reversed(_bf16_parts(f, n_parts)):
            got = got + mm(part.float(), bf.float())
        errs[n_parts] = float((got - want).abs().max() / want.abs().max())
    assert errs[3] <= 1e-6, (product, errs)
    assert errs[2] > 1e-6, (product, errs)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _batch(vocab, B=4, S=64, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _live_weights(rc, seed=0):
    npp = jax.tree.map(np.asarray, JM.init_params(rc, jax.random.key(seed)))
    AP._perturb_norms(npp, np.random.default_rng(seed))
    return live_state(npp, rc)


def _grads_match(rc, trc, npp, jb, tb, **tkw):
    jcfg = JT.TrainStepConfig(ce_chunk=32, **tkw)
    tcfg = TT.TrainStepConfig(ce_chunk=32, **tkw)
    (jl, ja), jg = jax.jit(jax.value_and_grad(JT.make_loss_fn(rc, jcfg),
                                              has_aux=True))(
        jax.tree.map(jnp.asarray, npp), jb)
    (tl, ta), tg = TS.make_grad_fn(trc, tcfg)(params_from_jax(npp, "cpu"),
                                              tb)
    assert _rel_err(jl, tl) <= LOSS_TOL
    for key in ("ce", "moe_aux"):
        assert _rel_err(ja[key], ta[key]) <= LOSS_TOL, key
    jflat = jax.tree.leaves(jg)
    assert len(jflat) == len(leaves(tg))
    for path, a, t in zip(jax.tree_util.tree_leaves_with_path(jg), jflat,
                          leaves(tg)):
        assert t.dtype == torch.float32
        err = _rel_err(a, t)
        assert err <= GRAD_TOL, (jax.tree_util.keystr(path[0]), err)
    return jg


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_mamba2_loss_and_every_gradient_match_jax(remat):
    rc, trc = AP.configs("mamba2-2.7b")
    assert rc.has_mamba and rc.mamba.chunk == 32
    jb, tb = _batch(rc.vocab_size)
    jg = _grads_match(rc, trc, _live_weights(rc), jb, tb, remat=remat)
    # the scan reaches the weights: A_log and dt_bias have gradients
    mamba = jg["blocks"]["layer_0"]["mamba"]
    assert float(jnp.abs(mamba["A_log"]).max()) > 0
    assert float(jnp.abs(mamba["dt_bias"]).max()) > 0


def test_jamba_loss_and_every_gradient_match_jax():
    """Reduced jamba: 7 Mamba2 layers, one attention layer (the flash
    gradient), MoE and MLP feed-forwards, the CE plus the aux loss."""
    rc, trc = AP.configs("jamba-v0.1-52b")
    assert rc.has_mamba and rc.moe is not None
    assert {s.mixer for s in rc.block_pattern} == {"mamba", "attn"}
    jb, tb = _batch(rc.vocab_size, B=2)
    _grads_match(rc, trc, _live_weights(rc), jb, tb)


def test_mamba2_microbatches_match_jax():
    rc, trc = AP.configs("mamba2-2.7b")
    npp = _live_weights(rc, seed=2)
    jb, tb = _batch(rc.vocab_size, seed=3)
    sched = dict(warmup=5, total=100, peak_lr=LR)
    jstep = jax.jit(JT.make_train_step(
        rc, JT.TrainStepConfig(ce_chunk=32, microbatches=2),
        JT.cosine_schedule(**sched)))
    tstep = TT.make_train_step(
        trc, TT.TrainStepConfig(ce_chunk=32, microbatches=2),
        TT.cosine_schedule(**sched))
    jp = jax.tree.map(jnp.asarray, npp)
    jp, _, jm = jstep(jp, JT.init_opt_state(jp), jb)
    tp = params_from_jax(npp, device="cpu")
    tp, to, tm = tstep(tp, TT.init_opt_state(tp), tb)
    for key in ("loss", "ce", "grad_norm"):
        assert _rel_err(jm[key], tm[key]) <= LOSS_TOL, key
    assert int(to["step"]) == 1
    for a, t in zip(jax.tree.leaves(jp), leaves(tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=4 * LR,
                                   rtol=0)


def test_mamba_configs_are_trainable_and_int8_is_not():
    for arch in ("mamba2-2.7b", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(AP.configs(arch)[1])
        params = TS.M.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        TS.M.check_trainable(cfg, params)
        with pytest.raises(NotImplementedError, match="item 6"):
            TS.M.check_trainable(cfg, TS.M.quantize_params(params))


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------


def _train(tmp_path, steps):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--arch", "mamba2-2.7b", "--steps", str(steps),
         "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "2"],
        env=env, capture_output=True, text=True, timeout=180, cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    return run.stdout


def test_launch_train_mamba2_checkpoints_and_resumes(tmp_path):
    out = _train(tmp_path, 3)
    assert re.search(r"^step 1/3 loss=\d+\.\d{4} lr=\S+ gnorm=\S+ "
                     r"\(\d+\.\ds\)$", out, re.M), out
    assert out.strip().endswith("done")
    mgr = TT.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.steps() == [2, 3]
    out = _train(tmp_path, 4)
    assert "resumed from step 3" in out, out
    assert re.search(r"^step 4/4 ", out, re.M), out
    assert mgr.steps() == [2, 3, 4]


# ---------------------------------------------------------------------------
# The kernel's source
# ---------------------------------------------------------------------------


def test_ssd_backward_source_adds_no_floats_atomically():
    """Every sum of ssd_backward.cu runs in a fixed order: no atomic and
    no reduction instruction at all; the sums over heads and over (b,
    sub-chunk) are a launch of their own."""
    from repro_torch.kernels import _build

    text = (_build.CSRC / "ssd_backward.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "atomic" not in code and "cp.reduce" not in code
    assert not re.findall(r"\b(?:red|atom)\.[\w.:]+", code)
    assert "ssd_backward" in _build.KERNELS
    cases = tuple(int(n) for n in re.findall(
        r"case (\d+): err = launch_dtype<\1>", text))
    assert cases == sops.STATE_DIMS
