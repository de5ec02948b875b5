"""Model-level parity of the port against ``repro.models.model`` for the
architectures beyond the plain dense family (``test_torch_moe.py``,
``test_torch_window_hybrid.py``): the same reduced config on both sides,
the JAX weights carried across with ``params_from_jax`` and every norm
moved off its zero init, then forward (with the MoE auxiliary loss),
prefill with a ring shorter than the prompt plus greedy decode steps
(each fed the JAX model's own token), and the paged prefill, decode and
verify, to the JAX suite's tolerances (tests/test_kernels.py:18)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as JB
from repro.configs.registry import REGISTRY
from repro.models import model as M
from repro_torch.configs import base as TB
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.models import model as TM
from repro_torch.models.bridge import params_from_jax

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def configs(arch, dtype="float32", window=None, **kw):
    """The reduced config of ``arch`` on both sides, in ``dtype``, with
    every windowed layer's window set to ``window`` (``reduced()`` keeps
    the full one) and the MoE fields in ``kw`` (e.g. capacity_factor)."""
    out = []
    for reg, base in ((REGISTRY, JB), (TREG, TB)):
        cfg = reg[arch].reduced()
        rep = dict(dtype=dtype)
        if window is not None:
            rep["block_pattern"] = tuple(
                dataclasses.replace(s, window=window if s.window else None)
                for s in cfg.block_pattern)
        if kw:
            rep["moe"] = dataclasses.replace(cfg.moe, **kw)
        out.append(dataclasses.replace(cfg, **rep))
    return out


def _perturb_norms(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_norms(v, rng)
        elif k.endswith("norm"):
            tree[k] = (np.asarray(v, np.float32)
                       + rng.normal(0.0, 0.5, v.shape)).astype(v.dtype)


def pair(rc, trc, seed=0):
    """JAX and port params of the same weights."""
    np_params = jax.tree.map(np.asarray,
                             M.init_params(rc, jax.random.key(seed)))
    _perturb_norms(np_params, np.random.default_rng(seed))
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_jax(np_params, device="cpu"))


def close(j, t, dtype="float32", what=""):
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype], err_msg=what,
    )


def check_forward(rc, trc, params, tparams, toks, dtype="float32"):
    hj, aux_j = M.forward(params, rc, tokens=jnp.asarray(toks, jnp.int32))
    ht, aux_t = TM.forward(tparams, trc, torch.from_numpy(toks))
    close(hj, ht, dtype, "hidden")
    close(M.lm_logits(params, rc, hj), TM.lm_logits(tparams, trc, ht),
          dtype, "logits")
    close(aux_j, aux_t, dtype, "moe aux loss")
    return float(aux_t)


def close_tree(j, t, what):
    for name, entry in j.items():
        for key, leaf in entry.items():
            if leaf.dtype == jnp.int32:
                np.testing.assert_array_equal(
                    t[name][key].numpy(), np.asarray(leaf),
                    err_msg=f"{what} {name}.{key}")
            else:
                close(leaf, t[name][key], what=f"{what} {name}.{key}")


def check_prefill_decode(rc, trc, params, tparams, toks, lengths, max_len,
                         steps=16):
    """Prefill (the logits and the whole cache), then ``steps`` decode
    steps (the logits and, at the end, the whole cache)."""
    decode = jax.jit(partial(M.decode_step, cfg=rc))
    lj, cj = M.prefill(params, rc, jnp.asarray(toks), jnp.asarray(lengths),
                       max_len=max_len)
    lt, ct = TM.prefill(tparams, trc, torch.from_numpy(toks),
                        torch.from_numpy(lengths), max_len=max_len)
    close(lj, lt, what="prefill logits")
    close_tree(cj, ct, "prefill cache")
    pos = lengths.copy()
    tok = np.array(jnp.argmax(lj, -1), np.int32)
    for t in range(steps):
        lj, cj = decode(params, tokens=jnp.asarray(tok), cache=cj,
                        lengths=jnp.asarray(pos))
        lt, ct = TM.decode_step(tparams, trc, torch.from_numpy(tok), ct,
                                torch.from_numpy(pos))
        close(lj, lt, what=f"decode step {t}")
        tok = np.array(jnp.argmax(lj, -1), np.int32)
        pos = pos + 1
    close_tree(cj, ct, f"cache after {steps} steps")
    return ct


def check_paged(rc, trc, params, tparams, seed=7, k=2):
    """Paged prefill, decode steps growing the tables page by page on
    non-contiguous pages, then a verify pass of k + 1 tokens: logits at
    every call and the whole pool at the end."""
    rng = np.random.default_rng(seed)
    B, P_len, G_len, ps, num_pages, Pmax = 2, 24, 6, 8, 16, 5
    toks = rng.integers(0, rc.vocab_size,
                        (B, P_len + G_len + k + 1)).astype(np.int32)
    cj = M.init_paged_cache(rc, num_pages, ps)
    ct = TM.init_paged_cache(trc, num_pages, ps, device="cpu")
    bt = np.full((B, Pmax), -1, np.int32)

    def cover(n):
        need = -(-n // ps)
        bt[0, :need] = np.arange(need)
        bt[1, :need] = np.arange(need) + 6

    cover(P_len)
    lengths = np.array([P_len, P_len - 5], np.int32)  # a pad tail in row 1
    zeros = np.zeros((B,), np.int32)
    lj, cj = M.prefill_paged(params, rc, jnp.asarray(toks[:, :P_len]),
                             jnp.asarray(lengths), jnp.asarray(zeros),
                             jnp.asarray(bt), cj)
    lt, ct = TM.prefill_paged(tparams, trc, torch.from_numpy(toks[:, :P_len]),
                              torch.from_numpy(lengths),
                              torch.from_numpy(zeros), torch.from_numpy(bt),
                              ct)
    close(lj, lt, what="paged prefill logits")
    decode = jax.jit(partial(M.decode_step_paged, cfg=rc))
    pos = lengths.copy()
    for t in range(G_len):
        cover(int(pos.max()) + 1)
        lj, cj = decode(params, tokens=jnp.asarray(toks[:, P_len + t]),
                        cache=cj, lengths=jnp.asarray(pos),
                        block_tables=jnp.asarray(bt))
        lt, ct = TM.decode_step_paged(tparams, trc,
                                      torch.from_numpy(toks[:, P_len + t]),
                                      ct, torch.from_numpy(pos),
                                      torch.from_numpy(bt))
        close(lj, lt, what=f"paged decode step {t}")
        pos = pos + 1
    cover(int(pos.max()) + k + 1)
    ver = toks[:, P_len + G_len:]
    lj, cj = M.verify_step_paged(params, rc, jnp.asarray(ver), cj,
                                 jnp.asarray(pos), jnp.asarray(bt))
    lt, ct = TM.verify_step_paged(tparams, trc, torch.from_numpy(ver), ct,
                                  torch.from_numpy(pos), torch.from_numpy(bt))
    close(lj, lt, what="verify logits")
    close_tree(cj, ct, "pool")


def check_layers(rc, trc, params, tparams, toks, dtype="bfloat16"):
    """Each layer of the first block on the JAX model's own input to it
    (the mixer, then the FFN on the mixer's residual), layer by layer
    along the JAX path: no layer's rounding feeds the next one's check."""
    x = jnp.take(params["embed"], jnp.asarray(toks), axis=0)
    B, S = toks.shape
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    tpos = torch.arange(S).expand(B, S)
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    tbp = TM._index(tparams["blocks"], 0)

    def port(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            getattr(torch, dtype))

    mamba = jax.jit(lambda p, x: M._mamba_full(p, rc, x, None)[0])
    ffn = jax.jit(lambda p, x: M._ffn(p, rc, x)[0])
    for i, spec in enumerate(rc.block_pattern):
        lp, tlp = bp[f"layer_{i}"], tbp[f"layer_{i}"]
        if spec.mixer == "attn":
            oj, _ = M._attn_full(lp["attn"], rc, spec, x, positions, None)
            ot, _ = TM._attn_full(tlp["attn"], trc, trc.block_pattern[i],
                                  port(x), tpos, None, False)
        else:
            oj = mamba(lp["mamba"], x)
            ot, _ = TM._mamba_full(tlp["mamba"], trc, port(x), None, False)
        close(oj, ot, dtype, f"layer {i} {spec.mixer}")
        x = x + oj
        if spec.ffn != "none":
            oj = ffn(lp, x)
            ot, _ = TM._ffn(tlp, trc, port(x))
            close(oj, ot, dtype, f"layer {i} {spec.ffn}")
            x = x + oj
