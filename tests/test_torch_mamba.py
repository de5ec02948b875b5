"""The port's Mamba2 path against the JAX package's, on
``REGISTRY["mamba2-2.7b"].reduced()`` in float32 with the JAX weights
carried across by ``params_from_jax``.  The weights are the JAX init
with x/B/C rescaled by ``_mamba_weights.live_state``: under the init
itself the SSM state never reaches the logits, and these tests could
not see it.

(c) The model: forward, prefill logits with the ``ssm``/``conv`` cache
    entries, then 16 decode steps each fed the JAX model's own token
    (tests/test_models.py:54), and decode after prefill against the
    port's own forward.
(d) Serving: a torch and a JAX real cluster in the ``plain-pd`` and
    ``chunked-pd`` scenarios are bit-equal in timing, placement, energy
    and stream lengths; every torch token passes the near-argmax replay
    through the JAX model; served tokens equal a direct port-model loop;
    Sim==Real holds; a decode slot steps only for a request in the batch.
(e) ``paged=True`` raises before any pool exists, and a bf16 cast in the
    bridge keeps ``A_log``/``dt_bias``/``D`` float32.
(f) Planted faults (scan output dropped, prefill state zeroed, state
    dropped in the P->D handoff) make (c) and (d) fail.

Tolerances: float32 logits and hidden states to 2e-5 absolute
(tests/test_kernels.py:18); the cache entries scale-normalised to 1e-5,
the SSD scan's float32 tolerance (tests/test_kernels.py:256-262), since
the state's scale follows the weights.  The port's scan (the token
recurrence on CPU) and the JAX model's chunked scan sum in another
order.
"""
import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as JS
from repro.configs.registry import REGISTRY
from repro.core.power import A100
from repro.models import model as M
from repro.serving.cluster import build_predictor
from repro.serving.realengine import make_real_backend_factory
import repro_torch.serving as TS
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.core.hwmodel import HardwareModel as THardwareModel
from repro_torch.core.power import A100 as TA100
from repro_torch.models import model as TM
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import realengine as TRE
from repro_torch.serving.cluster import build_predictor as t_build_predictor
from _mamba_weights import live_state
from _port_parity import assert_same_run, replay_near_argmax

TOL = 2e-5
STATE_TOL = 1e-5
MAX_LEN = 128
ARCH = "mamba2-2.7b"


def _close(j, t, what="", tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _close_scaled(j, t, what=""):
    want = np.asarray(j, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0.1, f"{what}: a state of scale {scale} tests nothing"
    err = float(np.abs(t.float().numpy() - want).max()) / scale
    assert err <= STATE_TOL, f"{what}: scale-normalised error {err}"


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def pair():
    rc = dataclasses.replace(REGISTRY[ARCH].reduced(), dtype="float32")
    trc = dataclasses.replace(TREG[ARCH].reduced(), dtype="float32")
    live = live_state(
        jax.tree.map(np.asarray, M.init_params(rc, jax.random.key(0))), rc)
    params = jax.tree.map(jnp.asarray, live)
    tparams = params_from_jax(live, device="cpu")
    return rc, trc, params, tparams


# ---------------------------------------------------------------------------
# (c) the model
# ---------------------------------------------------------------------------


def test_config_is_the_jax_packages():
    assert dataclasses.asdict(TREG[ARCH]) == dataclasses.asdict(
        REGISTRY[ARCH])
    TM.check_supported(TREG[ARCH])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_jax_layout_and_scale(dtype):
    """Same tree, shapes, dtypes (A_log, dt_bias and D float32 in a bf16
    model) and spreads as M.init_params; the draws themselves differ."""
    rc = dataclasses.replace(REGISTRY[ARCH].reduced(), dtype=dtype)
    trc = dataclasses.replace(TREG[ARCH].reduced(), dtype=dtype)
    jp = jax.tree.map(np.asarray, M.init_params(rc, jax.random.key(0)))
    tp = TM.init_params(trc, torch.Generator().manual_seed(0), device="cpu")
    jl, tl = dict(_leaves_with_path(jp)), dict(_leaves_with_path(tp))
    assert jl.keys() == tl.keys()
    for path, leaf in jl.items():
        t = tl[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype) == f"torch.{leaf.dtype}", path
        want = np.asarray(leaf, np.float32)
        got = t.float().numpy()
        if path[-1] == "D":
            np.testing.assert_array_equal(got, want)
        elif path[-1] == "A_log":  # -A = exp(A_log) ~ U[1, 16]
            for a in (got, want):
                assert 1.0 - 1e-6 <= np.exp(a).min() <= np.exp(a).max() \
                    <= 16.0 + 1e-4, path
        elif path[-1] == "dt_bias":  # softplus(dt_bias) in [1e-3, 0.1]
            for a in (got, want):
                dt0 = np.log1p(np.exp(a))
                assert 1e-3 * (1 - 1e-4) <= dt0.min() <= dt0.max() \
                    <= 0.1 * (1 + 1e-4), path
        else:
            assert float(got.std()) == pytest.approx(
                float(want.std()), rel=0.2, abs=1e-9), path


def test_bridge_is_leaf_for_leaf(pair):
    rc, trc, params, tparams = pair
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == sum(1 for _ in _leaves_with_path(tparams))
    for path, leaf in flat:
        t = _at(tparams, [k.key for k in path])
        assert str(t.dtype) == f"torch.{leaf.dtype}"
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_forward_matches(pair, plain):
    rc, trc, params, tparams = pair
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 64))
    hj, _ = M.forward(params, rc, tokens=jnp.asarray(toks, jnp.int32))
    ht, _ = TM.forward(tparams, trc, torch.from_numpy(toks),
                       plain_attention=plain)
    _close(hj, ht, "hidden")
    _close(M.lm_logits(params, rc, hj), TM.lm_logits(tparams, trc, ht),
           "logits")


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_prefill_then_decode_matches(pair, plain):
    """Ragged prompts (row 0 right-padded): the prefill logits, the final
    SSM state and the conv tail of every row, then 16 decode steps."""
    rc, trc, params, tparams = pair
    rng = np.random.default_rng(2)
    B, S, steps = 3, 64, 16
    toks = rng.integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    lengths = np.array([37, 64, 2], np.int32)  # row 2 shorter than K-1
    decode = jax.jit(partial(M.decode_step, cfg=rc))
    lj, cj = M.prefill(params, rc, jnp.asarray(toks), jnp.asarray(lengths),
                       max_len=MAX_LEN)
    lt, ct = TM.prefill(tparams, trc, torch.from_numpy(toks),
                        torch.from_numpy(lengths), max_len=MAX_LEN,
                        plain_attention=plain)
    assert lt.dtype == torch.float32 and lt.shape == (B, rc.vocab_size)
    _close(lj, lt, "prefill logits")
    entry_j, entry_t = cj["layer_0"], ct["layer_0"]
    assert set(entry_t) == set(entry_j) == {"ssm", "conv"}
    for key in ("ssm", "conv"):
        assert tuple(entry_t[key].shape) == entry_j[key].shape
        assert str(entry_t[key].dtype) == f"torch.{entry_j[key].dtype}"
        _close_scaled(entry_j[key], entry_t[key], f"prefill cache {key}")
    pos = lengths.copy()
    tok = np.array(jnp.argmax(lj, -1), np.int32)
    for t in range(steps):
        lj, cj = decode(params, tokens=jnp.asarray(tok), cache=cj,
                        lengths=jnp.asarray(pos))
        lt, ct = TM.decode_step(tparams, trc, torch.from_numpy(tok), ct,
                                torch.from_numpy(pos), plain_attention=plain)
        _close(lj, lt, f"decode step {t}")
        tok = np.array(jnp.argmax(lj, -1), np.int32)
        pos = pos + 1
    for key in ("ssm", "conv"):
        _close_scaled(cj["layer_0"][key], ct["layer_0"][key],
                      f"decoded {key}")


def test_decode_after_prefill_matches_forward():
    """tests/test_models.py:54 within the port: decode_step after prefill
    reproduces the full-sequence forward logits token by token."""
    trc = dataclasses.replace(TREG[ARCH].reduced(), dtype="float32")
    tp = live_state(TM.init_params(trc, torch.Generator().manual_seed(5),
                                   device="cpu"), trc)
    B, P, G = 2, 32, 32  # prompt and forward both whole chunks
    toks = torch.randint(0, trc.vocab_size, (B, P + G),
                         generator=torch.Generator().manual_seed(6))
    h, _ = TM.forward(tp, trc, toks)
    ref = TM.lm_logits(tp, trc, h)
    lengths = torch.full((B,), P)
    logits, cache = TM.prefill(tp, trc, toks[:, :P], lengths, max_len=P + G)
    torch.testing.assert_close(logits, ref[:, P - 1], rtol=2e-3, atol=2e-3)
    pos = lengths
    for t in range(G):
        logits, cache = TM.decode_step(tp, trc, toks[:, P + t], cache, pos)
        torch.testing.assert_close(logits, ref[:, P + t], rtol=2e-3,
                                   atol=2e-3)
        pos = pos + 1


def test_greedy_entry_points():
    trc = dataclasses.replace(TREG[ARCH].reduced(), dtype="float32")
    tp = live_state(TM.init_params(trc, torch.Generator().manual_seed(3),
                                   device="cpu"), trc)
    toks = torch.randint(0, trc.vocab_size, (1, 32),
                         generator=torch.Generator().manual_seed(4))
    lengths = torch.tensor([27])
    ids, cache = TM.prefill_greedy(tp, trc, toks, lengths, max_len=64)
    logits, cache_p = TM.prefill(tp, trc, toks, lengths, max_len=64,
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


# ---------------------------------------------------------------------------
# (d) serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side(pair):
    rc, _, params, _ = pair
    model = REGISTRY[ARCH]
    pred = build_predictor(model, A100, A100.freq_levels_2, kv_cap=400_000)
    return SimpleNamespace(
        pkg=JS, model=model, chip=A100, rc=rc, params=params, pred=pred,
        factory=lambda **kw: make_real_backend_factory(
            rc, params, slots=8, max_len=MAX_LEN, **kw),
    )


@pytest.fixture(scope="module")
def torch_side(pair):
    _, trc, _, tparams = pair
    model = TREG[ARCH]
    pred = t_build_predictor(model, TA100, TA100.freq_levels_2,
                             kv_cap=400_000)
    return SimpleNamespace(
        pkg=TS, model=model, chip=TA100, rc=trc, params=tparams, pred=pred,
        factory=lambda **kw: TRE.make_real_backend_factory(
            trc, tparams, slots=8, max_len=MAX_LEN, device="cpu", **kw),
    )


def _workload(side, seed=21):
    p = side.pkg
    tiny = p.DatasetDist(
        "tiny",
        prefill=p.LengthDist(24.0, 10.0, hi=60),
        decode=p.LengthDist(6.0, 3.0, hi=12),
    )
    reqs = p.poisson_workload(tiny, 2.5, 10.0, seed=seed)
    return p.attach_tokens(reqs, side.rc.vocab_size, seed=seed + 1)


def _pressure_workload(side):
    """Batch-tier long decodes hold one decode instance; an interactive
    burst lands meanwhile (forces preemption).  Mamba2 decodes faster on
    the hardware model than llama, so the burst comes at 0.2 s, not 0.4."""
    p = side.pkg
    reqs = [p.Request(i, 0.01 * i, prompt_len=40, decode_len=80,
                      tier="batch") for i in range(3)]
    reqs += [p.Request(3 + j, 0.2 + 0.01 * j, prompt_len=60, decode_len=10,
                       tier="interactive") for j in range(3)]
    return p.attach_tokens(reqs, side.rc.vocab_size, seed=5)


SCENARIOS = {
    "plain-pd": dict(chunked_prefill=False, prefill_chunk_tokens=None),
    "chunked-pd": dict(prefill_chunk_tokens=32),
    "pressure": dict(n_decode=1, kv_capacity_tokens=200,
                     prefill_chunk_tokens=32, slo_tiers="tiers",
                     admission_control=False),
    "failure": dict(prefill_chunk_tokens=32, slo_tiers="tiers",
                    admission_control=False),
}


def _cluster_cfg(side, scenario, **kw):
    base = dict(
        model=side.model, chip=side.chip, n_prefill=1, n_decode=2,
        policy="voltana", predictor=side.pred, kv_capacity_tokens=400_000,
        online_adapt=False, decode_max_running=8, seed=4, noise_sigma=0.0,
    )
    for k, v in SCENARIOS[scenario].items():
        base[k] = side.pkg.DEFAULT_TIERS if v == "tiers" else v
    base.update(kw)
    return side.pkg.ClusterConfig(**base)


def _reqs_for(side, scenario):
    if scenario in ("pressure", "failure"):
        return _pressure_workload(side)
    return _workload(side)


@pytest.mark.parametrize("scenario", ["plain-pd", "chunked-pd"])
def test_torch_real_cluster_matches_jax_real_cluster(jax_side, torch_side,
                                                     scenario):
    runs = []
    for side in (jax_side, torch_side):
        reqs = _reqs_for(side, scenario)
        m = side.pkg.PDCluster(_cluster_cfg(
            side, scenario, backend_factory=side.factory())).run(reqs)
        assert m.finished_frac() == 1.0
        for r in reqs:
            assert len(r.output_tokens) == r.decode_len + 1
        runs.append((reqs, m))
    (ra, ma), (rb, mb) = runs
    assert_same_run(ra, ma, rb, mb)
    replay_near_argmax(jax_side.rc, jax_side.params, rb, MAX_LEN)


def test_served_tokens_match_direct_model_loop(torch_side):
    """tests/test_realengine.py:63: what the cluster serves is what the
    port's own prefill/decode loop produces for each request alone."""
    side = torch_side
    reqs = _workload(side, seed=7)[:4]
    side.pkg.PDCluster(_cluster_cfg(
        side, "plain-pd", n_decode=1,
        backend_factory=side.factory())).run(reqs)
    for r in reqs:
        n = len(r.prompt_tokens)
        buf = torch.zeros((1, TRE._bucket(n, hi=MAX_LEN)), dtype=torch.int32)
        buf[0, :n] = torch.tensor(r.prompt_tokens)
        logits, cache = TM.prefill(side.params, side.rc, buf,
                                   torch.tensor([n]), max_len=MAX_LEN)
        want = [int(logits[0].argmax())]
        pos = torch.tensor([n])
        for _ in range(r.decode_len):
            logits, cache = TM.decode_step(
                side.params, side.rc, torch.tensor([want[-1]]), cache, pos)
            want.append(int(logits[0].argmax()))
            pos = pos + 1
        assert r.output_tokens == want, f"req {r.rid} diverged"


def _pinned(factory, log):
    """Wrap a factory so every real decode step checks that the slots it
    steps hold exactly the requests in its batch: the step advances every
    resident slot, and a recurrent state cannot be rolled back."""
    def wrapped(kind, idx, hw, seed, tp=None):
        be = factory(kind, idx, hw, seed, tp=tp)
        inner = be._real_decode_step

        def step(reqs):
            rids = [r.rid for r in reqs]
            assert len(set(rids)) == len(rids)
            assert set(be.slot_of) == set(rids), (sorted(be.slot_of), rids)
            log.append(len(rids))
            return inner(reqs)

        be._real_decode_step = step
        return be

    return wrapped


@pytest.mark.parametrize("scenario", ["chunked-pd", "pressure", "failure"])
def test_sim_and_real_agree_and_slots_step_only_for_the_batch(torch_side,
                                                              scenario):
    """tests/test_backend_parity.py:100, :287 and :437 with the Mamba2
    backend: Sim==Real, also through preemption (a resume rebuilds the
    recurrent state from prompt + delivered ids) and a decode failure
    with a scale-out (the restart regenerates from scratch), while every
    decode step's batch is exactly the resident slots."""
    side = torch_side
    runs, log = [], []
    for factory in (None, _pinned(side.factory(), log)):
        reqs = _reqs_for(side, scenario)
        cl = side.pkg.PDCluster(_cluster_cfg(side, scenario,
                                             backend_factory=factory))
        if scenario == "failure":
            cl.schedule_failure(0.1, "decode", 0)
            cl.schedule_scale_out(0.15, "decode")
        runs.append((reqs, cl.run(reqs)))
    (rs, ms), (rr, mr) = runs
    assert ms.finished_frac() == 1.0
    if scenario == "pressure":
        assert ms.preemptions_total() > 0, "scenario never preempted"
    if scenario == "failure":
        assert any(r.restarts > 0 for r in rr), "the failure hit nobody"
    assert_same_run(rs, ms, rr, mr, streams=False)
    for r in rr:
        assert len(r.output_tokens) == r.decode_len + 1
    assert log, "never decoded"
    if scenario != "chunked-pd":  # short Poisson decodes rarely overlap
        assert max(log) > 1, "never decoded a batch"


# ---------------------------------------------------------------------------
# (e) what the recurrent state rules out, and the bridge's float32 leaves
# ---------------------------------------------------------------------------


def test_paged_mamba_raises_before_any_pool(torch_side, monkeypatch):
    side = torch_side
    hw = THardwareModel(side.model, side.chip)

    def no_pool(*a, **k):
        raise AssertionError("a KV pool was allocated for a Mamba config")

    monkeypatch.setattr(TRE, "KVPool", no_pool)
    with pytest.raises(ValueError, match="Mamba"):
        TRE.RealBackend(hw, side.rc, side.params, slots=2, max_len=64,
                        paged=True, device="cpu")
    factory = side.factory(paged=True, page_size=16)
    with pytest.raises(ValueError, match="Mamba"):
        factory("decode", 0, hw, 0)
    with pytest.raises(ValueError, match="Mamba"):
        TM.init_paged_cache(side.rc, 8, 16, device="cpu")
    with pytest.raises(ValueError, match="attention"):
        TRE.make_draft_config(side.rc)


def test_bridge_bf16_cast_keeps_float32_leaves(pair):
    _, _, params, _ = pair
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu",
                         dtype=torch.bfloat16)
    mamba = tp["blocks"]["layer_0"]["mamba"]
    for name in ("A_log", "dt_bias", "D"):
        assert mamba[name].dtype == torch.float32, name
        np.testing.assert_array_equal(
            mamba[name].numpy(),
            np.asarray(params["blocks"]["layer_0"]["mamba"][name]))
    for name in ("in_proj", "conv_w", "out_proj", "norm", "gnorm"):
        assert mamba[name].dtype == torch.bfloat16, name
    assert tp["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# (f) planted faults: the checks above see the state
# ---------------------------------------------------------------------------


_ssd_scan = TM.ssd_scan
_put_slot = TRE._put_slot


def _scan_zeroes(out):
    """The model's ``ssd_scan`` with output ``out`` (0: y, 1: the final
    state) zeroed."""
    def scan(*a, **k):
        res = list(_ssd_scan(*a, **k))
        res[out] = torch.zeros_like(res[out])
        return tuple(res)
    return scan


def _handoff_drops_state(dst_tree, src_tree, slot):
    _put_slot(dst_tree, src_tree, slot)
    for entry in dst_tree.values():
        entry["ssm"][:, slot] = 0


@pytest.mark.parametrize("fault", ["scan-output-dropped",
                                   "prefill-state-zeroed",
                                   "handoff-drops-state"])
def test_planted_fault_fails_the_parity_check(pair, jax_side, torch_side,
                                              monkeypatch, fault):
    """Each fault breaks what the port hands on from the SSD scan, and the
    parity test that covers that stage must then fail."""
    if fault == "scan-output-dropped":
        monkeypatch.setattr(TM, "ssd_scan", _scan_zeroes(0))
        run = partial(test_forward_matches, pair, False)
    elif fault == "prefill-state-zeroed":
        monkeypatch.setattr(TM, "ssd_scan", _scan_zeroes(1))
        run = partial(test_prefill_then_decode_matches, pair, False)
    else:
        monkeypatch.setattr(TRE, "_put_slot", _handoff_drops_state)
        run = partial(test_torch_real_cluster_matches_jax_real_cluster,
                      jax_side, torch_side, "plain-pd")
    with pytest.raises(AssertionError):
        run()
