"""Spawned ``torch.distributed`` worlds for the port's mesh tests.

:func:`start_world` runs a rank body in ``world`` spawned processes that
join one process group (gloo on the CPU, the backend
``init_world`` picks on the card), each with a process-group timeout and
the parent with a join timeout, so a rank that raises fails one test and
never hangs the suite.  The rank bodies below import the port only:
JAX runs in the parent, which holds what the ranks return against the
JAX package (``test_torch_mesh.py``) or against the plain versions
(``test_torch_cuda.py``).
"""
import multiprocessing as mp
import pickle
import sys
import time
import traceback
import uuid
from pathlib import Path

import numpy as np

JOIN_TIMEOUT_S = 240.0  # the parent's wait for a whole world
PG_TIMEOUT_S = 180.0  # a rank's wait in one collective


class World:
    """A started world; :meth:`result` waits for it."""

    def __init__(self, procs, outs, timeout):
        self.procs, self.outs = procs, outs
        self.deadline = time.monotonic() + timeout
        self._results = None

    def result(self):
        """Each rank's return value, in rank order.  Raises with every
        failing rank's traceback, or when the world outlasts its time."""
        if self._results is not None:
            return self._results
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results, errors = [], []
        for r, (p, out) in enumerate(zip(self.procs, self.outs)):
            if not out.exists():
                errors.append(f"rank {r}: exit code {p.exitcode}, no result")
                continue
            ok, val = pickle.loads(out.read_bytes())
            if not ok:
                errors.append(f"rank {r}:\n{val}")
            results.append(val)
        if hung:
            errors.insert(0, f"ranks {hung} outlasted the join timeout")
        if errors:
            raise RuntimeError("\n".join(errors))
        self._results = results
        return results


def start_world(target, world: int, tmp: Path, *args,
                device_type: str = "cpu",
                timeout: float = JOIN_TIMEOUT_S) -> World:
    """Start ``target(rank, world, *args)`` on ``world`` spawned ranks."""
    ctx = mp.get_context("spawn")
    tag = uuid.uuid4().hex[:10]
    tmp = Path(tmp)
    init = f"file://{tmp / f'store_{tag}'}"
    outs = [tmp / f"{tag}_rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(target, r, world, init, str(outs[r]),
                               device_type, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return World(procs, outs, timeout)


def _rank_entry(target, rank, world, init, out, device_type, args):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import init_world

    torch.set_num_threads(1)
    try:
        init_world(rank, world, init, device_type, timeout_s=PG_TIMEOUT_S)
        res = (True, target(rank, world, *args))
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                                "repro")]
        if leaked:
            res = (False, f"a rank imported {leaked[:5]}")
    except BaseException:  # reported to the parent, which fails the test
        res = (False, traceback.format_exc())
    Path(out).write_bytes(pickle.dumps(res))
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------


def _wrapper(kind):
    """(wrapper, q's head dim) of a decode-attention kind."""
    from repro_torch.kernels.decode_attention import ops

    return {"decode": (ops.decode_attention, 1),
            "paged_decode": (ops.paged_decode_attention, 1),
            "paged_verify": (ops.paged_verify_attention, 2)}[kind]


def sharded_call(kind, arrays, mesh, device="cpu", route="dtensor"):
    """One decode-attention wrapper on ``mesh``: q, K and V (full, as
    numpy or torch) cut to this rank's heads when the heads divide the
    ``"model"`` axis, the output gathered back to full heads; otherwise
    the plain full tensors.  ``route`` "dtensor" passes the cuts as
    DTensors to the wrapper (the ``shard_map`` form), "local" passes the
    local tensors to its sharded branch as the model does
    (``ops.on_local_heads``).  Returns (full output, sharded?)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.context import (
        gather_model, heads_shardable, mesh_context, model_width,
    )
    from repro_torch.kernels.decode_attention import ops

    fn, qd = _wrapper(kind)
    q, k, v, *rest = (torch.as_tensor(a).to(device) for a in arrays)
    if not heads_shardable(mesh, q.shape[qd], k.shape[2]):
        out = fn(q, k, v, *rest, mesh=mesh)
        assert not isinstance(out, DTensor)
        return out, False
    w, i = model_width(mesh), mesh.get_local_rank("model")
    local = [t.chunk(w, dim=d)[i].contiguous()
             for t, d in ((q, qd), (k, 2), (v, 2))]
    if route == "local":
        out = ops.on_local_heads(fn, *local, *rest, mesh=mesh)
    else:
        out = fn(*(DTensor.from_local(t, mesh, (Replicate(), Shard(d)),
                                      run_check=False)
                   for t, d in zip(local, (qd, 2, 2))), *rest, mesh=mesh)
        assert isinstance(out, DTensor)
        assert tuple(out.placements) == (Replicate(), Shard(qd))
        out = out.to_local()
    with mesh_context(mesh):
        return gather_model(out, dim=qd), True


def mesh_rank(rank, world, cases, variants):
    """On a ``world``-wide slice (CPU): each wrapper case ``(id, kind,
    arrays)`` through its sharded wrapper by each route, {(id, route):
    (full output, sharded?)}; the forwards of :func:`forward_rank`; and
    :func:`slicer_rank`'s probes."""
    from repro_torch.distributed import make_slice_mesh

    mesh = make_slice_mesh(range(world), "cpu")
    wrappers = {}
    for cid, kind, arrays in cases:
        for route in ROUTES:
            out, sharded = sharded_call(kind, arrays, mesh, route=route)
            wrappers[cid, route] = (out.numpy(), sharded)
    return {"wrappers": wrappers, "forward": forward_rank(rank, world,
                                                         variants),
            "slicer": slicer_rank(rank, world)}


# the llama-3.1-8b main path's shapes (chip_smoke.py): 8 decode slots,
# a 1,024-token ring or 64 pages of 16 per table over the pool's 1,536
# pages and the scratch page, 32 q and 8 kv heads of 128
MAIN = dict(B=8, C=1024, Hq=32, Hkv=8, Dh=128, ps=16, Pmax=64, P=1537)
MAIN_LENGTHS = [1024, 700, 513, 512, 300, 17, 4, 0]  # 0: a free slot


def main_shape_inputs(torch, kind, dtype, device, seed=0):
    """Seeded full inputs of one wrapper at the main shapes: ring rows
    partly filled (the last empty), paged rows at ragged lengths with
    shuffled disjoint tables, T = 3 for verify."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    B, C, Hq, Hkv, Dh = (MAIN[k] for k in ("B", "C", "Hq", "Hkv", "Dh"))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(dt)

    if kind == "decode":
        filled = torch.tensor(MAIN_LENGTHS, device=device)
        slots = torch.arange(C, device=device)
        slot_pos = torch.where(slots[None] < filled[:, None], slots[None],
                               -1).to(torch.int32)
        q_pos = torch.clamp(filled - 1, min=0).to(torch.int32)
        return (randn(B, Hq, Dh), randn(B, C, Hkv, Dh), randn(B, C, Hkv, Dh),
                slot_pos, q_pos)
    ps, Pmax, P = MAIN["ps"], MAIN["Pmax"], MAIN["P"]
    perm = torch.randperm(P - 1, generator=g, device=device)
    bt = torch.full((B, Pmax), -1, dtype=torch.int32, device=device)
    for b, n in enumerate(MAIN_LENGTHS):
        k = -(-n // ps)
        bt[b, :k] = perm[b * Pmax: b * Pmax + k].to(torch.int32)
    q = randn(B, Hq, Dh) if kind == "paged_decode" else randn(B, 3, Hq, Dh)
    return (q, randn(P, ps, Hkv, Dh), randn(P, ps, Hkv, Dh), bt,
            torch.tensor(MAIN_LENGTHS, dtype=torch.int32, device=device))


ROUTES = ("dtensor", "local")


def check_sharded_wrappers(torch, mesh, device="cuda"):
    """Each sharded wrapper at the main shapes, bf16 and float32, by
    both routes of :func:`sharded_call`, its output gathered to full
    heads against the plain version on the full tensors (a length-0
    paged row, which the kernel zeroes and the plain version averages,
    is left out); then an empty batch through the sharded branch, which
    launches nothing.  Returns {kind: {dtype: {route: (max abs error,
    within the bound?, sharded launches on this rank by local Hkv)}},
    "empty": sharded launches the empty batches added}."""
    from repro_torch.distributed.context import model_width
    from repro_torch.kernels.decode_attention import ops, ref

    plain = {"decode": ref.decode_attention_ref,
             "paged_decode": ref.paged_decode_attention_ref,
             "paged_verify": ref.paged_verify_attention_ref}
    tol = {"bfloat16": 2e-2, "float32": 2e-5}  # tests/test_kernels.py:18

    def launched(n0):
        return {k[1]: n - n0.get(k, 0) for k, n in ops.sharded_launches.items()
                if n != n0.get(k, 0)}

    res = {}
    for seed, kind in enumerate(plain):
        res[kind] = {}
        for dtype in tol:
            args = main_shape_inputs(torch, kind, dtype, device, seed)
            want = plain[kind](*args)
            res[kind][dtype] = {}
            for route in ROUTES:
                n0 = dict(ops.sharded_launches)
                got, sharded = sharded_call(kind, args, mesh, device, route)
                if device == "cuda":
                    torch.cuda.synchronize()
                assert sharded, kind
                live = (args[4] > 0) if kind != "decode" else slice(None)
                g, w = got[live].float(), want[live].float()
                err = float((g - w).abs().max())
                over = float(((g - w).abs() - tol[dtype] * (1 + w.abs()))
                             .max())
                res[kind][dtype][route] = (
                    err, over <= 0 and bool(torch.isfinite(g).all()),
                    launched(n0))
    n0 = dict(ops.sharded_launches)
    w, i = model_width(mesh), mesh.get_local_rank("model")
    for kind in plain:
        fn, qd = _wrapper(kind)
        q, k, v, *rest = main_shape_inputs(torch, kind, "bfloat16", device)
        if kind == "decode":  # no rows: the ring goes too
            k, v = k[:0], v[:0]
        local = [t.chunk(w, dim=d)[i].contiguous()
                 for t, d in ((q[:0], qd), (k, 2), (v, 2))]
        out = ops.on_local_heads(fn, *local, *(t[:0] for t in rest),
                                 mesh=mesh)
        assert out.shape[0] == 0, (kind, tuple(out.shape))
    res["empty"] = launched(n0)
    return res


def card_wrapper_rank(rank, world):
    """:func:`check_sharded_wrappers` on a ``world``-wide slice of the
    card."""
    import torch

    from repro_torch.distributed import make_slice_mesh

    return check_sharded_wrappers(torch, make_slice_mesh(range(world),
                                                         "cuda"))


def forward_rank(rank, world, variants):
    """Dense and paged/verify forwards on a ``world``-wide slice, per
    variant ``(name, cfg, numpy params, steps)``: {name: [logits...]}
    (see ``test_torch_mesh.forward_script``)."""
    import torch

    from repro_torch.distributed import (
        make_slice_mesh, mesh_context, shard_params,
    )
    from repro_torch.models import model as TM
    from repro_torch.models.bridge import params_from_jax

    mesh = make_slice_mesh(range(world), "cpu")
    res = {}
    for name, cfg, np_params, script in variants:
        params = shard_params(params_from_jax(np_params, device="cpu"), cfg,
                              mesh)
        with mesh_context(mesh):
            res[name] = run_forward_script(TM, cfg, params, script, torch)
    return res


def run_forward_script(TM, cfg, params, s, torch):
    """The forward script ``s`` (numpy inputs) through the port's model
    ``TM``: dense prefill and decode steps, then (where ``s`` has them:
    not for a Mamba2 config, which the paged pool does not serve) paged
    prefill, decode steps and one verify window.  Returns every step's
    logits."""
    t = torch.from_numpy
    out = []
    logits, cache = TM.prefill(params, cfg, t(s["toks"]), t(s["lens"]),
                               max_len=s["max_len"])
    out.append(logits.numpy())
    pos = s["lens"].copy()
    for nxt in s["dense_next"]:
        logits, cache = TM.decode_step(params, cfg, t(nxt), cache, t(pos))
        out.append(logits.numpy())
        pos += 1
    if "ptoks" not in s:
        return out
    cache = TM.init_paged_cache(cfg, s["pool_pages"], s["ps"], device="cpu")
    bt = t(s["bt"])
    logits, cache = TM.prefill_paged(
        params, cfg, t(s["ptoks"]), t(s["plens"]),
        torch.zeros(len(s["plens"]), dtype=torch.int32), bt, cache)
    out.append(logits.numpy())
    pos = s["plens"].copy()
    for nxt in s["paged_next"]:
        logits, cache = TM.decode_step_paged(params, cfg, t(nxt), cache,
                                             t(pos), bt)
        out.append(logits.numpy())
        pos += 1
    logits, _ = TM.verify_step_paged(params, cfg, t(s["vtoks"]), cache,
                                     t(pos), bt)
    out.append(logits.numpy())
    return out


def workload(pkg, vocab: int, seed: int = 21):
    """The serving tests' tiny Poisson workload (either package)."""
    tiny = pkg.DatasetDist(
        "tiny",
        prefill=pkg.LengthDist(24.0, 10.0, hi=60),
        decode=pkg.LengthDist(6.0, 3.0, hi=12),
    )
    reqs = pkg.poisson_workload(tiny, 2.5, 10.0, seed=seed)
    return pkg.attach_tokens(reqs, vocab, seed=seed + 1)


def cluster_cfg(pkg, model, chip, pred, **kw):
    """The serving tests' chunked P/D cluster: one prefill and two
    decode instances (either package)."""
    base = dict(
        model=model, chip=chip, n_prefill=1, n_decode=2, policy="voltana",
        predictor=pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=8, seed=4, noise_sigma=0.0,
        prefill_chunk_tokens=32,
    )
    base.update(kw)
    return pkg.ClusterConfig(**base)


SPEC_K = 2
MAX_LEN = 128


def cluster_rank(rank, world, rc, np_params, dcfg, np_draft, preds):
    """Real tp=``world`` clusters on the reduced model: the dense ring
    and paged speculation, each rank running the same cluster, and a
    pool-drain probe of one sliced backend (tests/test_mesh_parity.py:
    371).  Returns {"ring": (reqs, metrics), "spec": (reqs, metrics,
    log), "drain": ...}."""
    import repro_torch.serving as TS
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.hwmodel import HardwareModel
    from repro_torch.core.power import A100
    from repro_torch.distributed import MeshSlicer
    from repro_torch.models.bridge import params_from_jax
    from repro_torch.serving.realengine import (
        RealBackend, make_real_backend_factory,
    )
    from _port_parity import recording

    model = REGISTRY["llama-3.1-8b"]
    params = params_from_jax(np_params, device="cpu")
    dparams = params_from_jax(np_draft, device="cpu")
    kw = dict(slots=8, max_len=MAX_LEN, tp=world, device="cpu")
    out = {}
    reqs = workload(TS, rc.vocab_size)
    cl = TS.PDCluster(cluster_cfg(
        TS, model, A100, preds["ring"], tp=world,
        backend_factory=make_real_backend_factory(rc, params, **kw)))
    m = cl.run(reqs)
    assert all(e.backend.mesh is not None for e in cl.decode)
    out["ring"] = (reqs, m)

    factory, log = recording(make_real_backend_factory(
        rc, params, paged=True, page_size=16, spec_k=SPEC_K,
        draft_cfg=dcfg, draft_params=dparams, **kw))
    reqs = workload(TS, rc.vocab_size)
    cl = TS.PDCluster(cluster_cfg(
        TS, model, A100, preds["spec"], tp=world, paged=True,
        kv_page_size=16, spec_decode=True, spec_k=SPEC_K,
        backend_factory=factory))
    m = cl.run(reqs)
    for e in cl.decode:
        e.backend.pool.assert_empty()
    out["spec"] = (reqs, m, log)

    be = RealBackend(
        HardwareModel(model, A100), rc, params, slots=2, max_len=64,
        paged=True, page_size=16,
        mesh=MeshSlicer(range(world), "cpu").slice(world), device="cpu")
    drain = [TS.Request(i, 0.0, prompt_len=17, decode_len=3,
                        prompt_tokens=list((np.arange(17) + i)
                                           % rc.vocab_size))
             for i in range(2)]
    be.prefill_iter(drain, 34, 1410.0)
    for r in drain:
        be.insert(r)
    be.decode_iter(drain, 2, 40, 1410.0)
    be.decode_iter(drain, 2, 42, 1410.0)
    for r in drain:
        be.release(r)
    be.flush()
    be.pool.assert_empty()
    out["drain"] = [list(r.output_tokens) for r in drain]
    return out


def tp1_rank(rank, world, rc, np_params, pred):
    """tests/test_mesh_parity.py:177 in the port: a paged cluster on
    tp=1 slices against the meshless one, then a warm second run over
    the same factory.  Returns (meshless reqs, mesh reqs, warm
    recompiles, the mesh backends' widths, :func:`slicer_rank`'s
    probes)."""
    import repro_torch.serving as TS
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.power import A100
    from repro_torch.models.bridge import params_from_jax
    from repro_torch.serving.realengine import make_real_backend_factory

    model = REGISTRY["llama-3.1-8b"]
    params = params_from_jax(np_params, device="cpu")
    kw = dict(slots=8, max_len=MAX_LEN, paged=True, page_size=16,
              device="cpu")
    ccfg = dict(paged=True, kv_page_size=16)
    r_plain = workload(TS, rc.vocab_size, seed=5)
    TS.PDCluster(cluster_cfg(
        TS, model, A100, pred, backend_factory=make_real_backend_factory(
            rc, params, **kw), **ccfg)).run(r_plain)
    mesh_factory = make_real_backend_factory(rc, params, tp=1, devices=[0],
                                             **kw)
    r_mesh = workload(TS, rc.vocab_size, seed=5)
    cl = TS.PDCluster(cluster_cfg(TS, model, A100, pred,
                                  backend_factory=mesh_factory, **ccfg))
    cl.run(r_mesh)
    widths = [e.backend.mesh.shape for e in cl.decode]
    m_warm = TS.PDCluster(cluster_cfg(
        TS, model, A100, pred, backend_factory=mesh_factory,
        **ccfg)).run(workload(TS, rc.vocab_size, seed=5))
    return (r_plain, r_mesh, m_warm.recompiles, widths,
            slicer_rank(rank, world))


def graphs_rank(rank, world, rc, params, pred):
    """With CUDA graphs made available on the CPU and a capture that
    fails the rank if it ever runs: a tp=``world`` cluster on the
    reduced model, and a sliced backend asked for ``cuda_graphs=True``.
    Returns (finished fraction, graphs captured, the decode backends'
    step graphs, the refusal's message or None)."""
    import repro_torch.serving as TS
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.hwmodel import HardwareModel
    from repro_torch.core.power import A100
    from repro_torch.distributed import MeshSlicer
    from repro_torch.serving import jitcache
    from repro_torch.serving.realengine import (
        RealBackend, make_real_backend_factory,
    )

    def no_capture(*a, **k):
        raise AssertionError("a mesh slice captured a step")

    jitcache.graphs_available = lambda device: True
    jitcache._capture = no_capture
    model = REGISTRY["llama-3.1-8b"]
    cl = TS.PDCluster(cluster_cfg(
        TS, model, A100, pred, tp=world,
        backend_factory=make_real_backend_factory(
            rc, params, slots=8, max_len=MAX_LEN, tp=world, device="cpu")))
    m = cl.run(workload(TS, rc.vocab_size))
    refused = None
    try:
        RealBackend(HardwareModel(model, A100), rc, params, slots=2,
                    max_len=64, device="cpu", cuda_graphs=True,
                    mesh=MeshSlicer(range(world), "cpu").slice(world))
    except ValueError as e:
        refused = str(e)
    return (m.finished_frac(), jitcache.capture_count(),
            [e.backend._graphs for e in cl.decode], refused)


def slicer_rank(rank, world):
    """MeshSlicer round-robin, restart and mesh sharing over the world's
    ranks, and ``mesh_fingerprint`` identity
    (tests/test_mesh_parity.py:73,111)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import MeshSlicer, make_slice_mesh
    from repro_torch.serving.jitcache import mesh_fingerprint

    sl = MeshSlicer(device_type="cpu")  # the whole world
    ranks = lambda m: tuple(m.mesh.flatten().tolist())  # noqa: E731
    got = {"n": sl.n_devices}
    a = sl.slice(1 if world == 1 else 2)
    b = sl.slice(1 if world == 1 else 2)
    got["a"], got["b"] = ranks(a), ranks(b)
    got["names"], got["shape"] = a.mesh_dim_names, tuple(a.shape)
    got["c_is_a"] = sl.slice(1 if world == 1 else 2) is a
    if world == 4:
        got["restart"] = ranks(sl.slice(3))  # 2 + 3 > 4: restart at 0
    m1, m2 = make_slice_mesh(range(world), "cpu"), make_slice_mesh(
        range(world), "cpu")
    other = DeviceMesh("cpu", torch.arange(world).reshape(1, world),
                       mesh_dim_names=("pod", "model"))
    got["fp_equal"] = mesh_fingerprint(m1) == mesh_fingerprint(m2)
    got["fp_other"] = mesh_fingerprint(m1) != mesh_fingerprint(other)
    got["fp_wrap"] = mesh_fingerprint(a) == mesh_fingerprint(b)
    return got


# ---------------------------------------------------------------------------
# Disjoint slices: prefill and decode on different ranks
# ---------------------------------------------------------------------------


def _instances(cluster):
    """Every instance's backend with its kind, in the cluster's order."""
    return ([("prefill", e.backend) for e in cluster.prefill]
            + [("decode", e.backend) for e in cluster.decode])


def _held_nothing(be):
    """A remote instance holds no weights, cache or drafter."""
    caches = [be.kvcache if be.paged else be.cache]
    held = [be.params]
    if be.spec_k:
        caches.append(be.draft_cache)
        held.append(be.draft_params)
    return all(t == {} for t in caches + held) and be._next_dev is None


def _facts(cluster):
    """What a run's instances did on this rank: each instance's ranks
    and whether this rank computed it, whether each remote one held
    nothing, the handoffs the decode instances counted, and the pools'
    pages still in use."""
    out = {"ranks": [], "local": [], "remote_empty": [], "crossed": 0,
           "local_handoffs": 0, "pages_in_use": [], "handoff_log": []}
    for kind, be in _instances(cluster):
        out["ranks"].append((kind, be.ranks))
        out["local"].append(be.local)
        if not be.local:
            out["remote_empty"].append(_held_nothing(be))
        if kind == "decode":
            out["crossed"] += be.handoffs["crossed"]
            out["local_handoffs"] += be.handoffs["local"]
            out["handoff_log"] += be.handoff_log
        if be.paged:
            out["pages_in_use"].append(be.pool.in_use)
    return out


def _case(name, dcfg=None, dparams=None):
    """(model, factory keywords, cluster keywords) of a disjoint case."""
    from repro_torch.configs.registry import REGISTRY

    if name == "spec":
        return (REGISTRY["llama-3.1-8b"],
                dict(paged=True, page_size=16, spec_k=SPEC_K, draft_cfg=dcfg,
                     draft_params=dparams),
                dict(paged=True, kv_page_size=16, spec_decode=True,
                     spec_k=SPEC_K))
    arch = "mamba2-2.7b" if name == "mamba" else "llama-3.1-8b"
    return REGISTRY[arch], {}, {}


def disjoint_rank(rank, world, cases, preds):
    """Clusters on tp=1 slices of a ``world``-rank world: the prefill
    instance on rank 0, decode 0 on rank 1 and decode 1 back on rank 0
    (``cluster_cfg``'s fleet), so one handoff path crosses ranks and one
    stays local.  ``cases`` are (name, config, numpy params, drafter
    config, drafter numpy params); every rank runs each, and rank 0 also
    runs it meshless.  Returns {name: {"disjoint": (reqs, metrics, log),
    "meshless": (reqs, metrics) on rank 0, "facts": :func:`_facts`}}."""
    import repro_torch.serving as TS
    from repro_torch.core.power import A100
    from repro_torch.models.bridge import params_from_jax
    from repro_torch.serving.realengine import make_real_backend_factory
    from _port_parity import recording

    out = {}
    for name, rc, np_params, dcfg, np_draft in cases:
        params = params_from_jax(np_params, device="cpu")
        dparams = (params_from_jax(np_draft, device="cpu")
                   if np_draft is not None else None)
        model, fkw, ckw = _case(name, dcfg, dparams)
        res = {}
        for mode in ("disjoint", "meshless"):
            if mode == "meshless" and rank != 0:
                continue
            kw = dict(tp=1) if mode == "disjoint" else {}
            factory, log = recording(make_real_backend_factory(
                rc, params, slots=8, max_len=MAX_LEN, device="cpu", **fkw,
                **kw))
            reqs = workload(TS, rc.vocab_size)
            cl = TS.PDCluster(cluster_cfg(TS, model, A100, preds[name],
                                          backend_factory=factory, **ckw))
            m = cl.run(reqs)
            res[mode] = (reqs, m, log)
            if mode == "disjoint":
                res["facts"] = _facts(cl)
        out[name] = res
    return out


def unequal_rank(rank, world, rc, np_params, fleet, preds,
                 arch="llama-3.1-8b"):
    """A dense ring cluster of ``arch`` whose prefill instance is a tp=1
    slice on rank 0 and whose decode instance a tp=2 slice on ranks 1-2
    (``fleet``: the (prefill, decode) ``InstanceSpec.tp``; ``preds`` the
    predictor bank by (chip, tp)).  Returns (reqs, metrics, facts)."""
    import repro_torch.serving as TS
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.power import A100
    from repro_torch.models.bridge import params_from_jax
    from repro_torch.serving.realengine import make_real_backend_factory

    params = params_from_jax(np_params, device="cpu")
    p_tp, d_tp = fleet
    reqs = workload(TS, rc.vocab_size)
    cl = TS.PDCluster(cluster_cfg(
        TS, REGISTRY[arch], A100, None,
        prefill_fleet=[TS.InstanceSpec(A100, p_tp)],
        decode_fleet=[TS.InstanceSpec(A100, d_tp)],
        predictor_bank=dict(preds),
        backend_factory=make_real_backend_factory(
            rc, params, slots=8, max_len=MAX_LEN, tp=1, device="cpu")))
    m = cl.run(reqs)
    return reqs, m, _facts(cl)


# ---------------------------------------------------------------------------
# Mamba2 heads and MoE experts over "model"
# ---------------------------------------------------------------------------


class FakeMesh:
    """Rank ``i`` of an ``n``-wide ``"model"`` axis, for the cuts
    (no process group)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, n, i):
        self.shape, self.i = (1, n), i

    def get_local_rank(self, axis):
        return self.i


def tree_leaves(tree, path=()):
    """(path, leaf) of a nested dict, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    else:
        yield path, tree


def join_shards(shards, spec, n):
    """The full leaf back from its ``n`` shards under ``spec`` (a
    ``Shard`` or a ``sharding.Segments``)."""
    import torch

    from repro_torch.distributed.sharding import Segments

    if not isinstance(spec, Segments):
        return torch.cat(shards, spec.dim)
    parts = []
    for (_, heads), at, w in zip(spec.parts, spec.starts(n), spec.widths(n)):
        parts += [s.narrow(spec.dim, at, w)
                  for s in (shards if heads else shards[:1])]
    return torch.cat(parts, spec.dim)


def assert_cuts_join(cfg, full, cuts):
    """Each leaf of ``full`` equals its shards in ``cuts`` (one tree a
    rank, in rank order) joined by its rule, and a leaf the rules keep
    whole is the same on every rank.  Returns the paths of the split
    leaves."""
    import torch
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import leaf_placement

    n = len(cuts)
    split = []
    for path, leaf in tree_leaves(full):
        spec = leaf_placement(cfg, path, FakeMesh(n, 0))
        shards = [dict(tree_leaves(c))[path] for c in cuts]
        if isinstance(spec, Replicate):
            assert all(torch.equal(s, leaf) for s in shards), path
            continue
        assert torch.equal(join_shards(shards, spec, n), leaf), path
        split.append(path)
    return split


def per_rank_gated_norm(y, z, w, cfg):
    """A planted fault: the Mamba2 gated norm over this rank's channels
    only, as if each rank's share of d_inner were the whole."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L

    return L.rms_norm(y * F.silu(z.float()).to(y.dtype), w, cfg.norm_eps)


def planted_forward_rank(rank, world, variants):
    """:func:`forward_rank` with the gated norm taken per rank."""
    from repro_torch.models import model as TM

    TM._gated_norm = per_rank_gated_norm
    return forward_rank(rank, world, variants)


def acceptance_cfg(pkg, model, chip, pred, **kw):
    """The JAX package's sharded-MoE acceptance scenario's cluster
    (tests/test_mesh_parity.py:400-436): one prefill and one decode
    instance over a paged pool at tp=2 (either package)."""
    base = dict(
        model=model, chip=chip, n_prefill=1, n_decode=1, policy="voltana",
        predictor=pred, kv_capacity_tokens=400_000, online_adapt=False,
        decode_max_running=8, seed=4, noise_sigma=0.0,
        prefill_chunk_tokens=32, paged=True, kv_page_size=16, tp=2,
    )
    base.update(kw)
    return pkg.ClusterConfig(**base)


def acceptance_workload(pkg, vocab: int):
    """That scenario's workload: the tiny Poisson mix over 5 s."""
    tiny = pkg.DatasetDist(
        "tiny",
        prefill=pkg.LengthDist(24.0, 10.0, hi=60),
        decode=pkg.LengthDist(6.0, 3.0, hi=12),
    )
    return pkg.attach_tokens(pkg.poisson_workload(tiny, 2.5, 5.0, seed=21),
                             vocab, seed=22)


def mixer_cluster_rank(rank, world, cases, preds):
    """tp=``world`` clusters of the Mamba2 and MoE configs, each rank
    running the same cluster.  ``cases`` are (name, arch, config, numpy
    params, scenario): "acceptance" is :func:`acceptance_cfg` over the
    paged pool, "dense" ``cluster_cfg``'s fleet over the dense ring.
    Returns {name: (reqs, metrics, the decode instances' model-axis
    widths)}; a paged decode pool that does not drain fails the rank."""
    import repro_torch.serving as TS
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.power import A100
    from repro_torch.models.bridge import params_from_jax
    from repro_torch.serving.realengine import make_real_backend_factory

    out = {}
    for name, arch, rc, np_params, scenario in cases:
        params = params_from_jax(np_params, device="cpu")
        paged = scenario == "acceptance"
        factory = make_real_backend_factory(
            rc, params, slots=8, max_len=MAX_LEN, tp=world, device="cpu",
            **(dict(paged=True, page_size=16) if paged else {}))
        if paged:
            reqs = acceptance_workload(TS, rc.vocab_size)
            ccfg = acceptance_cfg(TS, REGISTRY[arch], A100, preds[name],
                                  tp=world, backend_factory=factory)
        else:
            reqs = workload(TS, rc.vocab_size)
            ccfg = cluster_cfg(TS, REGISTRY[arch], A100, preds[name],
                               tp=world, backend_factory=factory)
        cl = TS.PDCluster(ccfg)
        m = cl.run(reqs)
        widths = []
        for e in cl.decode:
            mesh = e.backend.mesh
            widths.append(dict(zip(mesh.mesh_dim_names, mesh.shape))["model"])
            if paged:
                e.backend.pool.assert_empty()
        out[name] = (reqs, m, widths)
    return out


# ---------------------------------------------------------------------------
# int8 on a slice
# ---------------------------------------------------------------------------


def int8_rank(rank, world, variants):
    """Per variant ``(name, int8 config, numpy float params, forward
    script or None)``: this rank's shards of the float tree quantized on
    a ``world``-wide slice (``quantize_params(..., mesh)``, the absmax of
    a leaf with a cut input dim taken over ``"model"``), as ``{path:
    numpy leaf}``, and the script's logits run on those shards.  Returns
    {name: {"shards": ..., "logits": [...] or None}}."""
    import torch

    from repro_torch.distributed import (
        make_slice_mesh, mesh_context, shard_params,
    )
    from repro_torch.models import model as TM
    from repro_torch.models.bridge import params_from_jax

    mesh = make_slice_mesh(range(world), "cpu")
    res = {}
    for name, cfg, np_params, script in variants:
        params = shard_params(params_from_jax(np_params, device="cpu"), cfg,
                              mesh)
        params = TM.quantize_params(params, cfg, mesh, consume=True)
        got = {"shards": {"/".join(p): t.numpy()
                          for p, t in tree_leaves(params)},
               "logits": None}
        if script is not None:
            with mesh_context(mesh):
                got["logits"] = run_forward_script(TM, cfg, params, script,
                                                   torch)
        res[name] = got
    return res


def card_int8_rank(rank, world, pred):
    """On a ``world``-wide slice of the card: reduced llama (float32)
    drawn on the slice, quantized there, served through a tp=``world``
    dense cluster with int8 weights and an int8 ring, then every stream
    replayed alone through the meshless plain path on the meshless
    quantization of the same draw.  Returns (whether this rank's shards
    equal the cut of the meshless int8 tree bitwise, the streams, the
    worst gap of an emitted token to its plain row's max logit, the
    sharded ring_decode launches)."""
    import dataclasses

    import torch

    import repro_torch.serving as TS
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.power import A100
    from repro_torch.distributed import make_slice_mesh, shard_params
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.models import model as TM
    from repro_torch.serving.realengine import (
        _bucket, make_real_backend_factory,
    )

    base = dataclasses.replace(REGISTRY["llama-3.1-8b"].reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(base, weight_dtype="int8", kv_dtype="int8")
    mesh = make_slice_mesh(range(world), "cuda")

    def draw(mesh=None):
        return TM.init_params(base, torch.Generator("cuda").manual_seed(0),
                              device="cuda", mesh=mesh)

    shards = TM.quantize_params(draw(mesh), cfg, mesh, consume=True)
    whole = TM.quantize_params(draw())
    cut = dict(tree_leaves(shard_params(whole, cfg, mesh)))
    same = all(torch.equal(leaf, cut[path])
               for path, leaf in tree_leaves(shards))
    dops.sharded_launches.clear()
    reqs = workload(TS, cfg.vocab_size)
    m = TS.PDCluster(cluster_cfg(
        TS, REGISTRY["llama-3.1-8b"], A100, pred, tp=world,
        backend_factory=make_real_backend_factory(
            cfg, shards, slots=8, max_len=MAX_LEN, tp=world,
            device="cuda"))).run(reqs)
    assert m.finished_frac() == 1.0
    launched = dict(dops.sharded_launches)
    worst = 0.0
    for r in reqs:
        toks = torch.tensor(r.prompt_tokens, dtype=torch.int32,
                            device="cuda")
        buf = torch.zeros((1, _bucket(len(toks), hi=MAX_LEN)),
                          dtype=torch.int32, device="cuda")
        buf[0, : len(toks)] = toks
        pos = torch.tensor([len(toks)], dtype=torch.int32, device="cuda")
        logits, cache = TM.prefill(whole, cfg, buf, pos, max_len=MAX_LEN,
                                   plain_attention=True)
        for tok in r.output_tokens:
            row = logits[0].double()
            worst = max(worst, float(row.max() - row[tok]))
            logits, cache = TM.decode_step(
                whole, cfg, torch.tensor([tok], dtype=torch.int32,
                                         device="cuda"),
                cache, pos, plain_attention=True)
            pos = pos + 1
    return same, [list(r.output_tokens) for r in reqs], worst, launched
