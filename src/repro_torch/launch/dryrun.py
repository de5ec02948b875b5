"""Multi-pod dry-run: trace every (arch × shape × mesh) cell with no card.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell on 512 placeholder host devices and reads memory, FLOPs, bytes and
collective bytes from the compiled artifact.  The port has no compiler
to ask, so it runs the steps themselves on tensors with no data: the
meta device under :func:`repro_torch.device.analysis_mode`, where the
model takes its card paths and every kernel wrapper returns outputs of
its launch's shapes, counts the launch and reports the kernel's cost.
Each record holds three groups of figures:

* **The reference layout**, exactly as the JAX dry-run computes it: the
  policy :func:`cell_policy` picks, ``microbatches``,
  ``params_local_bytes`` (:func:`_sharded_param_bytes` under the
  reference specs of :mod:`repro_torch.distributed.sharding`) and the
  analytic ``comm_model_bytes`` and ``mem_model_gb``
  (:mod:`repro_torch.distributed.commmodel`).
* **The meshless step at the cell's global shapes**
  (:func:`traced_cost`): ``flops_global``, aten's FLOPs
  (``FlopCounterMode``: products and convolutions) plus the kernels'
  cost functions, and ``bytes_global``, the pre-fusion sum over ops of
  input plus output bytes plus the kernels' bytes (the same kind of
  figure as XLA's "bytes accessed"): an upper estimate of the traffic,
  which fusion and caches cut, so no floor on a step's time.
* **The port's own rank program**: rank 0 of the production mesh, under
  a fake world of 256 or 512 ranks (:mod:`repro_torch.launch.mesh`).  It
  holds its data-parallel share of the batch and its model group's
  shards under the port's serving placements, and runs on its model
  group as a ``(1, 16)`` ``("data", "model")`` slice, the shape the
  serving code expects (data-parallel serving has no collective across
  "data").  It records the FLOPs and bytes per device, the collectives
  it issued (:mod:`repro_torch.distributed.hloanalysis`), its kernel
  launches, and ``peak_bytes``: the resident params, cache and inputs
  plus the step's transient peak, from a tracker of live storages
  (each rounded as the CUDA caching allocator rounds a block).

A cell the port refuses gets ``status: "not_ported"`` with the refusal's
message and the ROADMAP item it names (training on a mesh wider than 1
is item 13); ``"fail"`` is kept for a sharding bug, ``"skip"`` follows
``cell_skip_reason``.  So the output is also the port's coverage map.
The int8 variants (``weight_dtype``, ``kv_dtype``, ``dispatch_dtype``)
run on the rank's shards: its weights are quantized on the slice when
the cell is built, outside the traced step, so the step's collectives
hold no load-time absmax reduce, as the reference compiles the step
alone.

The reference's ``donate_for`` has no counterpart: the port compiles no
step to donate buffers to, and its steps update the decode cache and a
train step's params and optimizer state in place already.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ASSIGNED, REGISTRY
from repro_torch.configs.shapes import SHAPES, ShapeSuite, cell_skip_reason
from repro_torch.device import ANALYSIS_DEVICE, analysis_mode
from repro_torch.distributed.commmodel import CellModel, MeshView, _params_bytes
from repro_torch.distributed.context import current_mesh, mesh_context
from repro_torch.distributed.hloanalysis import (
    c10d_entry,
    collective_bytes,
)
from repro_torch.distributed.meshslice import make_slice_mesh
from repro_torch.distributed.sharding import (
    ShardingPolicy,
    default_policy,
    mesh_shape_of,
    ref_param_pspecs,
)
from repro_torch.launch.mesh import MESH_DEVICE_TYPE, make_production_mesh
from repro_torch.models import model as M
from repro_torch.training._tree import leaves
from repro_torch.training.optimizer import (
    AdamWConfig,
    init_opt_state,
    wsd_schedule,
)
from repro_torch.training.trainstep import TrainStepConfig, make_train_step

I32 = torch.int32
BF16 = torch.bfloat16
ALLOC_GRAIN = 512  # the CUDA caching allocator rounds a block to 512 B


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, no data)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeSuite) -> dict:
    """The step's inputs at the cell's global shapes, as meta tensors
    (the reference's ``ShapeDtypeStruct`` stand-ins)."""
    B, S = shape.global_batch, shape.seq_len

    def sds(dims, dt):
        return torch.empty(dims, dtype=dt, device=ANALYSIS_DEVICE)

    if shape.kind == "train":
        specs = {"labels": sds((B, S), I32)}
        if cfg.embed_inputs:
            specs["tokens"] = sds((B, S), I32)
        else:  # modality frontend stub: precomputed frame embeddings
            specs["inputs_embeds"] = sds((B, S, cfg.d_model), BF16)
        return specs
    if shape.kind == "prefill":
        specs = {"lengths": sds((B,), I32)}
        if cfg.embed_inputs:
            specs["tokens"] = sds((B, S), I32)
        else:
            specs["inputs_embeds"] = sds((B, S, cfg.d_model), BF16)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {
        "tokens": sds((B,), I32),
        "lengths": sds((B,), I32),
        "cache": M.init_cache(cfg, B, S, ANALYSIS_DEVICE),
    }


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def _materialize(name: str, t: torch.Tensor, device, generator,
                 vocab: int, seq_len: int):
    """Input ``name``'s spec tensor on ``device``: meta stays as it is; on
    a real device token ids and labels are drawn from ``generator``,
    lengths are whole rows, embeddings zeros."""
    if torch.device(device).type == "meta":
        return t
    if name == "lengths":
        return torch.full(t.shape, seq_len, dtype=I32, device=device)
    if t.dtype == I32:
        return torch.randint(0, vocab, tuple(t.shape), generator=generator,
                             dtype=I32, device=device)
    return torch.zeros(t.shape, dtype=t.dtype, device=device)


def build_cell(cfg: ModelConfig, shape: ShapeSuite, *, microbatches: int = 1,
               device=ANALYSIS_DEVICE, params=None,
               generator: Optional[torch.Generator] = None,
               batch: Optional[int] = None):
    """``(fn, args)``: the port's step of the cell, ``fn(*args)``.

    Train: ``make_train_step`` (AdamW, remat, ``microbatches``, the WSD
    schedule of the reference's dry-run) on (params, optimizer state,
    batch).  Prefill: ``M.prefill`` (an encoder's forward and logits).
    Decode: ``M.decode_step`` on (params, tokens, cache, lengths), the
    token at position ``seq_len - 1``.  ``batch`` overrides the global
    batch (a rank's share); tensors are made on ``device`` (meta by
    default, inside the caller's mesh context for a rank's shards),
    params from ``generator`` unless given."""
    B = shape.global_batch if batch is None else batch
    shape = dataclasses.replace(shape, global_batch=B)
    if params is None:
        mesh = current_mesh()
        params = M.init_params(cfg, generator, device=device, mesh=mesh)
        if cfg.weight_dtype == "int8":  # on the slice: before the step
            params = M.quantize_params(params, cfg, mesh, consume=True)
    specs = input_specs(cfg, shape) if shape.kind != "decode" else {
        "tokens": torch.empty((B,), dtype=I32, device=ANALYSIS_DEVICE)}
    made = {k: _materialize(k, v, device, generator, cfg.vocab_size,
                            shape.seq_len) for k, v in specs.items()}

    if shape.kind == "train":
        tcfg = TrainStepConfig(adamw=AdamWConfig(), remat=True,
                               microbatches=microbatches)
        step = make_train_step(cfg, tcfg, wsd_schedule(100, 1000, 500, 3e-4))
        if "tokens" in made:  # the labels are the tokens themselves
            made["labels"] = made["tokens"]
        return step, (params, init_opt_state(params), made)

    if shape.kind == "prefill":
        if cfg.is_encoder_only:
            def fn(params, batch):
                hidden, _ = M.forward(params, cfg,
                                      tokens=batch.get("tokens"),
                                      inputs_embeds=batch.get(
                                          "inputs_embeds"))
                return M.lm_logits(params, cfg, hidden)
        else:
            def fn(params, batch):
                return M.prefill(params, cfg, batch.get("tokens"),
                                 batch["lengths"],
                                 inputs_embeds=batch.get("inputs_embeds"))
        return fn, (params, made)

    # decode / serve_step
    cache = M.init_cache(cfg, B, shape.seq_len, device)
    lengths = torch.full((B,), shape.seq_len - 1, dtype=I32, device=device)

    def fn(params, tokens, cache, lengths):
        return M.decode_step(params, cfg, tokens, cache, lengths)

    return fn, (params, made["tokens"], cache, lengths)


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------


def alloc_bytes(nbytes: int) -> int:
    """The bytes the CUDA caching allocator counts for a block of
    ``nbytes`` (``memory_allocated``): rounded up to 512, none for an
    empty tensor."""
    return -(-nbytes // ALLOC_GRAIN) * ALLOC_GRAIN if nbytes else 0


_ALLOCATION_ONLY = ("empty", "empty_like", "empty_strided", "new_empty",
                    "new_empty_strided")


class _Tracer(TorchDispatchMode):
    """Every dispatched op: its input plus output bytes (views and bare
    allocations move none), the collectives it issued, and with
    ``track`` the storages alive (a finalizer per storage tracks its
    end)."""

    def __init__(self, track: bool):
        super().__init__()
        self.bytes = 0
        self.collectives: List[Tuple[str, int]] = []
        self.track = track
        self.storages: Dict[int, int] = {}
        self.current = 0
        self.peak = 0

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as alive until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.storages:
            return
        size = alloc_bytes(st.nbytes())
        self.storages[key] = size
        self.current += size
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        entry = c10d_entry(func, args)
        if entry is not None:
            self.collectives.append(entry)
        elif not func.is_view and (
                func.overloadpacket.__name__ not in _ALLOCATION_ONLY):
            self.bytes += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        if self.track:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.hold(t)
        return out


@dataclasses.dataclass
class Trace:
    """What one traced (or measured) step did."""
    aten_flops: float
    kernel_flops: float
    aten_bytes: float
    kernel_bytes: float
    launches: Dict[str, int]
    kernel_calls: Dict[str, int]
    collectives: List[Tuple[str, int]]
    resident_bytes: int = 0  # storages alive before the step
    transient_peak_bytes: int = 0  # the step's peak above them

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernel_flops

    @property
    def bytes(self) -> float:
        return self.aten_bytes + self.kernel_bytes

    @property
    def peak_bytes(self) -> int:
        return self.resident_bytes + self.transient_peak_bytes


def _count_key(key: tuple) -> str:
    """A :func:`repro_torch.kernels.launch_counts` key as a string."""
    return "/".join(str(k) for k in key)


def trace(fn: Callable, args: tuple, *, track_memory: bool = True) -> Trace:
    """Run ``fn(*args)`` under the counters: aten FLOPs, bytes per op,
    the kernels' launches and costs, the collectives, and with
    ``track_memory`` (meta tensors) the resident and transient peak
    bytes of live storages.  On the card the same counters run around
    the real step (``track_memory=False``: the allocator's own figures
    stand there)."""
    tracer = _Tracer(track_memory)
    if track_memory:
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                tracer.hold(t)
    resident = tracer.current
    tracer.peak = resident
    before = kernels.launch_counts()
    with kernels.kernel_costs() as costs, \
            FlopCounterMode(display=False) as flops, tracer:
        out = fn(*args)
    del out
    calls: Dict[str, int] = {}
    for name, _, _ in costs:
        calls[name] = calls.get(name, 0) + 1
    return Trace(
        aten_flops=float(flops.get_total_flops()),
        kernel_flops=sum(c[1] for c in costs),
        aten_bytes=float(tracer.bytes),
        kernel_bytes=sum(c[2] for c in costs),
        launches={_count_key(k): n for k, n in
                  kernels.launches_since(before).items()},
        kernel_calls=calls,
        collectives=list(tracer.collectives),
        resident_bytes=resident if track_memory else 0,
        transient_peak_bytes=(tracer.peak - resident) if track_memory else 0,
    )


# ---------------------------------------------------------------------------
# The reference layout's figures
# ---------------------------------------------------------------------------


def _depth_variant(cfg: ModelConfig, n_super_blocks: int) -> ModelConfig:
    """``cfg`` cut (or grown) to ``n_super_blocks`` of its pattern."""
    return dataclasses.replace(
        cfg, n_layers=len(cfg.block_pattern) * n_super_blocks
    )


def cell_policy(cfg: ModelConfig, shape: ShapeSuite, mesh,
                variant: Optional[dict] = None) -> ShardingPolicy:
    """The policy ``run_cell`` picks (``repro/launch/dryrun.py:327-363``).
    Training wants aggressive ZeRO: FSDP above a 4 MiB leaf per model
    shard, or FSDP + sequence parallelism (``fsdp_sp``) where the model
    shard itself passes 9e9 B.  Serving reads weights every step, so only
    a model shard above 9e9 B opts into FSDP (32 MiB leaves)."""
    base = default_policy(mesh)
    mdl = mesh_shape_of(mesh).get("model", 1)
    need = _params_bytes(cfg) / mdl
    if shape.kind == "train":
        if need > 9e9:
            base = dataclasses.replace(base, mode="fsdp_sp")
        else:
            base = dataclasses.replace(base, fsdp_threshold=4 * 1024 * 1024)
    else:
        thr = (1 << 62) if need <= 9e9 else 32 * 1024 * 1024
        base = dataclasses.replace(base, fsdp_threshold=thr)
    if variant and "mode" in variant:
        base = dataclasses.replace(base, mode=variant["mode"])
    return base


def _dp(mesh, pol: ShardingPolicy) -> int:
    shape = mesh_shape_of(mesh)
    dp = 1
    for a in pol.dp_axes:
        dp *= shape.get(a, 1)
    return dp


def microbatches(cfg: ModelConfig, shape: ShapeSuite, mesh,
                 pol: ShardingPolicy) -> int:
    """Adaptive gradient accumulation: the fewest microbatches that keep
    each one's (B_mb, S, d) bf16 residual stream under 128 MB a device
    (1 for serving)."""
    if shape.kind != "train":
        return 1
    b_loc = max(1, shape.global_batch // _dp(mesh, pol))
    row_bytes = shape.seq_len * cfg.d_model * 2
    for cand in range(1, b_loc + 1):
        if b_loc % cand == 0 and (b_loc // cand) * row_bytes <= 128e6:
            return cand
    return b_loc


def _sharded_param_bytes(cfg: ModelConfig, mesh, pol) -> float:
    """Exact per-device parameter bytes under the reference specs."""
    params = _param_tree(cfg)
    pspecs = ref_param_pspecs(cfg, params, mesh, pol)
    mesh_shape = mesh_shape_of(mesh)

    def leaf_bytes(s, p):
        n = float(math.prod(s.shape)) * s.dtype.itemsize
        for entry in p:
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            for a in axes:
                n /= mesh_shape.get(a, 1)
        return n

    return sum(leaf_bytes(s, p)
               for s, p in zip(leaves(params), _spec_leaves(pspecs)))


def _spec_leaves(tree) -> list:
    """A spec tree's specs in ``leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


def _param_tree(cfg: ModelConfig):
    """The full parameter tree on the meta device (the serving layout's
    ``{"q8", "sc"}`` leaves under int8 weights)."""
    params = M.init_params(cfg, None, device=ANALYSIS_DEVICE)
    return M.quantize_params(params) if cfg.weight_dtype == "int8" \
        else params


def apply_variant(cfg: ModelConfig, variant: dict) -> ModelConfig:
    """Perf-iteration config variants: kv/weight/dispatch quantization."""
    kw = {}
    for k in ("kv_dtype", "weight_dtype", "dtype"):
        if k in variant:
            kw[k] = variant[k]
    if "dispatch_dtype" in variant and cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, dispatch_dtype=variant["dispatch_dtype"]
        )
    return dataclasses.replace(cfg, **kw) if kw else cfg


def reference_figures(cfg: ModelConfig, shape: ShapeSuite, mesh,
                      pol: ShardingPolicy) -> dict:
    """The reference layout's figures of a cell: its policy,
    microbatches, per-device parameter bytes and the analytic comm and
    memory model."""
    mesh_shape = mesh_shape_of(mesh)
    n_dev = math.prod(mesh_shape.values())
    mb = microbatches(cfg, shape, mesh, pol)
    local = _sharded_param_bytes(cfg, mesh, pol)
    cell = CellModel(cfg, shape,
                     MeshView(n_dev, mesh_shape.get("model", 1),
                              _dp(mesh, pol), mode=pol.mode),
                     microbatches=mb, params_local_bytes=local)
    return {"n_devices": n_dev, "policy": dataclasses.asdict(pol),
            "microbatches": mb, "params_local_bytes": local,
            "comm_model_bytes": cell.comm_bytes(),
            "mem_model_gb": cell.memory_gb()}


# ---------------------------------------------------------------------------
# Traces of the port's steps
# ---------------------------------------------------------------------------


def traced_cost(cfg: ModelConfig, shape: ShapeSuite,
                microbatches: int = 1) -> Trace:
    """The meshless step at the cell's global shapes, traced: global
    FLOPs and bytes.  The counterpart of the reference's ``scaled_cost``,
    which rebuilds the full-depth totals from two shallow loop-free
    lowerings (XLA counts a ``while`` body once); an eager trace runs
    every layer, so the full-depth figures are read directly."""
    with analysis_mode():
        fn, args = build_cell(cfg, shape, microbatches=microbatches)
        return trace(fn, args, track_memory=False)


def local_batch(shape: ShapeSuite, mesh, pol: ShardingPolicy) -> int:
    """The rows rank 0 holds: the global batch over the data-parallel
    axes the reference's ``batch_pspec`` puts it on (all of it where it
    does not divide, as long_500k's single row)."""
    from repro_torch.distributed.sharding import batch_pspec

    axes = batch_pspec(shape.global_batch, mesh, ndim=2, pol=pol)[0] or ()
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = mesh_shape_of(mesh)
    return shape.global_batch // math.prod(sizes.get(a, 1) for a in axes)


def slice_trace(cfg: ModelConfig, shape: ShapeSuite, width: int,
                batch: int) -> Tuple[Trace, dict]:
    """This rank's program on a ``(1, width)`` ``("data", "model")`` slice
    over ranks ``0 .. width - 1`` of the live (fake) world: ``batch`` rows
    of the cell on its shards.  Returns the trace and the port's own
    resident bytes (params; cache and inputs); raises the port's refusal
    where it does not run the cell."""
    slice_mesh = make_slice_mesh(range(width), MESH_DEVICE_TYPE)
    with analysis_mode(), mesh_context(slice_mesh):
        fn, args = build_cell(cfg, shape, batch=batch)
        if shape.kind == "train":
            M.check_trainable(cfg, args[0])
        layout = {"params_local_bytes": _tree_bytes(args[0]),
                  "inputs_local_bytes": _tree_bytes(args[1:])}
        return trace(fn, args), layout


def rank_trace(cfg: ModelConfig, shape: ShapeSuite, mesh,
               pol: ShardingPolicy) -> Tuple[Trace, dict]:
    """Rank 0's own program on the production ``mesh`` (inside its fake
    world): its data-parallel rows on its model group as a ``(1, 16)``
    slice (:func:`slice_trace`)."""
    return slice_trace(cfg, shape, mesh_shape_of(mesh).get("model", 1),
                       local_batch(shape, mesh, pol))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


_ITEM = re.compile(r"item (\d+[a-z]?)")


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             pol: Optional[ShardingPolicy] = None, verbose: bool = True,
             variant: Optional[dict] = None) -> dict:
    """One (arch × shape × mesh) record (see the module docstring)."""
    cfg = REGISTRY[arch_id]
    if variant:
        cfg = apply_variant(cfg, variant)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "variant": dict(variant or {}),
    }
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec["status"] = "skip"
        rec["reason"] = skip
        return rec
    t0 = time.time()
    try:
        with make_production_mesh(multi_pod=multi_pod) as mesh:
            pol = pol or cell_policy(cfg, shape, mesh, variant)
            rec.update(reference_figures(cfg, shape, mesh, pol))
            glob = traced_cost(cfg, shape, rec["microbatches"])
            rec.update(flops_global=glob.flops, bytes_global=glob.bytes,
                       kernel_launches_global=glob.kernel_calls)
            try:
                rank, layout = rank_trace(cfg, shape, mesh, pol)
            except NotImplementedError as e:
                item = _ITEM.search(str(e))
                rec.update(status="not_ported", reason=str(e),
                           item=item.group(1) if item else None,
                           total_s=round(time.time() - t0, 1))
                if verbose:
                    print(f"[not_ported] {arch_id} x {shape_name} x "
                          f"{rec['mesh']}: item {rec['item']}", flush=True)
                return rec
        coll = collective_bytes(rank.collectives)
        rec.update(
            status="ok",
            total_s=round(time.time() - t0, 1),
            local_batch=local_batch(shape, mesh, pol),
            flops_per_device=rank.flops,
            bytes_per_device=rank.bytes,
            collective_bytes_by_op=coll.bytes_by_op,
            collective_counts=coll.count_by_op,
            collective_total_bytes=coll.total_bytes,
            launch_counts=rank.launches,
            resident_bytes=rank.resident_bytes,
            transient_peak_bytes=rank.transient_peak_bytes,
            peak_bytes=rank.peak_bytes,
            port_layout=layout,
        )
        if verbose:
            print(f"[ok] {arch_id} x {shape_name} x {rec['mesh']}: "
                  f"{rec['total_s']:.0f}s mb={rec['microbatches']} "
                  f"flops/dev {rec['flops_per_device']:.3e} "
                  f"comm {coll.total_bytes / 1e9:.2f} GB/dev "
                  f"peak {rec['peak_bytes'] / 1e9:.2f} GB/dev "
                  f"(reference model {rec['mem_model_gb']['total']:.2f})",
                  flush=True)
    except Exception as e:  # a failure here is a sharding bug
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch_id} x {shape_name}: {rec['error'][:300]}",
                  flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="a JSONL file of the records, written anew")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED) if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [
        args.multi_pod
    ]
    out_f = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        out_f = open(args.out, "w")
    counts = {"ok": 0, "not_ported": 0, "fail": 0, "skip": 0}
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp)
                counts[rec["status"]] += 1
                if out_f:
                    json.dump({k: v for k, v in rec.items()
                               if k != "traceback"}, out_f)
                    out_f.write("\n")
                    out_f.flush()
    print(f"\n=== dry-run: {counts['ok']} ok / {counts['not_ported']} "
          f"not_ported / {counts['fail']} fail / {counts['skip']} skip in "
          f"{time.time() - t0:.1f} s ===")
    if out_f:
        out_f.close()
    return 1 if counts["fail"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
