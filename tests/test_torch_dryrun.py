"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

- The reference layout, exactly, for every runnable (arch × shape) cell
  on both production meshes: every parameter leaf's spec, the batch and
  cache specs, the optimizer state's, the policy, ``microbatches``,
  ``_sharded_param_bytes``, ``CellModel.comm_bytes()`` and
  ``memory_gb()``, ``input_specs``' shapes and dtypes, and the 31-cell
  skip matrix.  The JAX side runs ``repro.distributed.sharding`` on a
  ``FakeMesh`` (``tests/test_sharding.py:41-44``); it needs no devices.
- The cases of ``tests/test_sharding.py:36-112`` and
  ``tests/test_quantization.py:118`` on the port's rules.
- The rank program's collectives at a tp=2 slice equal the counts and
  bytes phase 21 of ``chip_smoke.py`` recorded on the card (qwen3-moe,
  mamba2, jamba's super-block).
- Traced FLOPs equal an analytic count from the config (reduced llama,
  mamba2 and qwen3-moe, three layers), and a trace with a layer skipped
  does not.
- The dry-run touches no device and leaves no fake world behind; every
  arch and every shape kind is traced at full width once.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ASSIGNED as JASSIGNED
from repro.configs.registry import REGISTRY as JREG
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import runnable_cells as j_runnable_cells
from repro.distributed import commmodel as JCM
from repro.distributed import sharding as JSH
from repro.models import model as JM
from repro.training.optimizer import opt_state_specs as j_opt_state_specs
from repro_torch.configs.registry import ASSIGNED, REGISTRY
from repro_torch.configs.shapes import SHAPES, ShapeSuite, runnable_cells
from repro_torch.device import analysis_mode
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.meshslice import MeshSlicer
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssd import ops as sops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import model as M
from repro_torch.training.optimizer import opt_state_specs


def _jax_dryrun():
    """``repro.launch.dryrun`` (for ``input_specs`` and
    ``_sharded_param_bytes``), imported without keeping the
    ``XLA_FLAGS`` it sets for its own process."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as JD
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return JD


class FakeMesh16:
    axis_names = ("data", "model")
    devices = np.empty((16, 16), object)


class FakeMesh512:
    axis_names = ("pod", "data", "model")
    devices = np.empty((2, 16, 16), object)


MESHES = {"16x16": FakeMesh16, "2x16x16": FakeMesh512}
CELLS = [(a, s, m) for a, s in runnable_cells(ASSIGNED) for m in MESHES]


def _tup(spec):
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(spec)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _jax_paths(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {tuple(getattr(k, "key", str(k)) for k in path): leaf
            for path, leaf in flat}


_TREES = {}


def _trees(arch):
    """(JAX param specs, the port's meta param tree) of ``arch``."""
    if arch not in _TREES:
        _TREES[arch] = (JM.param_specs(JREG[arch]),
                        M.init_params(REGISTRY[arch], None, device="meta"))
    return _TREES[arch]


def jax_policy(cfg, shape, mesh):
    """The policy ``repro/launch/dryrun.py:327-363`` picks, written out
    on the JAX package's own functions."""
    base = JSH.default_policy(mesh)
    mdl = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)
    need = JCM._params_bytes(cfg) / mdl
    if shape.kind == "train":
        if need > 9e9:
            return dataclasses.replace(base, mode="fsdp_sp")
        return dataclasses.replace(base, fsdp_threshold=4 * 1024 * 1024)
    thr = (1 << 62) if need <= 9e9 else 32 * 1024 * 1024
    return dataclasses.replace(base, fsdp_threshold=thr)


def jax_microbatches(cfg, shape, mesh, pol):
    """``repro/launch/dryrun.py:377-388``, on the JAX policy."""
    mesh_shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    dp = 1
    for a in pol.dp_axes:
        dp *= mesh_shape.get(a, 1)
    mb = 1
    if shape.kind == "train":
        b_loc = max(1, shape.global_batch // dp)
        row_bytes = shape.seq_len * cfg.d_model * 2
        for cand in range(1, b_loc + 1):
            if b_loc % cand == 0 and (b_loc // cand) * row_bytes <= 128e6:
                mb = cand
                break
        else:
            mb = b_loc
    return mb, dp


# ---------------------------------------------------------------------------
# The reference layout, cell by cell
# ---------------------------------------------------------------------------


def test_skip_matrix_is_the_reference_one():
    cells = runnable_cells(ASSIGNED)
    assert cells == j_runnable_cells(JASSIGNED)
    assert len(cells) == 31 and len(CELLS) == 62
    assert ("hubert-xlarge", "decode_32k") not in cells
    assert ("hubert-xlarge", "long_500k") not in cells
    assert ("mamba2-2.7b", "long_500k") in cells
    assert ("jamba-v0.1-52b", "long_500k") in cells
    assert ("gemma2-27b", "long_500k") not in cells


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELLS)
def test_reference_layout_equals_the_jax_dryrun(arch, shape_name, mesh_name):
    cfg, jcfg = REGISTRY[arch], JREG[arch]
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    mesh = MESHES[mesh_name]()
    jpol = jax_policy(jcfg, jshape, mesh)
    pol = D.cell_policy(cfg, shape, mesh)
    assert dataclasses.asdict(pol) == dataclasses.asdict(jpol)

    jspecs, params = _trees(arch)
    want = {p: _tup(s) for p, s in _jax_paths(
        JSH.param_pspecs(jcfg, jspecs, mesh, jpol),
        is_leaf=lambda x: isinstance(x, P)).items()}
    got = dict(_paths(SH.ref_param_pspecs(cfg, params, mesh, pol)))
    assert got == want
    jopt = j_opt_state_specs(JSH.param_pspecs(jcfg, jspecs, mesh, jpol))
    opt = opt_state_specs(SH.ref_param_pspecs(cfg, params, mesh, pol))
    assert opt["step"] == _tup(jopt["step"])
    assert dict(_paths(opt["m"])) == want

    B, S = shape.global_batch, shape.seq_len
    for ndim in (1, 2, 3):
        assert SH.batch_pspec(B, mesh, ndim=ndim, pol=pol, seq_len=S) == \
            _tup(JSH.batch_pspec(B, mesh, ndim=ndim, pol=jpol, seq_len=S))

    JD = _jax_dryrun()
    jin, pin = JD.input_specs(jcfg, jshape), D.input_specs(cfg, shape)
    jleaves = _jax_paths(jin)
    pleaves = dict(_paths(pin))
    assert set(pleaves) == set(jleaves)
    for path, leaf in pleaves.items():
        assert tuple(leaf.shape) == tuple(jleaves[path].shape), path
        assert str(leaf.dtype).split(".")[-1] == str(jleaves[path].dtype), \
            path
    if shape.kind == "decode":
        jc = {p: _tup(s) for p, s in _jax_paths(
            JSH.cache_pspecs(jcfg, jin["cache"], mesh, jpol),
            is_leaf=lambda x: isinstance(x, P)).items()}
        assert dict(_paths(SH.cache_pspecs(cfg, pin["cache"], mesh,
                                           pol))) == jc

    local = D._sharded_param_bytes(cfg, mesh, pol)
    assert local == JD._sharded_param_bytes(jcfg, mesh, jpol)
    mb, dp = jax_microbatches(jcfg, jshape, mesh, jpol)
    fig = D.reference_figures(cfg, shape, mesh, pol)
    assert fig["microbatches"] == mb
    assert fig["params_local_bytes"] == local
    n_dev = mesh.devices.size
    jcell = JCM.CellModel(
        jcfg, jshape,
        JCM.MeshView(n_dev, dict(zip(mesh.axis_names,
                                     mesh.devices.shape))["model"], dp,
                     mode=jpol.mode),
        microbatches=mb, params_local_bytes=local)
    assert fig["comm_model_bytes"] == jcell.comm_bytes()
    assert fig["mem_model_gb"] == jcell.memory_gb()


# ---------------------------------------------------------------------------
# tests/test_sharding.py:36-112 and tests/test_quantization.py:118, ported
# ---------------------------------------------------------------------------


def _divides(dim, axes, mesh_shape):
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh_shape.get(a, 1)
    return dim % n == 0


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_param_specs_always_divisible(arch):
    """Every sharded dim divides its axes at the production sizes."""
    _, params = _trees(arch)
    specs = SH.ref_param_pspecs(REGISTRY[arch], params, FakeMesh16())
    shape = {"data": 16, "model": 16}
    for (path, leaf), (_, spec) in zip(_paths(params), _paths(specs)):
        for dim, axes in zip(leaf.shape, spec):
            if axes is not None:
                assert _divides(dim, axes, shape), (arch, path, spec)


def test_large_leaves_get_fsdp_second_axis():
    _, params = _trees("dbrx-132b")
    specs = SH.ref_param_pspecs(REGISTRY["dbrx-132b"], params, FakeMesh16())
    wg = specs["blocks"]["layer_0"]["moe"]["w_gate"]
    assert "model" in str(wg) and "data" in str(wg)
    _, cr = _trees("command-r-plus-104b")
    cr = SH.ref_param_pspecs(REGISTRY["command-r-plus-104b"], cr,
                             FakeMesh16())
    assert "data" not in str(cr["blocks"]["layer_0"]["mlp"]["w_gate"])
    assert "data" not in str(cr["embed"])  # never 2D-sharded


def test_batch_pspec_fallbacks():
    assert SH.batch_pspec(256, FakeMesh512()) == (("pod", "data"), None)
    assert SH.batch_pspec(1, FakeMesh512()) == (None, None)


def test_cache_pspecs_long_context_spreads_seq():
    cfg = REGISTRY["jamba-v0.1-52b"]
    cache = M.init_cache(cfg, 1, 524_288, "meta")
    k_spec = SH.cache_pspecs(cfg, cache, FakeMesh16())["layer_4"]["k"]
    assert "data" in str(k_spec) and "model" in str(k_spec)


def test_fsdp_sp_mode_specs():
    pol = SH.ShardingPolicy(dp_axes=("data",), mode="fsdp_sp")
    cfg = REGISTRY["phi4-mini-3.8b"]
    _, params = _trees("phi4-mini-3.8b")
    wg = SH.ref_param_pspecs(cfg, params, FakeMesh16(), pol)[
        "blocks"]["layer_0"]["mlp"]["w_gate"]
    assert "data" in str(wg) and "model" in str(wg)
    assert SH.batch_pspec(32, FakeMesh16(), ndim=2, pol=pol,
                          seq_len=32768) == ("data", "model")


def test_int8_scales_replicated():
    cfg = dataclasses.replace(REGISTRY["phi4-mini-3.8b"], weight_dtype="int8")
    specs = SH.ref_param_pspecs(cfg, D._param_tree(cfg), FakeMesh16())
    wq = specs["blocks"]["layer_0"]["attn"]["wq"]
    assert "model" in str(wq["q8"]) and "model" not in str(wq["sc"])


def test_serving_policy_of_a_slice_is_the_default():
    class Slice:
        mesh_dim_names = ("data", "model")
        shape = (1, 2)

    assert SH.default_policy(Slice()) == SH.ShardingPolicy()


# ---------------------------------------------------------------------------
# The rank program's collectives against phase 21's recorded ones
# ---------------------------------------------------------------------------

DECODE = ShapeSuite("phase21_decode", "decode", 1024, 8)  # 8 slots of 1,024
PREFILL = ShapeSuite("phase21_prefill", "prefill", 512, 1)  # the probe's


def _slice_collectives(cfg, shape):
    with fake_world(2):
        tr, _ = D.slice_trace(cfg, shape, 2, shape.global_batch)
    got = {}
    for op, nbytes in tr.collectives:
        got.setdefault(op, {}).setdefault(nbytes, 0)
        got[op][nbytes] += 1
    return got, tr


def test_qwen3_moe_slice_collectives_are_phase_21s():
    """A decode step: 49 all-reduces (48 ``wo`` partial sums in float32
    and the embedding), 48 MoE gathers of 524,288 B and the logits
    gather; a 512-token prefill gathers 20,971,520 B a layer."""
    cfg = REGISTRY["qwen3-moe-30b-a3b"]
    got, tr = _slice_collectives(cfg, DECODE)
    d, V = cfg.d_model, cfg.vocab_size
    assert got["all-gather"] == {524_288: 48, 8 * V * 4: 1}
    assert got["all-reduce"] == {8 * d * 4: 48, 8 * d * 2: 1}
    assert tr.launches["decode_attention/launches"] == 48
    got, _ = _slice_collectives(cfg, PREFILL)
    assert got["all-gather"] == {20_971_520: 48, V * 4: 1}
    assert sum(got["all-reduce"].values()) == 49


def test_mamba2_slice_collectives_are_phase_21s():
    """128 all-reduces a decode step (the gated norm's sum of squares,
    8 x 4 B a row, and ``out_proj``) + the embedding + the logits
    gather."""
    cfg = REGISTRY["mamba2-2.7b"]
    got, tr = _slice_collectives(cfg, DECODE)
    d = cfg.d_model
    assert got["all-reduce"] == {32: 64, 8 * d * 4: 64, 8 * d * 2: 1}
    assert sum(got["all-gather"].values()) == 1
    got, tr = _slice_collectives(cfg, PREFILL)
    assert sum(got["all-reduce"].values()) == 129
    assert tr.launches == {"ssd/launches": 64, "ssd/head_launches/40": 64}


def test_jamba_super_block_slice_collectives_are_phase_21s():
    """jamba cut to one super-block: 14 + 1 + 4 + 1 all-reduces, 4 MoE
    gathers (262,144 B at a decode step, 10,485,760 B at the prefill)
    and the logits gather."""
    cfg = dataclasses.replace(REGISTRY["jamba-v0.1-52b"], n_layers=8)
    got, _ = _slice_collectives(cfg, DECODE)
    assert sum(got["all-reduce"].values()) == 20
    assert got["all-gather"][262_144] == 4
    assert sum(got["all-gather"].values()) == 5
    got, _ = _slice_collectives(cfg, PREFILL)
    assert got["all-gather"][10_485_760] == 4


def test_collective_stats_use_the_reference_wire_factors():
    from repro_torch.distributed.hloanalysis import collective_bytes

    st = collective_bytes([("all-reduce", 100), ("all-gather", 10),
                           ("all-reduce", 1)])
    assert st.bytes_by_op == {"all-reduce": 202.0, "all-gather": 10.0}
    assert st.count_by_op == {"all-reduce": 2, "all-gather": 1}
    assert st.total_bytes == 212.0
    assert st.summary()["total_GB"] == round(212 / 1e9, 4)


# ---------------------------------------------------------------------------
# FLOPs against an analytic count
# ---------------------------------------------------------------------------

B_, S_ = 2, 64


def analytic_prefill_flops(cfg) -> float:
    """Products a prefill of B_ rows of S_ tokens makes (2 a multiply-add)
    plus the kernels' operations, from the config alone."""
    T, d, V = B_ * S_, cfg.d_model, cfg.vocab_size
    total = 2.0 * B_ * d * V  # the head, at each row's last position
    pairs = B_ * S_ * (S_ + 1) // 2  # causal (query, key) pairs a head
    for spec in cfg.block_pattern:
        n = cfg.n_blocks
        if spec.mixer == "attn":
            qd, kvd = cfg.q_dim, cfg.kv_dim
            total += n * (2.0 * T * d * (qd + 2 * kvd) + 2.0 * T * qd * d
                          + 4.0 * cfg.n_heads * cfg.head_dim * pairs)
        else:
            m = cfg.mamba
            di, nh, N = m.d_inner(d), m.n_heads(d), m.d_state
            L = min(m.chunk, S_)
            scan = B_ * (S_ // L) * (L * (L + 1) * N + nh * (
                L * (L + 1) * m.head_dim + 4 * L * N * m.head_dim))
            total += n * (2.0 * T * d * (2 * di + 2 * N + nh)
                          + scan + 2.0 * T * di * d)
        if spec.ffn == "mlp":
            total += n * 3 * 2.0 * T * d * cfg.d_ff
        elif spec.ffn == "moe":
            e = cfg.moe
            C = max(1, math.ceil(T * e.top_k / e.num_experts
                                 * e.capacity_factor))
            total += n * (2.0 * T * d * e.num_experts
                          + 3 * 2.0 * e.num_experts * C * d * e.d_ff_expert)
    return total


def _prefill_trace(cfg):
    with analysis_mode():
        fn, args = D.build_cell(cfg, ShapeSuite("p", "prefill", S_, B_))
        return D.trace(fn, args)


@pytest.mark.parametrize("arch", ["llama-3.1-8b", "mamba2-2.7b",
                                  "qwen3-moe-30b-a3b"])
def test_traced_flops_equal_the_analytic_count(arch):
    cfg = D._depth_variant(REGISTRY[arch].reduced(), 3)
    tr = _prefill_trace(cfg)
    assert tr.flops == analytic_prefill_flops(cfg)
    assert tr.kernel_flops > 0 and tr.aten_flops > 0
    # planted: a trace one layer short is caught
    short = _prefill_trace(D._depth_variant(cfg, 2))
    assert short.flops != analytic_prefill_flops(cfg)
    assert short.flops == analytic_prefill_flops(D._depth_variant(cfg, 2))


# ---------------------------------------------------------------------------
# Kernel cost functions: the figures of PERF.md §6
# ---------------------------------------------------------------------------


def test_cost_functions_give_the_kernel_table_figures():
    # flash at B=1 S=512 32/8 Dh 128 bf16, kv_len 341: bound 0.00292 ms
    fl, nb = fops.flash_cost(1, 512, 512, 32, 8, 128, 2, causal=True,
                             lens=[341])
    assert nb == 9_785_344 and round(nb / 3.35e12 * 1e3, 5) == 0.00292
    assert nb / 3.35e12 > fl / 989e12  # bound by bytes
    # hubert's forward: 4 clips to 1,500, 16 heads of 80, no causal mask
    fl, nb = fops.flash_cost(4, 1500, 1500, 16, 16, 80, 2, causal=False,
                             lens=[400, 750, 1100, 1500])
    assert (round(fl / 1e9, 1), round(nb / 1e6, 1)) == (28.8, 49.9)
    # the flash backward at minicpm's training shape
    fl, nb = fops.flash_backward_cost(4, 1024, 1024, 36, 36, 64, 2,
                                      causal=True)
    assert (round(fl / 1e9, 1), round(nb / 1e6, 1)) == (48.4, 151.6)
    # ssd_scan at serving's shape (chunk 256), ssd_backward at training's
    fl, nb = sops.ssd_scan_cost(1, 512, 80, 64, 128, 256, 2)
    assert (round(fl / 1e9, 2), round(nb / 1e6, 1)) == (2.03, 13.5)
    fl, nb = sops.ssd_backward_cost(4, 1024, 80, 64, 128, 2)
    assert (round(fl / 1e9, 1), round(nb / 1e6, 1)) == (29.7, 132.6)


def test_a_traced_launch_counts_and_reports_like_a_real_one():
    q = torch.empty((1, 64, 4, 32), dtype=torch.float32, device="meta")
    before = fops.launches
    with pytest.raises(ValueError, match="no flash_attention"):
        fops.flash_attention(q, q, q)  # outside analysis mode
    from repro_torch.kernels import kernel_costs

    with analysis_mode(), kernel_costs() as costs:
        out = fops.flash_attention(q, q, q)
    assert out.shape == q.shape and out.is_meta
    assert fops.launches == before + 1
    assert costs == [("flash_prefill",
                      *fops.flash_cost(1, 64, 64, 4, 4, 32, 4, causal=True))]


# ---------------------------------------------------------------------------
# The dry-run end to end: no device, no world left behind
# ---------------------------------------------------------------------------

# every arch once, every shape kind at least once, at full width
SAMPLE = [
    ("phi4-mini-3.8b", "decode_32k", False),
    ("gemma2-27b", "prefill_32k", True),
    ("minicpm-2b", "train_4k", True),
    ("command-r-plus-104b", "decode_32k", True),
    ("chameleon-34b", "prefill_32k", False),
    ("qwen3-moe-30b-a3b", "decode_32k", False),
    ("dbrx-132b", "prefill_32k", True),
    ("hubert-xlarge", "prefill_32k", False),
    ("mamba2-2.7b", "long_500k", False),
    ("jamba-v0.1-52b", "long_500k", True),
]


def test_the_sample_covers_every_arch_and_shape_kind():
    assert {a for a, _, _ in SAMPLE} == set(ASSIGNED)
    assert {SHAPES[s].kind for _, s, _ in SAMPLE} == {"train", "prefill",
                                                      "decode"}
    assert "long_500k" in {s for _, s, _ in SAMPLE}


@pytest.mark.parametrize("arch,shape_name,multi_pod", SAMPLE)
def test_run_cell_at_full_width(arch, shape_name, multi_pod):
    rec = D.run_cell(arch, shape_name, multi_pod, verbose=False)
    assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()
    shape = SHAPES[shape_name]
    assert rec["flops_global"] > 0 and rec["bytes_global"] > 0
    assert rec["n_devices"] == (512 if multi_pod else 256)
    if shape.kind == "train":
        assert rec["status"] == "not_ported" and rec["item"] == "13"
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["flops_per_device"] > 0
    assert rec["peak_bytes"] == rec["resident_bytes"] + \
        rec["transient_peak_bytes"]
    assert rec["transient_peak_bytes"] > 0
    assert rec["collective_counts"]["all-reduce"] > 0
    dp = 32 if multi_pod else 16
    assert rec["local_batch"] == (shape.global_batch // dp
                                  if shape.global_batch % dp == 0
                                  else shape.global_batch)


def test_the_fake_world_is_gone_after_a_dry_run():
    with make_production_mesh() as mesh:
        assert dist.get_world_size() == 256
        assert mesh.shape == (16, 16)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="join one first"):
        MeshSlicer()
    with pytest.raises(ZeroDivisionError):
        with make_production_mesh(multi_pod=True) as mesh:
            assert dist.get_world_size() == 512
            1 / 0
    assert not dist.is_initialized()


def test_entry_points_still_need_a_card_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with analysis_mode():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.init_params(REGISTRY["llama-3.1-8b"].reduced(), None)


def test_main_writes_one_record_a_cell(tmp_path):
    """One record a cell and mesh, in a file written anew each run (its
    folder made if missing)."""
    out = tmp_path / "new" / "d.jsonl"
    for _ in range(2):
        rc = D.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                     "--both-meshes", "--out", str(out)])
    import json

    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert rc == 0 and [r["status"] for r in recs] == ["skip", "skip"]


def test_kernel_costs_collect_launches_from_other_threads():
    """A backward pass on the card launches from autograd's device
    thread: the cost sink must see it."""
    import threading

    from repro_torch.kernels import kernel_costs, record_cost

    with kernel_costs() as costs:
        t = threading.Thread(target=record_cost,
                             args=("flash_backward", lambda: (1.0, 2.0)))
        t.start()
        t.join()
    assert costs == [("flash_backward", 1.0, 2.0)]
    record_cost("flash_backward", lambda: (1.0, 2.0))  # no sink: no-op
    assert len(costs) == 1
