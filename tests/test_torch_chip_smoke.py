"""``chip_smoke.py`` off the card: it refuses to run without one, and its
readers of the compiler's and the timers' output."""
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _mesh_worlds as W

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

# ptxas -v output of two instantiations, as nvcc prints it for sm_90a
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f818paged_split_kernelILi128ELi2EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f818paged_split_kernelILi128ELi2EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f822paged_attention_kernelIfLi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f822paged_attention_kernelIfLi64EEEvNS_6ParamsE
    8 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 32 registers, 1024 bytes smem, used 1 barriers
"""


@pytest.mark.parametrize("argv", [[], ["--kernels-only"]])
def test_refuses_to_run_without_a_card(argv, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main(argv) != 0
    assert capsys.readouterr().out == ""


def test_src_needs_kernels_only():
    with pytest.raises(SystemExit) as e:
        cs.main(["--src", str(ROOT)])
    assert e.value.code != 0


def test_fails_alone_in_a_directory(tmp_path):
    """Without the repo's sources it exits non-zero and prints no result,
    with or without a card."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert run.stdout == ""


@pytest.mark.parametrize("label,want", [
    ("paged_split_kernel<128,2>",
     {"registers": 168, "static_smem_bytes": 0, "spill_store_bytes": 0,
      "spill_load_bytes": 0}),
    ("paged_attention_kernel<float,64>",
     {"registers": 32, "static_smem_bytes": 1024, "spill_store_bytes": 12,
      "spill_load_bytes": 20}),
])
def test_ptxas_table_reads_each_instantiation(label, want):
    rows = cs.ptxas_table(PTXAS_LOG)
    assert len(rows) == 2
    assert rows[label] == want


@pytest.mark.parametrize("library_ms,library_device_ms,want", [
    (0.05, 0.025, {"vs_library": 0.4, "bound_frac": 0.1,
                   "device_vs_library": 0.4, "device_bound_frac": 0.2}),
    (None, None, {"vs_library": None, "bound_frac": 0.1,
                  "device_vs_library": None, "device_bound_frac": 0.2}),
])
def test_ratios_compare_within_one_method(library_ms, library_device_ms,
                                          want):
    row = {"ms": 0.02, "device_ms": 0.01, "bound_ms": 0.002,
           "library_ms": library_ms, "library_device_ms": library_device_ms}
    got = cs.ratios(row)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == (pytest.approx(v) if v is not None else None)


# ptxas -v of the ring and SSD libraries' redesigned kernels and the
# float32 bodies they keep beside them
PTXAS_RING_SSD = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__caccf2de_14_ring_decode_cu_5ce215f817ring_split_kernelILi128ELi1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__caccf2de_14_ring_decode_cu_5ce215f817ring_split_kernelILi128ELi1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__caccf2de_14_ring_decode_cu_5ce215f819ring_combine_kernelENS_6ParamsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__caccf2de_14_ring_decode_cu_5ce215f819ring_combine_kernelENS_6ParamsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__caccf2de_11_ssd_scan_cu_5ce215f816ssd_chunk_kernelILi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__caccf2de_11_ssd_scan_cu_5ce215f816ssd_chunk_kernelILi128EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__caccf2de_11_ssd_scan_cu_5ce215f815ssd_scan_kernelIfLi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__caccf2de_11_ssd_scan_cu_5ce215f815ssd_scan_kernelIfLi128EEEvNS_6ParamsE
    8 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""


@pytest.mark.parametrize("label,registers,spill", [
    ("ring_split_kernel<128,1>", 96, 0),
    ("ring_combine_kernel<>", 30, 0),
    ("ssd_chunk_kernel<128>", 128, 0),
    ("ssd_scan_kernel<float,128>", 64, 20),
])
def test_ptxas_table_reads_the_ring_and_ssd_kernels(label, registers,
                                                    spill):
    rows = cs.ptxas_table(PTXAS_RING_SSD)
    assert len(rows) == 4
    assert rows[label]["registers"] == registers
    assert rows[label]["spill_store_bytes"] == spill


# a SASS listing with every instruction the redesigned kernels use
_SASS = ("/*0050*/ HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
         "/*0090*/ @P0 LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;\n"
         "/*00a0*/ LDSM.16.M88.4 R8, [R2] ;\n"
         "/*00b0*/ HGMMA.64x64x16.F32.BF16 R56, gdesc[UR16], RZ, !UPT ;\n"
         "/*00c0*/ UTMALDG.4D [UR8], [UR4] ;\n"
         "/*00d0*/ FFMA R5, R6, R7, R5 ;\n"
         "/*00e0*/ MUFU.EX2 R9, R9 ;\n")


@pytest.mark.parametrize("lib,drop", [
    (None, None),  # all present
    ("ring_decode", "HMMA"),
    ("ring_decode", "LDGSTS"),
    ("ssd_scan", "HMMA"),
    ("flash_prefill", "LDSM"),
    ("flash_backward", "HGMMA"),
    ("flash_backward", "UTMALDG"),
    ("ssd_backward", "HMMA"),
    ("ssd_backward", "LDGSTS"),
])
def test_sass_ops_flag_a_library_missing_its_instructions(lib, drop):
    """Every redesigned library must show the tensor-core product; the
    ring's must show the async copy too."""
    assert cs.REDESIGNED["ring_decode"][:2] == ("HMMA", "LDGSTS")
    assert "HMMA" in cs.REDESIGNED["ssd_scan"]
    listings = {name: _SASS for name in cs.REDESIGNED}
    if lib is not None:
        listings[lib] = "\n".join(
            line for line in _SASS.splitlines() if drop not in line)
    got = cs.sass_ops(listings)
    assert set(got) == set(cs.REDESIGNED)
    missing = {name: [op for op, shown in ops.items() if not shown]
               for name, ops in got.items()}
    want = {name: [] for name in cs.REDESIGNED}
    if lib is not None:
        want[lib] = [drop]
    assert missing == want


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::ring_split_kernel<128, 1>((anonymous "
     "namespace)::Params)", "ring_split_kernel"),
    ("(anonymous namespace)::ring_combine_kernel((anonymous "
     "namespace)::Params, int)", "ring_combine_kernel"),
    ("void (anonymous namespace)::ssd_cb_kernel<128>((anonymous "
     "namespace)::Params)", "ssd_cb_kernel"),
])
def test_kernel_name_drops_namespaces_and_templates(key, name):
    assert cs.kernel_name(key) == name


@pytest.mark.parametrize("graphs,tp,captured,replayed,ok", [
    (None, 0, 2, 28, True),  # one graph per entry, then every step replays
    (None, 0, 2, 27, False),  # a step ran neither eagerly nor from a graph
    (None, 0, 3, 27, False),  # a graph captured twice
    (None, 0, 0, 0, False),  # graphs on, none used
    (False, 0, 0, 0, True),  # eager: nothing captured
    (False, 0, 1, 29, False),
    (None, 2, 0, 0, True),  # a mesh slice: eager
    (None, 2, 2, 28, False),
])
def test_graph_counts_hold_a_serve_to_its_captures_and_replays(
        graphs, tp, captured, replayed, ok):
    """A serve with 30 steps over 2 entries: graphs on a meshless
    instance capture 2 and replay 28; eager and mesh serves capture
    nothing."""
    class Counts:
        def capture_count(self):
            return 10 + captured

        def replay_count(self):
            return 100 + replayed

    call = lambda: cs.graph_counts(Counts(), (10, 100), graphs, tp, 2, 30,
                                   "serve")
    if ok:
        assert call() == {"cuda_graphs": graphs is not False and not tp,
                          "captures": captured, "replays": replayed}
    else:
        with pytest.raises(RuntimeError, match="graph captures"):
            call()


@pytest.mark.parametrize("arch,weights_gb,ring_gb", [
    ("ministral-3b", 7.335837696, 0.872415232),
    ("qwen3-32b", 65.5228928, 2.147483648),
    ("chameleon-34b", 68.585259008, 1.610612736),
])
def test_reckon_gb_counts_weights_and_the_decode_ring(arch, weights_gb,
                                                      ring_gb):
    """bf16 weights from the config's parameter count, and the ring's 8
    slots x 1024 positions x layers x K and V x kv heads x head dim."""
    from repro_torch.configs.registry import REGISTRY

    got = cs.reckon_gb(REGISTRY[arch])
    assert got == pytest.approx({"weights_gb": weights_gb,
                                 "ring_gb": ring_gb}, rel=1e-12)


def test_family_launches_are_one_a_layer_a_call():
    from repro_torch.configs.registry import REGISTRY

    cfg = REGISTRY["qwen3-32b"]
    assert cs.family_launches(cfg, 1, 16) == {
        "flash_prefill": 64, "flash_prefill_q_offset": 0,
        "ring_decode": 64 * 16, "paged": 0, "ssd_scan": 0}
    assert cs.family_launches(cfg, 1, 0)["ring_decode"] == 0


def test_spec_kinds_follow_the_verify_log():
    """The prefill's token and each verify pass's last token are the
    target's; accepted drafts the drafter's; other requests' entries
    are skipped."""
    from types import SimpleNamespace

    r = SimpleNamespace(rid=3)
    log = [(3, 2), (1, 1), (3, 0), (3, 1)]
    assert cs.spec_kinds(r, log) == [
        "target", "draft", "draft", "target", "target", "draft", "target"]
    assert cs.spec_kinds(SimpleNamespace(rid=9), log) == ["target"]


def test_dense_family_phases_name_served_configs():
    from repro_torch.configs.registry import REGISTRY

    for arch in cs.FAMILY_SERVED + cs.FAMILY_CHECKED:
        assert arch in REGISTRY
    assert "command-r-plus-104b" not in cs.FAMILY_SERVED + cs.FAMILY_CHECKED


def test_window_moe_phases_name_registered_configs():
    """Phases 13-15 serve registered configs; jamba's cut keeps whole
    super-blocks."""
    from repro_torch.configs.registry import REGISTRY

    for arch in cs.WINDOW_MOE:
        assert arch in REGISTRY
    jamba = REGISTRY["jamba-v0.1-52b"]
    assert cs.JAMBA_LAYERS % len(jamba.block_pattern) == 0
    assert cs.JAMBA_LAYERS < jamba.n_layers
    gemma = REGISTRY["gemma2-27b"]
    assert {s.window for s in gemma.block_pattern} == {cs.GEMMA_WINDOW, None}
    assert cs.GEMMA_WINDOW < cs.GEMMA_BUCKET <= cs.GEMMA_MAX_LEN


def test_reckon_gb_counts_windowed_rings_states_and_pools():
    """gemma2's local rings hold the window, its global ones max_len;
    jamba's Mamba2 layers hold conv tails and float32 states; pools are
    two (prefill and decode instance) of pool_pages + 1 pages."""
    from repro_torch.configs.registry import REGISTRY

    gemma = REGISTRY["gemma2-27b"]
    got = cs.reckon_gb(gemma, cs.GEMMA_SLOTS, cs.GEMMA_MAX_LEN)
    kv = 2 * 16 * 128 * 2
    assert got["ring_gb"] == pytest.approx(
        4 * 23 * (8256 + 4096) * kv / 1e9, rel=1e-12)
    jamba = REGISTRY["jamba-v0.1-52b"]
    got = cs.reckon_gb(jamba)
    assert got["state_gb"] == pytest.approx(
        8 * 28 * (3 * (8192 + 256) * 2 + 128 * 64 * 128 * 4) / 1e9,
        rel=1e-12)
    moe = REGISTRY["qwen3-moe-30b-a3b"]
    got = cs.reckon_gb(moe, pool_pages=cs.POOL_PAGES)
    assert got["pools_gb"] == pytest.approx(
        2 * (cs.POOL_PAGES + 1) * 16 * 48 * 2 * 4 * 128 * 2 / 1e9, rel=1e-12)


def test_reckon_gb_counts_int8_weights_and_rings_with_their_scales():
    """int8 weights: the block matrices at a byte each plus a float32
    scale per output channel, the bf16 embedding and head as they were;
    an int8 ring: a byte per element plus a float32 scale per position
    and kv head."""
    import dataclasses

    from repro_torch.configs.registry import REGISTRY

    llama = REGISTRY["llama-3.1-8b"]
    int8 = dataclasses.replace(llama, weight_dtype="int8", kv_dtype="int8")
    got = cs.reckon_gb(int8)
    blocks = 32 * (4096 * 4096 * 2 + 2 * 4096 * 1024 + 3 * 4096 * 14336)
    scales = 32 * (4096 + 2 * 1024 + 4096 + 2 * 14336 + 4096)
    head = 2 * 128256 * 4096 * 2
    assert got["weights_gb"] == pytest.approx(
        (blocks + 4 * scales + head) / 1e9, rel=1e-12)
    assert got["ring_gb"] == pytest.approx(
        8 * 1024 * 32 * 2 * 8 * (128 + 4) / 1e9, rel=1e-12)
    moe = REGISTRY["qwen3-moe-30b-a3b"]
    assert cs._scales_per_block(moe) == (
        32 * 128 + 2 * 4 * 128 + 2048 + 128 * (1 + 2 * 768 + 2048))


def test_hubert_and_int8_phases_name_registered_configs():
    """Phase 16's clips and the plain path's padding (the reference's
    chunk rule: at most 512 frames, or a whole number of 1,024-key
    chunks); phase 17's llama."""
    from repro_torch.configs.registry import REGISTRY

    assert not REGISTRY["hubert-xlarge"].embed_inputs
    assert cs.HUBERT_FRAMES == max(cs.HUBERT_CLIPS) == 1500
    assert [cs.plain_frames(n) for n in (200, 512, 600, 1024, 1500, 2048)] \
        == [200, 512, 1024, 1024, 2048, 2048]
    assert cs.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == {"b": 3.0, "c": 2.0}
    head = {"flash_prefill": {}, "flash_prefill@hubert encoder": {"x": 1},
            "ring_decode@shard": {}, "ring_decode@gemma2 global ring": {}}
    assert cs.case_rows(head, "flash_prefill") == {"hubert encoder": {"x": 1}}
    assert list(cs.case_rows(head, "ring_decode")) == ["gemma2 global ring"]


def test_kernel_layers_and_window_counts():
    from repro_torch.configs.registry import REGISTRY

    jamba = REGISTRY["jamba-v0.1-52b"]
    assert cs.kernel_layers(jamba, "ssd_scan") == 28
    assert cs.kernel_layers(jamba, "flash_prefill") == 4
    assert cs.kernel_layers(REGISTRY["gemma2-27b"], "ring_decode") == 46
    assert cs.window_masked(4096, 4096) == (0, 0)
    assert cs.window_masked(4099, 4096) == (3, 6)


# ---------------------------------------------------------------------------
# The batch-faithful replay on the CPU
# ---------------------------------------------------------------------------

MOE_MAX_LEN = 128
MARGIN = 1e-5  # float32 on the CPU: the served path is the plain one


@pytest.fixture(scope="module")
def moe_serve():
    """The reduced qwen3-moe at capacity factor 0.5 (2 slots an expert at
    8 rows) in float32, served dense on the CPU with its backends
    recorded: a burst of 8 requests with long decodes fills the decode
    slots, so entries of the requests in later slots drop behind those
    in earlier ones."""
    import dataclasses

    from repro_torch.configs.registry import REGISTRY
    from repro_torch.core.power import A100
    from repro_torch.models import layers as L
    from repro_torch.models import model as TM
    from repro_torch.serving import ClusterConfig, PDCluster, Request
    from repro_torch.serving.cluster import build_predictor
    from repro_torch.serving.realengine import make_real_backend_factory

    full = REGISTRY["qwen3-moe-30b-a3b"]
    cfg = full.reduced()
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rec = cs.Recorder()
    base = make_real_backend_factory(cfg, params, slots=8,
                                     max_len=MOE_MAX_LEN, device="cpu")

    def factory(kind, idx, hw, seed, tp=None):
        be = base(kind, idx, hw, seed, tp=tp)
        rec.attach(be)
        return be

    g = torch.Generator().manual_seed(4)
    reqs = []
    for i in range(8):
        n = int(torch.randint(20, 40, (1,), generator=g))
        reqs.append(Request(i, 0.0, prompt_len=n, decode_len=48,
                            prompt_tokens=torch.randint(
                                0, cfg.vocab_size, (n,),
                                generator=g).tolist()))
    # the served routings, as a mesh rank of phase 21 records its own
    routes = cs.Routes(L, torch)
    with routes:
        routes.mode = "record"
        m = PDCluster(ClusterConfig(
            model=full, chip=A100, n_prefill=1, n_decode=1,
            policy="voltana",
            predictor=build_predictor(full, A100, A100.freq_levels_2,
                                      kv_cap=400_000),
            kv_capacity_tokens=400_000, online_adapt=False,
            decode_max_running=8, seed=0,
            backend_factory=factory)).run(reqs)
    assert m.finished_frac() == 1.0
    rec.served_routes = routes.log
    return cfg, params, rec, reqs


def test_batch_replay_holds_a_moe_serve(moe_serve):
    """Both passes hold every emitted token, and on the CPU (the kernel
    path's wrappers run their plain versions) the plain pass routes as
    the served path did: no near-tie is forced."""
    cfg, params, rec, reqs = moe_serve
    res = cs.batch_replay(torch, rec, (cfg, params), label="cpu",
                          margin=MARGIN)
    assert res["near_ties_forced"] == 0
    assert res["routings"] > 0
    assert res["tokens_held"]["prefill"] == len(reqs)
    assert res["tokens_held"]["decode"] == sum(r.decode_len for r in reqs)
    assert res["dropped_per_step_max"] > 0
    assert _busiest(rec)[1] >= 4, "no decode step ran 4 requests or more"


@pytest.mark.parametrize("planted", [False, True])
def test_batch_replay_forces_the_served_routes(moe_serve, planted):
    """Phase 21's replay: the recorded calls moved to the host and the
    served run's own routings given, the plain pass alone runs, forced to
    them, and holds every token; a served routing to an expert far off
    the router's top-k (a planted fault) fails it."""
    cfg, params, rec, reqs = moe_serve
    served = [t.clone() for t in rec.served_routes]
    if planted:  # row 0 of the first routing: its k-th expert swapped
        first = served[0][0].tolist()
        served[0][0, -1] = next(e for e in range(cfg.moe.num_experts)
                                if e not in first)
    host = cs.host_events(rec)
    assert all(not t.is_cuda for ev in host.events for t in ev
               if isinstance(t, torch.Tensor))
    if planted:
        with pytest.raises(RuntimeError, match="router logit"):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(cs, "ROUTE_MARGIN", 1e-6)
                cs.batch_replay(torch, host, (cfg, params), label="forced",
                                margin=MARGIN, served_routes=served)
        return
    res = cs.batch_replay(torch, host, (cfg, params), label="forced",
                          margin=MARGIN, served_routes=served)
    assert res["kernel_path_worst_gap"] is None
    assert res["near_ties_forced"] == 0 and res["routings"] > 0
    assert res["tokens_held"]["decode"] == sum(r.decode_len for r in reqs)


def _busiest(rec):
    """(index in the log, rows) of the first decode step that ran the
    most requests."""
    rows = [len(kw) if kind == "rows" else 0
            for kind, _, _, kw, _ in rec.events]
    return rows.index(max(rows)), max(rows)


def test_batch_replay_fails_on_a_reordered_batch(moe_serve, monkeypatch):
    """The decode step that ran the most requests, replayed by the plain
    pass with its rows in reverse order (tokens, positions, cache rows
    and the served routings it is held to alike, so only the order in
    which entries claim capacity changes): a token the served step
    emitted is no longer its row's argmax."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as TM

    cfg, params, rec, _ = moe_serve
    # the target decode steps before the busiest one
    at = sum(1 for kind, _, _, _, _ in rec.events[:_busiest(rec)[0]]
             if kind == "step")
    inner, calls = TM.decode_step, [0]

    def decode_step(params_, cfg_, tokens, cache, lengths, **kw):
        calls[0] += bool(kw.get("plain_attention"))
        if calls[0] != at + 1 or not kw.get("plain_attention"):
            return inner(params_, cfg_, tokens, cache, lengths, **kw)
        rev = torch.arange(tokens.shape[0] - 1, -1, -1)
        routes = L._route  # the replay's Routes, forcing the served ones
        for j in range(routes.i, routes.i + cfg_.n_layers):
            routes.log[j] = routes.log[j][rev]

        def flip(tree):
            for e in tree.values():
                for k in e:
                    e[k][:] = e[k][:, rev]
        flip(cache)
        logits, cache = inner(params_, cfg_, tokens[rev], cache,
                              lengths[rev], **kw)
        flip(cache)
        return logits[rev], cache

    monkeypatch.setattr(TM, "decode_step", decode_step)
    with pytest.raises(RuntimeError, match="below the plain path's max"):
        cs.batch_replay(torch, rec, (cfg, params), label="reordered",
                        margin=MARGIN)


def test_a_batch_one_replay_flags_a_moe_stream(moe_serve):
    """Replayed alone (``replay_phase``), a request routes without its
    batch-mates and loses no entry to them: some request's emitted token
    is then off its argmax, though the batch replay holds every one."""
    cfg, params, rec, reqs = moe_serve
    flagged = []
    for r in reqs:
        try:
            cs.replay_phase(torch, {"target": (cfg, params)}, r,
                            max_len=MOE_MAX_LEN, margin=MARGIN)
        except RuntimeError as e:
            assert "below the plain path's max" in str(e)
            flagged.append(r.rid)
    assert flagged


def test_routes_force_near_ties_and_refuse_other_routings():
    """A recorded routing replaces a differing one only within
    ``ROUTE_MARGIN`` of the router's own top-k; farther off it fails."""
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 16), generator=g)
    router = torch.randn((16, 8), generator=g)
    probs, _, tope, _ = L._route(x, router, 2, 1.25)
    logp = torch.log(probs)
    near = tope.clone()  # the third expert where it is a near-tie
    third = torch.sort(logp, dim=-1, descending=True).indices[:, 2]
    gap = logp.gather(1, tope[:, 1:2])[:, 0] - logp.gather(1, third[:, None])[:, 0]
    row = int(gap.argmin())
    for far, want in ((False, None), (True, "router logit")):
        routes = cs.Routes(L, torch)
        routes.log = [near.clone()]
        routes.log[0][row, 1] = third[row] if not far else \
            torch.sort(logp[row], descending=True).indices[-1]
        routes.mode = "force"
        margin = float(gap[row]) + 1e-6
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cs, "ROUTE_MARGIN", margin)
            with routes:
                if want:
                    with pytest.raises(RuntimeError, match=want):
                        L.moe_ffn_sorted(x, router, *[torch.randn(
                            (8, 16, 4), generator=g)] * 2, torch.randn(
                            (8, 4, 16), generator=g), top_k=2)
                    continue
                _, w, e, _ = L._route(x, router, 2, 1.25)
        assert routes.forced == 1
        assert torch.equal(e, routes.log[0])
        assert torch.allclose(w.sum(-1), torch.ones(6))


# ---------------------------------------------------------------------------
# Phase 18 and the flash_backward rows
# ---------------------------------------------------------------------------


def test_train_phase_names_minicpm_at_full_width_and_its_launches():
    """Phase 18 trains the registered minicpm-2b at full width and depth
    on launch/train.py's batch; a step launches flash_prefill twice a
    layer under remat (forward and recompute) and flash_backward once."""
    from repro_torch.configs.registry import REGISTRY

    cfg = REGISTRY[cs.TRAIN_ARCH]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        40, 2304, 36, 36, 64, 5760, 122753)
    assert cs.train_launches(cfg) == {"flash_prefill": 80,
                                      "flash_backward": 40, "ssd_scan": 0,
                                      "ssd_backward": 0}
    assert cs.train_launches(cfg, remat=False)["flash_prefill"] == 40
    assert cs.TRAIN_SEQ % cs.TRAIN_CE_CHUNK == 0
    assert cs.TRAIN_STEPS == 5


@pytest.mark.parametrize("name,group", [
    ("flash_prefill_bf16_kernel", "flash forward"),
    ("dkdv_bf16_kernel", "flash backward"),
    ("dq_bf16_kernel", "flash backward"),
    ("delta_kernel", "flash backward"),
    ("dkdvq_wgmma_kernel", "flash backward"),
    ("delta_tiles_kernel", "flash backward"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "cuBLAS"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN", "cuBLAS"),
    ("Kernel2", "cuBLAS"),  # cuBLAS's product at minicpm's odd vocabulary
    ("index_elementwise_kernel_with_sort",
     "elementwise (AdamW, norms, RoPE, CE)"),
    ("embedding_backward_feature_kernel", "other"),
    ("vectorized_elementwise_kernel", "elementwise (AdamW, norms, RoPE, CE)"),
    ("reduce_kernel", "reductions (CE, norms, global norm)"),
])
def test_kernel_group_sorts_the_profile(name, group):
    assert cs.kernel_group(name) == group


def test_flash_backward_is_a_kernel_of_the_line():
    """The kernels line carries flash_backward from phase 18 with its
    note, its SASS must show the wgmma + TMA body (HGMMA, UTMALDG) and
    the kept mma.sync body (HMMA), and its case rows come from the
    kernel phase."""
    source, replaces, phase = cs.KERNELS["flash_backward"]
    assert (ROOT / source).is_file() and phase == "train"
    assert replaces == "src/repro/kernels/flash_attention/kernel.py:93"
    assert "XLA" in cs.KERNEL_NOTES["flash_backward"]
    assert cs.REDESIGNED["flash_backward"] == ("HGMMA", "UTMALDG", "HMMA")
    head = {"flash_backward": {}, "flash_backward@llama GQA": {"x": 1}}
    assert cs.case_rows(head, "flash_backward") == {"llama GQA": {"x": 1}}


def test_flash_backward_case_holds_the_plain_backward_on_the_cpu(
        monkeypatch):
    """The kernel phase's backward row, untimed, with the forward launch
    stood in by the plain version (the CPU has no kernel): the wrapper's
    CPU path is the plain backward, so the errors are 0 and two calls
    repeat."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    monkeypatch.setattr(fops, "_launch", lambda q, k, v, causal, window,
                        softcap, *a, **kw: attention_ref(
                            q, k, v, causal=causal, window=window,
                            softcap=softcap))
    src = (ROOT / "chip_smoke.py").read_text().replace('"cuda"', '"cpu"')
    mod = type(cs)("chip_smoke_cpu")
    mod.__file__ = str(ROOT / "chip_smoke.py")
    exec(compile(src, "chip_smoke_cpu", "exec"), mod.__dict__)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    row = mod.flash_backward_case(torch, F, 2, 40, 4, 2, 16, "float32",
                                  True, 8, 5.0, timed=False)
    assert row["repeats_bitwise"] and row["max_abs_err"] == 0.0
    assert row["shape"] == "B=2 S=40 Hq=4 Hkv=2 Dh=16"


def test_backward_rows_quote_the_ptxas_rows_of_their_body(monkeypatch):
    """A backward row names its body and carries that body's ``ptxas -v``
    rows from the library this run built (none when it built none)."""
    table = {"dkdvq_wgmma_kernel<64>": {"registers": 168},
             "dkdv_bf16_kernel<80>": {"registers": 155},
             "dq_bf16_kernel<80>": {"registers": 121},
             "dkdv_f32_kernel<64>": {"registers": 94}}
    monkeypatch.setattr(cs, "PTXAS", {})
    assert cs.body_ptxas("wgmma", 64) is None
    monkeypatch.setattr(cs, "PTXAS", {"flash_backward": table})
    assert cs.body_ptxas("wgmma", 64) == {
        "dkdvq_wgmma_kernel<64>": {"registers": 168}}
    assert set(cs.body_ptxas("mma_sync", 80)) == {"dkdv_bf16_kernel<80>",
                                                 "dq_bf16_kernel<80>"}
    assert cs.body_ptxas("cuda_cores", 64) == {
        "dkdv_f32_kernel<64>": {"registers": 94}}
    assert set(cs.BODY_KERNELS) == set(
        __import__("repro_torch.kernels.flash_attention.ops",
                   fromlist=["x"]).BACKWARD_BODIES)


def test_training_forward_case_writes_the_row_lse_on_the_cpu(monkeypatch):
    """The kernel phase's training-forward row, untimed: it launches
    through ``_launch`` with an lse buffer (stood in by the plain version
    on the CPU, which fills it) and holds the output against the plain
    version."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    seen = []

    def launch(q, k, v, causal, window, softcap, kv_len, q_start, lse=None):
        seen.append((kv_len, q_start, None if lse is None else lse.shape))
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)

    monkeypatch.setattr(fops, "_launch", launch)
    src = (ROOT / "chip_smoke.py").read_text().replace('"cuda"', '"cpu"')
    mod = type(cs)("chip_smoke_cpu")
    mod.__file__ = str(ROOT / "chip_smoke.py")
    exec(compile(src, "chip_smoke_cpu", "exec"), mod.__dict__)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    row = mod.flash_case(torch, F, 2, 40, 4, 4, 16, "float32", kv_frac=None,
                         window=None, softcap=None, timed=False,
                         train_lse=True)
    assert row["writes_lse"] and row["max_abs_err"] == 0.0
    assert seen == [(None, None, torch.Size([2, 4, 40]))]


# ---------------------------------------------------------------------------
# Phase 19 and the ssd_backward rows
# ---------------------------------------------------------------------------


def test_mamba_train_phase_names_mamba2_at_full_width_and_its_launches():
    """Phase 19 trains the registered mamba2-2.7b at full width and depth;
    a step launches ssd_scan twice a layer under remat (forward and
    recompute) and ssd_backward once, and no attention kernel.  jamba's
    super-block counts its one attention and seven Mamba2 layers."""
    from repro_torch.configs.registry import REGISTRY

    cfg = REGISTRY[cs.MAMBA_TRAIN_ARCH]
    m = cfg.mamba
    assert (cfg.n_layers, cfg.d_model, m.d_inner(cfg.d_model),
            m.n_heads(cfg.d_model), m.head_dim, m.d_state, m.chunk,
            cfg.vocab_size) == (64, 2560, 5120, 80, 64, 128, 256, 50280)
    assert cs.train_launches(cfg) == {"flash_prefill": 0,
                                      "flash_backward": 0, "ssd_scan": 128,
                                      "ssd_backward": 64}
    assert cs.train_launches(cfg, remat=False)["ssd_scan"] == 64
    jamba = REGISTRY["jamba-v0.1-52b"].reduced()
    assert cs.train_launches(jamba) == {"flash_prefill": 2,
                                        "flash_backward": 1, "ssd_scan": 14,
                                        "ssd_backward": 7}


def test_ssd_backward_is_a_kernel_of_the_line():
    """The kernels line carries ssd_backward from phase 19 with its note;
    its SASS must show the tensor-core body (mma.sync, cp.async, ldmatrix)
    and no atomic."""
    source, replaces, phase = cs.KERNELS["ssd_backward"]
    assert (ROOT / source).is_file() and phase == "train-mamba"
    assert replaces == "src/repro/kernels/ssd/kernel.py:98"
    assert "L.ssd_chunked" in cs.KERNEL_NOTES["ssd_backward"]
    assert cs.REDESIGNED["ssd_backward"] == ("HMMA", "LDGSTS", "LDSM")
    assert cs.kernel_group("ssd_bwd_chunk_kernel") == "ssd"
    assert cs.kernel_group("ssd_bwd_chunk_tc_kernel") == "ssd"
    assert cs.kernel_group("ssd_dstate_tc_kernel") == "ssd"
    assert cs.kernel_group("ssd_chunk_kernel") == "ssd"


@pytest.mark.parametrize("planted", [None, "ATOMG.E.ADD.F32.FTZ.RN",
                                     "ATOMS.ADD", " RED.E.ADD.F32.FTZ.RN"])
def test_sass_ops_flag_an_atomic_in_the_ssd_backward(planted):
    listings = {name: _SASS for name in cs.REDESIGNED}
    if planted:
        listings["ssd_backward"] = _SASS + f"/*0100*/ {planted} [R2], R3 ;\n"
    got = cs.sass_ops(listings)["ssd_backward"]
    assert got["HMMA"] and got["LDGSTS"] and got["LDSM"]
    assert (got["no ATOM"] and got["no RED."]) is (planted is None)


def test_ssd_backward_case_holds_the_plain_backward_on_the_cpu(monkeypatch):
    """The kernel phase's SSD backward row, untimed, with the training
    forward stood in by a no-op (the CPU has no kernel; the CPU backward
    reads no states): the wrapper's CPU path is the plain backward, so
    the errors are 0 and two calls repeat."""
    from repro_torch.kernels.ssd import ops as sops

    monkeypatch.setattr(sops, "_launch", lambda *a, **kw: None)
    src = (ROOT / "chip_smoke.py").read_text().replace('"cuda"', '"cpu"')
    mod = type(cs)("chip_smoke_cpu")
    mod.__file__ = str(ROOT / "chip_smoke.py")
    exec(compile(src, "chip_smoke_cpu", "exec"), mod.__dict__)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for fused, dstate in ((False, True), (True, False)):
        row = mod.ssd_backward_case(torch, 1, 96, 2, 16, 16, "float32",
                                    dstate, timed=False, fused=fused)
        assert row["repeats_bitwise"] and row["max_abs_err"] == 0.0
        assert row["shape"] == "B=1 S=96 H=2 P=16 N=16"
        assert row["dstate"] is dstate and row["fused"] is fused


def test_ssd_backward_scratch_bytes_follow_the_body():
    """The design's own traffic the SSD backward row reports: at
    mamba2-2.7b's training shape the states read once (167.8 MB), the
    walk's dS written and read, and the partials of dB and dC written and
    read, one a group of 8 heads in bf16 (21.0 MB each), one a head in
    float32 (167.8 MB each)."""
    from repro_torch.kernels.ssd import ops as sops

    states = 4 * 16 * 80 * 64 * 128 * 4
    dap = 4 * 16 * 80 * 4
    bf16 = cs.ssd_backward_scratch_bytes(sops, 4, 1024, 80, 64, 128, 1)
    f32 = cs.ssd_backward_scratch_bytes(sops, 4, 1024, 80, 64, 128, 0)
    assert bf16 == 3 * states + 4 * (4 * 1024 * 10 * 128 * 4) + 2 * dap
    assert f32 == 3 * states + 4 * (4 * 1024 * 80 * 128 * 4) + 2 * dap
    assert round(bf16 / 1e6, 1) == 587.2


def test_plain_sub_chunk_states_are_the_recurrences():
    """What the training forward's states are held against: the plain
    recurrence's state entering each 64-row sub-chunk, the first zero,
    the one entering sub-chunk c the final state of the first 64 c rows."""
    from repro_torch.kernels.ssd.ref import ssd_ref

    g = torch.Generator().manual_seed(0)
    B, S, H, P, N = 2, 150, 2, 4, 8
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    A = -torch.rand((H,), generator=g) - 0.5
    Bm, Cm = (torch.randn((B, S, N), generator=g) for _ in range(2))
    st = cs.plain_sub_chunk_states(torch, x, dt, A, Bm, Cm)
    assert st.shape == (B, 3, H, P, N)
    assert not st[:, 0].any()
    for c in (1, 2):
        _, want = ssd_ref(x[:, :64 * c], dt[:, :64 * c], A, Bm[:, :64 * c],
                          Cm[:, :64 * c])
        torch.testing.assert_close(st[:, c], want, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# Phase 20: prefill and decode on disjoint ranks
# ---------------------------------------------------------------------------

RING = 134_348_800  # llama-3.1-8b's B=1 ring, K/V and positions


def _disjoint_world(n=3):
    """Stand-in results of phase 20's two ranks (prefill on rank 0,
    decode on rank 1) and phase 4's (streams, finish times, energy)."""
    streams = [{"rid": i, "prompt_tokens": [1, 2, 3],
                "output_tokens": [10 + i, 20 + i]} for i in range(n)]
    t_finish = [0.25 * (i + 1) for i in range(n)]

    def serve(rank, kernel, iters):
        moves = [{"tokens": 100 + i, "bytes_sent": RING if rank == 0 else 0,
                  "bytes_received": RING if rank == 1 else 0, "ms": 80.0,
                  "clock_bytes": 131_072 * (100 + i)} for i in range(n)]
        st = {"virtual_t_finish": list(t_finish), "virtual_energy_j": 200.0,
              "handoffs": {"crossed": n, "local": 0, "moves": moves},
              "launches": {"flash_prefill": 32 * n if rank == 0 else 0,
                           kernel: 0 if rank == 0 else 64, "paged_by_T": {}},
              "prefill_ms_median": 50.0 if rank == 0 else None,
              iters: None if rank == 0 else 43.0,
              "decode_tok_s": None if rank == 0 else 59.0,
              "max_memory_allocated_gb": 17.0, "captures": 0,
              "dispatch_s": 1.0, "device_wait_s": 1.0}
        return ([dict(s, output_tokens=list(s["output_tokens"]))
                 for s in streams], [], st)

    ranks = [{"ok": True, "backend": "gloo", "weights_gb": 16.06,
              "ring_bytes": RING,
              "serves": {"dense": serve(r, "ring_decode", "decode_ms_median"),
                         "paged": serve(r, "paged_decode", "iter_ms_median")}}
             for r in range(2)]
    return ranks, (streams, t_finish, 200.0)


def _plant(ranks, fault):
    dense1, paged1 = ranks[1]["serves"]["dense"], ranks[1]["serves"]["paged"]
    if fault == "stream":  # rank 1's dense stream differs from phase 4's
        dense1[0][2]["output_tokens"] = [99, 99]
    elif fault == "clock":  # a finish time off by a hair
        ranks[0]["serves"]["dense"][2]["virtual_t_finish"][1] += 1e-12
    elif fault == "energy":
        dense1[2]["virtual_energy_j"] = 200.5
    elif fault == "bytes":  # a handoff that moved half the ring
        dense1[2]["handoffs"]["moves"][0]["bytes_received"] //= 2
    elif fault == "local":  # a handoff that stayed on its rank
        dense1[2]["handoffs"]["local"] = 1
    elif fault == "launch":  # rank 1 ran the prefill instance's kernel
        paged1[2]["launches"]["flash_prefill"] = 32
    elif fault == "paged":  # the ranks' paged streams differ
        paged1[0][0]["output_tokens"] = [7]


@pytest.mark.parametrize("fault", [None, "stream", "clock", "energy",
                                   "bytes", "local", "launch", "paged"])
def test_disjoint_phase_holds_phase_4_and_the_handoffs(monkeypatch, capsys,
                                                       fault):
    """Phase 20's checks on stand-in rank results: each rank's dense
    streams and virtual clock equal phase 4's eager serve, every dense
    handoff crosses ranks with the whole ring, each rank launches only
    its own instance's kernels, and the ranks' paged streams agree; any
    planted fault fails the phase."""
    ranks, phase4 = _disjoint_world()
    _plant(ranks, fault)
    monkeypatch.setattr(cs, "spawn_world", lambda *a: ranks)
    if fault is not None:
        with pytest.raises(RuntimeError):
            cs.disjoint_phase(torch, None, phase4)
        return
    rank0, launches = cs.disjoint_phase(torch, None, phase4)
    assert rank0 is ranks[0]
    assert launches["disjoint-dense"] == {"flash_prefill": 96,
                                          "ring_decode": 64}
    assert launches["disjoint-paged"] == {"flash_prefill": 96,
                                          "paged_decode": 64}
    out = capsys.readouterr().out
    assert "disjoint-dense: handoff medians: bytes moved 134348800" in out


def test_handoff_stats_price_each_move_beside_the_clock():
    """``handoff_stats`` reads the decode instances' counters and logs
    and prices each move's context as the virtual clock does; a
    meshless cluster has none."""
    from types import SimpleNamespace

    hw = SimpleNamespace(kv_transfer_bytes=lambda n, page_size=0: (
        n * 1000 if not page_size else -(-n // page_size) * page_size * 1000))
    be = SimpleNamespace(mesh=object(), hw=hw,
                         handoffs={"crossed": 2, "local": 1},
                         handoff_log=[(33, 0, 500, 4.0), (17, 0, 0, 0.1)])
    got = cs.handoff_stats(SimpleNamespace(decode=[SimpleNamespace(
        backend=be)]), page_size=16)
    assert (got["crossed"], got["local"]) == (2, 1)
    assert [m["clock_bytes"] for m in got["moves"]] == [48_000, 32_000]
    assert got["moves"][0]["bytes_received"] == 500
    be.mesh = None
    assert cs.handoff_stats(SimpleNamespace(decode=[SimpleNamespace(
        backend=be)])) is None


# ---------------------------------------------------------------------------
# Phase 21: Mamba2 heads and MoE experts over "model"
# ---------------------------------------------------------------------------


def test_mixer_phase_names_registered_configs():
    """Phase 21 serves mamba2-2.7b and qwen3-moe-30b-a3b at full depth and
    jamba cut to its super-block, each at full width; qwen3-moe also
    over the paged pool (the JAX package's acceptance scenario) and with
    int8 dispatch, mamba2 also with int8 weights."""
    from repro_torch.configs.registry import REGISTRY

    got = {label: (arch, n, serves)
           for label, arch, n, serves in cs.MIXER_MODELS}
    assert got == {
        "mamba2": ("mamba2-2.7b", None, ("dense", "int8")),
        "qwen3moe": ("qwen3-moe-30b-a3b", None,
                     ("dense", "paged", "dispatch8")),
        "jamba": ("jamba-v0.1-52b", cs.JAMBA_LAYERS, ("dense",))}
    for label, (arch, n, _) in got.items():
        cfg = cs.config_of(arch, n)
        full = REGISTRY[arch]
        assert cfg.d_model == full.d_model
        assert cfg.n_layers == (n or full.n_layers)
    jamba = cs.config_of("jamba-v0.1-52b", cs.JAMBA_LAYERS)
    assert jamba.has_mamba and jamba.has_attention and jamba.moe is not None


def test_mixer_phase_cuts_requests_not_depth():
    """Phase 21 serves fewer requests than phases 4 and 6, never fewer
    layers: the first ``MIXER_REQUESTS`` of phase 4's requests (at least
    the 4 a dense serve needs) and ``MIXER_TURNS`` turns of the
    multi-turn workload, whose later turns still extend the earlier
    ones' prompts (the prefix cache's reuse)."""
    from types import SimpleNamespace

    from repro_torch.serving import Request

    assert all(n is None or label == "jamba"
               for label, _, n, _ in cs.MIXER_MODELS)
    reqs = cs.phase4_requests(SimpleNamespace(vocab_size=1000))
    assert 4 <= cs.MIXER_REQUESTS < len(reqs)
    assert cs.MIXER_TURNS >= 2
    turns = cs.multiturn_workload(Request, 1000, n_turns=cs.MIXER_TURNS)
    assert len(turns) == 2 * cs.MIXER_TURNS
    for late in turns[2:]:
        early = turns[late.rid - 2]
        assert late.conv_id == early.conv_id
        assert late.prompt_tokens[:early.prompt_len] == early.prompt_tokens


def _norms(tree, path=()):
    """Elements of the leaves the rules keep whole on every rank."""
    return sum(leaf.numel() for name, leaf in cs.named_leaves(tree)
               if name.split("/")[-1] in ("norm", "q_norm", "k_norm",
                                          "final_norm", "router"))


def test_expected_local_params_follow_the_rules():
    """A rank of a 2-wide slice holds half of every split leaf: for
    qwen3-moe everything but the norms and routers (its vocabulary, heads
    and 128 experts all divide 2); for mamba2 the same, except that
    in_proj's B and C columns and conv_w's B and C channels stay whole."""
    from repro_torch.models import model as M

    moe = cs.config_of("qwen3-moe-30b-a3b", None)
    full = M.init_params(moe, torch.Generator(), device="meta")
    total = sum(t.numel() for _, t in cs.named_leaves(full))
    whole = _norms(full)
    assert cs.expected_local_params(torch, moe, 2) == \
        (total - whole) // 2 + whole
    mamba = cs.config_of("mamba2-2.7b", None)
    full = M.init_params(mamba, torch.Generator(), device="meta")
    total = sum(t.numel() for _, t in cs.named_leaves(full))
    whole = _norms(full)
    m, d, n = mamba.mamba, mamba.d_model, mamba.n_layers
    bc = 2 * m.d_state
    kept = n * (d * bc + bc * m.d_conv)  # B and C of in_proj and conv_w
    assert cs.expected_local_params(torch, mamba, 2) == \
        (total - whole - kept) // 2 + whole + kept


def test_reckon_gb_counts_one_rank_of_a_slice():
    """At width 2 a rank holds its shards by the rules (bf16, mamba2's
    float32 leaves at 4 bytes), half the kv
    heads of a ring or pool, and half the SSD heads of a Mamba2 state
    with the conv tail's B and C channels whole; phase 21's two ranks
    fit the card together."""
    for label, arch, n_layers, serves in cs.MIXER_MODELS:
        cfg = cs.config_of(arch, n_layers)
        pages = cs.POOL_PAGES if "paged" in serves else None
        full = cs.reckon_gb(cfg, pool_pages=pages)
        got = cs.reckon_gb(cfg, pool_pages=pages, width=2)
        assert got.keys() == full.keys()
        assert got["weights_gb"] == pytest.approx(
            cs.expected_local_bytes(torch, cfg, 2) / 1e9, rel=1e-12)
        for leaf in ("ring_gb", "pools_gb"):
            if leaf in full:
                assert got[leaf] == pytest.approx(full[leaf] / 2, rel=1e-12)
        if cfg.has_mamba:
            m, S = cfg.mamba, cs.SLOTS * (cfg.n_layers - cfg.n_attn_layers)
            di, nh = m.d_inner(cfg.d_model) // 2, m.n_heads(cfg.d_model) // 2
            assert got["state_gb"] == pytest.approx(S * (
                (m.d_conv - 1) * (di + 2 * m.d_state) * 2
                + nh * m.head_dim * m.d_state * 4) / 1e9, rel=1e-12)
        assert 2 * sum(got.values()) <= cs.CARD_GB
    qwen = cs.config_of("qwen3-moe-30b-a3b", None)
    assert cs.reckon_gb(qwen, width=2)["weights_gb"] == pytest.approx(
        30.545, abs=1e-3)
    # every leaf bf16 but mamba2's float32 A_log, dt_bias and D
    assert cs.expected_local_bytes(torch, qwen, 2) == \
        2 * cs.expected_local_params(torch, qwen, 2)


def _mixer_world():
    """Stand-in results of phase 21's two ranks, at the rules' local
    parameter counts, with their configs."""
    cfgs, ranks = {}, [{"ok": True, "backend": "gloo", "models": {}}
                       for _ in range(2)]
    for label, arch, n_layers, serves in cs.MIXER_MODELS:
        cfg = cs.config_of(arch, n_layers)
        local = cs.expected_local_params(torch, cfg, 2)
        cfgs[label] = (cfg, local)
        for res in ranks:
            got = {"local_params": local, "serves": {}}
            for serve in serves:
                heads = {"flash_prefill": {}, "ssd_scan": {}}
                sharded = {}
                if cfg.has_mamba:
                    heads["ssd_scan"] = {
                        str(cfg.mamba.n_heads(cfg.d_model) // 2): 64}
                if cfg.has_attention:
                    heads["flash_prefill"] = {str(cfg.n_heads // 2): 96}
                    fn = ("paged_decode_attention" if serve == "paged"
                          else "decode_attention")
                    sharded[f"{fn}/hkv{cfg.n_kv_heads // 2}"] = 480
                got["serves"][serve] = {
                    "streams": [{"rid": i, "prompt_tokens": [1, 2],
                                 "output_tokens": [5] * (i + 2)}
                                for i in range(3)],
                    "decode_lens": [1, 2, 3],
                    "stats": {"head_launches": heads,
                              "sharded_launches": sharded,
                              "pool_pages_in_use": [0] if serve == "paged"
                              else []}}
            res["models"][label] = got
    return ranks, cfgs


@pytest.mark.parametrize("fault", [None, "streams", "length", "full-leaf",
                                   "shard-launch", "ssd-heads",
                                   "undrained"])
def test_mixer_checks_hold_phase_21(fault):
    """Phase 21's checks on stand-in rank results: the same streams on
    both ranks, ``decode_len + 1`` tokens each, the rules' local
    parameter counts, kernels launched at the rank's share of the heads
    only, drained pools; each planted fault fails them."""
    ranks, cfgs = _mixer_world()
    moe = ranks[1]["models"]["qwen3moe"]
    if fault == "streams":  # rank 1 emitted another token
        moe["serves"]["dense"]["streams"][0]["output_tokens"][1] = 6
    elif fault == "length":  # a stream one token short, on both ranks
        for res in ranks:
            res["models"]["jamba"]["serves"]["dense"]["streams"][2][
                "output_tokens"].pop()
    elif fault == "full-leaf":  # rank 1 kept a full-width in_proj
        m = cfgs["mamba2"][0].mamba
        d = cfgs["mamba2"][0].d_model
        ranks[1]["models"]["mamba2"]["local_params"] += \
            64 * d * (m.d_inner(d) + m.n_heads(d) // 2)
    elif fault == "shard-launch":  # the paged decode ran on full heads
        moe["serves"]["paged"]["stats"]["sharded_launches"] = {}
    elif fault == "ssd-heads":  # a scan over all 80 heads on rank 0
        ranks[0]["models"]["mamba2"]["serves"]["dense"]["stats"][
            "head_launches"]["ssd_scan"]["80"] = 1
    elif fault == "undrained":
        moe["serves"]["paged"]["stats"]["pool_pages_in_use"] = [3]
    if fault is None:
        cs.mixer_checks(ranks, cfgs)
        return
    with pytest.raises(RuntimeError):
        cs.mixer_checks(ranks, cfgs)


def test_dryrun_and_demo_phases_name_what_they_run():
    """Phase 22 traces the registered llama-3.1-8b (its weights then
    serve phase 4) and phase 18's minicpm-2b; phase 23 trains the JAX
    demo's float32 config at head dim 32, which only the flash kernels'
    float32 bodies take."""
    import sys

    from repro_torch.configs.registry import REGISTRY
    from repro_torch.kernels import _build

    assert cs.DRYRUN_ARCH == "llama-3.1-8b" and cs.DRYRUN_ARCH in REGISTRY
    assert cs.TRAIN_ARCH in REGISTRY
    assert 0 < cs.RESIDENT_TOL <= 0.01 and cs.PEAK_TOL <= 0.25
    assert cs.PEAK_SLACK == 64 * 2 ** 20
    sys.path.insert(0, str(ROOT / "examples"))
    import train_small_torch as T

    cfg = T.model_config(False)
    assert (cfg.head_dim, cfg.dtype) == (32, "float32")
    assert cfg.head_dim in _build.FLASH_HEAD_DIMS
    assert cfg.head_dim not in _build.FLASH_BF16_HEAD_DIMS
    assert cs.train_launches(cfg) == {"flash_prefill": 8,
                                      "flash_backward": 4, "ssd_scan": 0,
                                      "ssd_backward": 0}


def test_kernel_bounds_come_from_the_wrappers_cost_functions():
    """The kernel phase's roofline bound of the llama prefill row is the
    one PERF.md quotes, from ``flash_cost`` (the dry-run's source too)."""
    from repro_torch.kernels.flash_attention import ops as fops

    ms, by = cs.bound(*fops.flash_cost(1, 512, 512, 32, 8, 128, 2,
                                       causal=True, lens=[341]), "bfloat16")
    assert (round(ms, 5), by) == (0.00292, "bytes")
    src = (ROOT / "chip_smoke.py").read_text()
    for name in ("flash_cost", "flash_backward_cost", "ring_decode_cost",
                 "paged_cost", "ssd_scan_cost", "ssd_backward_cost"):
        assert f"ops.{name}(" in src, name


# ---------------------------------------------------------------------------
# int8 on a slice (phases 9, 17 and 21)
# ---------------------------------------------------------------------------


def test_int8_serves_name_registered_configs_and_cut_requests_only():
    """Phase 9's int8 serves are llama-3.1-8b at full width and depth on
    the shortest of phase 4's requests (dense, an int8 ring) and the first
    turn of phase 6's two conversations (paged, int8 weights); phase
    21's are mamba2 (int8 weights) and qwen3-moe (int8 dispatch) at full
    depth on fewer of phase 4's requests.  Each serve names its int8
    modes."""
    from types import SimpleNamespace

    from repro_torch.configs.registry import REGISTRY

    llama = cs.config_of("llama-3.1-8b")
    assert llama == REGISTRY["llama-3.1-8b"] and llama.n_layers == 32
    assert {"int8-dense", "int8-paged"} <= set(cs.MESH_SERVES)
    vocab = SimpleNamespace(vocab_size=1000)
    reqs = cs.phase4_requests(vocab)
    for n in (cs.MESH_INT8_REQUESTS, cs.MIXER_INT8_REQUESTS):
        assert 2 <= n < len(reqs)
        cut = cs.shortest_requests(vocab, n)
        assert len(cut) == n and all(r in reqs for r in cut)
        assert [r.rid for r in cut] == sorted(r.rid for r in cut)
        longest = max(r.decode_len for r in cut)
        assert all(r.decode_len >= longest for r in reqs if r not in cut)
    assert 1 <= cs.MESH_INT8_TURNS < 3  # both conversations, 2+ requests
    # phase 9's bf16 serves: cut requests, at least a dense serve's 4
    assert 4 <= cs.MESH_REQUESTS < len(reqs) and cs.MESH_TURNS >= 2
    dense = cs.serve_config(llama, "int8-dense")
    assert (dense.weight_dtype, dense.kv_dtype) == ("int8", "int8")
    paged = cs.serve_config(llama, "int8-paged")
    assert (paged.weight_dtype, paged.kv_dtype) == ("int8", llama.kv_dtype)
    assert dense.n_layers == paged.n_layers == llama.n_layers
    for label, arch, n_layers, serves in cs.MIXER_MODELS:
        for serve in set(serves) & set(cs.MIXER_INT8):
            assert n_layers is None
            cfg = cs.serve_config(cs.config_of(arch), serve)
            assert cfg.n_layers == REGISTRY[arch].n_layers
            if serve == "dispatch8":
                assert cfg.moe.dispatch_dtype == "int8"
                assert cfg.weight_dtype == "bfloat16"
            else:
                assert cfg.weight_dtype == "int8"
    assert cs.serve_config(llama, "dense") is llama


def test_reckon_gb_counts_a_ranks_int8_shards_with_their_cut_scales():
    """At width 2 a rank of int8 llama holds half of every split leaf's
    codes, the scales of a column-parallel leaf halved with its columns
    and a row-parallel leaf's whole, and half of the bf16 embedding and
    head: the bytes of rank 0's cut of the quantized tree on the reduced
    config, and the count by hand at full width."""
    import dataclasses

    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M

    small = dataclasses.replace(
        cs.config_of("llama-3.1-8b").reduced(), weight_dtype="int8")
    full = M.quantize_params(M.init_params(
        small, torch.Generator().manual_seed(0), device="cpu"))
    cut = SH.shard_params(full, small, W.FakeMesh(2, 0))
    held = sum(t.numel() * t.element_size() for _, t in cs.named_leaves(cut))
    assert cs.expected_local_bytes(torch, small, 2) == held
    cfg = dataclasses.replace(cs.config_of("llama-3.1-8b"),
                              weight_dtype="int8")
    d, q, kv, ff, V = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff,
                       cfg.vocab_size)
    codes = (2 * q * d + 2 * kv * d + 3 * d * ff) // 2
    scales = 4 * ((q + 2 * kv + 2 * ff) // 2 + 2 * d)
    layer = codes + scales + 2 * 2 * d  # and two bf16 norms
    want = cfg.n_layers * layer + 2 * V * d + 2 * d
    assert cs.reckon_gb(cfg, width=2)["weights_gb"] == pytest.approx(
        want / 1e9, rel=1e-12)
    assert cs.reckon_gb(cfg, width=2)["weights_gb"] < \
        cs.reckon_gb(cs.config_of("llama-3.1-8b"), width=2)["weights_gb"]


@pytest.mark.parametrize("fault", [None, "scale", "code", "one-rank"])
def test_int8_checksums_of_the_shards_join_to_the_meshless_tree(fault):
    """Phase 9's per-rank checksums of its shards, joined by each leaf's
    placement (a cut leaf adds up, a replicated scale counts once),
    equal phase 17's of the meshless tree; a scale off by one part in a
    million, a code off by one, or one rank's replicated scale off, each
    fails the check."""
    import dataclasses

    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cs.config_of("llama-3.1-8b").reduced(),
                              weight_dtype="int8")
    full = M.quantize_params(M.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    cuts = [SH.shard_params(full, cfg, W.FakeMesh(2, i)) for i in range(2)]
    attn = "/blocks/layer_0/attn"
    if fault == "scale":  # a row-parallel scale, on both ranks alike
        for c in cuts:
            sc = c["blocks"]["layer_0"]["attn"]["wo"]["sc"] = \
                c["blocks"]["layer_0"]["attn"]["wo"]["sc"].clone()
            sc[0, 3] *= 1 + 1e-6  # 8 float32 ulps
    elif fault == "code":
        q8 = cuts[1]["blocks"]["layer_0"]["attn"]["wq"]["q8"].clone()
        q8[0, 0, 0] += 1
        cuts[1]["blocks"]["layer_0"]["attn"]["wq"]["q8"] = q8
    elif fault == "one-rank":
        sc = cuts[1]["blocks"]["layer_0"]["mlp"]["w_out"]["sc"].clone()
        sc[0, 0] *= 2
        cuts[1]["blocks"]["layer_0"]["mlp"]["w_out"]["sc"] = sc
    per_rank = [cs.int8_checksums(c) for c in cuts]
    want = cs.int8_checksums(full)
    assert f"{attn}/wq/q8" in want and f"{attn}/wo/sc" in want
    if fault is None:
        joined = cs.join_checksums(cfg, per_rank, 2)
        assert cs.compare_checksums(joined, want, "int8") == len(want) == 14
        return
    with pytest.raises(RuntimeError):
        cs.compare_checksums(cs.join_checksums(cfg, per_rank, 2), want,
                             "int8")


def test_moe_gather_bytes_set_int8_beside_bf16():
    probe = {w: {"moe_gather": {"calls": 48, "bytes_out": 48 * b}}
             for w, b in (("prefill", 4096), ("decode", 256))}
    int8 = {w: {"moe_gather": {"calls": 48, "bytes_out": 48 * b}}
            for w, b in (("prefill", 2052), ("decode", 130))}
    got = cs.moe_gather_bytes(probe, int8)
    assert got["prefill"] == {"bf16": 4096, "int8": 2052,
                              "ratio": 2052 / 4096}
    with pytest.raises(RuntimeError):
        int8["decode"]["moe_gather"]["calls"] = 47
        cs.moe_gather_bytes(probe, int8)
