"""``chip_smoke.py`` off the card: it refuses to run without one, and its
readers of the compiler's and the timers' output."""
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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
         "/*00a0*/ LDSM.16.M88.4 R8, [R2] ;\n")


@pytest.mark.parametrize("lib,drop", [
    (None, None),  # all present
    ("ring_decode", "HMMA"),
    ("ring_decode", "LDGSTS"),
    ("ssd_scan", "HMMA"),
    ("flash_prefill", "LDSM"),
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
    m = PDCluster(ClusterConfig(
        model=full, chip=A100, n_prefill=1, n_decode=1, policy="voltana",
        predictor=build_predictor(full, A100, A100.freq_levels_2,
                                  kv_cap=400_000),
        kv_capacity_tokens=400_000, online_adapt=False, decode_max_running=8,
        seed=0, backend_factory=factory)).run(reqs)
    assert m.finished_frac() == 1.0
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
