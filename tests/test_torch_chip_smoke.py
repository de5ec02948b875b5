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
