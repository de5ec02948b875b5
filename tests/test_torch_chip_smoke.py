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
