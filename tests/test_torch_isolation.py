"""The port stands alone: no JAX and nothing of the JAX package, CUDA by
default, and unported paths fail loudly instead of falling back."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import REGISTRY
from repro_torch.core.hwmodel import HardwareModel
from repro_torch.core.power import A100
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import bridge
from repro_torch.models import model as TM
from repro_torch.serving.realengine import (
    RealBackend,
    make_real_backend_factory,
)

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
MODEL = REGISTRY["llama-3.1-8b"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "repro"):
                bad.append(f"{f.relative_to(PORT)}: {mod}")
    assert not bad, bad


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.serving, repro_torch.core\n"
        "import repro_torch.models.model, repro_torch.models.bridge\n"
        "import repro_torch.serving.realengine, repro_torch.kernels._build\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.decode_attention\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PORT.parent)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = MODEL.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(rc, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_real_backend_factory(rc, {}, slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_jax({"w": np.zeros(2, np.float32)})
    params = TM.init_params(rc, torch.Generator(), device="cpu")
    assert params["embed"].device.type == "cpu"


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel or raises."""
    q = torch.zeros((1, 16, 4, 16), device="meta")
    k = torch.zeros((1, 16, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no flash_attention"):
        flash_attention(q, k, k)
    qd = torch.zeros((1, 4, 16), device="meta")
    pos = torch.zeros((1, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no decode_attention"):
        decode_attention(qd, k, k, pos, pos[:, 0])


@pytest.mark.parametrize("kw,item", [
    (dict(paged=True), "item 4"),
    (dict(spec_k=2), "item 5"),
    (dict(tp=2), "item 8"),
])
def test_unported_serving_paths_raise(kw, item):
    rc = MODEL.reduced()
    with pytest.raises(NotImplementedError, match=item):
        make_real_backend_factory(rc, {}, device="cpu", **kw)
    if "tp" not in kw:
        with pytest.raises(NotImplementedError, match=item):
            RealBackend(HardwareModel(MODEL, A100), rc, {}, device="cpu",
                        **kw)


def test_unported_model_paths_raise():
    rc = dataclasses.replace(MODEL.reduced(), dtype="float32")
    params = TM.init_params(rc, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 7"):
        TM.prefill(params, rc, toks, torch.tensor([32]), max_len=16)
    with pytest.raises(NotImplementedError, match="item 6"):
        TM.init_cache(dataclasses.replace(rc, kv_dtype="int8"), 1, 16,
                      device="cpu")
