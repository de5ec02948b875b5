"""The port stands alone: no JAX and nothing of the JAX package, CUDA by
default, and unported paths fail loudly instead of falling back."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import REGISTRY
from repro_torch.core.hwmodel import HardwareModel
from repro_torch.core.power import A100
from repro_torch.distributed import mesh_context
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
        "import repro_torch.kernels.ssd\n"
        "import repro_torch.distributed, repro_torch.distributed.context\n"
        "import repro_torch.distributed.meshslice\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.commmodel\n"
        "import repro_torch.configs.shapes\n"
        "import repro_torch.core.state_space, repro_torch.serving.scenarios\n"
        "import repro_torch.serving.traces, repro_torch.serving.loadgen\n"
        "import repro_torch.launch.serve\n"
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


@pytest.mark.parametrize("arch,kw,item", [
    # disjoint slices: a 2-wide slice of a 4-rank world
    pytest.param("llama-3.1-8b", dict(tp=2, devices=[0, 1, 2, 3]), "item 8",
                 id="kw2-item 8"),
    pytest.param("mamba2-2.7b", dict(tp=2, devices=[0, 1]), "item 8",
                 id="mamba2-tp2-item 8"),
])
def test_unported_serving_paths_raise(arch, kw, item):
    """Mesh slices that the port does not serve raise before any process
    group is touched (the ranks are given, no world is joined)."""
    rc = REGISTRY[arch].reduced()
    with pytest.raises(NotImplementedError, match=item):
        make_real_backend_factory(rc, {}, device="cpu", **kw)


def test_mamba2_model_on_a_mesh_raises():
    """The model itself refuses Mamba2 on a mesh wider than 1 (a stand-in
    mesh: only its axis names and sizes are read before the raise)."""
    rc = REGISTRY["mamba2-2.7b"].reduced()
    wide = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    with mesh_context(wide):
        with pytest.raises(NotImplementedError, match="item 8"):
            TM.init_cache(rc, 1, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        TM.init_params(rc, torch.Generator(), device="cpu", mesh=wide)


def test_sharded_weights_need_a_mesh_context():
    """Weights cut for a slice (here ``w_out`` at half its rows) outside
    any mesh context raise instead of computing a partial sum."""
    rc = dataclasses.replace(MODEL.reduced(), dtype="float32")
    params = TM.init_params(rc, torch.Generator().manual_seed(0),
                            device="cpu")
    mlp = params["blocks"]["layer_0"]["mlp"]
    mlp["w_out"] = mlp["w_out"][:, : rc.d_ff // 2].contiguous()
    mlp["w_gate"] = mlp["w_gate"][..., : rc.d_ff // 2].contiguous()
    mlp["w_in"] = mlp["w_in"][..., : rc.d_ff // 2].contiguous()
    with pytest.raises(RuntimeError, match="mesh_context"):
        TM.forward(params, rc, torch.zeros((1, 8), dtype=torch.int32))


def test_paged_and_spec_serving_paths_are_ported():
    """The paged pool (ROADMAP queue 1, item 4) and speculation (item 5)
    construct; speculation still needs the paged pool and a drafter."""
    rc = MODEL.reduced()
    hw = HardwareModel(MODEL, A100)
    be = RealBackend(hw, rc, {}, slots=2, max_len=64, paged=True,
                     device="cpu")
    assert be.pool.free_pages == be.pool_pages == (2 * 2 + 8) * 4
    assert make_real_backend_factory(rc, {}, paged=True, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        RealBackend(hw, rc, {}, spec_k=2, device="cpu")


def test_unported_model_paths_raise():
    """int8 KV still raises where the reference raises: on the paged
    pool, with the reference's ``ValueError``; the dense int8 ring is
    served.  A ring shorter than the prompt (``max_len`` < S) is served
    too, and as the JAX model serves it: the last ``max_len`` positions
    of each row at slot ``pos % max_len``."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import REGISTRY as JREG
    from repro.models import model as JM

    rc = dataclasses.replace(MODEL.reduced(), dtype="float32")
    jrc = dataclasses.replace(JREG["llama-3.1-8b"].reduced(), dtype="float32")
    np_params = jax.tree.map(np.asarray, JM.init_params(jrc,
                                                        jax.random.key(0)))
    params = bridge.params_from_jax(np_params, device="cpu")
    toks = np.random.default_rng(0).integers(
        0, rc.vocab_size, (2, 32)).astype(np.int32)
    lengths = np.array([32, 20], np.int32)
    lj, cj = JM.prefill(jax.tree.map(jnp.asarray, np_params), jrc,
                        jnp.asarray(toks), jnp.asarray(lengths), max_len=16)
    lt, ct = TM.prefill(params, rc, torch.from_numpy(toks),
                        torch.from_numpy(lengths), max_len=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5,
                               rtol=2e-5)
    for key, leaf in cj["layer_0"].items():
        np.testing.assert_allclose(ct["layer_0"][key].numpy(),
                                   np.asarray(leaf), atol=2e-5, rtol=2e-5)
    int8_kv = dataclasses.replace(rc, kv_dtype="int8")
    jint8_kv = dataclasses.replace(jrc, kv_dtype="int8")
    with pytest.raises(ValueError, match="int8 KV") as want:
        JM.init_paged_cache(jint8_kv, 8, 16)
    with pytest.raises(ValueError, match="int8 KV") as got:
        TM.init_paged_cache(int8_kv, 8, 16, device="cpu")
    assert str(got.value) == str(want.value)
    ring = TM.init_cache(int8_kv, 1, 16, device="cpu")["layer_0"]
    assert ring["k"].dtype == torch.int8
    assert ring["k_sc"].dtype == torch.float32


def test_hubert_int8_and_wide_moe_raise():
    """What the port still refuses, each naming its reason or ROADMAP
    item: hubert through the serving backend (an encoder fed embeddings
    has no decode phase), every int8 mode (weights, KV, MoE dispatch) on
    a mesh wider than 1 (item 8), and a MoE model on a mesh wider than
    1, in the model and in the serving factory before any process group
    is touched (item 8).  Off the mesh, hubert and the int8 modes pass
    the model's check."""
    hubert = REGISTRY["hubert-xlarge"].reduced()
    TM.check_supported(hubert)
    with pytest.raises(ValueError, match="no decode phase"):
        make_real_backend_factory(hubert, {}, device="cpu")
    with pytest.raises(ValueError, match="no decode phase"):
        RealBackend(HardwareModel(MODEL, A100), hubert, {}, device="cpu")
    moe = REGISTRY["qwen3-moe-30b-a3b"].reduced()
    wide = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    for bad in (dataclasses.replace(MODEL.reduced(), weight_dtype="int8"),
                dataclasses.replace(MODEL.reduced(), kv_dtype="int8"),
                dataclasses.replace(moe, moe=dataclasses.replace(
                    moe.moe, dispatch_dtype="int8"))):
        TM.check_supported(bad)
        with mesh_context(wide):
            with pytest.raises(NotImplementedError, match="item 8"):
                TM.check_supported(bad)
        with pytest.raises(NotImplementedError, match="item 8"):
            make_real_backend_factory(bad, {}, device="cpu", tp=2,
                                      devices=[0, 1])
    with mesh_context(wide):
        with pytest.raises(NotImplementedError, match="item 8"):
            TM.init_cache(moe, 1, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        make_real_backend_factory(moe, {}, device="cpu", tp=2,
                                  devices=[0, 1])


# Modules of the port ported by hand (they import JAX in the reference, or
# the port's own design replaces the reference's).  Every other module
# with the same path in both packages is a copy under ROADMAP's copy rule.
HAND_PORTED = {
    "distributed/__init__.py",
    "distributed/context.py",
    "distributed/meshslice.py",
    "distributed/sharding.py",
    "serving/jitcache.py",
    "serving/realengine.py",
}
HAND_PORTED_DIRS = ("kernels/", "models/")


def _copies():
    ref = PORT.parent / "repro"
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT).as_posix()
        if (ref / rel).is_file() and rel not in HAND_PORTED \
                and not rel.startswith(HAND_PORTED_DIRS):
            yield rel


def test_copied_modules_equal_the_reference_under_the_rewrite():
    """Each copy, with ``repro_torch`` read as ``repro``, is the
    reference's source exactly: the rewrite of ``repro.`` to
    ``repro_torch.`` is the only change a copy may make."""
    ref = PORT.parent / "repro"
    copies = list(_copies())
    for rel in ("serving/traces.py", "serving/loadgen.py",
                "serving/scenarios.py", "serving/__init__.py",
                "core/state_space.py", "distributed/commmodel.py",
                "configs/shapes.py", "launch/serve.py",
                "configs/qwen3_32b.py", "configs/ministral_3b.py"):
        assert rel in copies, rel
    assert not (PORT / "launch" / "__init__.py").exists()
    differ = [rel for rel in copies
              if (PORT / rel).read_text().replace("repro_torch", "repro")
              != (ref / rel).read_text()]
    assert not differ, differ


def test_hand_ported_list_names_real_modules():
    ref = PORT.parent / "repro"
    for rel in HAND_PORTED:
        assert (PORT / rel).is_file() and (ref / rel).is_file(), rel
