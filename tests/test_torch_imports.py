"""The PyTorch port stands alone: no module of `src/repro_torch/` and not
`chip_smoke.py` imports jax or anything of the JAX package `repro`, and the
entry points never fall back to the CPU quietly."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES}
    for want in ("kernels/grau.py", "kernels/paged_attention.py",
                 "kernels/matmul_wq.py", "serve/engine.py", "models/lm.py",
                 "nn/attention.py", "quant/pot.py", "quant/kv.py",
                 "quant/quantizers.py", "quant/policy.py",
                 "quant/weights.py", "kernels/matmul_grau.py",
                 "kernels/ops.py", "kernels/ref.py", "core/hwcost.py",
                 "core/multithreshold.py", "data/pipeline.py",
                 "models/vision.py", "models/convert.py",
                 "launch/quickstart.py", "tables/table3_small_models.py",
                 "tables/table45_sweep.py", "tables/table6_hwcost.py",
                 "kernels/flash_attention.py", "configs/shapes.py",
                 "train/optim.py", "train/loop.py", "ckpt/checkpoint.py",
                 "launch/steps.py", "launch/train.py",
                 "launch/train_lm_grau.py", "serve/prng.py",
                 "serve/telemetry.py", "serve/trace.py", "serve/faults.py"):
        assert want in names
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_need_an_explicit_cpu(monkeypatch):
    from repro_torch.configs.archs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    cfg = get_config("llama3.2-3b", smoke=True)
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, EngineConfig(slots=2, max_seq=32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--smoke", "--requests", "1"])
    eng = ServeEngine(cfg, params, EngineConfig(slots=2, max_seq=32),
                      device="cpu")
    assert eng.device.type == "cpu"


def test_paper_flow_entry_points_need_an_explicit_cpu(monkeypatch):
    """The quickstart, the device-running table drivers and the vision
    model's constructors run on CUDA unless given the CPU; with no card they
    raise before any work."""
    from repro_torch.data.pipeline import ImagePipeline
    from repro_torch.launch import quickstart
    from repro_torch.models import vision
    from repro_torch.models.convert import vision_from_reference
    from repro_torch.tables import table3_small_models, table45_sweep

    cfg = vision.VisionConfig(hw=4, widths=(8,))
    params = vision.init_vision(cfg, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: quickstart.main([]),
                 lambda: table3_small_models.main(["--quick", "--steps", "1"]),
                 lambda: table45_sweep.main(["--quick"]),
                 lambda: vision.init_vision(cfg),
                 lambda: vision.train_vision(cfg, steps=1),
                 lambda: ImagePipeline(hw=4).batch(0),
                 lambda: vision_from_reference(
                     {k: {kk: v.numpy() for kk, v in d.items()}
                      for k, d in params.items()}, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_paged_caches_need_an_explicit_cpu(monkeypatch):
    from repro_torch.configs.archs import get_config
    from repro_torch.serve import kv_cache as kvc

    cfg = get_config("llama3.2-3b", smoke=True)
    pools = kvc.init_paged_caches(cfg, 3, 8, dtype=torch.float32,
                                  device="cpu")
    assert pools[0][0].k.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kvc.init_paged_caches(cfg, 3, 8)


def test_converters_need_an_explicit_cpu(monkeypatch):
    """from_reference and pools_from_reference carry weights and pools
    across: with no card and no device given they raise, like every entry
    point; so do the training entry points."""
    from repro_torch.configs.archs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train, train_lm_grau
    from repro_torch.models import lm
    from repro_torch.models.convert import (from_reference,
                                            pools_from_reference)
    from repro_torch.serve import kv_cache as kvc

    cfg = get_config("llama3.2-3b", smoke=True)
    params = lm.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    ref = {k: (v.numpy() if torch.is_tensor(v) else v)
           for k, v in params.items() if not k.startswith("group")}
    ref["group0"] = {"l0": {"ln1_w": params["group0"][0]["l0"]["ln1_w"]
                            .numpy()[None].repeat(2, 0)}}
    pools = kvc.init_paged_caches(cfg, 3, 8, dtype=torch.float32,
                                  device="cpu")
    ref_pools = tuple(tuple(type(c)(*(t.numpy() for t in c)) for c in grp)
                      for grp in pools)
    assert from_reference(ref, cfg, device="cpu")["embed"].device.type == \
        "cpu"
    assert pools_from_reference(ref_pools, device="cpu")[0][0].k.device \
        .type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: from_reference(ref, cfg),
                 lambda: pools_from_reference(ref_pools),
                 lambda: TokenPipeline(16, 8, 1).batch(0),
                 lambda: train.main(["--arch", "llama3.2-3b", "--smoke"]),
                 lambda: train_lm_grau.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_kernels_build_for_hopper_from_repo_sources():
    from repro_torch.kernels import build as kbuild
    assert "arch=compute_90a,code=sm_90a" in kbuild.NVCC_FLAGS
    assert set(kbuild.SOURCES) == {"grau", "paged_attention", "paged_prefill",
                                   "matmul_wq", "matmul_grau",
                                   "flash_attention"}
    for name in kbuild.SOURCES:
        assert (kbuild.CSRC / f"{name}.cu").exists()
    assert (kbuild.CSRC / "grau_datapath.cuh").exists()
    assert kbuild.BUILD_DIR.relative_to(ROOT).as_posix() == "build/kernels"
