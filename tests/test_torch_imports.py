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
                 "quant/weights.py"):
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


def test_kernels_build_for_hopper_from_repo_sources():
    from repro_torch.kernels import build as kbuild
    assert "arch=compute_90a,code=sm_90a" in kbuild.NVCC_FLAGS
    assert set(kbuild.SOURCES) == {"grau", "paged_attention", "matmul_wq"}
    for name in kbuild.SOURCES:
        assert (kbuild.CSRC / f"{name}.cu").exists()
    assert (kbuild.CSRC / "grau_datapath.cuh").exists()
    assert kbuild.BUILD_DIR.relative_to(ROOT).as_posix() == "build/kernels"
