"""chip_smoke.py, the port's check on a CUDA card: it refuses to run (exit 2)
without one, and its phases hold together end to end in a CPU rehearsal at
smoke size (plain kernel versions, no timings; exit 1 by design)."""
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exits_2_without_a_card(monkeypatch, capsys):
    mod = _load()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""                       # no result printed
    assert "is_available() is false" in out.err


def test_cpu_rehearsal_runs_every_phase(capsys, tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = _load().main(["--rehearse", "--out", str(tmp_path / "r.json")])
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr()
    assert rc == 1, out.err
    lines = out.out.strip().splitlines()
    kernels = json.loads(lines[-1])["kernels"]
    assert [k["name"] for k in kernels] == [
        "grau", "paged_attention", "paged_prefill", "paged_attention_kv4",
        "paged_prefill_kv4", "matmul_wq", "matmul_grau"]
    assert all(k["route"] == "cuda" and (ROOT / k["source"]).exists()
               for k in kernels)
    report = json.loads((tmp_path / "r.json").read_text())
    for label in ("float", "grau", "wq4_kv4_grau"):
        res = report["slice"][label]
        assert res["requests"] == 8 and res["decode_tokens"] > 0
        assert res["greedy_identical_share"] == 1.0
        assert res["first_step_logits_rel_l2"] < 1e-5
    res = report["slice"]["wq4_kv4_grau"]
    assert res["weight_bits"] == 4 and res["kv_bits"] == 4
    assert res["weight_bytes"] < report["slice"]["grau"]["weight_bytes"] / 3.6
    assert [r["kv_bits"] for r in report["kernels_kv8"]] == [8, 8]
    # slice (d): the quickstart, Table III for SFC / CNV with SiLU, and the
    # kernel path against the plain unit (both plain on the CPU)
    paper = report["paper_flow"]
    assert paper["quickstart"]["matmul_grau"]["shape"] == [128, 128]
    rows = paper["table3"]["rows"]
    assert [(r["model"], r["act"], r["layers"]) for r in rows] == [
        ("sfc", "silu", 3), ("cnv", "silu", 2)]
    assert paper["table3"]["int_act_calls"] == 2 * 6 * (3 + 2)
    assert paper["kernel_vs_plain"] == {"grau_outputs_compared": 60,
                                        "bit_exact": True,
                                        "same_logits": True}
    grau_row = kernels[0]
    assert grau_row["launches"] == (grau_row["launches_quickstart"]
                                    + grau_row["launches_table3"])
    assert set(report["phase_s"]) >= {"grau", "paged_attention", "matmul_wq",
                                      "matmul_grau", "slices_abc", "slice_d"}
    assert '"ok"' not in out.out
