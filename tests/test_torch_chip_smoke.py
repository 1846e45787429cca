"""chip_smoke.py, the port's check on a CUDA card: it refuses to run (exit 2)
without one, and its phases — the kernels, serving slices (a)-(c), the
paper's flow (d) and training (e) — hold together end to end in a CPU
rehearsal at smoke size (plain kernel versions, no timings; exit 1 by
design)."""
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
        "paged_prefill_kv4", "matmul_wq", "matmul_grau", "flash_attention"]
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
    # slice (e): training through the loop (the plain attention scan on the
    # CPU, so no launches), the kernel-vs-plain comparison and the resume
    train = report["train"]
    assert train["layers"] == 2 and train["dtype"] == "torch.float32"
    assert train["kernel_vs_plain"]["loss_rel"] == 0.0
    assert train["kernel_vs_plain"]["grau_elements"] == 2 * 64 * 2 * 256
    losses = train["train"]["losses"]
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert train["train"]["flash_launches_want"] == 2 * 2 * 8
    res = train["resume"]
    assert res["resumed_start"] == 3 and res["restored_identical"]
    assert res["resumed_losses"] == res["uninterrupted_losses"][3:]
    assert kernels[-1]["replaces"] == "src/repro/kernels/flash_attention.py:79"
    assert kernels[-1]["launches"] == 0
    assert set(report["phase_s"]) >= {"grau", "paged_attention", "matmul_wq",
                                      "matmul_grau", "flash_attention",
                                      "slices_abc", "slice_d", "slice_e"}
    assert '"ok"' not in out.out


def _emulated_flash_bf16(q, k, v, drop_tile=None, late_scale=1.0, late=0):
    """The flash kernel's bf16 rounding on the CPU: P rounded to bf16 before
    P V, l summed from the f32 P, o rounded to bf16; optionally broken (one
    64-key tile dropped, or rows >= late scaled)."""
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    g = h // k.shape[2]
    mask = torch.arange(s)[:, None] >= torch.arange(s)[None, :]
    out = torch.empty(q.shape)
    for hi in range(h):
        sc = q[0, :, hi].float() @ k[0, :, hi // g].float().T * d ** -0.5
        sc = torch.where(mask, sc, torch.tensor(-1e30))
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        pb = p.bfloat16().float()
        if drop_tile is not None:
            pb[:, drop_tile * 64:(drop_tile + 1) * 64] = 0
        out[0, :, hi] = (pb @ v[0, :, hi // g].float()) / p.sum(-1,
                                                                 keepdim=True)
    out[:, late:] *= late_scale
    return out.bfloat16()


@pytest.mark.parametrize("broken", [None, "late rows 3% high",
                                    "key tile 3 dropped"])
def test_flash_bf16_check_holds_the_kernels_rounding_only(broken):
    """chip_smoke's bf16 check of the flash kernel passes a CPU emulation of
    the kernel's rounding and fails a late-row error of 3% (which the outer
    2e-2 gate passes) and a dropped key tile."""
    from repro_torch.kernels.ref import flash_attention_plain
    mod = _load()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 1024, n, 64), generator=g).bfloat16()
               for n in (4, 2, 2))
    want, _ = flash_attention_plain(q, k, v, causal=True)
    o = _emulated_flash_bf16(
        q, k, v, drop_tile=3 if broken == "key tile 3 dropped" else None,
        late_scale=1.03 if broken == "late rows 3% high" else 1.0, late=512)
    ratio, late = mod.flash_bf16_bound(torch, q, k, v, o, want, True, 0)
    passes = ratio <= 1.0 and late <= mod.FLASH_LATE_REL_L2
    assert passes == (broken is None), (ratio, late)
    if broken == "late rows 3% high":
        tol = mod.FLASH_TOL["bfloat16"][0]
        assert mod.close(o, want, tol, tol)[0]
