"""The port's quickstart and paper-table drivers run end to end on the CPU
(`--device cpu`; the kernels' plain versions), print the reference's rows,
and hold what the reference's drivers hold: the quickstart's kernel outputs
bit for bit against their plain versions, Table IV/V's printed rows equal
to the JAX package's, Table VI's headline LUT reduction."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.launch import quickstart
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "fitted window 2^-12..2^-5" in out
    assert "matches its plain version" in out
    res = quickstart.run("cpu", verbose=False)
    assert res["matmul_grau"] == {"shape": [128, 128], "dtype": "torch.int8"}
    # the reference quickstart's outputs for the same register files
    assert res["silu_out"][0][:3] == [127, 127, 17]
    assert res["relu_out"][0][:3] == [127, 127, 20]


def test_table3_runs_on_the_cpu(capsys):
    """--quick at a cut step count: one row per setting, every accuracy a
    share, one range per activation layer."""
    from repro_torch.tables import table3_small_models as t3
    rows = t3.main(["--quick", "--device", "cpu", "--steps", "15",
                    "--settings", "sfc-relu", "cnv-silu"])
    out = capsys.readouterr().out.splitlines()
    assert [r["model"] + "-" + r["act"] for r in rows] == ["sfc-relu",
                                                           "cnv-silu"]
    assert [r["layers"] for r in rows] == [3, 2]
    for r, line in zip(rows, out):
        assert line.startswith(f"table3,{r['model']}-{r['act']},orig=")
        for k in ("original", "pwlf", "pot", "apot"):
            assert 0.0 <= r[k] <= 1.0


def test_table45_prints_the_reference_rows(capsys):
    from benchmarks import table45_sweep as ref
    from repro_torch.tables import table45_sweep as t45
    rows = t45.main(["--quick", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    want_rows = ref.run(quick=True)
    want = capsys.readouterr().out.splitlines()
    assert out[:-1] == want and len(rows) == len(want_rows) == 18
    assert t45.check_paper_trends(rows) == ref.check_paper_trends(want_rows)
    assert out[-1] == str(t45.check_paper_trends(rows))


def test_table6_prints_the_reference_rows(capsys):
    from benchmarks import table6_hwcost as ref
    from repro_torch.tables import table6_hwcost as t6
    rows = t6.main(["--quick"])
    out = capsys.readouterr().out
    ref.run(quick=True)
    assert out == capsys.readouterr().out
    assert "headline_lut_reduction=91.3%" in out
    assert len(rows) == 16
