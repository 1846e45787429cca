"""The port's serving launcher (repro_torch.launch.serve) as a real process
on the CPU at smoke size: killed with SIGKILL mid-run and rerun with
--resume, every stream in the journal ends as an uninterrupted journaled
run's; a first SIGTERM drains the in-flight streams and writes the final
snapshot, a second stops at once, and either way --resume finishes the
rest with the same streams.

Streams are read back from the journal itself (its token records, rid by
rid), the ledger a crashed process leaves behind.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import journal as tjl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--smoke", "--device", "cpu", "--dtype", "float32",
         "--requests", "4", "--slots", "2", "--max-seq", "256",
         "--page-size", "8", "--max-new", "160", "--temperature", "0.8",
         "--top-k", "40", "--alternate-greedy", "--eos-id", "-1"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def launch(*extra):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *FLAGS, *extra],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish(proc, timeout=240):
    out, _ = proc.communicate(timeout=timeout)
    return proc.returncode, out


def journal_streams(path):
    """{rid: every delivered token} from the journal's records."""
    out = {}
    for line in Path(path).read_bytes().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue                    # the torn tail of a killed writer
        if rec["kind"] == "submit":
            out.setdefault(rec["rid"], [])
        elif rec["kind"] == "token":
            out[rec["rid"]].append(rec["tok"])
    return out


def token_records(path):
    if not Path(path).exists():
        return 0
    return Path(path).read_bytes().count(b'"kind": "token"')


def wait_for_tokens(proc, path, n, timeout=240):
    t0 = time.monotonic()
    while token_records(path) < n:
        assert proc.poll() is None, proc.communicate()[0]
        assert time.monotonic() - t0 < timeout, "no tokens journaled"
        time.sleep(0.005)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """One uninterrupted journaled run on FLAGS: its streams."""
    path = tmp_path_factory.mktemp("serve") / "full.journal"
    rc, out = finish(launch("--journal", str(path)))
    assert rc == 0, out
    st = tjl.replay(path)
    assert not st.live and len(st.retired) == 4 and st.epochs == 1
    streams = journal_streams(path)
    assert all(len(t) == 160 for t in streams.values())
    return streams


def test_sigkill_then_resume_matches_uninterrupted(uninterrupted, tmp_path):
    path = tmp_path / "killed.journal"
    proc = launch("--journal", str(path))
    wait_for_tokens(proc, path, 40)
    proc.send_signal(signal.SIGKILL)
    finish(proc)
    assert proc.returncode == -signal.SIGKILL
    killed = tjl.replay(path)
    assert killed.live, "the run ended before the kill"
    rc, out = finish(launch("--journal", str(path), "--resume"))
    assert rc == 0, out
    assert f"resumed {len(killed.live)} live requests" in out
    final = tjl.replay(path)
    assert not final.live and final.epochs == killed.epochs + 1
    assert journal_streams(path) == uninterrupted


@pytest.mark.parametrize("signals", [1, 2], ids=["sigterm", "sigterm_twice"])
def test_sigterm_drains_snapshots_and_resumes(uninterrupted, tmp_path,
                                              signals):
    """One SIGTERM: the in-flight streams finish, queued requests wait in
    the journal and the snapshot. Two: the process stops at once, in-flight
    streams live too. The exit is clean either way, and --resume finishes
    every stream as the uninterrupted run."""
    path, snap = tmp_path / "term.journal", tmp_path / "snap"
    proc = launch("--journal", str(path), "--snapshot-dir", str(snap))
    wait_for_tokens(proc, path, 10)
    for _ in range(signals):
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.05)
    rc, out = finish(proc)
    assert rc == 0, out
    assert "draining: finishing in-flight streams" in out
    st = tjl.replay(path)
    payload = teng.ServeEngine._load_snapshot(snap, None)
    live = sorted(st.live)
    assert live and sorted(r["rid"] for r in payload["requests"]) == live
    for rec in payload["requests"]:
        assert rec["delivered"] == st.live[rec["rid"]].delivered
    if signals == 1:
        # the two admitted requests ran to the end before the exit
        assert sorted(st.retired) == [0, 1] and live == [2, 3]
        assert all(not st.live[r].delivered for r in live)
    else:
        assert any(st.live[r].delivered for r in live)
    assert payload["engine_config"]["eos_id"] == -1
    rc, out = finish(launch("--journal", str(path), "--resume"))
    assert rc == 0, out
    assert not tjl.replay(path).live
    assert journal_streams(path) == uninterrupted


def test_layers_serves_the_first_n_layers(capsys):
    """--layers N serves the arch cut to its first N layers at full width:
    the weights are init_lm's of the cut config, bit for bit in bytes; an
    arch whose layers are of several kinds is refused."""
    from repro_torch.configs.archs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import lm
    from repro_torch.models.config import dense_groups
    from repro_torch.quant.weights import packed_param_bytes

    launcher.main(["--smoke", "--device", "cpu", "--dtype", "float32",
                   "--requests", "2", "--slots", "2", "--max-seq", "64",
                   "--max-new", "4", "--layers", "1"])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cut = get_config("llama3.2-3b", smoke=True).replace(
        groups=dense_groups(1))
    want = packed_param_bytes(lm.init_lm(cut, seed=0, dtype=torch.float32,
                                         device="cpu"))
    assert metrics["weight_bytes"] == want
    assert metrics["decode_tokens"] == 8
    with pytest.raises(SystemExit):
        launcher.main(["--smoke", "--device", "cpu", "--arch",
                       "jamba-v0.1-52b", "--layers", "1"])
