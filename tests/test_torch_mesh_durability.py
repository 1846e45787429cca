"""PyTorch port vs the JAX reference: durable serving and the front door
under a serving mesh — snapshot / restore, crash recovery from the
journal, live handoff (also between mesh shapes over the same ranks) and
the asyncio front door, on (2, 1) and (1, 2) meshes of two gloo rank
processes on the CPU, and the launcher at --mesh 2x1 killed and resumed.

Every rank runs the same host schedule; global rank 0 alone writes the
journal and the snapshot, runs the door and broadcasts its admissions and
cancels in the tick's sync (serve/engine.py). One spawn of two ranks serves
every job (tests/torch_mesh_ranks.py; a job names its mesh shape); the
reference runs unsharded in this process. Streams are compared with the
reference's uninterrupted run, and a snapshot's request records and radix
summary with the reference's snapshot of the same traffic at the same
point.
"""
import functools
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks as M  # noqa: E402
from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import journal as tjl  # noqa: E402

JOIN_S = 240.0
ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"2x1": (2, 1), "1x2": (1, 2)}
HANDOFFS = [("2x1", "2x1"), ("2x1", "1x2"), ("1x2", "2x1")]
DOOR = {"n": 8, "cancel": 3, "max_new": 12}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models():
    jcfg = jget_config("llama3.2-3b", smoke=True)
    jparams, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    return jcfg, jparams, tcfg, from_reference(jparams, tcfg, device="cpu")


PREFIX = {"ecfg": {"prefix_cache": True}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of every job, from one spawn."""
    tmp = tmp_path_factory.mktemp("mesh_durable")
    jobs = {}
    for name, shape in SHAPES.items():
        jobs[f"snapshot_{name}"] = {"kind": "snapshot", "mesh": shape,
                                    "dir": str(tmp / f"snap_{name}"),
                                    **PREFIX}
        jobs[f"crash_{name}"] = {"kind": "crash", "mesh": shape,
                                 "dir": str(tmp / f"crash_{name}")}
    for src, dst in HANDOFFS:
        jobs[f"handoff_{src}_{dst}"] = {"kind": "handoff",
                                        "src": SHAPES[src],
                                        "dst": SHAPES[dst]}
    jobs["frontdoor"] = {"kind": "frontdoor", **DOOR}
    _, _, tcfg, tparams = models()
    return tmesh.spawn_ranks(
        M.run_mesh, 2, args=((2, 1), [("llama3", tcfg, tparams, jobs)]),
        threads=1, join_s=JOIN_S)


def _jrequests(n, max_new=10):
    jcfg = models()[0]
    return M.durable_requests(jcfg.vocab_size, request_cls=jeng.Request,
                              sampling_cls=jeng.SamplingParams, n=n,
                              max_new=max_new)


def _jengine(**kw):
    jcfg, jparams, _, _ = models()
    return jeng.ServeEngine(jcfg, jparams, jeng.EngineConfig(
        telemetry=False, paged_impl="gather", **M.DURABLE_ECFG, **kw))


@functools.lru_cache(maxsize=None)
def reference_streams(n, max_new=10):
    """The reference's uninterrupted run of the durable traffic."""
    eng = _jengine()
    return M.streams(eng.run(_jrequests(n, max_new)))


@functools.lru_cache(maxsize=None)
def reference_snapshot(tmp):
    """The reference's snapshot of the durable traffic (prefix cache on) at
    the snapshot job's point: its request records and radix summary."""
    eng = _jengine(prefix_cache=True)
    for r in _jrequests(4):
        eng.submit(r)
    while not all(s is not None for s in eng.slot_req) or \
            eng.stats["ticks"] < 2:
        eng.step()
        eng.poll()
    eng.snapshot(tmp, step=123)
    payload = jeng.ServeEngine._load_snapshot(tmp, 123)
    for rec in payload["requests"]:
        rec.pop("deadline_elapsed_ms")
    return payload


@pytest.mark.parametrize("shape", list(SHAPES))
def test_snapshot_restore_on_a_mesh(shape, ranks, tmp_path):
    """snapshot() on every rank with every slot busy (global rank 0 alone
    writes it, and the trace; both return its path), restore(mesh=) on
    the same mesh: every
    stream as the uninterrupted mesh run's and the reference's; the
    payload's request records and radix pin summary the reference's."""
    want = reference_streams(4)
    ref = reference_snapshot(str(tmp_path / "ref"))
    res = [r["llama3"][f"snapshot_{shape}"] for r in ranks]
    assert [r["saves"] for r in res] == [1, 0]
    assert res[0]["trace_lines"] > 0 and res[1]["trace_lines"] == 0
    assert res[0]["path"] == res[1]["path"]
    for r in res:
        assert r["whole"] == want and r["streams"] == want
        assert r["requests"] == ref["requests"]
        assert r["radix"] == ref["radix"] and r["radix"] is not None
        assert r["tick"] == ref["tick"]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_crash_recover_on_a_mesh(shape, ranks):
    """process_crash mid-prefill, with >= 3 slots decoding and at the last
    tick, then recover(mesh=): the journal's streams (every delivered
    token, rid by rid) are the reference's uninterrupted ones, each rank's
    recovered streams end them, and global rank 0 alone held a writer."""
    want = reference_streams(4)
    res = [r["llama3"][f"crash_{shape}"] for r in ranks]
    assert res[0]["ticks"] == res[1]["ticks"]
    assert len(set(res[0]["ticks"])) == 3
    for i, run in enumerate(res[0]["runs"]):
        assert run["writers"] == [True, True]
        assert res[1]["runs"][i]["writers"] == [False, False]
        assert res[1]["runs"][i]["journal"] is None
        assert run["journal"] == want, run["tick"]
        for r in res:
            got = r["runs"][i]["streams"]
            assert all(want[rid] == toks for rid, toks in got.items())


@pytest.mark.parametrize("src,dst", HANDOFFS)
def test_handoff_between_meshes(src, dst, ranks):
    """A live handoff mid-decode from an engine on one mesh to a fresh one
    on the same or another shape over the same two ranks: the reference's
    streams, the source DRAINING with every block free."""
    want = reference_streams(4)
    for r in ranks:
        h = r["llama3"][f"handoff_{src}_{dst}"]
        assert h["streams"] == want and h["transferred"] > 0
        assert h["health"] == "draining"
        assert h["free_blocks"] == h["usable_blocks"]


def test_frontdoor_on_a_mesh(ranks):
    """The asyncio front door on global rank 0 of the (2, 1) mesh, the
    other rank following: 8 concurrent submits with max_waiting=2 (the
    queue never deeper), rid 3 cancelled after its 4th token (a prefix of
    its stream), every other stream the reference's; both ranks' engines
    finished the same streams."""
    want = reference_streams(DOOR["n"], DOOR["max_new"])
    door = ranks[0]["llama3"]["frontdoor"]
    assert set(door["clients"]) == set(want)
    for rid, (toks, why) in door["clients"].items():
        if rid == DOOR["cancel"]:
            assert why == "cancelled" and 4 <= len(toks) < len(want[rid])
            assert toks == want[rid][:len(toks)]
        else:
            assert toks == want[rid], rid
    assert door["max_waiting_seen"] <= 2
    assert ranks[1]["llama3"]["frontdoor"]["engine"] == door["engine"]


# ---------------------------------------------------------------------------
# The launcher at --mesh 2x1, killed and resumed
# ---------------------------------------------------------------------------

FLAGS = ["--smoke", "--device", "cpu", "--dtype", "float32",
         "--requests", "4", "--slots", "2", "--max-seq", "128",
         "--page-size", "8", "--max-new", "64", "--temperature", "0.8",
         "--top-k", "40", "--alternate-greedy", "--eos-id", "-1"]


def _launch(tmp, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *FLAGS, *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _finish(proc, timeout=240):
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    return proc.returncode, out


def test_launcher_mesh_journal_kill_resume(tmp_path):
    """`--mesh 2x1 --journal --snapshot-dir`, its process group SIGKILLed
    after 40 journaled tokens, then rerun with --resume: every stream in
    the journal ends as an uninterrupted unsharded journaled run's, one
    epoch more, nothing live, and the resumed run's final snapshot (global
    rank 0's) is the only one."""
    full = tmp_path / "full.journal"
    rc, out = _finish(_launch(tmp_path, "--journal", str(full)))
    assert rc == 0, out
    want = M.journal_streams(full)
    assert len(want) == 4 and all(len(t) == 64 for t in want.values())

    path, snap = tmp_path / "mesh.journal", tmp_path / "snap"
    mesh = ["--mesh", "2x1", "--journal", str(path), "--snapshot-dir",
            str(snap)]
    proc = _launch(tmp_path, *mesh)
    t0 = time.monotonic()
    while (not path.exists()
           or path.read_bytes().count(b'"kind": "token"') < 40):
        assert proc.poll() is None, proc.communicate()[0]
        assert time.monotonic() - t0 < 240, "no tokens journaled"
        time.sleep(0.005)
    os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()
    killed = tjl.replay(path)
    assert killed.live, "the run ended before the kill"
    assert not snap.exists()
    rc, out = _finish(_launch(tmp_path, *mesh, "--resume"))
    assert rc == 0, out
    assert f"resumed {len(killed.live)} live requests" in out
    final = tjl.replay(path)
    assert not final.live and final.epochs == killed.epochs + 1
    assert M.journal_streams(path) == want
    steps = sorted(p.name for p in snap.iterdir() if p.name.startswith(
        "step_"))
    assert len(steps) == 1 and out.count("snapshot: ") == 1
