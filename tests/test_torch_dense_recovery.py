"""PyTorch port vs the JAX reference: durable serving on the dense backend.

Each package recovers the other's journal of a mamba2-smoke (exact-length
SSM prefill) and a whisper-smoke (encoder-decoder) run killed by
`process_crash` at every tick index — before the first admission, right
after one-shot prefills, mid-decode — and finishes with the uninterrupted
reference run's streams, greedy and sampled, compared per rid. A journal
holds no encoder frames: the port's recover() takes them as
`encoder_frames` ({rid: frames}); the reference's has no such argument, so
the test hands them to its re-queued requests before the first step.
Then the port alone: snapshot / restore (the config dict carries `paged`
and `prefill_buckets`) and a live handoff that carries Whisper's frames.
"""
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401
from torch_dense_common import engine, model, requests  # noqa: E402

from repro.serve import engine as jeng  # noqa: E402
from repro.serve import faults as jfl  # noqa: E402
from repro.serve import journal as jjl  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import faults as tfl  # noqa: E402
from repro_torch.serve import journal as tjl  # noqa: E402

# contexts the reference's exact-length SSM prefill takes even after its
# recovery folds up to 4 delivered tokens into the prompt (<= chunk 64)
LENS = [5, 12, 30, 40]
MAX_NEW = 4
PKG = {"ref": (jeng, jfl, jjl), "port": (teng, tfl, tjl)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reqs(which, arch):
    cfg = model(arch)[0 if which == "ref" else 2]
    return requests(PKG[which][0], cfg, LENS, max_new=MAX_NEW)


def _streams(done):
    return {r.rid: list(r.out_tokens) for r in done}


def _frames(arch):
    return {r.rid: r.encoder_frames for r in _reqs("ref", arch)}


def _recover(which, arch, path):
    """The reader package's recover() on the dense backend, with the
    frames of an enc-dec run given back."""
    jcfg, jp, tcfg, tp = model(arch)
    mod = PKG[which][0]
    ecfg = mod.EngineConfig(slots=2, max_seq=160, seed=11, eos_id=-1,
                            paged=False)
    if which == "port":
        frames = _frames(arch) if tcfg.encoder is not None else None
        return teng.ServeEngine.recover(tcfg, tp, path, ecfg=ecfg,
                                        device="cpu", encoder_frames=frames)
    eng = jeng.ServeEngine.recover(jcfg, jp, path, ecfg=ecfg)
    if jcfg.encoder is not None:
        frames = _frames(arch)
        for rs in eng.scheduler.waiting:
            rs.encoder_frames = frames[rs.rid]
    return eng


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-medium"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")],
                         ids=["ref_writes_port_recovers",
                              "port_writes_ref_recovers"])
def test_cross_package_recovery_on_the_dense_backend(arch, writer, reader,
                                                     tmp_path):
    ref_eng = engine("ref", arch, paged=False)
    want = _streams(ref_eng.run(_reqs("ref", arch)))
    ticks = ref_eng.stats["ticks"]
    ref_eng.close()
    mod, fl, jl = PKG[writer]
    kills = 0
    for k in range(ticks + 1):
        path = tmp_path / f"{writer}_{k}.journal"
        plan = fl.FaultPlan()
        plan.arm("process_crash", tick=k)
        eng = engine(writer, arch, paged=False, faults=plan,
                     journal=jl.RequestJournal(path))
        eng._owns_journal = True
        reqs = _reqs(writer, arch)
        for r in reqs:
            eng.submit(r)
        crashed = False
        try:
            while (eng.scheduler.waiting
                   or any(s is not None for s in eng.slot_req)):
                eng.step()
                eng.poll()
        except fl.ProcessCrash:
            crashed = True
        if not crashed:
            eng.close()
            assert _streams(reqs) == want
            continue
        kills += 1
        pre = {r.rid: list(r.out_tokens) for r in reqs}
        del eng                                   # no close(): a dead process
        state = PKG[reader][2].replay(path)
        eng2 = _recover(reader, arch, path)
        resumed = _streams(eng2.run([]))
        eng2.close()
        assert not PKG[reader][2].replay(path).live
        for rid, tokens in want.items():
            got = resumed.get(rid, pre[rid])
            if rid in state.live:
                assert got[:len(state.live[rid].delivered)] == (
                    state.live[rid].delivered)
            assert got == tokens, (f"kill at tick {k}: rid {rid}", got,
                                   tokens)
    assert kills == ticks


def test_snapshot_restore_and_config_dict_on_the_dense_backend(tmp_path):
    """mamba2-smoke: a snapshot mid-run carries `paged` and
    `prefill_buckets`; the restored engine is dense again and finishes
    every stream as the uninterrupted run does."""
    arch = "mamba2-1.3b"
    base = engine("port", arch, paged=False, prefill_buckets=(16, 159))
    want = _streams(base.run(_reqs("port", arch)))
    base.close()
    eng = engine("port", arch, paged=False, prefill_buckets=(16, 159))
    for r in _reqs("port", arch):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    first = _streams(eng.poll())
    eng.snapshot(tmp_path / "snap")
    eng.close()
    cfg = teng.ServeEngine._load_snapshot(tmp_path / "snap",
                                          None)["engine_config"]
    assert cfg["paged"] is False and cfg["prefill_buckets"] == [16, 159]
    _, _, tcfg, tp = model(arch)
    eng2 = teng.ServeEngine.restore(tcfg, tp, tmp_path / "snap",
                                    device="cpu")
    assert not eng2.paged and eng2.buckets == (16, 159)
    got = {**first, **_streams(eng2.run([]))}
    eng2.close()
    assert got == want


def test_handoff_carries_encoder_frames():
    """whisper-smoke handed off mid-decode to a second dense engine: the
    frames travel with the requests (records carry none) and every stream
    equals the uninterrupted run's; an enc-dec readmission without frames
    is refused before anything moves."""
    arch = "whisper-medium"
    base = engine("port", arch, paged=False)
    want = _streams(base.run(_reqs("port", arch)))
    base.close()
    src = engine("port", arch, paged=False)
    for r in _reqs("port", arch):
        src.submit(r)
    for _ in range(3):
        src.step()
    first = _streams(src.poll())
    bare = engine("port", arch, paged=False)
    with pytest.raises(ValueError, match="encoder_frames"):
        bare._readmit(src._live_records())
    bare.close()
    dst = engine("port", arch, paged=False, slots=3)
    assert src.handoff(dst)["transferred"] > 0
    got = {**first, **_streams(dst.run([]))}
    src.close()
    dst.close()
    assert got == want
