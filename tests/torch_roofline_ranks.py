"""Rank-side job of tests/test_torch_roofline.py, importable by the spawned
rank processes (torch and the port only, no JAX).

`decode_counts(rank, cfg, params, buckets)` runs in each rank of a (1, 2)
gloo mesh on the CPU: it builds the port's engine under the mesh and, at
each decode bucket, returns decode_cost's meta count beside the count of
one real decode tick on the CPU (roofline/count.py over the engine's own
_decode_tick, its collectives issued over gloo).
"""
from __future__ import annotations

from repro_torch.roofline import count as rcount
from repro_torch.serve.engine import EngineConfig, ServeEngine


def decode_counts(rank: int, cfg, params, buckets):
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh(1, 2, device="cpu", backend="gloo")
    engine = ServeEngine(cfg, params, EngineConfig(slots=2, max_seq=64,
                                                   page_size=8),
                         device="cpu", mesh=mesh)
    out = {}
    for b in buckets:
        meta = engine.decode_cost(b)
        with rcount.count() as t:
            engine._decode_tick(b)
        out[b] = {"meta": meta,
                  "real": {**rcount.decode_keys(t),
                           "collective_bytes": t.collective,
                           "collectives": dict(t.collective_by_op),
                           "collective_count": t.collectives}}
    return out
