"""Training loop: step + checkpoint/auto-resume + failure handling (the JAX
package's train/loop.py).

The loop is deliberately boring — the step lives in launch/steps.py and the
atomic commits in ckpt/. Fault tolerance:
  * auto-resume: on start, restore the latest committed checkpoint and seek
    the (pure-function-of-step) data pipeline to that step;
  * NaN fuse: a non-finite loss stops the run before it can poison a
    checkpoint (the previous committed checkpoint stays the restart point);
  * straggler log: steps longer than `straggler_factor` x the rolling median
    are logged (on a cluster that feeds the reschedule signal).
Reading the loss each step (`float(...)`) waits for the device, as the
reference's does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.ckpt import checkpoint as ckpt_lib


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


def run(
    *,
    train_step: Callable,          # (params, opt_state, batch) -> (params, opt, metrics)
    params,
    opt_state,
    batch_fn: Callable[[int], Dict],
    loop: LoopConfig,
    log: Callable[[str], None] = print,
):
    start = 0
    if loop.ckpt_dir:
        last = ckpt_lib.latest_step(loop.ckpt_dir)
        if last is not None:
            log(f"[resume] restoring step {last} from {loop.ckpt_dir}")
            state = ckpt_lib.restore(loop.ckpt_dir, last,
                                     {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = last

    times = []
    losses = []
    for step in range(start, loop.total_steps):
        t0 = time.time()
        batch = batch_fn(step)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        times.append(dt)
        losses.append(loss)

        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite loss at step {step}; last committed checkpoint "
                f"remains the restart point")

        if len(times) > 5:
            med = float(np.median(times[-20:]))
            if dt > loop.straggler_factor * med:
                log(f"[straggler] step {step} took {dt:.2f}s "
                    f"(median {med:.2f}s) — flagged for rescheduling")

        if step % loop.log_every == 0:
            log(f"step {step:6d} loss {loss:8.4f} "
                f"lr {float(metrics.get('lr', 0)):.2e} "
                f"gnorm {float(metrics.get('grad_norm', 0)):.2f} "
                f"{dt * 1e3:.0f}ms")

        if loop.ckpt_dir and (step + 1) % loop.ckpt_every == 0:
            ckpt_lib.save(loop.ckpt_dir, step + 1,
                          {"params": params, "opt": opt_state},
                          keep=loop.keep)
            log(f"[ckpt] committed step {step + 1}")

    return params, opt_state, {"losses": losses, "times": times,
                               "start": start}
