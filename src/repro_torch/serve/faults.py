"""Deterministic fault-injection harness for the serving stack.

A :class:`FaultPlan` is a registry of named injection points ("sites")
threaded through the engine hot path.  Each site is armed with one or
more :class:`FaultSpec` entries; when the engine reaches the site it
calls :meth:`FaultPlan.fire` with the current schedule context (request
id, tick) and receives either ``None`` (no fault) or the armed spec.
Triggering is purely a function of the schedule context and the spec's
own counters — never of wall-clock time or global RNG state — so a
chaos run replays identically given the same plan and workload.

The harness itself never raises: sites that model *exceptions* raise
:class:`InjectedFault` from the call site in the engine, so containment
code exercises exactly the ``except`` paths that real faults would.

Sites:

========================  ====================================================
site                      models
========================  ====================================================
``alloc_exhausted``       BlockAllocator returning None mid-chunk
``radix_pin_leak``        a retire path that forgets to unpin its radix chain
``block_leak``            a retire path that forgets to free its KV blocks
``nan_logits``            NaN/Inf appearing in one slot's decode logits
``slow_step``             a device step that takes ``delay_s`` too long
``chunk_error``           an exception inside ``_run_chunk``
``step_error``            an exception inside ``ServeEngine.step``
``sink_error``            a front-door token sink raising on delivery
``process_crash``         the serving process dying at a tick boundary
                          (raises :class:`ProcessCrash`, which deliberately
                          escapes every containment layer — recovery is
                          journal replay in a new engine, not an except)
========================  ====================================================
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SITES = (
    "alloc_exhausted",
    "radix_pin_leak",
    "block_leak",
    "nan_logits",
    "slow_step",
    "chunk_error",
    "step_error",
    "sink_error",
    "process_crash",
)


class InjectedFault(RuntimeError):
    """Raised by engine call sites when an exception-type fault fires."""

    def __init__(self, site: str, rid: Optional[int] = None, tick: Optional[int] = None):
        super().__init__(f"injected fault site={site} rid={rid} tick={tick}")
        self.site = site
        self.rid = rid
        self.tick = tick


class ProcessCrash(RuntimeError):
    """Simulated hard process death (the ``process_crash`` site).

    Deliberately NOT an :class:`InjectedFault`: the engine's step-level
    containment (and the front door's tick-loop containment) must let it
    propagate — a crashed process cannot handle its own crash.  Tests and
    benches abandon the engine when this escapes (recovering a fresh one
    from a journal is not ported yet: this site only raises)."""

    def __init__(self, tick: Optional[int] = None):
        super().__init__(f"injected process crash at tick {tick}")
        self.tick = tick


@dataclass
class FaultSpec:
    """One armed fault at one site.

    Matching is AND over the non-None selectors: ``rid`` matches the
    request the engine is operating on, ``tick`` the engine tick
    counter.  ``nth`` skips the first ``nth`` matching occasions (0 =
    fire on the first match).  ``once`` (default) consumes the spec
    after it fires; a non-once spec fires on every match.
    ``delay_s`` parameterizes ``slow_step``.
    """

    site: str
    rid: Optional[int] = None
    tick: Optional[int] = None
    nth: int = 0
    once: bool = True
    delay_s: float = 0.0
    # bookkeeping
    _seen: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; known: {SITES}")

    def _matches(self, rid: Optional[int], tick: Optional[int]) -> bool:
        # A None *context* value means the site has no such notion (e.g.
        # step_error fires before any request is chosen) — the selector is
        # skipped, and self.rid survives as payload on the raised fault.
        if self.rid is not None and rid is not None and rid != self.rid:
            return False
        if self.tick is not None and tick is not None and tick != self.tick:
            return False
        return True

    @property
    def spent(self) -> bool:
        return self.once and self.fired > 0


class FaultPlan:
    """Schedule-deterministic registry of armed faults.

    ``fire(site, rid=..., tick=...)`` returns the first live matching
    :class:`FaultSpec` (marking it consumed if ``once``) or ``None``.
    ``injected`` counts fires per site for assertions and telemetry.
    """

    def __init__(self, specs: Optional[List[FaultSpec]] = None):
        self._specs: List[FaultSpec] = list(specs or [])
        for spec in self._specs:
            # construction-time validation even for duck-typed spec objects:
            # a typo'd site must raise here, not silently never fire
            if spec.site not in SITES:
                raise ValueError(
                    f"unknown fault site {spec.site!r}; known: {SITES}")
        self.injected: Dict[str, int] = {}
        self.log: List[Tuple[str, Optional[int], Optional[int]]] = []

    def arm(self, site: str, **kw) -> FaultSpec:
        spec = FaultSpec(site=site, **kw)
        self._specs.append(spec)
        return spec

    def fire(self, site: str, rid: Optional[int] = None, tick: Optional[int] = None) -> Optional[FaultSpec]:
        if site not in SITES:
            # an engine-side typo'd call site would otherwise never match
            # any spec and pass silently — fail loudly instead
            raise ValueError(
                f"unknown fault site {site!r}; known: {SITES}")
        for spec in self._specs:
            if spec.site != site or spec.spent:
                continue
            if not spec._matches(rid, tick):
                continue
            if spec._seen < spec.nth:
                spec._seen += 1
                continue
            spec.fired += 1
            self.injected[site] = self.injected.get(site, 0) + 1
            self.log.append((site, rid, tick))
            return spec
        return None

    def pending(self) -> List[FaultSpec]:
        """Specs armed but never fired (useful for chaos-run assertions)."""
        return [s for s in self._specs if s.fired == 0]

    @classmethod
    def seeded(
        cls,
        seed: int,
        sites: Tuple[str, ...] = ("chunk_error", "nan_logits", "alloc_exhausted"),
        rids: Tuple[int, ...] = (),
        n: int = 4,
    ) -> "FaultPlan":
        """Reproducible random plan: same seed + workload → same chaos run.

        Draws ``n`` (site, rid) pairs with a private PRNG.  Determinism
        comes from the specs being fixed before the run starts, not from
        seeding anything inside the engine.
        """
        rng = random.Random(seed)
        plan = cls()
        pool = list(rids) or [None]
        for _ in range(n):
            plan.arm(rng.choice(list(sites)), rid=rng.choice(pool))
        return plan


def fault_matrix(rid: int) -> List[Tuple[str, FaultPlan, str]]:
    """The canonical one-fault-per-run matrix used by tests and the bench.

    Returns ``(site, plan, expected_retire_reason)`` triples, each plan
    arming exactly one fault against request ``rid``.
    """
    rows = [
        ("alloc_exhausted", "resource_exhausted"),
        ("radix_pin_leak", None),  # leak is silent at retire; audit() reclaims
        ("block_leak", None),
        ("nan_logits", "numeric_error"),
        ("chunk_error", "internal_error"),
        ("step_error", "internal_error"),
        ("sink_error", "sink_error"),
        # no retire reason: the process dies and recovery is journal
        # replay in a fresh engine, not containment —
        # consumers that drive engine.run() directly must special-case it
        ("process_crash", None),
    ]
    out = []
    for site, reason in rows:
        plan = FaultPlan()
        plan.arm(site, rid=rid)
        out.append((site, plan, reason))
    return out
