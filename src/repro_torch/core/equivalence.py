"""Differential equivalence checking for the HIR transformation layer.

The paper's product is a *source-to-source rewrite*; the only acceptable
evidence that a rewrite is safe on programs nobody hand-inspected is a
differential oracle (the "Automated Synthesis of Asynchronizations"
discipline): run the untransformed program on the synchronous
:class:`~repro.core.hir.Interpreter`, run ``transform_program``'s output on
the sharded :class:`~repro.core.runtime.AsyncQueryRuntime` against the
*same* service, and require

* **bit-identical observables** — the final environment restricted to the
  original program's variable names, plus the ordered list of effect
  emissions, and
* **strictly fewer service round trips** whenever the applicability
  analysis claimed a rewrite (a batch costs 3 round trips — §5.2.3 — so
  saving round trips is the transformation's entire point), and
* **analysis/transformer agreement** — ``analyze_applicability`` approves a
  rewrite if and only if the transformed program actually contains a
  fissioned loop (a drifting analysis would make Table-1 style reporting
  meaningless).

A :class:`~repro.core.faults.ChaosService` variant re-checks equivalence
under injected transient faults and latency spikes (the runtime retries;
the synchronous oracle runs against the raw inner service) — the rewrite
must stay invisible even when the service is misbehaving.  Round-trip wins
are not asserted under chaos: retries legitimately add trips.

:func:`synthesize_async` is the synthesis-lite search: enumerate subsets of
the fissionable loop sites (``enumerate_fission_sites``), check each
candidate for equivalence, and keep the cheapest safe rewrite — equivalence
as the search filter rather than a post-hoc assertion.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Mapping, Optional, Sequence

from repro_torch.core.faults import ChaosPlan, ChaosService, InjectedFault
from repro_torch.core.hir import (
    Interpreter,
    Program,
    Stmt,
    _ProducerConsumer,
    analyze_applicability,
    collect_names,
    enumerate_fission_sites,
    transform_program,
)
from repro_torch.core.resilience import Resilience
from repro_torch.core.services import SimulatedDBService
from repro_torch.core.strategies import PureBatch
from repro_torch.core.runtime import AsyncQueryRuntime

__all__ = [
    "TrialResult",
    "DifferentialReport",
    "SynthesisResult",
    "make_service",
    "count_fissioned",
    "check_program",
    "run_differential",
    "synthesize_async",
]

_UNSET = "<unset>"


def make_service(compute_fn: Optional[Callable[[str, tuple], Any]] = None,
                 ) -> SimulatedDBService:
    """A near-zero-latency simulated database with a deterministic compute
    function — latency would only slow the harness down; the cost model we
    assert on is the round-trip *count*, not wall time."""
    if compute_fn is None:
        from repro_torch.core.services import TableService  # noqa: F401 (doc link)

        def compute_fn(q: str, p: tuple) -> int:
            return (sum((i + 3) * int(v) for i, v in enumerate(p)) * 7 + 1) \
                % 10007
    return SimulatedDBService(rtt=0.0, single_proc=0.0, batch_proc=0.0,
                              batch_fixed=0.0, concurrency=8,
                              compute_fn=compute_fn)


def count_fissioned(stmts: Sequence[Stmt]) -> int:
    """Number of ``_ProducerConsumer`` statements anywhere in the tree."""
    from repro_torch.core.hir import If, Loop

    n = 0
    for s in stmts:
        if isinstance(s, _ProducerConsumer):
            n += 1
            n += count_fissioned([s.producer])
            n += count_fissioned(s.consumer_body)
        elif isinstance(s, Loop):
            n += count_fissioned(s.body)
        elif isinstance(s, If):
            n += count_fissioned(s.then_body) + count_fissioned(s.else_body)
    return n


class _RetryingExecute:
    """Service facade giving the interpreter's *blocking* query path the
    same bounded retry the runtime's lanes already have: consumer-side
    ``Query`` statements call ``runtime.execute`` which is a straight
    pass-through, so a transient chaos fault there would otherwise surface
    where the batched path would have retried and succeeded."""

    def __init__(self, runtime: AsyncQueryRuntime, attempts: int):
        self._runtime = runtime
        self._attempts = max(1, attempts)

    def execute(self, query_name: str, params: tuple):
        """Execute one query, retrying transient injected faults."""
        last: Optional[BaseException] = None
        for _ in range(self._attempts):
            try:
                return self._runtime.execute(query_name, params)
            except InjectedFault as e:  # transient by construction
                last = e
        raise last  # type: ignore[misc]

    def __getattr__(self, name):
        return getattr(self._runtime, name)


@dataclasses.dataclass
class TrialResult:
    """Outcome of one differential trial."""

    equivalent: bool
    fissioned: int                 # _ProducerConsumer count in transformed
    approved: int                  # analyze_applicability()["transformed"]
    sync_round_trips: int
    async_round_trips: int
    chaos: bool
    overlap: bool
    mismatches: list[str] = dataclasses.field(default_factory=list)

    @property
    def round_trip_win(self) -> bool:
        """Strictly fewer round trips than the synchronous oracle."""
        return self.async_round_trips < self.sync_round_trips

    def violations(self) -> list[str]:
        """Everything about this trial that breaks the harness contract."""
        out = list(self.mismatches)
        if (self.approved > 0) != (self.fissioned > 0):
            out.append(
                f"analysis/transformer drift: approved={self.approved} "
                f"but fissioned={self.fissioned}")
        if self.approved > 0 and not self.chaos and not self.round_trip_win:
            out.append(
                f"approved rewrite did not save round trips: sync="
                f"{self.sync_round_trips} async={self.async_round_trips}")
        return out


def _observe(env: Mapping[str, Any], names: Sequence[str]) -> dict[str, Any]:
    return {k: env.get(k, _UNSET) for k in names}


def check_program(
    prog: Program,
    inputs: Mapping[str, Any],
    observe: Optional[Sequence[str]] = None,
    *,
    overlap: bool = False,
    chaos_seed: Optional[int] = None,
    service: Optional[SimulatedDBService] = None,
    n_threads: int = 4,
    sites: Optional[Sequence[int]] = None,
) -> TrialResult:
    """Run one differential trial: synchronous oracle vs. transformed
    program on the async runtime, same backing service.

    ``chaos_seed`` wraps the transformed side's service in a
    :class:`ChaosService` injecting transient faults and latency spikes
    (the oracle keeps the raw service — its results define correctness).
    ``sites`` restricts fission to a site subset (the synthesis search).
    """
    svc = service if service is not None else make_service()
    names = tuple(observe) if observe is not None \
        else tuple(sorted(collect_names(prog.body) | set(prog.inputs)))

    sync_interp = Interpreter(svc)
    rt0 = int(svc.stats.round_trips)
    sync_env = sync_interp.run(prog, dict(inputs))
    rt1 = int(svc.stats.round_trips)

    analysis = analyze_applicability(prog)
    transformed = transform_program(prog, overlap=overlap, sites=sites)
    fissioned = count_fissioned(transformed.body)

    plan = None
    backing = svc
    resilience = None
    if chaos_seed is not None:
        # Transient-only faults: the runtime's bounded retry (default
        # max_attempts=3 > transient_repeats=2) plus batch fission-retry
        # must absorb every injected failure, leaving results bit-identical
        # to the raw-service oracle.  The breaker stays off so no trial
        # drifts into shed mode and changes the round-trip accounting shape.
        plan = ChaosPlan(seed=chaos_seed, transient_rate=0.06,
                         transient_repeats=2, latency_rate=0.05,
                         latency=2e-4)
        backing = ChaosService(svc, plan)
        resilience = Resilience(breaker_threshold=None)
    runtime = AsyncQueryRuntime(backing, n_threads=n_threads,
                                strategy=PureBatch(), resilience=resilience)
    facade = (_RetryingExecute(runtime, plan.transient_repeats + 1)
              if plan is not None else runtime)
    async_interp = Interpreter(facade)
    try:
        async_env = async_interp.run(transformed, dict(inputs))
    finally:
        runtime.drain()
        runtime.shutdown()
    rt2 = int(svc.stats.round_trips)

    mismatches: list[str] = []
    a, b = _observe(sync_env, names), _observe(async_env, names)
    for k in names:
        if a[k] != b[k]:
            mismatches.append(f"env[{k!r}]: sync={a[k]!r} async={b[k]!r}")
    if sync_interp.emitted != async_interp.emitted:
        mismatches.append(
            f"emissions differ: sync={sync_interp.emitted!r} "
            f"async={async_interp.emitted!r}")

    approved = analysis["transformed"] if sites is None else fissioned
    return TrialResult(
        equivalent=not mismatches,
        fissioned=fissioned,
        approved=approved,
        sync_round_trips=rt1 - rt0,
        async_round_trips=rt2 - rt1,
        chaos=chaos_seed is not None,
        overlap=overlap,
        mismatches=mismatches,
    )


@dataclasses.dataclass
class DifferentialReport:
    """Aggregate over a generated-program corpus."""

    n_programs: int = 0
    n_fissioned: int = 0
    n_chaos: int = 0
    n_overlap: int = 0
    n_round_trip_wins: int = 0
    violations: list[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        """True when the whole corpus satisfied the contract."""
        return not self.violations


def run_differential(
    seed: int = 0,
    n_programs: int = 50,
    *,
    chaos_every: int = 5,
    overlap_every: int = 3,
    max_violations: int = 10,
) -> DifferentialReport:
    """Generate ``n_programs`` random HIR programs (deterministic in
    ``seed``) and differential-check every one; every ``chaos_every``-th
    trial re-runs under chaos injection, every ``overlap_every``-th uses
    the §5.1 overlap variant.  Stops early after ``max_violations``."""
    # The generator lives with the tests (it is test infrastructure), the
    # checker with the core; tests put tests/ on sys.path, and so must any
    # other caller of this loop.
    from hir_strategies import gen_program

    rng = random.Random(seed)
    report = DifferentialReport()
    for i in range(n_programs):
        gp = gen_program(rng)
        chaos = chaos_every > 0 and (i % chaos_every == chaos_every - 1)
        overlap = (overlap_every > 0
                   and (i % overlap_every == overlap_every - 1))
        res = check_program(gp.program, gp.inputs, gp.observe,
                            overlap=overlap,
                            chaos_seed=(seed * 1000 + i) if chaos else None)
        report.n_programs += 1
        report.n_fissioned += 1 if res.fissioned else 0
        report.n_chaos += 1 if chaos else 0
        report.n_overlap += 1 if overlap else 0
        report.n_round_trip_wins += 1 if res.round_trip_win else 0
        for v in res.violations():
            report.violations.append(
                f"[seed={seed} program={i} chaos={chaos} overlap={overlap}] "
                f"{v}\n{gp.program!r}")
        if len(report.violations) >= max_violations:
            break
    return report


@dataclasses.dataclass
class SynthesisResult:
    """Outcome of the synthesis-lite search over fission-site subsets."""

    best_sites: tuple[int, ...]
    best_program: Program
    best_round_trips: int
    sync_round_trips: int
    n_candidates: int
    all_equivalent: bool


def synthesize_async(
    prog: Program,
    inputs: Mapping[str, Any],
    observe: Optional[Sequence[str]] = None,
    *,
    max_candidates: int = 16,
    overlap: bool = False,
) -> SynthesisResult:
    """Enumerate *which* loops to asynchronize, with equivalence as the
    filter: try subsets of the fissionable sites, differential-check each
    candidate, and keep the safe rewrite with the fewest round trips.

    The paper transforms everything it can prove safe; the synthesis view
    inverts that — propose, check, keep the best — which also makes the
    harness self-validating (an unsafe site subset would be caught by its
    own equivalence check, not by luck)."""
    ok_sites = [site for site, ok, _ in enumerate_fission_sites(
        prog, overlap=overlap) if ok]
    subsets: list[tuple[int, ...]] = [()]
    if 2 ** len(ok_sites) <= max_candidates:
        for site in ok_sites:
            subsets += [s + (site,) for s in list(subsets)]
        subsets = sorted(set(subsets), key=lambda s: (len(s), s))
    else:  # too many: empty, singletons, everything
        subsets += [(s,) for s in ok_sites] + [tuple(ok_sites)]

    best: Optional[tuple[tuple[int, ...], Program, int]] = None
    sync_rt = 0
    all_equivalent = True
    for sites in subsets:
        res = check_program(prog, inputs, observe, overlap=overlap,
                            sites=sites)
        sync_rt = res.sync_round_trips
        if not res.equivalent:
            all_equivalent = False
            continue
        cand = transform_program(prog, overlap=overlap, sites=sites)
        if best is None or res.async_round_trips < best[2]:
            best = (sites, cand, res.async_round_trips)
    assert best is not None  # the empty subset is always equivalent
    return SynthesisResult(
        best_sites=best[0],
        best_program=best[1],
        best_round_trips=best[2],
        sync_round_trips=sync_rt,
        n_candidates=len(subsets),
        all_equivalent=all_equivalent,
    )
