"""End-to-end serving driver — §5.2 as continuous batching.

The port's twin of the JAX package's ``examples/serve_continuous_batching.py``:
the same demos, names and traffic over the port's engines.  Serves a
reduced llama3-family model with batched requests arriving over time;
compares the paper's admission strategies on time-to-first-token and
total throughput.  Run:

    python -m repro_torch.examples.serve_continuous_batching [--device cpu]

Every engine dispatch is a compiled step (:mod:`repro_torch.serving.graphs`):
on the card its first call runs for real and records a CUDA graph that
later calls replay, so the reference's "warm the jit caches" drive records
the graphs here.  ``main``'s two first parts are :func:`compare_strategies`
and :func:`mixed_lanes_demo`, so that they can be driven on any model.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.lane_policy import LanePolicy
from repro_torch.core.strategies import GrowingUpperThreshold, OneOrAll, PureAsync
from repro_torch.models.registry import get_arch
from repro_torch.serving.engine import HostSpillPool, InferenceEngine, proportional_shares
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

__all__ = ["overlap_kv_demo", "depth_spill_demo", "compare_strategies",
           "mixed_lanes_demo", "main"]


def overlap_kv_demo(arch, params, n_requests: int = 16, verbose: bool = True,
                    device: str = "cuda"):
    """Speculative prefill + per-template KV partitioning, end to end.

    LanePolicy ``lane_weights`` say which templates matter; the same
    weights derive the engine's ``kv_shares`` (proportional lane
    reservations), so a chat burst can never evict the summarize lanes.
    ``overlap=True`` dispatches the next lane's prefill on a side thread
    while the current decode tick runs, committing the staged KV at the
    next tick boundary.  Returns the finished requests + scheduler stats.
    """
    rng = np.random.default_rng(7)
    weights = {"chat": 2.0, "summarize": 1.0}
    shares = proportional_shares(weights, n_lanes=8, reserve=0.5)
    eng = InferenceEngine(arch, params, n_lanes=8, max_prompt_len=16,
                          max_len=48, kv_shares=shares, device=device)
    policy = LanePolicy(hot_threshold=10**9, lane_weights=weights)
    sched = ContinuousBatchingScheduler(eng, policy=policy, overlap=True)
    for i in range(n_requests):
        tmpl = "chat" if i % 2 == 0 else "summarize"
        size = 5 if tmpl == "chat" else 14
        sched.submit(Request(rid=200 + i,
                             prompt=rng.integers(1, 200, size=size).astype(np.int32),
                             max_new_tokens=8, template=tmpl))
    sched.producer_done()
    done = sched.run_until_drained()
    st = sched.stats
    if verbose:
        print(f"  kv_shares {shares} (from lane_weights {weights})")
        spec = sum(1 for r in done if r.metrics.speculative)
        print(f"  {len(done)} finished | spec prefills: "
              f"{st.spec_dispatched} dispatched, {st.spec_committed} "
              f"committed, {st.spec_aborted} aborted | "
              f"{spec} requests rode the overlapped path")
        for tmpl, trace in st.lane_admissions.items():
            sizes = [n for _, n in trace]
            print(f"  lane {tmpl:10s} admissions {sizes}")
    return done, st


def depth_spill_demo(arch, params, n_requests: int = 12, verbose: bool = True,
                     device: str = "cuda"):
    """Depth-k speculation + chunked prefill + host KV spill, end to end.

    ``spec_depth=2`` keeps two speculative prefills in flight;
    ``chunk_tokens=8`` folds one oversized prompt in chunk-per-tick
    (bit-identical to the one-shot prefill); ``kv_spill`` stages evicted
    straggler KV to a host LRU whose per-template budgets come from the
    policy (``spill_budget_for``), so a re-admitted straggler RESUMES
    instead of restarting.  Returns finished requests + scheduler stats.
    """
    rng = np.random.default_rng(11)
    policy = LanePolicy(hot_threshold=10**9, spill_budget=4,
                        spill_budgets={"bulk": 0})
    pool = HostSpillPool(max_entries=8, budget_for=policy.spill_budget_for)
    eng = InferenceEngine(arch, params, n_lanes=4, max_prompt_len=16,
                          max_len=48, kv_spill=pool, device=device)
    sched = ContinuousBatchingScheduler(eng, policy=policy, overlap=True,
                                        spec_depth=2, chunk_tokens=8,
                                        lane_timeout=6)
    # one oversized prompt (chunked), the rest short chat traffic; long
    # generations make a straggler eviction (and spill/restore) likely
    sched.submit(Request(rid=300,
                         prompt=rng.integers(1, 200, size=15).astype(np.int32),
                         max_new_tokens=4, template="doc"))
    for i in range(1, n_requests):
        sched.submit(Request(rid=300 + i,
                             prompt=rng.integers(1, 200, size=5).astype(np.int32),
                             max_new_tokens=10, template="chat"))
    sched.producer_done()
    done = sched.run_until_drained()
    st = sched.stats
    if verbose:
        print(f"  {len(done)} finished | spec: {st.spec_dispatched} "
              f"dispatched / {st.spec_committed} committed / "
              f"{st.spec_aborted} aborted | {st.spec_chunks} prefill "
              f"chunks | kv spilled {st.kv_spilled} restored "
              f"{st.kv_restored} (pool {pool.snapshot()})")
    return done, st


STRATEGIES = (
    ("one-at-a-time (async)", PureAsync),
    ("one-or-all", OneOrAll),
    ("growing-upper (paper best)", lambda: GrowingUpperThreshold(initial_upper=2, bt=None)),
)


def compare_strategies(arch, params, rng, verbose: bool = True, device: str = "cuda"):
    """``main``'s first part: the three admission strategies, each on a
    fresh engine warmed by one drive (on the card: each step's first call
    runs and records its graph), then timed on 24 requests drawn from
    ``rng``.  Returns ``{name: (finished requests, engine, wall s)}``."""
    def mk_requests(n=24):
        return [Request(rid=i,
                        prompt=rng.integers(1, 200, size=int(rng.integers(4, 12))).astype(np.int32),
                        max_new_tokens=12) for i in range(n)]

    out = {}
    for name, make in STRATEGIES:
        strat = make()
        eng = InferenceEngine(arch, params, n_lanes=8, max_prompt_len=16, max_len=48,
                              device=device)
        # warm the compiled steps so strategies are compared at steady state
        warm = ContinuousBatchingScheduler(eng, strategy=strat)
        for r in mk_requests(12):
            warm.submit(r)
        warm.producer_done()
        warm.run_until_drained()
        eng.decode_steps = eng.prefill_calls = 0
        sched = ContinuousBatchingScheduler(eng, strategy=strat)
        reqs = mk_requests()
        t0 = time.perf_counter()
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        done = sched.run_until_drained()
        dt = time.perf_counter() - t0
        out[name] = (done, eng, dt)
        if verbose:
            ttfts = sorted(r.metrics.ttft for r in done)
            toks = sum(len(r.generated) for r in done)
            print(f"{name:28s} total {dt*1e3:7.0f} ms | {toks/dt:7.1f} tok/s | "
                  f"ttft p50 {ttfts[len(ttfts)//2]*1e3:6.0f} ms | "
                  f"decode steps {eng.decode_steps:3d} | prefills {eng.prefill_calls}")
    return out


def mixed_lanes_demo(arch, params, rng, verbose: bool = True, device: str = "cuda"):
    """``main``'s lane demo: two request classes (templates) interleaved.
    The scheduler shards pending requests into one lane per template, so
    each prefill batch is homogeneous (chat prompts bucket at 8 wide,
    summarize prompts at 16) instead of head-of-line blocking.  Returns
    (finished requests, scheduler, engine)."""
    eng = InferenceEngine(arch, params, n_lanes=8, max_prompt_len=16, max_len=48,
                          device=device)
    sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(
        initial_upper=2, bt=None))
    for i in range(16):
        tmpl = "chat" if i % 2 == 0 else "summarize"
        size = 5 if tmpl == "chat" else 14
        sched.submit(Request(rid=100 + i,
                             prompt=rng.integers(1, 200, size=size).astype(np.int32),
                             max_new_tokens=8, template=tmpl))
    sched.producer_done()
    done = sched.run_until_drained()
    assert len(done) == 16
    if verbose:
        for tmpl, trace in sched.stats.lane_admissions.items():
            sizes = [n for _, n in trace]
            print(f"  lane {tmpl:10s} admissions {sizes} "
                  f"(mean batch {sum(sizes)/len(sizes):.1f})")
    return done, sched, eng


def main(device: str = "cuda"):
    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    params = arch.init(seed=0, device=device)
    rng = np.random.default_rng(0)

    runs = compare_strategies(arch, params, rng, device=device)
    done = runs[STRATEGIES[-1][0]][0]
    r0 = done[0]
    print("\nsample generation (request 0):", r0.generated)

    # ----------------------------------------------------------- lane demo
    print("\nmixed-template lanes (chat ~5-tok prompts vs summarize ~14-tok):")
    mixed_lanes_demo(arch, params, rng, device=device)

    # -------------------------------------------- overlap + KV shares demo
    # Speculative prefill under decode + per-template lane reservations:
    # the serving-side version of "results already fetched by the time
    # they are consumed" (see docs/ARCHITECTURE.md for the timeline).
    print("\noverlapped serving (speculative prefill + kv_shares):")
    overlap_kv_demo(arch, params, device=device)

    # ------------------------------- depth-k + chunked prefill + KV spill
    # Two staged bets in flight, oversized prompts folded chunk-per-tick,
    # straggler KV staged to host memory and resumed on re-admission.
    print("\ndepth-2 pipeline + chunked prefill + host KV spill:")
    depth_spill_demo(arch, params, device=device)


if __name__ == "__main__":
    from repro_torch.examples import device_from_argv

    main(device=device_from_argv(__doc__))
