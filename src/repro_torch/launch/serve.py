"""Serving launcher: continuous batching with the paper's strategies.

Port of :mod:`repro.launch.serve`: the same flags, strategies, engine
(``InferenceEngine``, 16-token prompts, 64-token lanes), traffic and
printout, plus ``--device`` (default ``cuda``; there is no CPU fallback)
and a first line with the config's parameter counts::

    python -m repro_torch.launch.serve --arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --reduced --device cpu --requests 32 --strategy growing_upper

Weights are random, drawn from seed 0 on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core.strategies import from_name
from repro_torch.models.registry import get_arch
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--strategy", default="growing_upper",
                    choices=["async", "one_or_all", "lower_threshold", "growing_upper"])
    ap.add_argument("--lane-timeout", type=int, default=None,
                    help="decode ticks before a lane is declared a straggler")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and its KV live on")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    params = arch.init(seed=0, device=args.device)
    print(f"{arch.cfg.name}: {arch.cfg.param_count()} parameters, "
          f"{arch.cfg.active_param_count()} active per token, on {args.device}")
    kw = {"initial_upper": 2} if args.strategy == "growing_upper" else {}
    eng = InferenceEngine(arch, params, n_lanes=args.lanes,
                          max_prompt_len=16, max_len=64, device=args.device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=from_name(args.strategy, **kw), lane_timeout=args.lane_timeout)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        sched.submit(Request(
            rid=i, prompt=rng.integers(1, 200, size=int(rng.integers(4, 14))).astype(np.int32),
            max_new_tokens=args.max_new))
    sched.producer_done()
    done = sched.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    ttfts = sorted(r.metrics.ttft for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s)")
    print(f"ttft p50/p95: {ttfts[len(ttfts)//2]*1e3:.0f}/"
          f"{ttfts[int(len(ttfts)*0.95)]*1e3:.0f} ms; "
          f"admission trace: {sched.stats.admission_trace[:10]}...")


if __name__ == "__main__":
    main()
