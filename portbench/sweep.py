"""Find the knee of an open-loop cell once: its mix offered at several
fixed rates, one window each, over one engine set up once.  For each rate,
one JSON line: requests offered and finished per second, the backlog
(requests due and not yet given a first token) at the middle and the end
of the window, and the TTFT and TPOT tails.  The knee is the highest rate
whose backlog does not grow over the window; the cell then offers four
fifths of it.

    python3 portbench/sweep.py --workload dsmoe-chat --seconds 30 --rates 3,4,5,6
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def backlog(requests, t: float) -> int:
    return sum(1 for tr in requests if tr.due <= t and (tr.first is None or tr.first > t))


def main(argv=None) -> int:
    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.prepare_env()
    from portbench.layouts import make_params
    from portbench.serving import Tracker
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    run = harness.Run(bench, args.workload, args.seed, args.seconds, False, "cuda:0")
    traffic = harness.load_module(harness.HERE / "traffic" / "open_loop.py", "sweep_open_loop")
    driver = traffic.Driver(run, make_params(run))
    driver.warmup()
    for rate in (float(r) for r in args.rates.split(",")):
        run.cell["traffic"]["rate"] = rate
        driver.plan = traffic.plan(run.cell["traffic"], run.seed, args.seconds,
                                   run.model["vocab_size"])
        driver.tracker = Tracker(run, driver.sched)
        run.tokens.clear()
        driver.window(args.seconds)
        t0, t1 = run.t0, run.t1
        reqs = list(driver.tracker.all)
        end = time.perf_counter() + 120
        while driver.tracker.live and time.perf_counter() < end:
            driver.tracker.tick()
        out = {"rate": rate, "offered_per_s": len(reqs) / (t1 - t0),
               "finished_per_s": sum(1 for tr in reqs if tr.done is not None and tr.done <= t1)
               / (t1 - t0),
               "backlog_mid": backlog(reqs, t0 + 0.5 * (t1 - t0)), "backlog_end": backlog(reqs, t1)}
        for name in ("ttft_p95_ms", "tpot_p95_ms", "output_tokens_per_s"):
            run.requests = reqs
            out[name] = harness.metric_reader(name)(run)
        print(json.dumps(out), flush=True)
    driver.quiesce()
    return 0


if __name__ == "__main__":
    sys.exit(main())
