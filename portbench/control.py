"""The control of a cell's correctness check, read on the chip.

For each seed, one run of the cell as the benchmark makes it (set-up, a
window of ``--seconds``, the sample of served requests), then over the same
sample both readings: the program's logit gaps against the plain
float32 reference, and the control's, the reference with every bf16
matrix rounded to float8 e4m3 (one scale per output channel), read for the
token the control puts first: the mean gap, the widest and the share of
positions off the reference's first token.  One JSON line per seed, with
two result lines' ``correct`` and ``checks``: the program's, and the
control's, which is the same line with the control's mean gap in the
program's place, held to the same limit.  The benchmark's own runs never
run this; the cell's ``mean_logit_gap_limit`` is set from it:

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds 11,12,13
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def read(run) -> tuple[dict, dict]:
    """One run of the cell with the control read beside the program → the
    program's result line and the control's."""
    import torch
    from portbench import harness
    from portbench.reference.common import fp8_round
    result = harness.run_cell(run, time.perf_counter(), cast=fp8_round)
    kind = (torch.cuda.get_device_name(0) if torch.device(run.device).type == "cuda"
            else "cpu")
    program = harness.result_line(run, result, kind)
    gap = dict(result["checks"]["mean_logit_gap"], value=run.counters["control_mean_gap"])
    control = harness.result_line(
        run, dict(result, checks=dict(result["checks"], mean_logit_gap=gap)), kind)
    return program, control


def main(argv=None) -> int:
    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    harness.prepare_env()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(bench, args.workload, seed, args.seconds, False, "cuda:0")
        t = time.perf_counter()
        program, control = read(run)
        print(json.dumps({"seed": seed,
                          "program": {k: program[k] for k in ("correct", "checks")},
                          "control": {k: control[k] for k in ("correct", "checks")},
                          **run.counters, "metrics": program["metrics"],
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
