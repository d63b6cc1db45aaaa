"""Faults planted underneath the timed path, each of which the cell's check
has to catch: the CPU tests plant them at a tiny size, and this script
reads them on the card at a cell's own size, sample and limits.

Each fault is ``plant(setattr)``, with ``setattr`` as Python's or as
pytest's ``monkeypatch.setattr``:

* ``altered_token``: every decode tick's token is the next one in the
  vocabulary;
* ``state_unchanged``: a decode tick leaves the page pool as it was, its
  key and value rows written to the trash page instead of the lanes' own
  pages (nothing is copied, so it runs at any size);
* ``half_batch``: the second half of every prefill batch is replaced by
  its first row;
* ``misdelivered``: a cohort's answers reach its queries rotated by one.

For each seed, one JSON line: the result line's ``correct`` and ``checks``
and the run's counters.  The benchmark's own runs never plant a fault:

    python3 portbench/faults.py --workload dsmoe-chat --fault state_unchanged --seconds 45 --seeds 11,12,13
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

__all__ = ["FAULTS"]


def altered_token(setattr) -> None:
    import repro_torch.serving.paged_kv as pk
    inner = pk.sample_tokens

    def sample(logits, *a):
        return (inner(logits, *a) + 1) % logits.shape[-1]
    setattr(pk, "sample_tokens", sample)


def state_unchanged(setattr) -> None:
    import repro_torch.models.paged_decode as pd
    inner = pd._write_slots

    def write_slots(block_tables, lengths, active, n_phys: int, ps: int):
        phys, off, att_len = inner(block_tables, lengths, active, n_phys, ps)
        return phys.new_full(phys.shape, n_phys - 1), off, att_len
    setattr(pd, "_write_slots", write_slots)


def half_batch(setattr) -> None:
    import repro_torch.models.transformer as tf
    inner = tf.prefill

    def prefill(cfg, params, tokens, *a, **k):
        half = (tokens.shape[0] + 1) // 2
        tokens = tokens.clone()
        tokens[half:] = tokens[:1]
        return inner(cfg, params, tokens, *a, **k)
    setattr(tf, "prefill", prefill)


def misdelivered(setattr) -> None:
    from repro_torch.serving.hir_bridge import SchedulerQueryService
    inner = SchedulerQueryService.execute_batch

    def execute_batch(self, query_name, params_list):
        out = inner(self, query_name, params_list)
        return out[1:] + out[:1]
    setattr(SchedulerQueryService, "execute_batch", execute_batch)


FAULTS = {"altered_token": altered_token, "state_unchanged": state_unchanged,
          "half_batch": half_batch, "misdelivered": misdelivered}


def main(argv=None) -> int:
    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    harness.prepare_env()
    import torch
    if not torch.cuda.is_available():
        print("faults: no CUDA device", file=sys.stderr)
        return 3
    FAULTS[args.fault](setattr)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(bench, args.workload, seed, args.seconds, False, "cuda:0")
        t = time.perf_counter()
        result = harness.run_cell(run, t)
        line = harness.result_line(run, result, torch.cuda.get_device_name(0))
        print(json.dumps({"fault": args.fault, "workload": args.workload, "seed": seed,
                          "correct": line["correct"], "checks": line["checks"],
                          **run.counters, "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
