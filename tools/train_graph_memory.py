"""The compiled train step's memory on one card: ``train-ssm`` with and
without emptying the allocator's cache before the recording.

    python3 tools/train_graph_memory.py [--steps 3]

Runs ``chip_smoke.py``'s ``train-ssm`` (``repro_torch.launch.train`` on
mamba2-1.3b at full width, 8 x 2048, int8 moments, ``donate=False``, no
checkpoints) for ``--steps`` steps three times, each in a process of its
own: under ``graphs.eager()``; compiled, the allocator's cache emptied
before the recording (``release``); compiled without it.  A compiled run
wraps ``CompiledStep._record`` to read the memory reserved just before
and just after the recording.  Prints per run the step walls, the peak
memory allocated and reserved, the train graph pool's bytes and those
two readings, and the card's name and power limit.  Needs one CUDA card;
every number it prints is that card's.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
MODES = ("eager", "release", "keep")


def _run(mode: str, steps: int) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    import torch
    from repro_torch.launch import train as train_mod
    from repro_torch.serving import graphs

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs.phase_build()
    readings, real = {}, graphs.CompiledStep._record

    def record(self):
        self.release = False  # this tool empties the cache itself, or not
        if mode == "release":
            torch.cuda.empty_cache()
        readings["before"] = torch.cuda.memory_reserved()
        real(self)
        readings["after"] = torch.cuda.memory_reserved()

    counter = cs._StepLaunches()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_mod, "make_train_step", counter(train_mod.make_train_step)), \
            mock.patch.object(graphs.CompiledStep, "_record", record), \
            (graphs.eager() if mode == "eager" else contextlib.nullcontext()):
        out = train_mod.main(cs.TRAIN_SSM + ["--steps", str(steps)])
        record_ = counter.take()
    torch.cuda.synchronize()
    walls = [t1 - t0 for t0, t1 in out["walls"]]
    print(f"[memory] train-ssm {mode}: step walls {walls} s, replays a step "
          f"{record_['replays']}, losses {out['losses']}; peak allocated "
          f"{torch.cuda.max_memory_allocated()} bytes, peak reserved "
          f"{torch.cuda.max_memory_reserved()} bytes; train graph pool {record_['pool']} "
          f"bytes; reserved just before the recording {readings.get('before')} bytes, "
          f"just after {readings.get('after')} bytes", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mode", choices=MODES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mode:
        _run(args.mode, args.steps)
        return 0
    rc = 0
    for mode in MODES:
        out = subprocess.run([sys.executable, __file__, "--mode", mode, "--steps",
                              str(args.steps)], capture_output=True, text=True)
        print("\n".join(line for line in out.stdout.splitlines()
                        if line.startswith("[memory]")), flush=True)
        if out.returncode:
            print(f"{mode}: exit {out.returncode}\n{out.stderr[-2000:]}", flush=True)
            rc = 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
