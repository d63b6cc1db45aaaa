"""Two trees of the PyTorch port on one card: the llama3-8b main path.

    python3 tools/ab_torch_main_path.py --parent DIR

``DIR`` holds another tree of this repository (for example ``git archive
<commit> | tar -x -C DIR``).  Runs the parent, this tree, this tree and the
parent again, each in a process of its own, and in each: after
``chip_smoke.py``'s warm-up, phase 4a's traffic (16 requests of 32 new
tokens, ``chip_smoke._drive``) on a fresh paged engine three times, each
engine's construction timed apart, then one engine serving the same
traffic three times in a row (a new scheduler each time).  Prints every wall, in seconds
for the 512 tokens, the medians of the fresh engines' drives, of their
construction and drive together, and of the one engine's second and
third drives (a warmed engine), and the card's name and power limit.  Needs one CUDA
card; every number it prints is that card's.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _walls(tree: str, tag: str) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(0, tree + "/src")
    import chip_smoke as cs
    import torch
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.models.registry import get_arch
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs.phase_build()
    arch = get_arch("llama3-8b")
    params = arch.init(seed=0, device="cuda")
    cs._warm(arch, params)
    def engine():
        t0 = time.perf_counter()
        eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256, max_len=512,
                                   page_size=16)
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    def drive(eng, label):
        sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2))
        cs._drive(label, eng, sched, cs._requests(Request, arch.cfg.vocab_size), "cuda")
        return cs.RUNS[label]["wall"]

    walls = {"build": [], "fresh": [], "same": []}
    for i in range(3):
        eng, built = engine()
        walls["build"].append(built)
        walls["fresh"].append(drive(eng, f"{tag}-fresh{i}"))
        del eng
    eng, _built = engine()
    for i in range(3):
        walls["same"].append(drive(eng, f"{tag}-same{i}"))
    torch.cuda.synchronize()
    med = statistics.median
    print(f"[ab] {tag}: main path walls (512 tokens), fresh engines {walls['fresh']} (built "
          f"in {walls['build']}), one engine {walls['same']}; medians: fresh "
          f"{med(walls['fresh'])!r} s, built and driven "
          f"{med(b + f for b, f in zip(walls['build'], walls['fresh']))!r} s, the one "
          f"engine's second and third drives {med(walls['same'][1:])!r} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other tree")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tree:
        _walls(args.tree, args.tag)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    rc = 0
    for tag, tree in (("parent", args.parent), ("change", str(ROOT)), ("change", str(ROOT)),
                      ("parent", args.parent)):
        out = subprocess.run([sys.executable, __file__, "--tree", str(Path(tree).resolve()),
                              "--tag", tag], capture_output=True, text=True)
        print("\n".join(line for line in out.stdout.splitlines() if line.startswith("[ab]")),
              flush=True)
        if out.returncode:
            print(f"{tag}: exit {out.returncode}\n{out.stderr[-2000:]}", flush=True)
            rc = 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
