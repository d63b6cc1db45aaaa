"""Two trees of the PyTorch port on one card: greedy streams at depth k.

    python3 tools/depth_streams_ab.py --parent DIR [--drives 8]

``DIR`` holds another tree of this repository (for example ``git archive
<commit> | tar -x -C DIR``).  Runs the parent, this tree, this tree and the
parent again, each in a process of its own, and in each: reduced
llama3-8b in float32 (seed 0, TF32 off) served by the paged and the dense
engine at ``spec_depth`` 1 and 4 (``overlap=True``, ``chunk_tokens`` 8,
``PureAsync``, 24 single-request bets over 4 templates, three of them
chunked), ``--drives`` times each, and counts the drives whose greedy
streams differ from the first drive of the same engine.  Every drive of
one tree serves the same prompts from the same weights, so a tree that
keeps its streams apart counts 0.  Then, on the dense engine, one prompt
of 12 tokens prefilled in the buckets (1, 16), (2, 16), (4, 16), (1, 32)
and (2, 32): whether its KV rows equal those of (1, 16) bit for bit, and
the largest difference.  Prints the card's name and power limit.  Needs
one CUDA card; every number it prints is that card's.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = ((1, 16), (2, 16), (4, 16), (1, 32), (2, 32))


def _engine(arch, params, paged: bool):
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paged_kv import PagedInferenceEngine

    kw = dict(n_lanes=4, max_prompt_len=16, max_len=48, device="cuda")
    if paged:
        return PagedInferenceEngine(arch, params, page_size=8, **kw)
    return InferenceEngine(arch, params, **kw)


def _streams(arch, params, depth: int, paged: bool) -> dict:
    from repro_torch.core.strategies import PureAsync
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(_engine(arch, params, paged), strategy=PureAsync(),
                                        overlap=True, spec_depth=depth, chunk_tokens=8)
    rng = np.random.default_rng(2)
    lens = [int(n) for n in rng.integers(4, 17, size=21)] + [23, 27, 30]
    reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=n).astype(np.int32),
                    max_new_tokens=int(rng.integers(2, 12)), template=f"t{i % 4}")
            for i, n in enumerate(lens)]
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    return {r.rid: list(r.generated) for r in reqs}


def _buckets(arch, params) -> list:
    """(bucket, KV rows equal to (1, 16)'s, largest difference) of one
    12-token prompt prefilled alone in each bucket of ``BUCKETS``."""
    import torch
    eng = _engine(arch, params, False)
    prompt = np.random.default_rng(3).integers(1, 256, size=12).astype(np.int32)
    rows = {}
    for bsz, plen in BUCKETS:
        toks = np.zeros((bsz, plen), np.int32)
        toks[0, :12] = prompt
        plens = np.ones((bsz,), np.int32)
        plens[0] = 12
        with eng._side():
            _first, cache = eng._prefill_step(toks, plens)
        torch.cuda.synchronize()
        rows[(bsz, plen)] = cache["layers"]["k"][:, 0, :12].float().cpu()
    base = rows[BUCKETS[0]]
    return [(b, torch.equal(k, base), float((k - base).abs().max())) for b, k in rows.items()]


def _run(tree: str, tag: str, drives: int) -> None:
    sys.path.insert(0, tree + "/src")
    import torch
    from repro_torch.models.registry import get_arch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())

    def to_card(tree_):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda() for k, v in tree_.items()}

    params = to_card(arch.init(seed=0, device="cpu"))
    first, differ, runs = {}, 0, 0
    t0 = time.perf_counter()
    for _ in range(drives):
        for paged in (False, True):
            for depth in (1, 4):
                got = _streams(arch, params, depth, paged)
                differ += got != first.setdefault(paged, got)
                runs += 1
    print(f"[ab] {tag}: {differ} of {runs} drives' greedy streams differ from the first "
          f"drive of their engine ({time.perf_counter() - t0:.1f} s); one prompt's KV rows "
          f"by bucket against (1, 16) (equal, largest difference): {_buckets(arch, params)}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other tree")
    ap.add_argument("--drives", type=int, default=8)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tree:
        _run(args.tree, args.tag, args.drives)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    rc = 0
    for tag, tree in (("parent", args.parent), ("change", str(ROOT)), ("change", str(ROOT)),
                      ("parent", args.parent)):
        out = subprocess.run([sys.executable, __file__, "--tree", str(Path(tree).resolve()),
                              "--tag", tag, "--drives", str(args.drives)],
                             capture_output=True, text=True)
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
