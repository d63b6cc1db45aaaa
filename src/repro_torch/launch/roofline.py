"""Roofline report generator: reads results/dryrun.json, emits the markdown
table for EXPERIMENTS.md §Roofline and ranks hillclimb candidates.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single] [--md]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun.json"
RESULTS = RESULTS.with_name("dryrun_torch.json")  # the port's dry run writes its own


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    for unit, f in (("s", 1.0), ("ms", 1e-3), ("µs", 1e-6), ("ns", 1e-9)):
        if x >= f:
            return f"{x/f:.2f}{unit}"
    return f"{x:.1e}s"


def rows(res: dict, mesh: str, with_opts: bool = False):
    for key, v in sorted(res.items()):
        parts = key.split("|")
        if len(parts) == 3:
            a, s, m = parts
            if with_opts:
                continue  # optimized-rows view
        elif len(parts) == 4:
            if not with_opts:
                continue  # baseline view skips optimized variants
            a, s, m = parts[0], parts[1] + f" [{parts[3]}]", parts[2]
        else:
            continue
        if m != mesh or "error" in v or "skipped" in v:
            continue
        tc, tm, tl = v["t_compute_s"], v["t_memory_s"], v["t_collective_s"]
        dom = v["dominant"]
        tdom = max(tc, tm, tl)
        frac = tc / tdom if tdom else 0.0
        yield {
            "arch": a, "shape": s, "key": key,
            "tc": tc, "tm": tm, "tl": tl, "dom": dom,
            "roofline_frac": frac,
            "useful": v.get("useful_flops_ratio"),
            "fit": v.get("hbm_fit"),
            "live_gib": (v.get("live_bytes") or 0) / 2**30,
            "coll_count": v["collectives"]["total_count"],
        }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--opts", action="store_true",
                    help="show the optimized (--opt) variants instead")
    ap.add_argument("--json", default=str(RESULTS))
    args = ap.parse_args()
    res = json.loads(Path(args.json).read_text())

    table = list(rows(res, args.mesh, with_opts=args.opts))
    if not table:
        print("(no rows)")
        return
    if args.md:
        print("| arch | shape | t_compute | t_memory | t_collective | dominant "
              "| compute/dominant | useful/HLO flops | HBM fit (live GiB) |")
        print("|---|---|---|---|---|---|---|---|---|")
    else:
        print(f"{'arch':22s} {'shape':12s} {'t_comp':>9s} {'t_mem':>9s} "
              f"{'t_coll':>9s} {'dom':>10s} {'frac':>6s} {'useful':>7s} fit")
    for r in table:
        useful = f"{r['useful']:.2f}" if r["useful"] else "-"
        if args.md:
            fit = ("yes" if r["fit"] else "**NO**") + f" ({r['live_gib']:.1f})"
            print(f"| {r['arch']} | {r['shape']} | {fmt_s(r['tc'])} | "
                  f"{fmt_s(r['tm'])} | {fmt_s(r['tl'])} | {r['dom']} | "
                  f"{r['roofline_frac']:.3f} | {useful} | {fit} |")
        else:
            print(f"{r['arch']:22s} {r['shape']:12s} {fmt_s(r['tc']):>9s} "
                  f"{fmt_s(r['tm']):>9s} {fmt_s(r['tl']):>9s} {r['dom']:>10s} "
                  f"{r['roofline_frac']:6.3f} {useful:>7s} "
                  f"{'ok' if r['fit'] else 'NO'}({r['live_gib']:.0f}G)")

    print("\n# hillclimb candidates")
    worst = min(table, key=lambda r: r["roofline_frac"])
    coll = max(table, key=lambda r: r["tl"] / max(r["tc"], 1e-12))
    print(f"worst roofline fraction : {worst['key']} frac={worst['roofline_frac']:.4f}")
    print(f"most collective-bound   : {coll['key']} t_coll/t_comp="
          f"{coll['tl']/max(coll['tc'],1e-12):.1f}")


if __name__ == "__main__":
    main()
