"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one configuration, traffic kind, cell or metric
is found by its name: ``configs/<config>.json``, ``cells/<cell>.json``,
``traffic/<kind>.py`` (the generator that a cell's ``traffic.kind`` names;
the mix is the cell's ``traffic``, and ``BENCHMARK.json`` names it by
``traffic.name``, or by its kind where it has no name, so that two cells of
one configuration on one generator are two mixes), ``metrics/<metric>.py`` (or, for a metric named
``<base>.<cell>``, ``metrics/<base>.py``), ``reference/<config>.py`` and,
where a configuration brings its own weights or FLOP count,
``layouts/<config>.py`` (``-`` and ``.`` as ``_``; ``layouts/__init__.py``).
``BENCHMARK.json`` says which metrics a cell reports.

A traced run switches the port's own tracer (``repro_torch.tracing``) on
over the traced part of its window: its spans are ``Run.program_spans``,
and all but the waits that start on one thread and end on another join
the benchmark's own spans, which name the breakdown's kernels and gaps.

The program under test is the port, ``repro_torch`` under ``src/``; nothing
here imports JAX or the JAX package, and a run that finds either loaded
once its window has closed prints no result.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["Run", "forbidden_modules", "load_module", "metric_reader", "port_tracer",
           "run_cell", "main"]

# The port's spans that are waits across threads (a query's time in its
# runtime lane, a drive's wait for the bridge's lock, a prefill's for its
# steps' hold): read from ``Run.program_spans``, kept out of the labels.
UNLABELLED = ("runtime.queued", "bridge.lock_wait", "prefill.hold")


def forbidden_modules(names=None) -> list[str]:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that are JAX or the JAX package."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def port_tracer():
    """The port's ``repro_torch.tracing``, or ``None`` where the program
    has no tracer."""
    try:
        return importlib.import_module("repro_torch.tracing")
    except ImportError:
        return None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, metrics_dir: Path = HERE / "metrics"):
    """The ``read(run)`` of ``metrics/<name>.py``, or of
    ``metrics/<base>.py`` for a name ``<base>.<suffix>``."""
    for stem in (name, name.split(".")[0]):
        path = metrics_dir / f"{stem}.py"
        if path.exists():
            return load_module(path, f"portbench_metric_{stem.replace('.', '_')}").read
    raise FileNotFoundError(f"no reader for metric {name!r} in {metrics_dir}")


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def process_start() -> float:
    """The ``time.perf_counter`` reading at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def traffic_name(cell: dict) -> str:
    """The name of a cell's traffic mix, as ``BENCHMARK.json`` gives it."""
    return cell["traffic"].get("name", cell["traffic"]["kind"])


class Run:
    """Everything one run records; the metric readers read it."""

    def __init__(self, bench: dict, cell_name: str, seed: int, seconds: float,
                 trace: bool, device, model_override: Optional[dict] = None,
                 root: Path = HERE):
        entry = next((w for w in bench["workloads"] if w["name"] == cell_name), None)
        if entry is None:
            raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
        self.bench = bench
        self.name = cell_name
        self.cell = load_json(root / "cells" / f"{cell_name}.json")
        if (self.cell["config"], traffic_name(self.cell)) != (entry["config"],
                                                              entry["traffic"]):
            raise ValueError(f"cells/{cell_name}.json disagrees with BENCHMARK.json")
        self.config = load_json(root / "configs" / f"{entry['config']}.json")
        self.model = dict(self.config["model"], **(model_override or {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.root = root
        from portbench.spans import Spans
        self.spans = Spans()
        self.tokens: list[tuple[float, int]] = []   # (seen at, tokens) after each tick
        self.requests: list = []                    # serving.Tracked of the window
        self.queries: list[float] = []              # an application query returned
        self.counters: dict = {}
        self.t0 = self.t1 = None
        self.setup_s: Optional[float] = None
        self.device_trace = None
        self.program_spans: Optional[list] = None   # the port's, on a traced run
        self.attempted = 0
        self.failed = 0
        self.driver = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def arch(self):
        import dataclasses
        from repro_torch.models.config import ModelConfig
        from repro_torch.models.registry import Arch
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        return Arch(cfg=ModelConfig(**{k: v for k, v in self.model.items() if k in fields}))

    def layer_window(self) -> tuple[float, float]:
        """Where per-layer metrics are read: the traced part of a traced
        run's window, else the whole window."""
        tr = self.device_trace
        if tr is not None and tr.t1 is not None:
            return tr.t0, tr.t1
        return self.t0, self.t1

    def program_named(self, name: str) -> Optional[list]:
        """The port's spans of ``name`` that start and end inside
        :meth:`layer_window`, by start, as :meth:`Spans.named` takes the
        benchmark's own (what runs on after the window is stretched by the
        trace's reading and the wind-down); ``None`` where the port's
        tracer was not on."""
        if self.program_spans is None:
            return None
        lo, hi = self.layer_window()
        return [s for s in self.program_spans if s.name == name and lo <= s.start and s.end <= hi]


def run_cell(run: Run, t_process: float, cast=None) -> dict:
    """Set up, measure, check and read the metrics of one run → what the
    result line is made of (:func:`result_line`).  The checks are the
    traffic driver's own (its ``checks()``, where it has one) and the
    served tokens' against the reference.  ``cast`` (the control's
    rounding) also reads the control's gap into ``run.counters``."""
    import torch
    from portbench import correctness, layouts

    kind = run.cell["traffic"]["kind"]
    traffic = load_module(run.root / "traffic" / f"{kind}.py", f"portbench_traffic_{kind}")
    params = layouts.make_params(run)
    run.driver = traffic.Driver(run, params)
    run.driver.warmup()
    from portbench.serving import synchronize
    synchronize(run.device)
    t_ready = time.perf_counter()
    run.setup_s = t_ready - t_process
    if torch.device(run.device).type == "cuda":
        print(f"portbench: after set-up {torch.cuda.memory_allocated(run.device)} bytes allocated, "
              f"{torch.cuda.memory_reserved(run.device)} reserved, peak "
              f"{torch.cuda.max_memory_allocated(run.device)}", file=sys.stderr)
    tracer = port_tracer() if run.trace else None
    if run.trace:
        from portbench.trace import DeviceTrace
        run.device_trace = DeviceTrace(run.device, tracer)
    try:
        run.driver.window(run.seconds)
        run.driver.quiesce()
    finally:
        if tracer is not None:
            tracer.disable()
    if tracer is not None:
        run.program_spans = tracer.collect()
        run.spans.items.extend((s.name, s.start, s.end, s.thread, s.data)
                               for s in run.program_spans if s.name not in UNLABELLED)
    result = {"memory_peak_bytes": (torch.cuda.max_memory_allocated(run.device)
                                    if torch.device(run.device).type == "cuda" else 0)}
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    served = run.driver.served()
    run.counters["served"] = len(served)
    driver_checks = getattr(run.driver, "checks", dict)()
    run.driver.close()
    run.driver = None
    gc.collect()
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = dict(driver_checks, **correctness.check(run, params, served, cast))
    del params
    section = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(run.bench, run.name, section):
        value = metric_reader(m["name"], run.root / "metrics")(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["metrics"] = metrics
    if run.trace and run.device_trace is not None and run.device_trace.t1 is not None:
        result["busy_s"] = run.device_trace.busy_s
        result["window_s"] = run.device_trace.window_s
        result["breakdown"] = run.device_trace.breakdown(run.spans.items)
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules of JAX or the JAX package are loaded: {found}")
        self.found = found


def _paths_present(root: Path) -> bool:
    return (root / "BENCHMARK.json").exists() and (root / "src" / "repro_torch").is_dir()


def result_line(run: Run, result: dict, device_name: str) -> dict:
    """The run's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, a traced run's ``breakdown``, and last the
    numbers compared with their limits (``checks``)."""
    checks = result["checks"]
    correct = (bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
               and run.failed == 0)
    device = {"platform": "gpu", "kind": device_name, "count": 1,
              "memory_peak_bytes": int(result["memory_peak_bytes"])}
    if run.trace:
        device["busy_s"] = result.get("busy_s", 0.0)
        device["window_s"] = result.get("window_s", 0.0)
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    return line


def prepare_env() -> None:
    """Caches of the program inside the checkout at fixed paths, no JAX
    behind a library's back, and the program importable."""
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not _paths_present(ROOT):
        print("portbench: BENCHMARK.json and the program (src/repro_torch) are not both in "
              f"{ROOT}", file=sys.stderr)
        return 2
    prepare_env()
    import torch
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: the cell needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    run = Run(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    try:
        result = run_cell(run, t_process)
    except ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    line = result_line(run, result, torch.cuda.get_device_name(0))
    checks = line["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
