"""Production-mesh dry run: trace one step of every (architecture x shape x
mesh) cell on fake ranks and fake card tensors, and derive its roofline.

Port of :mod:`repro.launch.dryrun`.  The reference compiles each cell
with XLA against 512 forced host devices; the port has no compiler, so it
*runs* the step, on nothing:

  1. a ``fake`` process group of 256 (single pod, 16 x 16) or 512 (two
     pods, 2 x 16 x 16) ranks, this process being rank 0, and the
     production :class:`DeviceMesh` over it
     (:func:`repro_torch.launch.mesh.make_production_mesh`);
  2. ``FakeTensorMode`` tensors: the parameters placed by
     ``param_shardings``, the cell's inputs (``Arch.input_specs``) by
     :func:`_input_placements`, so the traced step is the port's own, its
     kernels' custom ops and their sharding rules included, and nothing is
     allocated anywhere.  They are ``cuda`` tensors where the PyTorch build
     has CUDA (autograd needs CUDA's device guard even for a fake tensor),
     so on the card's machine the trace takes the card's branches; a
     CPU-only build traces ``cpu`` fakes, whose only other ops are the
     float32 widening of the bf16 head and expert products (same flops);
  3. the train step (fwd + bwd + AdamW), the prefill, or ``decode_step``
     under :class:`~repro_torch.launch.op_cost.OpCost`: flops, bytes,
     collectives and the peak of live bytes of rank 0, counted on its
     local shards;
  4. the three roofline terms on one H100 SXM (``mesh.HW``):
        compute    = flops / 989e12
        memory     = bytes / 3.35e12
        collective = collective bytes / 450e9 (NVLink, each way)
  5. a row with the reference's keys in ``results/dryrun_torch.json``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single

Differences from the reference: the cell keeps its config's dtypes (the
reference lowers in float32 and halves bytes with ``BYTE_SCALE = 0.5`` to
undo XLA's CPU bf16 emulation, which a trace of the card's ops does not
have); bytes have no fusion model (``op_cost``); ``lower_s`` is the
trace's seconds and nothing is compiled.  The microbatch loop is fissioned
(``TrainStepConfig.fission``, the default, as in the reference): where the
model has a query (``query_embedding``) the cell counts the fissioned
program, whose producer, one batched query and consumer each rank runs.
A row's ``collectives_by_axis`` counts the collectives by the mesh axes
of their group.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.utils import _pytree as pytree

from repro_torch.distributed.sharding import (
    batch_placements,
    distribute_params,
    dp_size,
    logical_to_spec,
    mesh_context,
    param_shardings,
    placements_of,
)
from repro_torch.launch.mesh import HW, make_production_mesh, make_test_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.models.registry import ARCH_IDS, Arch, get_arch
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainStepConfig, make_train_step

__all__ = ["run_cell", "OPTS", "RESULTS", "fake_process_group"]

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch.json"

OPTS = (
    "kv_seq_shard",     # decode KV/SSM cache sharded over `model`
    "donate_cache",     # the decode step writes its cache in place (always, eagerly)
    "chunked_prefill",  # attn_chunk=512 (the reference's memory option; same math)
    "microbatch8",      # 8-way gradient accumulation (train activations)
    "int8_moments",     # 8-bit blockwise Adam moments, placed like their params
)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks (this process rank
    0) for the life of the ``with`` block, unless one is already up."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up; "
                               f"the cell needs {world_size}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _input_placements(mesh, specs: dict, opts=frozenset()) -> dict:
    """Placements for every input leaf (the reference's ``_input_shardings``)."""
    nm = mesh.size(mesh.mesh_dim_names.index("model")) if "model" in mesh.mesh_dim_names else 1

    def one(path: str, leaf):
        shape = leaf.shape
        if len(shape) == 0:
            return placements_of(mesh, ())
        if path.startswith("cache"):
            # cache leaves: (L, B, ...) — batch at axis 1
            if "kv_seq_shard" in opts:
                axes = [None] * len(shape)
                if shape[1] % dp_size(mesh) == 0:
                    axes[1] = "dp"
                key = path.split("/")[-1]
                if key in ("k", "v", "cross_k", "cross_v") and len(shape) == 5 \
                        and shape[2] % nm == 0:
                    axes[2] = "model"
                elif key == "ssm" and len(shape) == 5 and shape[2] % nm == 0:
                    axes[2] = "model"  # SSM heads
                elif key == "conv" and len(shape) == 4 and shape[3] % nm == 0:
                    axes[3] = "model"
                return placements_of(mesh, logical_to_spec(mesh, axes))
            return batch_placements(mesh, shape, batch_axis=1)
        if path.startswith("positions"):
            return batch_placements(mesh, shape, batch_axis=1)  # (3, B, S)
        return batch_placements(mesh, shape)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        return one(path, node)

    return walk(specs, "")


def _fake(tree, device: str):
    """A tree of tensors (real or meta) as fake tensors on ``device`` of the
    same shapes and dtypes (call under ``FakeTensorMode``)."""
    return pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), tree)


def _local_bytes(tree) -> int:
    total = 0
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total


def _state_tensors(state) -> list:
    out = []
    for leaf in pytree.tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif hasattr(leaf, "q"):  # an int8 moment
            out += [leaf.q, leaf.scale]
    return out


def run_cell(arch_name: Union[str, Arch], shape_name: Union[str, ShapeSpec],
             mesh_kind: str = "single", check_fit: bool = True,
             opts: frozenset = frozenset(), *, mesh_shape: Optional[tuple] = None,
             microbatches: Optional[int] = None) -> dict:
    """Trace one cell (module docstring) and return its row.  ``arch_name``
    and ``shape_name`` may be an :class:`Arch` or :class:`ShapeSpec` (a cut
    configuration); ``mesh_shape`` overrides the production mesh with a
    (data, model) test mesh of that shape; ``microbatches`` a train cell's
    count (else 8 under ``microbatch8``, 1 without)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    arch = get_arch(arch_name) if isinstance(arch_name, str) else arch_name
    if "chunked_prefill" in opts:
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, attn_chunk=512))
    cfg = arch.cfg
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return {"skipped": "full attention cannot serve 524k context (see DESIGN.md)"}
    multi = mesh_kind == "multi"
    n_chips = int(np.prod(mesh_shape)) if mesh_shape else 512 if multi else 256
    device = "cuda" if torch.cuda.is_available() else "cpu"

    with fake_process_group(n_chips):
        mesh = (make_test_mesh(*mesh_shape, device_type=device) if mesh_shape else
                make_production_mesh(multi_pod=multi, device_type=device))
        oc = OpCost(mesh)
        with FakeTensorMode():
            params = _fake(arch.init(0, "cpu"), device)  # shapes only: nothing is drawn
            p_sh = param_shardings(mesh, params)
            params = distribute_params(mesh, params, p_sh)
            specs = arch.input_specs(shape)
            in_pl = _input_placements(mesh, specs, opts)
            inputs = pytree.tree_map(
                lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None),
                _fake(specs, device), in_pl, is_leaf=lambda x: isinstance(x, tuple))
            t0 = time.time()
            with mesh_context(mesh):
                args_bytes = _local_bytes(params) + _local_bytes(inputs)
                if shape.kind == "train":
                    opt_cfg = AdamWConfig(
                        moments_dtype="int8" if "int8_moments" in opts else "float32")
                    init_state, train_step = make_train_step(
                        arch, opt_cfg,
                        TrainStepConfig(donate=False,
                                        microbatches=microbatches or (
                                            8 if "microbatch8" in opts else 1)),
                        mesh=mesh)
                    state = init_state(params)
                    args_bytes += _local_bytes(_state_tensors(state))
                    oc.hold(args_bytes)
                    with oc:
                        train_step(params, state, inputs)
                elif shape.kind == "prefill":
                    oc.hold(args_bytes)
                    with oc:
                        arch.prefill(params, inputs)
                else:
                    oc.hold(args_bytes)
                    with oc:
                        arch.decode_step(params, inputs["token"], inputs["cache"],
                                         inputs["lengths"])
            t_trace = time.time() - t0
        peak_total = oc.peak_bytes

    lcost = oc.cost()
    flops = lcost.flops
    t_compute = flops / HW["peak_bf16_flops"]
    t_memory = lcost.bytes / HW["hbm_bw"]
    t_coll = lcost.collective_bytes / HW["nvlink_bw"]
    dominant = max([("compute", t_compute), ("memory", t_memory), ("collective", t_coll)],
                   key=lambda kv: kv[1])[0]
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        model_flops = 6 * n_active * tokens
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * tokens
    else:
        model_flops = 2 * n_active * shape.global_batch  # one token/request
    model_flops_per_chip = model_flops / n_chips
    row = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "x".join(map(str, mesh_shape)) if mesh_shape else mesh_kind,
        "opts": sorted(opts),
        "chips": n_chips,
        "step": shape.kind,
        "traced_on": device,
        "lower_s": round(t_trace, 2),
        "compile_s": 0.0,
        "flops_per_device": flops,
        "bytes_per_device": lcost.bytes,
        "collectives": oc.collectives_row(),
        "collectives_by_axis": oc.by_axis_row(),
        "flops_by_op": dict(sorted(oc.flops_by_op.items(), key=lambda kv: -kv[1])),
        "collective_bytes_loop_aware": lcost.collective_bytes,
        "collective_counts_loop_aware": lcost.collective_counts,
        "raw_cost_analysis_flops": flops,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flops_ratio": (model_flops_per_chip / flops) if flops else None,
        "params": cfg.param_count(),
        "active_params": n_active,
        "memory_analysis": f"peak live local bytes {peak_total} (arguments {args_bytes})",
        "argument_size_bytes": args_bytes,
        "output_size_bytes": None,
        "temp_size_bytes": max(0, peak_total - args_bytes),
    }
    if check_fit:
        row["hbm_fit"] = bool(peak_total <= HW["hbm_bytes"])
        row["live_bytes"] = peak_total
    return row


def _load_results() -> dict:
    if RESULTS.exists():
        return json.loads(RESULTS.read_text())
    return {}


def _save_results(res: dict) -> None:
    RESULTS.parent.mkdir(parents=True, exist_ok=True)
    tmp = RESULTS.with_suffix(".tmp")
    tmp.write_text(json.dumps(res, indent=1, default=str))
    os.replace(tmp, RESULTS)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default="", help=f"comma-joined optimizations from {OPTS}")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    opts = frozenset(o for o in args.opt.split(",") if o)
    for o in opts:
        if o not in OPTS:
            raise SystemExit(f"unknown opt {o!r}; choose from {OPTS}")
    suffix = ("|" + "+".join(sorted(opts))) if opts else ""

    results = _load_results()
    for a in archs:
        for s in shapes:
            for m in meshes:
                key = f"{a}|{s}|{m}{suffix}"
                if key in results and not args.force and "error" not in results[key]:
                    print(f"[skip] {key}")
                    continue
                print(f"[cell] {key} ...", flush=True)
                try:
                    row = run_cell(a, s, m, opts=opts)
                except Exception as e:  # noqa: BLE001  (recorded in the row, the sweep goes on)
                    row = {"error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"  ERROR {e}")
                results[key] = row
                _save_results(results)
                if "error" not in row and "skipped" not in row:
                    print(f"  ok trace={row['lower_s']}s dominant={row['dominant']} "
                          f"t=({row['t_compute_s']:.3e},{row['t_memory_s']:.3e},"
                          f"{row['t_collective_s']:.3e})s")
    print("done:", RESULTS)


if __name__ == "__main__":
    main()
