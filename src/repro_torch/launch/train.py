"""Training launcher.

Port of :mod:`repro.launch.train`: the same flags, optimizer, schedule and
loop — prefetched data (:class:`~repro_torch.data.pipeline.PrefetchLoader`,
the §5.1 overlap), asynchronous checkpoints through the query runtime
(:class:`~repro_torch.checkpoint.manager.CheckpointManager`) with a
restart from the newest one if ``--ckpt-dir`` holds any, and a synchronous
save at the end (``on_preempt``) — plus ``--device`` (default ``cuda``;
there is no CPU fallback)::

    python -m repro_torch.launch.train --arch mamba2-1.3b --batch 8 --seq 2048 \\
        --moments int8 --steps 4 --ckpt-every 2 --ckpt-dir /path/to/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --device cpu --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

It prints the reference's lines, each logged step's own wall beside the
running mean, how long each ``save()`` blocked the loop (its snapshot to
host memory) and, at the end, each write's bytes and seconds on the
runtime's thread.  ``main`` returns what it measured (``start``, per-step
``losses`` and ``walls`` as (start, end) ``time.perf_counter`` pairs,
``saves`` as (step, seconds blocked), the manager's ``writes``) with the
final ``params`` and ``state``.  Weights are random, drawn from seed 0 on
the device; batches come from ``SyntheticLMStream``, so a token-stream
family (not the embeddings of qwen2-vl or seamless-m4t's frames) trains
here, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMStream
from repro_torch.models.registry import get_arch
from repro_torch.train.optimizer import AdamWConfig, cosine_schedule
from repro_torch.train.step import TrainStepConfig, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moments", default="float32", choices=["float32", "int8"])
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and its optimizer state live on")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    cfg = arch.cfg
    print(f"arch={cfg.name} params={cfg.param_count():,} device={args.device}")

    opt = AdamWConfig(lr=args.lr, moments_dtype=args.moments,
                      schedule=cosine_schedule(args.lr, warmup=10, total=args.steps))
    init_state, step = make_train_step(
        arch, opt,
        TrainStepConfig(microbatches=args.microbatches,
                        grad_compression=args.grad_compression, donate=False),
    )

    params = arch.init(seed=0, device=args.device)
    state = init_state(params)
    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None:
        restored = mgr.restore_latest(params, state)
        if restored:
            start, params, state = restored
            print(f"restored checkpoint at step {start}")

    stream = SyntheticLMStream(cfg.vocab_size, args.seq, args.batch)
    loader = PrefetchLoader(stream, n_prefetch=4, start_step=start,
                            max_steps=args.steps - start)
    out = {"start": start, "losses": [], "walls": [], "saves": []}
    t0 = time.perf_counter()
    i = start
    for batch in loader:
        ts = time.perf_counter()
        params, state, m = step(params, state, batch)
        out["losses"].append(float(m["loss"]))  # waits for the step's device work
        out["walls"].append((ts, time.perf_counter()))
        i += 1
        if i % args.log_every == 0:
            dt = (time.perf_counter() - t0) / (i - start)
            print(f"step {i:5d} loss {out['losses'][-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} {dt*1e3:.0f} ms/step "
                  f"(this step {(out['walls'][-1][1] - ts)*1e3:.0f} ms)")
        if mgr is not None and i % args.ckpt_every == 0:
            ts = time.perf_counter()
            mgr.save(i, params, state)
            out["saves"].append((i, time.perf_counter() - ts))
            print(f"checkpoint step {i}: save() blocked the loop "
                  f"{out['saves'][-1][1]*1e3:.1f} ms")
    if mgr is not None:
        mgr.on_preempt(i, params, state)
        mgr.close()
        for w in mgr.writes:
            print(f"checkpoint step {w['step']}: wrote {w['bytes']:,} bytes in "
                  f"{w['end'] - w['start']:.3f} s on the runtime's thread")
    out.update(writes=mgr.writes if mgr is not None else [], params=params, state=state)
    print("done")
    return out


if __name__ == "__main__":
    main()
