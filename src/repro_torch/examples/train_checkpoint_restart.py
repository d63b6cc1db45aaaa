"""Fault-tolerant training driver: async checkpointing (the paper's
asynchronous submission applied to IO), a simulated preemption, and an
exact restart.

The port's twin of the JAX package's ``examples/train_checkpoint_restart.py``,
its ``main`` factored into :func:`run`, which takes the model and the
cadence and returns what happened.  Run:

    python -m repro_torch.examples.train_checkpoint_restart [--device cpu]

The train step is compiled (:mod:`repro_torch.train.step`): on the card its
first call runs and records one CUDA graph, and every later call, the
restarted ones included, copies the parameters and moments passed in into
the step's own (``donate=False``) and replays it.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMStream
from repro_torch.models.registry import get_arch
from repro_torch.train.optimizer import AdamWConfig, cosine_schedule
from repro_torch.train.step import TrainStepConfig, make_train_step

__all__ = ["run", "main"]


def run(arch, params, *, steps: int = 60, every: int = 20, resume: int = 20,
        ckpt_dir=None, verbose: bool = True) -> dict:
    """Train ``steps`` steps from ``params`` with an asynchronous checkpoint
    every ``every``, take a durable save at the simulated preemption
    (``on_preempt``, while the last asynchronous write may be in flight),
    restore the newest checkpoint into fresh tensors and train ``resume``
    more steps from the loader's cursor through the same compiled step.
    Checkpoints go under ``ckpt_dir`` (a new temporary directory by
    default).  Returns ``losses`` (the first ``steps``), ``resumed_at``,
    ``resumed`` (the losses after the restart), ``save_blocked`` (seconds
    each ``save()`` held the loop), ``preempt_s``, ``restore_s``,
    ``writes`` (the manager's record of each write: step, bytes, start,
    end), and ``params``, ``state``, ``step`` and ``stream`` as they stood
    at the preemption."""
    opt = AdamWConfig(lr=3e-3, schedule=cosine_schedule(3e-3, warmup=10, total=120))
    init_state, step = make_train_step(arch, opt, TrainStepConfig(donate=False))

    stream = SyntheticLMStream(arch.cfg.vocab_size, seq_len=32, batch=8)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_") if ckpt_dir is None else ckpt_dir
    state = init_state(params)
    say = print if verbose else (lambda *a, **k: None)

    with CheckpointManager(ckpt_dir, keep_last=2) as mgr:
        say(f"phase 1: train {steps} steps, async-checkpoint every {every}")
        loader = PrefetchLoader(stream, n_prefetch=4, max_steps=steps)
        losses, blocked = [], []
        for i, batch in enumerate(loader):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            if (i + 1) % every == 0:
                t0 = time.perf_counter()
                mgr.save(i + 1, params, state)   # returns once the snapshot is taken
                blocked.append(time.perf_counter() - t0)
                say(f"  step {i+1:3d} loss {losses[-1]:.3f} (ckpt submitted)")
        say(f"  loss: {losses[0]:.3f} → {losses[-1]:.3f}")
        say("phase 2: PREEMPTED (simulated) — durable save")
        t0 = time.perf_counter()
        mgr.on_preempt(steps, params, state)
        preempt_s = time.perf_counter() - t0
        writes = list(mgr.writes)

    say("phase 3: restart from latest checkpoint")
    with CheckpointManager(ckpt_dir) as mgr2:
        t0 = time.perf_counter()
        restored = mgr2.restore_latest(params, state)
        restore_s = time.perf_counter() - t0
        assert restored is not None
        step_no, params2, state2 = restored
        say(f"  resumed at step {step_no}")
        # deterministic stream: continue from the same cursor
        loader = PrefetchLoader(stream, n_prefetch=4, start_step=step_no, max_steps=resume)
        resumed = []
        for batch in loader:
            params2, state2, m = step(params2, state2, batch)
            resumed.append(float(m["loss"]))
        say(f"  step {step_no+resume} loss {resumed[-1]:.3f}")
    say("done — training survived a preemption with no data reuse/skip")
    return dict(losses=losses, resumed_at=step_no, resumed=resumed, save_blocked=blocked,
                preempt_s=preempt_s, restore_s=restore_s, writes=writes, params=params,
                state=state, step=step, stream=stream)


def main(device: str = "cuda"):
    arch = get_arch("olmo-1b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    params = arch.init(seed=0, device=device)
    run(arch, params)


if __name__ == "__main__":
    from repro_torch.examples import device_from_argv

    main(device=device_from_argv(__doc__))
