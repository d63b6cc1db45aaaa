"""Data pipeline: deterministic synthetic LM stream + asynchronous prefetch.

The port's copy of :mod:`repro.data.pipeline` (numpy only): the stream is
the same pure function of (seed, step, shard), bit for bit, so both
packages train on the same batches.  One repair: ``PrefetchLoader.stop``
waits for the producer thread to end (the reference's can leave it
blocked on a full queue).

The host-side input pipeline is the clearest instance of the paper's
pattern in an ML system: the naive loop does

    for step in range(n):         # ss1: build batch (slow host work)
        batch = next_batch(step)  # the blocking "query"
        train_step(batch)         # ss2: consume

Rule A fissions it: a *producer* thread generates batches ahead of need
into a bounded blocking queue (the loop-context table of §5.1), while the
*consumer* (the train loop) fetches — compute and host IO overlap, and the
bounded queue is the paper's §8 memory back-off.  :class:`PrefetchLoader`
is exactly that, built on :class:`repro_torch.core.loop_context.LoopContextTable`.

Determinism & fault tolerance: ``SyntheticLMStream`` is a pure function of
(seed, step, shard), so a restarted job resumes the exact stream from the
checkpointed step — no data-state checkpoint needed; a real corpus reader
would checkpoint its cursor the same way.
"""
from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.loop_context import LoopContextTable

__all__ = ["SyntheticLMStream", "PrefetchLoader"]


class SyntheticLMStream:
    """Zipf-ish token stream with local structure (repeated n-grams) so tiny
    models actually learn (loss decreases) in integration tests."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int = 0,
                 shard: int = 0, n_shards: int = 1):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.shard = shard
        self.n_shards = n_shards

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard])
        )
        b, s, v = self.batch, self.seq_len, self.vocab_size
        # structured sequences: random walk over a small markov-ish table
        base = rng.zipf(1.5, size=(b, s)).astype(np.int64)
        toks = (base + rng.integers(0, 7, size=(b, 1))) % v
        # inject copy structure: second half repeats first half shifted
        half = s // 2
        toks[:, half:half * 2] = (toks[:, :half] + 1) % v
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": toks}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchLoader:
    """§5.1 overlap for the input pipeline (producer thread + bounded
    blocking loop-context table)."""

    def __init__(self, stream, n_prefetch: int = 4, start_step: int = 0,
                 max_steps: Optional[int] = None):
        self.stream = stream
        self.table = LoopContextTable(blocking=True, maxsize=n_prefetch)
        self._start = start_step
        self._max = max_steps
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._stop = threading.Event()
        self._thread.start()

    def _produce(self):
        step = self._start
        while not self._stop.is_set():
            if self._max is not None and step >= self._start + self._max:
                break
            self.table.put(self.stream.batch_at(step))
            step += 1
        self.table.close()

    def __iter__(self):
        return iter(self.table)

    def stop(self):
        """Stop the producer and wait for it to end.  The reference drains
        once; the producer can then block again on the full queue (its next
        ``put``, or ``close``), so this drains until the thread is gone."""
        self._stop.set()
        while self._thread.is_alive():
            self.table.delete()
            self._thread.join(timeout=0.01)
