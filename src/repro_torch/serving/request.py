"""Serving request objects + per-request latency accounting."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

__all__ = ["Request", "RequestMetrics"]


@dataclasses.dataclass
class RequestMetrics:
    """Wall-clock milestones for one request's trip through the scheduler.

    ``admitted`` is when the request left its queue for a prefill batch —
    for a speculatively-prefilled request that is the *dispatch* time (the
    prefill started while the previous decode tick was still running), and
    ``speculative`` records that the request took the overlap path.  A
    speculative request whose bet missed is re-queued and may be admitted
    again; the timestamps always describe the attempt that finally landed.
    """

    arrival: float = 0.0
    admitted: float = 0.0
    first_token: float = 0.0
    finished: float = 0.0
    speculative: bool = False  # prefill overlapped a decode tick

    @property
    def ttft(self) -> float:
        """Time to first token (paper: time to k-th response)."""
        return self.first_token - self.arrival

    @property
    def latency(self) -> float:
        """Total arrival → finished wall time."""
        return self.finished - self.arrival


@dataclasses.dataclass
class Request:
    """One generation request (prompt in, ``max_new_tokens`` tokens out)."""

    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    generated: list = dataclasses.field(default_factory=list)
    metrics: RequestMetrics = dataclasses.field(default_factory=RequestMetrics)
    lane: Optional[int] = None
    # Query template (runtime lane key): requests sharing a template are
    # admitted/prefilled together, so heterogeneous traffic (chat vs embed vs
    # summarize) batches per class instead of head-of-line blocking.
    template: str = "default"
    # Per-request sampling params, carried per LANE through the decode
    # megabatch (one dispatch covers all templates).  temperature 0 is
    # greedy argmax — the bit-identity default; > 0 samples under a
    # counter-based key derived from (sample_seed, position), so draws
    # reproduce across spill/restore and batch composition changes.
    temperature: float = 0.0
    sample_seed: int = 0

    def __post_init__(self):
        if self.metrics.arrival == 0.0:
            self.metrics.arrival = time.perf_counter()

    @property
    def done(self) -> bool:
        """Whether the token budget is spent."""
        return len(self.generated) >= self.max_new_tokens

    @property
    def remaining(self) -> int:
        """Tokens still owed (0 once :attr:`done`)."""
        return max(0, self.max_new_tokens - len(self.generated))
