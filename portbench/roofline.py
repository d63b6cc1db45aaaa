"""Peaks of one NVIDIA H100 and the least time a kernel call can take.

Frozen copy of the bring-up script ``chip_smoke.py``: ``HBM_BYTES_PER_S``,
``BF16_FLOPS_PER_S``, ``F32_FLOPS_PER_S``, ``_bound`` (here in seconds, not
milliseconds) and its byte and flop counts of ``paged_decode_attention`` and
``flash_attention``.  The program's own cost tables are not read: the counts
here come from the inputs of a call, whatever implements it.

The peaks are NVIDIA's data sheet for the SXM part, dense: 3.35 TB/s of HBM,
989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor cores.
"""
from __future__ import annotations

import math
from typing import Sequence

__all__ = ["HBM_BYTES_PER_S", "BF16_FLOPS_PER_S", "F32_FLOPS_PER_S", "bound_s",
           "paged_decode_call", "flash_call"]

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """(least seconds, "bytes" or "operations"): the larger of the bytes over
    the bandwidth and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_decode_call(ctx_lens: Sequence[int], hq: int, hkv: int, d: int,
                      page_size: int, itemsize: int = 2) -> tuple[int, int]:
    """(bytes, flops) of one paged decode call over the lanes whose keys
    number ``ctx_lens``: q in and the output out per lane, each lane's valid
    K and V rows read once, the block-table entries those rows need and the
    lengths; QK and PV per (query head, key)."""
    b = len(ctx_lens)
    kv = int(sum(ctx_lens))
    pages = sum(math.ceil(n / page_size) for n in ctx_lens)
    nbytes = b * hq * d * itemsize * 2 + 2 * kv * hkv * d * itemsize + pages * 4 + b * 4
    return nbytes, 4 * hq * d * kv


def flash_call(prompt_lens: Sequence[int], hq: int, hkv: int, d: int,
               itemsize: int = 2) -> tuple[int, int]:
    """(bytes, flops) of one causal flash call over unpadded prompts of
    ``prompt_lens``: Q, K, V in and O out once; causal QK and PV."""
    nbytes = sum(n * (2 * hq + 2 * hkv) * d * itemsize for n in prompt_lens)
    flops = sum(4 * hq * d * (n * (n + 1) // 2) for n in prompt_lens)
    return nbytes, flops
