#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``:

1. card — ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build — compile every CUDA kernel of the serving path from
   ``src/repro_torch/csrc`` with ``nvcc`` (one process per source, in
   parallel) and time it;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes in bf16 and at a small ragged float32 shape (the
   ``ssd_scan`` kernel: mamba2-1.3b's prefill shape in float32 and the
   reference's sweep shapes in float32 and bf16), with the tolerance
   stated; its time, the plain version's, one library call's as a
   yardstick where one exists (never called by the port) and the least
   time the card could take (``bound_ms``);
4. serving paths — llama3-8b at full width (32 layers, bf16, weights
   drawn from seed 0 on the card) served through
   ``ContinuousBatchingScheduler``, 32 new tokens a request, three paths,
   each with every kernel launch count zeroed just before it and read
   just after, and held to exact counts (one launch per layer per
   dispatch or per token):
   a. main — the synchronous path, ``PagedInferenceEngine``, 16 requests:
      ``paged_decode_attention`` = decode steps x 32, ``flash_attention``
      = prefill dispatches x 32;
   b. async — the paper's asynchronous path: ``overlap=True`` (prefills on
      the speculation thread and the engine's own stream),
      ``chunk_tokens=256`` and fused chunk ticks, 16 requests of which 3
      are longer than ``max_prompt_len``: ``decode_attention`` = tokens
      fed through the decode path x 32, and no speculation crash;
   c. dense — ``InferenceEngine`` with the main path's requests:
      ``decode_attention`` = decode steps x 32;
   then mamba2-1.3b at full width (48 layers, bf16, weights drawn from
   seed 0 on the card) through ``InferenceEngine(n_lanes=8,
   max_prompt_len=2048, max_len=2080)``:
   d. ssm — the synchronous path, 16 requests of 300-2000 tokens:
      ``ssd_scan`` = prefill dispatches x 48, no other kernel;
   e. ssm-async — ``overlap=True, chunk_tokens=1024``, 14 prompts of
      300-1000 tokens and 2 of 1056-1152 (their tails fed through the
      recurrent decode): ``ssd_scan`` = prefill dispatches x 48, no
      speculation crash;
5. checks — first prefill and first decode tick of the full-width
   llama3-8b, and the first full-width mamba2 prefill, kernel path
   against the plain path on the same weights and batch;
6. profile — ``torch.profiler`` over one full-width llama3-8b prefill
   dispatch, a few decode ticks and one fused tick (a 64-token prompt
   chunk folded into the decode), then one mamba2 prefill dispatch and a
   few of its decode ticks: host wall time, device busy time, the kernels
   that take the most of it, and ``ssd_scan``'s share of the prefill;
7. reduced check — the reduced llama3-8b in float32 served on the card
   with the kernels against the same model served on the CPU with the
   plain versions, on the synchronous paged path, the dense engine and
   the overlap + chunk paged path; the reduced mamba2 the same way on the
   dense engine, synchronous and overlap + chunk (per-request greedy
   streams and the engine's counters must be equal).

Any failure exits non-zero.  The last lines are the card's name and power
limit, the kernels' JSON line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core peak and
# the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


# ----------------------------------------------------------------- phase 1
def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi}")
    log(f"[card] torch: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    # Float32 products in full float32 on the card (the plain versions'
    # einsums), so float32 comparisons are not TF32-limited.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


# ----------------------------------------------------------------- phase 2
def phase_build():
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    dt = time.perf_counter() - t0
    for name, path in libs.items():
        log(f"[build] {name}: {path.relative_to(ROOT)}")
    log(f"[build] {len(libs)} kernels built in {dt:.3f} s (nvcc in parallel)")
    torch.cuda.synchronize()


# ----------------------------------------------------------------- phase 3
class Timer:
    """Median device time of one call, from CUDA events around each call,
    with the 50 MB L2 flushed before each so the call finds its operands
    in device memory, as it does on the serving path."""

    def __init__(self):
        import torch
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 25) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def _bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _compare(label, got, want, rtol, atol):
    import torch
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), rtol=rtol, atol=atol)
    log(f"[kernels] {label}: max_abs_err {err!r} (tolerance rtol {rtol}, atol {atol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{label}: kernel disagrees with its plain version")
    return err


def _paged_case(gen, rng, b, hq, hkv, d, ps, np_, dtype):
    import torch
    n_pages = b * np_ + 1  # page 0 stays out of the tables
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda").to(dtype)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(b, np_).astype(np.int32)
    lengths = rng.integers(1, np_ * ps + 1, size=(b,)).astype(np.int32)
    lengths[0] = 0  # a lane with nothing to attend: zeros, never NaN
    return (q, kp, vp, torch.as_tensor(tables, device="cuda"),
            torch.as_tensor(lengths, device="cuda"))


def _flash_case(gen, b, hq, hkv, s, d, dtype):
    import torch
    # The model's layout: (B, S, H, D) buffers viewed as (B, H, S, D).
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _decode_case(gen, rng, b, hq, hkv, t, d, dtype):
    import torch
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
    lengths = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    if b > 2:
        lengths[:3] = (0, 1, t)  # nothing to attend, one key, the whole cache
    return q, k, v, torch.as_tensor(lengths, device="cuda")


def phase_kernels(timer):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    rows = {}

    # -- paged decode attention.  bf16 tolerance: both sides accumulate in
    # float32 and round the output to bf16 once (2^-8 relative), so they may
    # differ by one bf16 ulp of an O(1) value.  float32: sums and exp in
    # another order, about 1e-6; 1e-4 leaves room.
    args = _paged_case(gen, rng, 8, 32, 8, 128, 16, 32, torch.bfloat16)
    out = paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(out[0]).all()) and float(out[0].abs().max()) == 0.0):
        fail("paged_decode_attention: the length-0 lane is not finite zeros")
    err = _compare("paged_decode_attention bf16 B=8 Hq=32 Hkv=8 D=128 ps=16 NP=32 "
                   f"lengths={args[4].tolist()}", out, paged_decode_ref(*args), 1e-2, 1e-2)
    small = _paged_case(gen, rng, 3, 4, 2, 64, 16, 5, torch.float32)
    small_out = paged_decode_attention_cuda(*small)
    if float(small_out[0].abs().max()) != 0.0:
        fail("paged_decode_attention float32: the length-0 lane is not zeros")
    _compare(f"paged_decode_attention f32 B=3 Hq=4 Hkv=2 D=64 lengths={small[4].tolist()}",
             small_out, paged_decode_ref(*small), 1e-4, 1e-4)
    q, _kp, _vp, tabs, lens = args
    kv_tokens = int(lens.sum())
    nbytes = (q.numel() * 2 * 2                       # q in, out
              + 2 * kv_tokens * 8 * 128 * 2           # valid K and V rows
              + tabs.numel() * 4 + lens.numel() * 4)
    flops = 4 * 32 * 128 * kv_tokens                  # QK and PV per (head, key)
    bound, by = _bound(nbytes, flops)
    rows["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:78",
        max_abs_err=err,
        ms=timer.ms(lambda: paged_decode_attention_cuda(*args)),
        plain_ms=timer.ms(lambda: paged_decode_ref(*args)),
        bound_ms=bound, bound_by=by, library_ms=None)
    log(f"[kernels] paged_decode_attention: {rows['paged_decode_attention']}")
    torch.cuda.synchronize()

    # -- flash attention (causal prefill), same tolerances and reasons.
    b, hq, hkv, s, d = 8, 32, 8, 256, 128
    fq, fk, fv = _flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
    out = flash_attention_cuda(fq, fk, fv, causal=True)
    err = _compare(f"flash_attention bf16 B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal",
                   out, attention_ref(fq, fk, fv, causal=True), 1e-2, 1e-2)
    for (sb, shq, shkv, ss, sd) in ((2, 4, 2, 77, 64), (1, 8, 2, 130, 128)):
        sq, sk, sv = _flash_case(gen, sb, shq, shkv, ss, sd, torch.float32)
        for causal in (True, False):
            _compare(f"flash_attention f32 ragged B={sb} Hq={shq} Hkv={shkv} S={ss} "
                     f"D={sd} causal={causal}",
                     flash_attention_cuda(sq, sk, sv, causal=causal),
                     attention_ref(sq, sk, sv, causal=causal), 1e-4, 1e-4)
    nbytes = 2 * (fq.numel() * 2 + fk.numel() + fv.numel())  # q, k, v in; out
    flops = 4 * b * hq * d * (s * (s + 1) // 2)                # causal QK and PV
    bound, by = _bound(nbytes, flops)

    def library():
        return F.scaled_dot_product_attention(fq, fk, fv, is_causal=True,
                                              enable_gqa=True)

    _compare("scaled_dot_product_attention (yardstick) vs plain", library(),
             attention_ref(fq, fk, fv, causal=True), 1e-2, 1e-2)
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:86",
        max_abs_err=err,
        ms=timer.ms(lambda: flash_attention_cuda(fq, fk, fv, causal=True)),
        plain_ms=timer.ms(lambda: attention_ref(fq, fk, fv, causal=True)),
        bound_ms=bound, bound_by=by, library_ms=timer.ms(library))
    log(f"[kernels] flash_attention: {rows['flash_attention']}")
    torch.cuda.synchronize()

    # -- dense-cache decode attention, same tolerances and reasons, at the
    # dense engine's shape (8 lanes) and the chunk side's (batch 1).
    timed = {}
    for label, b in (("dense engine", 8), ("chunk side", 1)):
        dq, dk, dv, dlen = _decode_case(gen, rng, b, 32, 8, 512, 128, torch.bfloat16)
        out = decode_attention_cuda(dq, dk, dv, dlen)
        torch.cuda.synchronize()
        if b > 1 and not (bool(torch.isfinite(out[0]).all()) and float(out[0].abs().max()) == 0.0):
            fail("decode_attention: the length-0 lane is not finite zeros")
        err = _compare(f"decode_attention bf16 ({label}) B={b} Hq=32 Hkv=8 T=512 D=128 "
                       f"lengths={dlen.tolist()}", out, decode_ref(dq, dk, dv, dlen),
                       1e-2, 1e-2)
        kv_tokens = int(dlen.sum())
        nbytes = (dq.numel() * 2 * 2                    # q in, out
                  + 2 * kv_tokens * 8 * 128 * 2         # valid K and V rows
                  + dlen.numel() * 4)
        bound, by = _bound(nbytes, 4 * 32 * 128 * kv_tokens)
        valid = (torch.arange(512, device="cuda")[None, :] < dlen[:, None].long())

        def library(dq=dq, dk=dk, dv=dv, valid=valid):
            return F.scaled_dot_product_attention(
                dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
                attn_mask=valid[:, None, None, :], enable_gqa=True)[:, :, 0]

        live = dlen > 0  # SDPA gives NaN on a fully masked row
        _compare(f"scaled_dot_product_attention (yardstick, {label}) vs plain",
                 library()[live], decode_ref(dq, dk, dv, dlen)[live], 1e-2, 1e-2)
        timed[label] = dict(
            route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:74",
            max_abs_err=err,
            ms=timer.ms(lambda: decode_attention_cuda(dq, dk, dv, dlen)),
            plain_ms=timer.ms(lambda: decode_ref(dq, dk, dv, dlen)),
            bound_ms=bound, bound_by=by, library_ms=timer.ms(library))
        log(f"[kernels] decode_attention ({label}): {timed[label]}")
    for (sb, shq, shkv, st, sd) in ((3, 4, 2, 77, 64), (2, 8, 2, 130, 16)):
        small = _decode_case(gen, rng, sb, shq, shkv, st, sd, torch.float32)
        _compare(f"decode_attention f32 ragged B={sb} Hq={shq} Hkv={shkv} T={st} D={sd} "
                 f"lengths={small[3].tolist()}", decode_attention_cuda(*small),
                 decode_ref(*small), 1e-4, 1e-4)
    rows["decode_attention"] = timed["dense engine"]
    torch.cuda.synchronize()
    rows["ssd_scan"] = _ssd_scan_kernel(timer, gen)
    return rows


def _scan_case(gen, shape, dtype):
    import torch
    b, c, h = shape[:3]
    states = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    decay = torch.sigmoid(torch.randn((b, c, h), generator=gen, device="cuda"))
    return states, decay


def _ssd_scan_kernel(timer, gen):
    """The ``ssd_scan`` kernel against its plain version.  Tolerances:
    float32 1e-6 (a few ulps: both sides do the same multiply and add in
    float32 per chunk, the kernel without FMA contraction, so it should
    read 0); bf16 ``prev`` 2^-7 relative (one bf16 ulp of its rounding:
    the kernel rounds the float32 carry to bf16, the plain version keeps
    it in float32) and ``final`` as float32."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    def check(label, states, decay, prev_tol):
        prev, final = ssd_scan_cuda(states, decay)
        torch.cuda.synchronize()
        rprev, rfinal = ssd_scan_ref(states, decay)
        if prev.dtype != states.dtype or final.dtype != torch.float32:
            fail(f"ssd_scan {label}: output dtypes {prev.dtype}, {final.dtype}")
        err = _compare(f"ssd_scan {label} prev", prev, rprev, *prev_tol)
        return max(err, _compare(f"ssd_scan {label} final", final, rfinal, 1e-6, 1e-6))

    # mamba2-1.3b's prefill: 8 prompts of 2048 tokens, chunks of 256.
    shape = (8, 8, 64, 64, 128)
    states, decay = _scan_case(gen, shape, torch.float32)
    err = check(f"f32 mamba2 prefill B,C,H,P,N={shape}", states, decay, (1e-6, 1e-6))
    for small in ((2, 8, 4, 16, 32), (1, 16, 2, 8, 8), (3, 4, 5, 32, 16), (1, 32, 1, 64, 64)):
        for dtype, tol in ((torch.float32, (1e-6, 1e-6)), (torch.bfloat16, (2.0 ** -7, 1e-6))):
            check(f"{str(dtype)[6:]} sweep B,C,H,P,N={small}",
                  *_scan_case(gen, small, dtype), tol)
    check("f32 one chunk B,C,H,P,N=(8, 1, 64, 64, 128)",
          *_scan_case(gen, (8, 1, 64, 64, 128), torch.float32), (1e-6, 1e-6))
    # States read once, prev and final written once (decay is 16 KB); two
    # float32 flops per element per chunk.
    nbytes = 4 * (2 * states.numel() + decay.numel() + states.numel() // shape[1])
    bound, by = _bound(nbytes, 2 * states.numel(), F32_FLOPS_PER_S)
    row = dict(route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
               replaces="src/repro/kernels/ssd_scan/kernel.py:51", max_abs_err=err,
               ms=timer.ms(lambda: ssd_scan_cuda(states, decay)),
               plain_ms=timer.ms(lambda: ssd_scan_ref(states, decay)),
               bound_ms=bound, bound_by=by, library_ms=None)
    log(f"[kernels] ssd_scan (no single PyTorch call computes it: library_ms null): {row}")
    torch.cuda.synchronize()
    return row


# ----------------------------------------------------------------- phase 4
def _requests(Request, vocab: int, n: int = 16, max_new: int = 32):
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 201, size=n)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(m)).astype(np.int32),
                    max_new_tokens=max_new) for i, m in enumerate(lens)]


def _async_requests(Request, vocab: int, max_new: int = 32):
    """13 prompts of 32-200 tokens (template "chat") and 3 of 320-448
    (template "long", longer than max_prompt_len 256: only chunked prefill
    serves them whole), interleaved, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(32, 201, size=13)]
    for at, n in zip((2, 7, 11), rng.integers(320, 449, size=3)):
        lens.insert(at, -int(n))
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=abs(m)).astype(np.int32),
                    max_new_tokens=max_new, template="long" if m < 0 else "chat")
            for i, m in enumerate(lens)]


def _drive(label, eng, sched, reqs, device):
    """Submit ``reqs`` at once and drain them, with every launch count set
    to 0 just before and read just after.  Checks that each request got
    its tokens, all in the vocabulary; logs tokens/s, TTFT and the
    counters.  Returns (launch counts, wall seconds)."""
    import torch
    from repro_torch.kernels import registry

    vocab = eng.arch.cfg.vocab_size
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        r.metrics.arrival = t0
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    for r in reqs:
        if (len(r.generated) != r.max_new_tokens
                or not all(0 <= t < vocab for t in r.generated)):
            fail(f"{label}: request {r.rid}: {len(r.generated)} tokens, not "
                 f"{r.max_new_tokens} in-vocab tokens")
    ttft = sorted(r.metrics.ttft for r in reqs)
    n_tok = sum(len(r.generated) for r in reqs)
    log(f"[{label}] prompt lengths {[len(r.prompt) for r in reqs]}")
    log(f"[{label}] launches {launches}; decode_steps {eng.decode_steps}, "
        f"dispatches {eng.dispatches}, prefill_calls {eng.prefill_calls}, "
        f"scheduler ticks {sched.stats.decode_ticks}")
    log(f"[{label}] {len(reqs)} requests, {n_tok} tokens in {wall!r} s: "
        f"{n_tok / wall!r} tokens/s; TTFT p50 {float(np.median(ttft)) * 1e3!r} ms, "
        f"max {ttft[-1] * 1e3!r} ms; decode ticks {eng.decode_steps}; "
        f"dispatches {eng.dispatches}; peak memory {peak / 2**30!r} GiB")
    log(f"[{label}] admission trace {sched.stats.admission_trace}")
    return launches, wall


def _expect(label, launches, want: dict) -> None:
    """Exact launch counts: ``want`` maps op name → expected count; each
    listed op of the path must have launched at least once."""
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{label}: {name} launched {launches[name]} times, expected {n}")
    if not all(launches[name] > 0 for name, n in want.items() if n):
        fail(f"{label}: a kernel of the path never launched")


def phase_main_path(arch, params, device="cuda"):
    """The synchronous path: ``overlap=False``, paged engine."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16, device=device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2))
    launches, _wall = _drive("main", eng, sched, _requests(Request, arch.cfg.vocab_size),
                             device)
    prefills = eng.dispatches - eng.decode_steps
    if eng.decode_steps == 0 or prefills == 0:
        fail("the main path ran no decode step or no prefill")
    # One launch per layer per dispatch: decode ticks run the paged kernel,
    # prefill dispatches the flash kernel; nothing runs the dense decode.
    _expect("main", launches, {"paged_decode_attention": eng.decode_steps * L,
                               "flash_attention": prefills * L,
                               "decode_attention": 0, "ssd_scan": 0})
    _sync(device)
    return launches


def _count_calls(eng, name: str, weight=lambda *a: 1):
    """Wrap ``eng.<name>`` to count its calls (thread-safe); the count is
    in the returned list.  Instrumentation of this script only."""
    import threading
    inner, lock, box = getattr(eng, name), threading.Lock(), [0]

    def counted(*args):
        with lock:
            box[0] += weight(*args)
        return inner(*args)

    setattr(eng, name, counted)
    return box


def phase_async(arch, params, device="cuda", chunk: int = 256):
    """The paper's asynchronous path: ``overlap=True`` (prefills
    dispatched on the speculation thread, on the engine's own stream,
    while the main thread decodes), ``chunk_tokens`` (prompts longer than
    a chunk prefill their first chunk and feed the rest through the
    dense decode path, ``decode_attention``), and the paged engine's
    fused ticks (a chunk folded into the decode dispatch).  No fault
    domain: a speculation-thread exception re-raises."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16, device=device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2), overlap=True,
        chunk_tokens=chunk)
    n_prefill = _count_calls(eng, "_prefill")
    n_extend = _count_calls(eng, "_extend")
    # Tokens fed through the decode path: each is one decode_step, one
    # decode_attention launch per layer (chunks are batch 1).
    fed = _count_calls(eng, "_extend", lambda _c, toks, _l: int(toks.shape[1]))
    reqs = _async_requests(Request, arch.cfg.vocab_size)
    launches, wall = _drive("async", eng, sched, reqs, device)
    st = sched.stats
    whole = sum(max(0, min(len(r.prompt), eng.max_len - 1) - chunk) for r in reqs)
    log(f"[async] spec_dispatched {st.spec_dispatched}, spec_committed "
        f"{st.spec_committed}, spec_aborted {st.spec_aborted}, spec_chunks "
        f"{st.spec_chunks}, spec_crashes {st.spec_crashes}, fused_folds "
        f"{eng.fused_folds}; prefill dispatches {n_prefill[0]}, chunk extends "
        f"{n_extend[0]}, tokens through the decode path {fed[0]} (the long "
        f"prompts past their first chunk: {whole})")
    if st.spec_crashes != 0 or st.spec_chunks < 2 or eng.fused_folds < 1:
        fail("async: need spec_crashes == 0, spec_chunks >= 2, fused_folds >= 1")
    if fed[0] < whole:
        fail("async: the long prompts were not fed whole through the chunks")
    if eng.dispatches != (n_prefill[0] + n_extend[0] + eng.decode_steps
                          - eng.fused_folds):
        fail("async: dispatches != prefills + extends + ticks - fused folds")
    _expect("async", launches, {"paged_decode_attention": eng.decode_steps * L,
                                "flash_attention": n_prefill[0] * L,
                                "decode_attention": fed[0] * L, "ssd_scan": 0})
    _sync(device)
    return launches, wall


def phase_dense(arch, params, device="cuda"):
    """The dense engine as a second entry point: phase 4's requests, each
    decode tick one ``decode_step`` over the stacked lane cache."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = InferenceEngine(arch, params, n_lanes=8, max_prompt_len=256, max_len=512,
                          device=device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2))
    launches, _wall = _drive("dense", eng, sched, _requests(Request, arch.cfg.vocab_size),
                             device)
    _expect("dense", launches, {"decode_attention": eng.decode_steps * L,
                                "flash_attention": (eng.dispatches - eng.decode_steps) * L,
                                "paged_decode_attention": 0, "ssd_scan": 0})
    _sync(device)
    return launches


def _ssm_requests(Request, vocab: int, max_new: int = 32):
    """16 prompts of 300-2000 tokens from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = rng.integers(300, 2001, size=16)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(m)).astype(np.int32),
                    max_new_tokens=max_new) for i, m in enumerate(lens)]


def _ssm_async_requests(Request, vocab: int, max_new: int = 32):
    """14 prompts of 300-1000 tokens (template "chat") and 2 of 1056-1152
    (template "long", longer than the 1024-token chunk), interleaved, from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(300, 1001, size=14)]
    for at, n in zip((3, 9), rng.integers(1056, 1153, size=2)):
        lens.insert(at, -int(n))
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=abs(m)).astype(np.int32),
                    max_new_tokens=max_new, template="long" if m < 0 else "chat")
            for i, m in enumerate(lens)]


def _ssm_engine(arch, params, device="cuda"):
    from repro_torch.serving.engine import InferenceEngine
    return InferenceEngine(arch, params, n_lanes=8, max_prompt_len=2048, max_len=2080,
                           device=device)


def phase_ssm(arch, params, device="cuda"):
    """mamba2 on the synchronous path: every prefill dispatch runs the
    ``ssd_scan`` kernel once per layer, nothing else launches a kernel of
    the port (decode is the recurrent update, plain PyTorch)."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = _ssm_engine(arch, params, device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2))
    shapes = []  # the padded (batch, prompt) bucket of each prefill
    n_prefill = _count_calls(eng, "_prefill",
                             lambda toks, _p: shapes.append(tuple(toks.shape)) or 1)
    launches, wall = _drive("ssm", eng, sched, _ssm_requests(Request, arch.cfg.vocab_size),
                            device)
    if eng.decode_steps == 0 or n_prefill[0] == 0:
        fail("ssm: the path ran no decode step or no prefill")
    if eng.dispatches != n_prefill[0] + eng.decode_steps:
        fail("ssm: dispatches != prefills + decode ticks")
    log(f"[ssm] prefill dispatches {n_prefill[0]}, padded buckets {shapes}")
    _expect("ssm", launches, {"ssd_scan": n_prefill[0] * L, "flash_attention": 0,
                              "decode_attention": 0, "paged_decode_attention": 0})
    _sync(device)
    return launches, wall


def phase_ssm_async(arch, params, device="cuda", chunk: int = 1024):
    """mamba2 on the asynchronous path: ``overlap=True`` and
    ``chunk_tokens``; the long prompts prefill their first chunk (one
    ``ssd_scan`` launch a layer) and feed the rest through the recurrent
    decode, one host-issued ``decode_step`` a token."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = _ssm_engine(arch, params, device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2), overlap=True,
        chunk_tokens=chunk)
    n_prefill = _count_calls(eng, "_prefill")
    n_extend = _count_calls(eng, "_extend")
    fed = _count_calls(eng, "_extend", lambda _c, toks, _l: int(toks.shape[1]))
    reqs = _ssm_async_requests(Request, arch.cfg.vocab_size)
    launches, wall = _drive("ssm-async", eng, sched, reqs, device)
    st = sched.stats
    whole = sum(max(0, len(r.prompt) - chunk) for r in reqs)
    log(f"[ssm-async] spec_dispatched {st.spec_dispatched}, spec_committed "
        f"{st.spec_committed}, spec_aborted {st.spec_aborted}, spec_chunks "
        f"{st.spec_chunks}, spec_crashes {st.spec_crashes}; prefill dispatches "
        f"{n_prefill[0]}, chunk extends {n_extend[0]}, tokens through the decode "
        f"path {fed[0]} (the long prompts past their first chunk: {whole})")
    if st.spec_crashes != 0 or st.spec_chunks < 2 or fed[0] != whole:
        fail("ssm-async: need spec_crashes == 0, spec_chunks >= 2 and every "
             "long prompt's tail fed through the decode path")
    if eng.dispatches != n_prefill[0] + n_extend[0] + eng.decode_steps:
        fail("ssm-async: dispatches != prefills + extends + decode ticks")
    _expect("ssm-async", launches, {"ssd_scan": n_prefill[0] * L, "flash_attention": 0,
                                    "decode_attention": 0, "paged_decode_attention": 0})
    _sync(device)
    return launches, wall


# ----------------------------------------------------------------- phase 5
def _plain_ops():
    """Patch the model's two kernel ops with their plain versions (the
    comparison path only; the port itself has no such switch)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import paged_decode as pd_mod

    def plain_attention(q, k, v, *, causal=True, window=0):
        return attention_ref(q, k, v, causal=causal, window=window)

    return (mock.patch.object(attn_mod, "attention_op", plain_attention),
            mock.patch.object(pd_mod, "paged_decode_op", paged_decode_ref))


def phase_logits_check(arch, params, device="cuda"):
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.models.paged_decode import paged_decode_step
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    cfg = arch.cfg
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16, device=device)
    reqs = _requests(Request, cfg.vocab_size, n=8)
    staged = eng.prefill_dispatch(reqs)
    toks = torch.zeros(staged.shape, dtype=torch.int32, device=device)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = torch.as_tensor(r.prompt, device=device)
    rows = torch.arange(len(reqs), device=device)
    last = torch.as_tensor(staged.plens - 1, device=device).long()
    with torch.no_grad():
        kern = tf.prefill(cfg, params, toks, return_all_logits=True)[0][rows, last]
        p1, p2 = _plain_ops()
        with p1, p2:
            plain = tf.prefill(cfg, params, toks, return_all_logits=True)[0][rows, last]
    _report_logits("first prefill (flash kernel vs plain attention)", kern, plain)

    eng.commit_prefill(staged)
    for lane in range(eng.n_lanes):  # the first tick's write page
        eng._ensure_pages(lane, int(eng.lengths[lane]) // eng.page_size + 1)
    token = torch.as_tensor(eng.last_token, device=device)
    args = (eng._device_tables(), torch.as_tensor(eng.lengths, device=device),
            torch.as_tensor(eng.active, device=device))

    def clone(cache):
        return {n: {k: a.clone() for k, a in st.items()} for n, st in cache.items()}

    with torch.no_grad():
        kern, kc = paged_decode_step(cfg, params, token, clone(eng.cache), *args)
        p1, p2 = _plain_ops()
        with p1, p2:
            plain, pc = paged_decode_step(cfg, params, token, clone(eng.cache), *args)
    _report_logits("first decode tick (paged kernel vs plain paged attention)", kern, plain)
    diff = max(float((kc[n][k].float() - pc[n][k].float()).abs().max())
               for n in kc for k in kc[n])
    log(f"[check] first decode tick: page arrays max abs diff {diff!r}")
    _sync(device)


def phase_ssm_logits_check(arch, params, device="cuda"):
    """The first full-width mamba2 prefill (8 prompts right-padded to 8 x
    2048, as the engine pads them): logits at ``plens - 1`` through the
    ``ssd_scan`` kernel against the plain scan, same weights and batch.
    Both scans are the same float32 multiply and add per chunk, so the two
    paths should agree exactly; the gate allows 1e-3 x max |logit| and an
    argmax that differs only where the plain path's top two logits lie
    within twice the difference of each other (a tie)."""
    import torch
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf
    from repro_torch.serving.request import Request

    cfg = arch.cfg
    reqs = _ssm_requests(Request, cfg.vocab_size)[:8]
    plens = np.array([len(r.prompt) for r in reqs])
    toks = torch.zeros((8, 2048), dtype=torch.int32, device=device)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = torch.as_tensor(r.prompt, device=device)
    rows = torch.arange(8, device=device)
    last = torch.as_tensor(plens - 1, device=device).long()

    def plain_scan(states, decay, initial_state=None):
        return ssd_scan_ref(states, decay, initial_state)

    with torch.no_grad():
        kern = tf.prefill(cfg, params, toks, return_all_logits=True)[0][rows, last]
        with mock.patch.object(ssm_mod, "ssd_scan_op", plain_scan):
            plain = tf.prefill(cfg, params, toks, return_all_logits=True)[0][rows, last]
    if not bool(torch.isfinite(kern).all()):
        fail("mamba2 prefill: non-finite logits")
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    top2 = plain.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= 2 * diff
    agree = kern.argmax(-1) == plain.argmax(-1)
    log(f"[check] first mamba2 prefill (ssd_scan kernel vs plain scan): logits "
        f"{tuple(kern.shape)}, prompt lengths {plens.tolist()}, max abs diff {diff!r} "
        f"(max |logit| {scale!r}), argmax agreement {int(agree.sum())}/8")
    if diff > 1e-3 * scale or not bool((agree | tie).all()):
        fail("mamba2 prefill: kernel path and plain path disagree")
    _sync(device)


def _report_logits(label, kern, plain):
    import torch
    if not bool(torch.isfinite(kern).all()):
        fail(f"{label}: non-finite logits")
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    log(f"[check] {label}: logits {tuple(kern.shape)}, max abs diff {diff!r} "
        f"(max |logit| {scale!r}), argmax agreement {agree}/{kern.shape[0]}")
    # bf16 through 32 layers: the two attention paths round differently,
    # and random weights give near-flat logits whose top entries lie
    # closer together than that rounding, so exact agreement is not
    # expected.  On the H100 the difference reads about 0.017 x max |logit|;
    # a broken kernel moves every row well past the 0.05 gate.
    if agree < kern.shape[0] - 2 or diff > 0.05 * scale:
        fail(f"{label}: kernel path and plain path disagree")


def _window(label, fn, n):
    """``torch.profiler`` over ``n`` calls of ``fn``: logs the host wall
    time per call, the device busy time and share, and the kernels that
    take the most of it.  Returns ``[(kernel name, ms per call, launches
    per call)]`` (empty when the profiler recorded no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(ms for _k, ms, _c in rows)
    if busy == 0:
        log(f"[profile] {label}: {wall!r} ms wall; device time not measured "
            "(the profiler recorded no device activity)")
        return []
    log(f"[profile] {label}: {wall!r} ms wall, {busy!r} ms device busy "
        f"({busy / wall!r} busy share), {sum(c for *_r, c in rows)} kernels")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"[profile]   {ms!r} ms  x{count}  {key[:90]}")
    return rows


def phase_profile(arch, params, ticks: int = 8):
    """Where a decode tick's time goes at full width: host wall time per
    tick against the device time ``torch.profiler`` records (busy share),
    and the kernels that take the most device time; the same for one
    prefill dispatch of 8 prompts.  Runs after the main path, so its
    launches are not in the main path's counts."""
    import torch
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16)
    reqs = _requests(Request, arch.cfg.vocab_size, n=8)

    with torch.no_grad():
        # The dispatch runs on the engine's own stream; the window ends in
        # torch.cuda.synchronize(), which waits for it.
        _window("prefill dispatch of 8 prompts (bucket 8 x 256)",
                lambda: eng.prefill_dispatch(reqs), 1)
        eng.commit_prefill(eng.prefill_dispatch(reqs))
        for _ in range(2):
            eng.decode_tick()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.decode_tick()
        torch.cuda.synchronize()
        log(f"[profile] decode tick, 8 lanes, no profiler: "
            f"{(time.perf_counter() - t0) / ticks * 1e3!r} ms wall (mean of {ticks})")
        _window(f"decode tick, 8 lanes (mean of {ticks})", eng.decode_tick, ticks)
        # One fused tick of the asynchronous path: the 8 lanes' paged decode
        # plus a 64-token prompt chunk fed through the dense decode path.
        prompt = np.random.default_rng(2).integers(
            0, arch.cfg.vocab_size, size=320).astype(np.int32)
        staged = eng.prefill_dispatch([Request(rid=99, prompt=prompt)], chunk=256)
        torch.cuda.synchronize()
        if not eng.stage_chunk(staged):
            fail("profile: the fused tick declined the chunk")
        _window("fused tick, 8 lanes + a 64-token chunk", eng.decode_tick, 1)
    torch.cuda.synchronize()


def phase_ssm_profile(arch, params, ticks: int = 4):
    """One full-width mamba2 prefill dispatch of 8 prompts (bucket 8 x
    2048) and a few decode ticks under the profiler, with ``ssd_scan``'s
    share of the prefill's device time."""
    import torch
    from repro_torch.serving.request import Request

    eng = _ssm_engine(arch, params)
    reqs = _ssm_requests(Request, arch.cfg.vocab_size)[:8]
    with torch.no_grad():
        rows = _window("mamba2 prefill dispatch of 8 prompts (bucket 8 x 2048)",
                       lambda: eng.prefill_dispatch(reqs), 1)
        if rows:
            scan = [(ms, c) for k, ms, c in rows if "ssd_scan" in k]
            busy = sum(ms for _k, ms, _c in rows)
            log(f"[profile]   ssd_scan: {sum(ms for ms, _c in scan)!r} ms over "
                f"{sum(c for _ms, c in scan)} launches, "
                f"{sum(ms for ms, _c in scan) / busy!r} of the prefill's device time")
        eng.commit_prefill(eng.prefill_dispatch(reqs))
        for _ in range(2):
            eng.decode_tick()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.decode_tick()
        torch.cuda.synchronize()
        log(f"[profile] mamba2 decode tick, 8 lanes, no profiler: "
            f"{(time.perf_counter() - t0) / ticks * 1e3!r} ms wall (mean of {ticks})")
        _window(f"mamba2 decode tick, 8 lanes (mean of {ticks})", eng.decode_tick, ticks)
    torch.cuda.synchronize()


def _reduced_run(kind, arch, params, device):
    """One reduced-model serving run: ``kind`` is "paged" (phase 4's
    synchronous path), "dense" (the dense engine), "async" (paged,
    ``overlap=True``, ``chunk_tokens=8``, with prompts up to 30 tokens in
    their own template) or "dense-async" (the dense engine under the same
    overlap + chunk traffic).  Returns (per-request streams, counters)."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    rng = np.random.default_rng(1)
    lens = [int(n) for n in rng.integers(3, 17, size=6)]
    skw = {}
    if kind.startswith("dense"):
        eng = InferenceEngine(arch, params, n_lanes=4, max_prompt_len=16, max_len=48,
                              device=device)
    else:
        eng = PagedInferenceEngine(arch, params, n_lanes=4, max_prompt_len=16,
                                   max_len=48, page_size=8, device=device)
    if kind.endswith("async"):
        lens += [21, 30]
        skw = dict(overlap=True, chunk_tokens=8)
    reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=n).astype(np.int32),
                    max_new_tokens=24 if n <= 16 else 8,
                    template="long" if n > 16 else "default")
            for i, n in enumerate(lens)]
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2), **skw)
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    counters = {a: getattr(eng, a) for a in ("dispatches", "decode_steps",
                                             "prefill_calls", "kv_bytes_moved")}
    counters["fused_folds"] = getattr(eng, "fused_folds", None)
    counters["spec_chunks"] = sched.stats.spec_chunks
    return {r.rid: r.generated for r in reqs}, counters


def phase_reduced_check(name: str = "llama3-8b", kinds=("paged", "dense", "async")):
    """A reduced model in float32: served on the card through the kernels
    and on the CPU through the plain versions, same weights and traffic,
    on each path of ``kinds`` (llama3-8b: the paged synchronous path, the
    dense engine and the paged overlap + chunk path; mamba2: the dense
    engine, synchronous and overlap + chunk).  Per-request greedy streams
    and the engine's counters must be equal (float32 sums in another
    order differ by about 1e-6, far below the logit gaps argmax decides
    on; with one speculation bet in flight the scheduler joins it at every
    boundary, so overlap admits in a fixed order)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models.registry import get_arch

    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    cpu_params = arch.init(seed=0, device="cpu")
    card_params = _to(cpu_params, "cuda")
    for kind in kinds:
        registry.reset_launches()
        card = _reduced_run(kind, arch, card_params, "cuda")
        torch.cuda.synchronize()
        launched = registry.launch_counts()
        cpu = _reduced_run(kind, arch, cpu_params, "cpu")
        same = card == cpu
        log(f"[check] reduced {name} f32 {kind}, card (kernels) vs CPU (plain): "
            f"greedy streams and counters {'equal' if same else 'DIFFER'} "
            f"({sum(len(g) for g in card[0].values())} tokens, {card[1]}; "
            f"card launches {launched})")
        if not same:
            log(f"[check]   card {card}")
            log(f"[check]   cpu  {cpu}")
            fail(f"reduced {name}, {kind}: kernel path differs from the plain path")
        if kind == "async" and not (card[1]["fused_folds"] and card[1]["spec_chunks"] >= 2
                                    and launched["decode_attention"] > 0):
            fail("reduced model, async: no fused chunk tick or no decode_attention launch")
        if kind == "dense-async" and card[1]["spec_chunks"] < 2:
            fail(f"reduced {name}, dense-async: fewer than two chunks on the spec thread")
        if arch.cfg.family == "ssm" and launched["ssd_scan"] == 0:
            fail(f"reduced {name}, {kind}: the ssd_scan kernel never launched")
    torch.cuda.synchronize()


def _sync(device) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# -------------------------------------------------------------------- main
def main() -> None:
    smi, name = phase_card()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.models.registry import get_arch

    phase_build()
    timer = Timer()
    log(f"[kernels] on {smi}")
    rows = phase_kernels(timer)
    del timer
    torch.cuda.empty_cache()

    arch = get_arch("llama3-8b")
    t0 = time.perf_counter()
    params = arch.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(a.numel()) for a in _leaves(params))
    log(f"[main] llama3-8b full width: {arch.cfg.n_layers} layers, d_model "
        f"{arch.cfg.d_model}, {n_params} parameters in bf16, drawn from seed 0 "
        f"in {time.perf_counter() - t0!r} s")
    paths = {"main": phase_main_path(arch, params)}
    paths["async"], async_wall = phase_async(arch, params)
    paths["dense"] = phase_dense(arch, params)
    phase_logits_check(arch, params)
    phase_profile(arch, params)
    del params
    torch.cuda.empty_cache()

    arch = get_arch("mamba2-1.3b")
    t0 = time.perf_counter()
    params = arch.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(a.numel()) for a in _leaves(params))
    log(f"[ssm] on {smi}: mamba2-1.3b full width: {arch.cfg.n_layers} layers, d_model "
        f"{arch.cfg.d_model}, {n_params} parameters (bf16; A_log, D, dt_bias float32), "
        f"drawn from seed 0 in {time.perf_counter() - t0!r} s")
    paths["ssm"], ssm_wall = phase_ssm(arch, params)
    log(f"[ssm-async] on {smi}")
    paths["ssm-async"], ssm_async_wall = phase_ssm_async(arch, params)
    log(f"[check] on {smi}")
    phase_ssm_logits_check(arch, params)
    log(f"[profile] on {smi}")
    phase_ssm_profile(arch, params)
    del params
    torch.cuda.empty_cache()
    phase_reduced_check()
    phase_reduced_check("mamba2-1.3b", ("dense", "dense-async"))

    # Launches on the five paths, each counted from 0 in its own run.
    launches = {n: sum(p[n] for p in paths.values()) for n in rows}
    log(f"[paths] launches by path {paths}; async wall {async_wall!r} s, ssm wall "
        f"{ssm_wall!r} s, ssm-async wall {ssm_async_wall!r} s")
    kernels = [dict(name=n, launches=launches[n], **rows[n]) for n in sorted(rows)]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(smi)
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
