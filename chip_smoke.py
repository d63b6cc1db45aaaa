#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``:

1. card — ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build — compile the five CUDA kernels from ``src/repro_torch/csrc``
   with ``nvcc`` (one process per source, in parallel) and time it; log
   ``ptxas``' registers and spills of the three attention kernels and the
   gather, and the SASS instruction mix of their main-path instances;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes in bf16 and at a small ragged float32 shape (the
   ``ssd_scan`` kernel: mamba2-1.3b's prefill shape in float32 and the
   reference's sweep shapes in float32 and bf16; ``batched_gather``: the
   llama3-8b table and one training step's 4096 ids, N = 1, 16 steps'
   65536 ids and ragged shapes, bit for bit, timed against
   ``index_select`` at 4096 and 65536; ``flash_attention`` at the
   serving shape and the trainer's, both instances at ragged shapes, bf16
   at D 16 to 128; ``decode_attention`` at the dense engine's 8 lanes and
   the chunk side's 1; ``paged_decode_attention`` beside
   ``decode_attention`` on the same keys gathered dense, and the host time
   of one call of each), with the tolerance stated; a repeated call of
   any attention kernel must give the same bits; its time, the plain
   version's, one library call's as a yardstick where one exists (never
   called by the port) and the least time the card could take
   (``bound_ms``);
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
   that take the most of it, ``paged_decode_attention``'s device time in
   a decode tick and ``ssd_scan``'s share of the prefill;
7. reduced check — the reduced llama3-8b in float32 served on the card
   with the kernels against the same model served on the CPU with the
   plain versions, on the synchronous paged path, the dense engine and
   the overlap + chunk paged path; the reduced mamba2 the same way on the
   dense engine, synchronous and overlap + chunk (per-request greedy
   streams and the engine's counters must be equal);
8. train — the trainer at full width, after the serving phases: llama3-8b
   (bf16, depth cut to 4 of 32 layers, ``query_embedding=True``,
   ``remat=False``) through ``make_train_step(..., TrainStepConfig(
   microbatches=4, fission=True))``, 3 steps of 8 x 512 tokens from
   ``SyntheticLMStream`` through ``PrefetchLoader``, one more under the
   profiler, then one step with ``fission=False`` from the same weights:
   ``batched_gather`` = 1 launch per fissioned step and 4 per unfissioned
   step, ``flash_attention`` = 4 microbatches x 4 layers per step, finite
   losses, the first step's loss equal with and without fission; trace
   time, wall, tokens/s, loss, launches per step and peak memory printed;
9. train check — reduced llama3-8b in float32 trained 2 steps on the card
   and on the CPU, fissioned and not: losses, parameters and launch counts;
10. fission — the twin of ``benchmarks/bench_fission.py::device_fission``:
    2048 single-row queries on a 10000 x 256 float32 table, plain ``scan``
    (2048 launches) against ``fission_scan`` (1), both walls printed.

Any failure exits non-zero.  The last lines are the card's name and power
limit, the kernels' JSON line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
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
    for name in _SASS_OF:
        _compiler_report(build, name, libs[name])
    torch.cuda.synchronize()


# The instances whose SASS phase 2 summarises: the main path's ones (bf16;
# the gather's slices copy of int32 ids, as the trainer's tokens come).
_SASS_OF = {"flash_attention": "flash_wgmma_kernelILi128EE",
            "decode_attention": "decode_cluster_kernelI13__nv_bfloat16Li4ELi8E",
            "paged_decode_attention": "paged_cluster_kernelI13__nv_bfloat16Li4ELi8E",
            "batched_gather": "gather_slicesIiE"}


def _compiler_report(build, name, lib):
    """Log ``ptxas``' registers and spills for every kernel in ``name``'s
    library, and the SASS instruction mix of its main-path instance."""
    import re
    kernel = None
    for line in build.ptxas_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_wgmma_kernel|flash_kernel|decode_cluster_kernel|"
                          r"paged_cluster_kernel|gather_rows|gather_slices)(I\w*?)EEv",
                          m.group(1))
            kernel = k.group(1) + k.group(2) if k else m.group(1)
        elif "spill" in line or "registers" in line:
            log(f"[build] ptxas {name}: {kernel}: {line.split(':', 1)[-1].strip()}")
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        log(f"[build] SASS {name}: cuobjdump not found")
        return
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    for func in sass.split("Function : ")[1:]:
        if _SASS_OF[name] not in func.split("\n", 1)[0]:
            continue
        ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", func,
                         flags=re.M)
        counts = sorted(((ops.count(o), o) for o in set(ops)), reverse=True)
        log(f"[build] SASS {name} {_SASS_OF[name]}: {len(ops)} instructions; HGMMA "
            f"{ops.count('HGMMA')}, UTMALDG {ops.count('UTMALDG')}; "
            + ", ".join(f"{o} {c}" for c, o in counts[:16]))


# ----------------------------------------------------------------- phase 3
class Timer:
    """Median device time of one call, from CUDA events around each call,
    with the 50 MB L2 flushed before each so the call finds its operands
    in device memory, as it does on the serving path.  A spin kernel of
    about 1 ms (``torch.cuda._sleep``) runs before each start event, so
    the device is still busy while the host issues the call: the events
    time the device work, not the host's enqueue latency."""

    SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz boost clock

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
            torch.cuda._sleep(self.SPIN_CYCLES)
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


def _repeat(name, fn, first) -> None:
    """A second call gives the same bits as the first (no atomics, fixed
    summation order)."""
    import torch
    again = fn()
    torch.cuda.synchronize()
    same = torch.equal(again, first)
    log(f"[kernels] {name}: a repeated call is bit-identical: {same}")
    if not same:
        fail(f"{name}: two calls on the same inputs differ")


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
    from repro_torch.kernels.flash_attention.ops import attention_op, flash_attention_cuda
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
    _repeat("paged_decode_attention", lambda: paged_decode_attention_cuda(*args), out)
    q, kp, vp, tabs, lens = args
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
    # Yardstick, not a gate: the dense kernel on the same keys gathered
    # into a (B, NP * ps, Hkv, D) cache, the same lengths.
    kd, vd = (x[tabs.long()].reshape(8, 32 * 16, 8, 128) for x in (kp, vp))
    _compare("decode_attention on the paged case's keys, gathered dense, vs paged plain",
             decode_attention_cuda(q, kd, vd, lens), paged_decode_ref(*args), 1e-2, 1e-2)
    log(f"[kernels] paged_decode_attention yardstick: decode_attention_cuda on the same "
        f"keys and lengths {timer.ms(lambda: decode_attention_cuda(q, kd, vd, lens))!r} ms")
    # Host time of one call (the wrapper, the tensor maps' encoding and the
    # launch), the device left busy so no call waits for it.
    for name, fn in (("paged_decode_attention_cuda", lambda: paged_decode_attention_cuda(*args)),
                     ("decode_attention_cuda", lambda: decode_attention_cuda(q, kd, vd, lens))):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(Timer.SPIN_CYCLES * 20)
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_us = (time.perf_counter() - t0) / 100 * 1e6
        torch.cuda.synchronize()
        log(f"[kernels] {name}: host time per call {host_us!r} us (mean of 100, enqueue only)")
    del kd, vd
    torch.cuda.synchronize()

    # -- flash attention (causal prefill), same tolerances and reasons.  Two
    # hand-written instances (``ops._instance``): bf16 at D 64 and 128 on the
    # tensor cores, float32 and bf16 at D 16 and 32 on the CUDA cores.
    from repro_torch.kernels.flash_attention.ops import _TENSOR_CORES, _aligned, _instance
    hq, hkv, d = 32, 8, 128
    timed = {}
    for label, b, s in (("serving", 8, 256), ("trainer", 2, 512)):
        fq, fk, fv = _flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
        if _instance(fq.dtype, d, _aligned(fq, fk, fv, fq)) != _TENSOR_CORES:
            fail("flash_attention: the main path's bf16 shape is not on the tensor cores")
        out = flash_attention_cuda(fq, fk, fv, causal=True)
        ref = attention_ref(fq, fk, fv, causal=True)
        err = _compare(f"flash_attention bf16 ({label}) B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
                       "causal", out, ref, 1e-2, 1e-2)
        _repeat("flash_attention", lambda: flash_attention_cuda(fq, fk, fv, causal=True), out)
        nbytes = 2 * (fq.numel() * 2 + fk.numel() + fv.numel())  # q, k, v in; out
        flops = 4 * b * hq * d * (s * (s + 1) // 2)                # causal QK and PV
        bound, by = _bound(nbytes, flops)

        def library(fq=fq, fk=fk, fv=fv):
            return F.scaled_dot_product_attention(fq, fk, fv, is_causal=True,
                                                  enable_gqa=True)

        _compare(f"scaled_dot_product_attention (yardstick, {label}) vs plain", library(),
                 ref, 1e-2, 1e-2)
        timed[label] = dict(
            route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:86",
            max_abs_err=err,
            ms=timer.ms(lambda: flash_attention_cuda(fq, fk, fv, causal=True)),
            plain_ms=timer.ms(lambda: attention_ref(fq, fk, fv, causal=True)),
            bound_ms=bound, bound_by=by, library_ms=timer.ms(library))
        log(f"[kernels] flash_attention ({label}): {timed[label]}")
        if label == "serving":
            # The op the model calls (the custom op around the kernel): its
            # first call pays torch.library's one-time set-up, which would
            # otherwise land in the first serving path's first prefill.
            t0 = time.perf_counter()
            op_out = attention_op(fq, fk, fv, causal=True)
            torch.cuda.synchronize()
            log(f"[kernels] flash_attention custom op, first call: "
                f"{time.perf_counter() - t0!r} s (one-time torch.library set-up)")
            if not torch.equal(op_out, out):
                fail("flash_attention: the custom op differs from the kernel it wraps")
        else:
            _compare(f"flash_attention bf16 (trainer) B={b} S={s} custom op",
                     attention_op(fq, fk, fv, causal=True), ref, 1e-2, 1e-2)
        del fq, fk, fv, out, ref
    # Both instances at ragged shapes: bf16 on the tensor cores (D 64, 128)
    # and on the CUDA cores (D 16, 32), float32 on the CUDA cores.
    for dtype, tol, shapes in (
            (torch.bfloat16, 1e-2, ((2, 4, 2, 77, 64), (1, 8, 2, 130, 128), (3, 4, 1, 65, 16),
                                    (2, 4, 2, 63, 32))),
            (torch.float32, 1e-4, ((2, 4, 2, 77, 64), (1, 8, 2, 130, 128)))):
        for (sb, shq, shkv, ss, sd) in shapes:
            sq, sk, sv = _flash_case(gen, sb, shq, shkv, ss, sd, dtype)
            for causal in (True, False):
                _compare(f"flash_attention {str(dtype)[6:]} ragged B={sb} Hq={shq} Hkv={shkv} "
                         f"S={ss} D={sd} causal={causal} (instance "
                         f"{_instance(dtype, sd)})",
                         flash_attention_cuda(sq, sk, sv, causal=causal),
                         attention_ref(sq, sk, sv, causal=causal), tol, tol)
    rows["flash_attention"] = timed["serving"]  # the trainer's row is logged above
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
        _repeat("decode_attention", lambda: decode_attention_cuda(dq, dk, dv, dlen), out)
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
    rows["decode_attention"] = timed["dense engine"]  # the chunk side's is logged above
    torch.cuda.synchronize()
    rows["ssd_scan"] = _ssd_scan_kernel(timer, gen)
    rows["batched_gather"] = _batched_gather_kernel(timer, gen)
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


def _batched_gather_kernel(timer, gen):
    """The ``batched_gather`` kernel against its plain version, bit for bit
    (tolerance 0: both copy the rows' bytes), at the training shape (the
    llama3-8b table, 128256 x 4096 bf16, and the 4096 ids of one
    ``SyntheticLMStream`` step, 8 x 512 tokens), at N = 1 (the
    unfissioned per-microbatch form is N = 1024; N = 1 is the fission
    phase's per-iteration query), at 16 steps' ids (N = 65536, an output
    the L2 cannot hold) and at ragged shapes that take the scalar path.
    The plain version is one library call (``index_select``) and a
    reshape, so plain_ms and library_ms time the same function."""
    import torch
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.kernels.batched_gather.ops import batched_gather_cuda
    from repro_torch.kernels.batched_gather.ref import gather_ref

    def check(label, table, ids):
        got = batched_gather_cuda(table, ids)
        torch.cuda.synchronize()
        want = gather_ref(table, ids)
        same = (got.shape == want.shape and got.dtype == want.dtype
                and torch.equal(got, want))
        err = float((got.float() - want.float()).abs().max()) if same else float("nan")
        log(f"[kernels] batched_gather {label}: max_abs_err {err!r} (tolerance 0: "
            f"bit-exact) {'ok' if same else 'MISMATCH'}")
        if not same:
            fail(f"batched_gather {label}: kernel differs from its plain version")
        return err

    V, D = 128256, 4096
    table = torch.randn((V, D), generator=gen, device="cuda").to(torch.bfloat16)
    toks = SyntheticLMStream(V, seq_len=512, batch=8, seed=0).batch_at(0)["tokens"]
    ids = torch.as_tensor(toks.reshape(-1), device="cuda")
    err = check(f"bf16 V={V} D={D} N={ids.numel()} (training step)", table, ids)
    check("bf16 N=1", table, ids[:1])
    check("bf16 int64 ids (8, 512)", table, ids.long().reshape(8, 512))
    for (v, d, n, dtype) in ((1000, 8, 7, torch.float32), (1000, 64, 4095, torch.float32),
                             (977, 7, 33, torch.bfloat16), (64, 3, 1, torch.float32)):
        small = torch.randn((v, d), generator=gen, device="cuda").to(dtype)
        sid = torch.randint(0, v, (n,), generator=gen, device="cuda", dtype=torch.int32)
        check(f"{str(dtype)[6:]} ragged V={v} D={d} N={n}", small, sid)

    def timed(idx):
        # The stream's ids are Zipf-distributed (348 distinct among one
        # step's 4096): a row is read from device memory once and from L2
        # after, so the bound counts each distinct row read once, every
        # output row written once, and the ids.
        n, distinct = idx.numel(), int(torch.unique(idx).numel())
        bound, by = _bound((distinct + n) * D * 2 + 4 * n, 0)
        return dict(ms=timer.ms(lambda: batched_gather_cuda(table, idx)),
                    plain_ms=timer.ms(lambda: gather_ref(table, idx)),
                    bound_ms=bound, bound_by=by,
                    library_ms=timer.ms(lambda: torch.index_select(table, 0, idx)))

    one = timed(ids[:1])
    log(f"[kernels] batched_gather N=1 (one query per iteration): {one}")
    row = dict(route="cuda", source="src/repro_torch/csrc/batched_gather.cu",
               replaces="src/repro/kernels/batched_gather/kernel.py:72", max_abs_err=err,
               **timed(ids))
    log(f"[kernels] batched_gather N={ids.numel()} (library_ms: index_select, which is "
        f"also the plain version): {row}")
    log(f"[kernels] batched_gather N={ids.numel()}: {int(torch.unique(ids).numel())} "
        f"distinct rows; ms / bound {row['ms'] / row['bound_ms']!r}; bound / ms "
        f"{row['bound_ms'] / row['ms']!r}")
    # The step's 33.6 MB output fits in the 50 MB L2, whose write-back may
    # outlast the end event; 16 steps' ids write 537 MB, which it cannot hold.
    many = torch.as_tensor(np.concatenate([
        SyntheticLMStream(V, seq_len=512, batch=8, seed=0).batch_at(k)["tokens"].reshape(-1)
        for k in range(16)]), device="cuda")
    check(f"bf16 N={many.numel()} (16 steps' ids)", table, many)
    big = timed(many)
    log(f"[kernels] batched_gather N={many.numel()} (output beyond L2, "
        f"{int(torch.unique(many).numel())} distinct rows): {big}; "
        f"ms / bound {big['ms'] / big['bound_ms']!r}")
    del many
    del table
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
        rows = _window(f"decode tick, 8 lanes (mean of {ticks})", eng.decode_tick, ticks)
        paged = [(ms, c) for key, ms, c in rows if "paged_cluster_kernel" in key]
        log(f"[profile] decode tick: paged_decode_attention {sum(ms for ms, _c in paged)!r} "
            f"ms device time in {sum(c for _ms, c in paged)} launches per tick")
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


# ----------------------------------------------------------------- phase 8
TRAIN_LAYERS = 4  # of llama3-8b's 32: what the step's state leaves room for


def _train_run(arch, params, fission: bool, steps: int, mb: int, batch: int, seq: int,
               profile: bool = False):
    """``steps`` train steps of ``arch`` from ``params`` (written in place:
    the step donates them), ``AdamWConfig(lr=1e-3)``, ``microbatches=mb``,
    on ``SyntheticLMStream(vocab, seq, batch, seed=0)`` through
    ``PrefetchLoader``, on the device of ``params``.  Returns (losses,
    per-step walls, per-step launch counts, per-step fission trace seconds,
    peak device memory, final params).  ``profile``: one more step after
    those, under ``torch.profiler`` (``_window``), outside every count."""
    import torch
    from repro_torch.core import fission as fission_mod
    from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMStream
    from repro_torch.kernels import registry
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    traced, real_trace = [], fission_mod.trace_body

    def timed_trace(*args, **kwargs):  # this script's instrumentation only
        t0 = time.perf_counter()
        out = real_trace(*args, **kwargs)
        traced.append(time.perf_counter() - t0)
        return out

    device = next(_leaves(params)).device.type
    init_state, step = make_train_step(arch, AdamWConfig(lr=1e-3),
                                       TrainStepConfig(microbatches=mb, fission=fission))
    state = init_state(params)
    loader = iter(PrefetchLoader(SyntheticLMStream(arch.cfg.vocab_size, seq_len=seq,
                                                   batch=batch, seed=0),
                                 n_prefetch=2, max_steps=steps + int(profile)))
    losses, walls, launches, traces = [], [], [], []
    _sync(device)
    if device == "cuda":
        log(f"[train] device memory allocated before the first step (weights and "
            f"AdamW moments): {torch.cuda.memory_allocated() / 2**30!r} GiB")
        torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(fission_mod, "trace_body", timed_trace):
        for _, b in zip(range(steps), loader):
            registry.reset_launches()
            del traced[:]
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, b)
            losses.append(float(metrics["loss"]))
            _sync(device)
            walls.append(time.perf_counter() - t0)
            launches.append(registry.launch_counts())
            traces.append(sum(traced))
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if profile:
        b = next(loader)
        _window(f"one more train step, fission={fission}",
                lambda: step(params, state, b), 1)
    return losses, walls, launches, traces, peak, params


def _train_gates(label, launches, fission: bool, mb: int, layers: int) -> None:
    """Per step: ``batched_gather`` once when fissioned, once per microbatch
    otherwise; ``flash_attention`` once per layer per microbatch (its
    backward runs the plain version); no serving kernel."""
    for i, got in enumerate(launches):
        _expect(f"{label} step {i}", got, {
            "batched_gather": 1 if fission else mb, "flash_attention": mb * layers,
            "paged_decode_attention": 0, "decode_attention": 0, "ssd_scan": 0})


def phase_train(smi, steps: int = 3, mb: int = 4, batch: int = 8, seq: int = 512):
    """The trainer at full width: llama3-8b (d_model 4096, 32 q / 8 kv
    heads, hd 128, d_ff 14336, vocab 128256, bf16), depth cut to
    ``TRAIN_LAYERS`` of 32, ``query_embedding=True``, ``remat=False``,
    through ``make_train_step(..., TrainStepConfig(microbatches=4,
    fission=True))``: ``steps`` steps and one more under the profiler, then
    one unfissioned step from the same weights (seed 0).  Gates: launches per step (``_train_gates``),
    finite losses, and the first step's loss equal with and without
    fission to 1e-5 relative (the forward is the same ops on the same
    rows; only the gradients differ, since the embedding's scatter-add
    uses atomics, so later steps are not compared)."""
    import torch
    from repro_torch.models.registry import get_arch

    arch = get_arch("llama3-8b")
    full = arch.cfg.n_layers
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=TRAIN_LAYERS, query_embedding=True, remat=False))
    tokens = batch * seq
    out = {}
    for label, fission, n in (("train", True, steps), ("train-plain", False, 1)):
        losses, walls, launches, traces, peak, params = _train_run(
            arch, arch.init(seed=0, device="cuda"), fission, n, mb, batch, seq,
            profile=fission)
        n_params = sum(int(a.numel()) for a in _leaves(params))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{label}] on {smi}: llama3-8b full width, depth cut to {TRAIN_LAYERS} of "
            f"{full} layers ({n_params} parameters, bf16, seed 0), query_embedding, "
            f"fission={fission}, {mb} microbatches of {batch // mb} x {seq} tokens")
        for i in range(n):
            log(f"[{label}] step {i}: loss {losses[i]!r}, wall {walls[i]!r} s "
                f"(fission trace {traces[i]!r} s), {tokens / walls[i]!r} tokens/s, "
                f"launches {launches[i]}")
        log(f"[{label}] peak device memory {peak / 2**30!r} GiB")
        if not all(np.isfinite(losses)):
            fail(f"{label}: a loss is not finite: {losses}")
        _train_gates(label, launches, fission, mb, TRAIN_LAYERS)
        out[label] = (losses, launches)
    first_f, first_p = out["train"][0][0], out["train-plain"][0][0]
    log(f"[train] first-step loss with fission {first_f!r}, without {first_p!r}, "
        f"difference {abs(first_f - first_p)!r} (gate 1e-5 relative)")
    if abs(first_f - first_p) > 1e-5 * abs(first_p):
        fail("train: the first step's loss differs with and without fission")
    torch.cuda.synchronize()
    return {label: {k: sum(c[k] for c in launches) for k in launches[0]}
            for label, (_losses, launches) in out.items()}


def phase_train_reduced(name: str = "llama3-8b", steps: int = 2, mb: int = 4):
    """Reduced llama3-8b in float32 with ``query_embedding``: ``steps``
    train steps on the card (kernels) and on the CPU (plain versions),
    fissioned and not, same weights and batches.  Losses and parameters
    must agree to 1e-4 (float32 sums in another order, about 1e-6 per op)
    and the card's launches must be ``_train_gates``' counts."""
    import torch
    from repro_torch.models.registry import get_arch

    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg.reduced(), query_embedding=True))
    params = arch.init(seed=0, device="cpu")
    for fission in (False, True):
        card = _train_run(arch, _to(params, "cuda"), fission, steps, mb, 8, 16)
        cpu = _train_run(arch, _clone(params), fission, steps, mb, 8, 16)
        dloss = max(abs(a - b) for a, b in zip(card[0], cpu[0]))
        dparam = max(float((a.cpu() - b).abs().max())
                     for a, b in zip(_leaves(card[5]), _leaves(cpu[5])))
        log(f"[check] reduced {name} f32 train, fission={fission}, card vs CPU: losses "
            f"{card[0]} / {cpu[0]}, max difference {dloss!r}; parameters after {steps} "
            f"steps max difference {dparam!r}; card launches {card[2]}")
        if dloss > 1e-4 or dparam > 1e-4:
            fail(f"reduced {name} train, fission={fission}: card differs from CPU")
        _train_gates(f"reduced train fission={fission}", card[2], fission, mb,
                     arch.cfg.n_layers)
    torch.cuda.synchronize()


def phase_fission(v: int = 10_000, d: int = 256, n: int = 2048, device: str = "cuda"):
    """The port's twin of ``benchmarks/bench_fission.py::device_fission``
    at its full size: a loop of ``n`` iterations, each gathering one row of
    a (v, d) float32 table and adding its sum to the carry, run as the
    plain ``scan`` (one ``batched_gather`` launch per iteration) and
    through ``fission_scan`` (one launch).  Results must agree to 1e-4
    relative, as in the benchmark."""
    import torch
    from repro_torch.core.fission import fission_scan, scan
    from repro_torch.core.query import async_query, table_gather_spec
    from repro_torch.kernels import registry

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    table = torch.randn((v, d), generator=gen, device=device)
    ids = ((torch.arange(n, device=device) * 37) % v).to(torch.int32)

    def body(c, i):
        return c + async_query(table_gather_spec, table, i).sum(), None

    res = {}
    for label, fn in (("scan", scan), ("fission_scan", fission_scan), ("scan", scan),
                      ("fission_scan", fission_scan)):
        registry.reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        c, _ = fn(body, torch.zeros((), device=device), ids)
        _sync(device)
        res.setdefault(label, []).append(
            (float(c), time.perf_counter() - t0, registry.launch_counts()["batched_gather"]))
    log(f"[fission] table {v} x {d} f32, {n} iterations, (result, wall s, batched_gather "
        f"launches) in turns: {res}")
    for label, want in (("scan", n), ("fission_scan", 1)):
        if any(k != want for _c, _w, k in res[label]):
            fail(f"fission: {label} launched batched_gather {res[label]}, expected {want}")
    a, b = res["scan"][0][0], res["fission_scan"][0][0]
    if not abs(a - b) <= 1e-4 * abs(a):
        fail(f"fission: scan {a!r} and fission_scan {b!r} differ beyond 1e-4 relative")
    log(f"[fission] wall: scan {res['scan'][1][1]!r} s, fission_scan "
        f"{res['fission_scan'][1][1]!r} s (second turn of each)")
    _sync(device)


def _sync(device) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


# -------------------------------------------------------------------- main
def main() -> None:
    t_start = time.perf_counter()
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
    gc.collect()  # engines and their threads can hold the weights in cycles
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
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(phase_train(smi))
    phase_reduced_check()
    phase_reduced_check("mamba2-1.3b", ("dense", "dense-async"))
    log(f"[check] on {smi}")
    phase_train_reduced()
    log(f"[fission] on {smi}")
    phase_fission()

    # Launches on the serving paths and the two training runs, each counted
    # from 0 in its own run.
    launches = {n: sum(p[n] for p in paths.values()) for n in rows}
    log(f"[paths] launches by path {paths}; async wall {async_wall!r} s, ssm wall "
        f"{ssm_wall!r} s, ssm-async wall {ssm_async_wall!r} s")
    kernels = [dict(name=n, launches=launches[n], **rows[n]) for n in sorted(rows)]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[total] {time.perf_counter() - t_start!r} s, kernel builds included")
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
