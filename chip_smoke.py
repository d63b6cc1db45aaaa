#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``:

1. card — ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build — compile every CUDA kernel of the serving path from
   ``src/repro_torch/csrc`` with ``nvcc`` (one process per source, in
   parallel) and time it;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes in bf16 and at a small ragged float32 shape, with
   the tolerance stated; its time, the plain version's, one library call's
   as a yardstick (never called by the port) and the least time the card
   could take (``bound_ms``);
4. main path — llama3-8b at full width (32 layers, bf16, weights drawn
   from seed 0 on the card) served through ``ContinuousBatchingScheduler``
   and ``PagedInferenceEngine``: 16 requests, 32 new tokens each.  Kernel
   launch counts are zeroed just before and read just after, and must be
   ``decode_steps * 32`` (paged decode) and ``prefill dispatches * 32``
   (flash attention);
5. checks — first prefill and first decode tick of the full-width model,
   kernel path against the plain path on the same weights and batch;
6. profile — ``torch.profiler`` over one full-width prefill dispatch and a
   few decode ticks: host wall time, device busy time and the kernels that
   take the most of it;
7. reduced check — the reduced llama3-8b in float32 served on the card
   with the kernels against the same model served on the CPU with the
   plain versions (greedy tokens and dispatches must be equal).

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

# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


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


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
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


def phase_kernels(timer):
    import torch
    import torch.nn.functional as F
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
    return rows


# ----------------------------------------------------------------- phase 4
def _requests(Request, vocab: int, n: int = 16, max_new: int = 32):
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 201, size=n)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(m)).astype(np.int32),
                    max_new_tokens=max_new) for i, m in enumerate(lens)]


def phase_main_path(arch, params, device="cuda"):
    import torch
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.kernels import registry
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    cfg = arch.cfg
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16, device=device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2))
    reqs = _requests(Request, cfg.vocab_size)
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
        if len(r.generated) != 32 or not all(0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"request {r.rid}: {len(r.generated)} tokens, not 32 in-vocab tokens")
    prefill_dispatches = eng.dispatches - eng.decode_steps
    log(f"[main] prompt lengths {[len(r.prompt) for r in reqs]}")
    log(f"[main] launches {launches}; decode_steps {eng.decode_steps}, "
        f"prefill dispatches {prefill_dispatches}, dispatches {eng.dispatches}, "
        f"prefill_calls {eng.prefill_calls}, scheduler ticks {sched.stats.decode_ticks}")
    # One launch per layer per dispatch: decode ticks run the paged kernel,
    # prefill dispatches the flash kernel.
    if launches["paged_decode_attention"] != eng.decode_steps * cfg.n_layers:
        fail("paged_decode_attention launches != decode_steps * n_layers")
    if launches["flash_attention"] != prefill_dispatches * cfg.n_layers:
        fail("flash_attention launches != prefill dispatches * n_layers")
    if eng.decode_steps == 0 or prefill_dispatches == 0:
        fail("the main path ran no decode step or no prefill")
    ttft = sorted(r.metrics.ttft for r in reqs)
    n_tok = sum(len(r.generated) for r in reqs)
    log(f"[main] {len(reqs)} requests, {n_tok} tokens in {wall!r} s: "
        f"{n_tok / wall!r} tokens/s; TTFT p50 {float(np.median(ttft)) * 1e3!r} ms, "
        f"max {ttft[-1] * 1e3!r} ms; decode ticks {eng.decode_steps}; "
        f"dispatches {eng.dispatches}; peak memory {peak / 2**30!r} GiB")
    log(f"[main] admission trace {sched.stats.admission_trace}")
    _sync(device)
    return launches


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
    # so exact agreement is not expected; a broken kernel moves every row.
    if agree < kern.shape[0] - 2 or diff > 0.25 * scale:
        fail(f"{label}: kernel path and plain path disagree")


def phase_profile(arch, params, ticks: int = 8):
    """Where a decode tick's time goes at full width: host wall time per
    tick against the device time ``torch.profiler`` records (busy share),
    and the kernels that take the most device time; the same for one
    prefill dispatch of 8 prompts.  Runs after the main path, so its
    launches are not in the main path's counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16)
    reqs = _requests(Request, arch.cfg.vocab_size, n=8)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def window(label, fn, n):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
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
            return
        log(f"[profile] {label}: {wall!r} ms wall, {busy!r} ms device busy "
            f"({busy / wall!r} busy share), {sum(c for *_r, c in rows)} kernels")
        for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
            log(f"[profile]   {ms!r} ms  x{count}  {key[:90]}")

    with torch.no_grad():
        window("prefill dispatch of 8 prompts (bucket 8 x 256)",
               lambda: eng.prefill_dispatch(reqs).first.cpu(), 1)
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
        window(f"decode tick, 8 lanes (mean of {ticks})", eng.decode_tick, ticks)
    torch.cuda.synchronize()


def phase_reduced_check():
    """Reduced llama3-8b in float32: served on the card through the kernels
    and on the CPU through the plain versions, same weights and traffic.
    Greedy tokens must be equal (float32 sums in another order differ by
    about 1e-6, far below the logit gaps argmax decides on)."""
    import torch
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.models.registry import get_arch
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    cpu_params = arch.init(seed=0, device="cpu")
    streams = {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, "cuda") if device == "cuda" else cpu_params
        eng = PagedInferenceEngine(arch, params, n_lanes=4, max_prompt_len=16,
                                   max_len=32, page_size=8, device=device)
        sched = ContinuousBatchingScheduler(
            eng, strategy=GrowingUpperThreshold(initial_upper=2))
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=int(n)).astype(np.int32),
                        max_new_tokens=24) for i, n in enumerate(rng.integers(3, 17, size=6))]
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        streams[device] = ([r.generated for r in reqs], eng.dispatches)
    same = streams["cuda"] == streams["cpu"]
    log(f"[check] reduced llama3-8b f32, card (kernels) vs CPU (plain): greedy streams "
        f"and dispatches {'equal' if same else 'DIFFER'} "
        f"({sum(len(g) for g in streams['cuda'][0])} tokens, "
        f"{streams['cuda'][1]} dispatches)")
    if not same:
        fail("reduced model: kernel path tokens differ from the plain path")
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
    launches = phase_main_path(arch, params)
    phase_logits_check(arch, params)
    phase_profile(arch, params)
    del params
    torch.cuda.empty_cache()
    phase_reduced_check()

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
