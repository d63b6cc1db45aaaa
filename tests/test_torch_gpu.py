"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

Run on a machine with a card and nvcc (the kernels build on first use):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors.  Tolerances: float32, 1e-4 (sums and exponentials in another
order, observed about 1e-6); bf16, 1e-2 (both sides accumulate in float32
and round once to bf16, one bf16 ulp of an O(1) value).  The ``ssd_scan``
kernel does the plain version's float32 multiply and add per chunk,
without FMA contraction: float32 1e-6 (a few ulps), its bf16 ``prev``
2^-7 relative (one bf16 ulp of its rounding; the plain version keeps
``prev`` in float32).  This file imports no JAX: the machine with the
card has none.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import registry
from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_ref
from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention.ops import paged_decode_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_decode_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda, ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _paged(gen, b, hq, hkv, d, ps, np_, dtype, lengths):
    n_pages = b * np_ + 1
    rng = np.random.default_rng(0)
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda").to(dtype)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(b, np_).astype(np.int32)
    return (q, kp, vp, torch.as_tensor(tables, device="cuda"),
            torch.as_tensor(np.asarray(lengths, np.int32), device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 8, 128, 16, 32), (3, 4, 2, 64, 16, 5),
                                   (2, 8, 1, 32, 8, 3)])
def test_paged_kernel_matches_plain(gen, dtype, shape):
    b, hq, hkv, d, ps, np_ = shape
    lengths = [0] + [int(x) for x in np.linspace(1, np_ * ps, b - 1)]
    args = _paged(gen, b, hq, hkv, d, ps, np_, dtype, lengths)
    before = paged_decode_attention_cuda.launches
    out = paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.launches == before + 1
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert not out[0].any()  # the length-0 lane: zeros, never NaN
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), paged_decode_ref(*args).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(8, 32, 8, 256, 128), (2, 4, 2, 77, 64),
                                   (1, 8, 2, 130, 128), (3, 2, 1, 1, 16), (1, 4, 4, 65, 32)])
def test_flash_kernel_matches_plain(gen, dtype, causal, shape):
    """Any S (ragged edges masked), GQA, the model's strided (B, S, H, D)
    buffers viewed as (B, H, S, D)."""
    b, hq, hkv, s, d = shape
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
               for h in (hq, hkv, hkv))
    out = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, causal=causal).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [77, 130, 512])
@pytest.mark.parametrize("shape", [(1, 32, 8, 128), (8, 32, 8, 128), (3, 4, 2, 64),
                                   (2, 16, 1, 16)])
def test_decode_kernel_matches_plain(gen, dtype, t, shape):
    """Any T (no block size that must divide it), GQA groups of 4, 2 and
    16, lengths 0 (zeros, never NaN), 1, T and ragged values between."""
    b, hq, hkv, d = shape
    lengths = ([0, 1, t] + [int(x) for x in np.linspace(2, t - 1, max(b - 3, 0))])[:b]
    if b == 1:
        lengths = [t - 5]
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    before = decode_attention_cuda.launches
    out = decode_attention_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and bool(torch.isfinite(out).all())
    if 0 in lengths:
        assert not out[lengths.index(0)].any()
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), decode_ref(q, k, v, lens).float(),
                               rtol=tol, atol=tol)


def test_decode_kernel_refuses_operands_outside_supports(gen):
    """Strided caches, a group of 32 query heads, mixed dtypes and float
    lengths raise ValueError on the card; nothing is launched."""
    q = torch.zeros((2, 8, 64), device="cuda")
    k = torch.zeros((2, 40, 2, 64), device="cuda")
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    registry.reset_launches()
    bad = [
        (q, k.transpose(1, 2).contiguous().transpose(1, 2), k, lens),  # strided cache
        (torch.zeros((2, 64, 64), device="cuda"), k, k, lens),         # G = 32
        (q.bfloat16(), k, k, lens),                                     # mixed dtypes
        (q, k, k, lens.float()),                                        # float lengths
        (torch.zeros((2, 8, 512), device="cuda"),
         torch.zeros((2, 40, 2, 512), device="cuda"),
         torch.zeros((2, 40, 2, 512), device="cuda"), lens),           # D > 256
    ]
    for args in bad:
        with pytest.raises(ValueError):
            registry.dispatch("decode_attention", args)
    assert registry.launch_counts() == {n: 0 for n in registry.names()}


def test_head_keeps_float32_accumulators(gen):
    """bf16 logits on the card are the float32 product of the bf16
    operands (``torch.mm`` with ``out_dtype``), not a bf16-rounded one."""
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_arch

    cfg = get_arch("llama3-8b").cfg
    x = torch.randn((2, 3, 512), generator=gen, device="cuda").bfloat16()
    w = torch.randn((512, 1000), generator=gen, device="cuda").bfloat16()
    cfg = dataclasses.replace(cfg, d_model=512, vocab_size=1000)
    got = transformer._head(cfg, {"lm_head": {"w": w}}, x)
    assert got.dtype == torch.float32
    want = torch.matmul(x.double(), w.double()).float()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_cuda_operands_never_fall_back(gen):
    """An unsupported operand on the card raises; it does not run the plain
    version."""
    q = torch.zeros((1, 4, 16, 48), device="cuda")
    k = torch.zeros((1, 2, 16, 48), device="cuda")
    registry.reset_launches()
    with pytest.raises(ValueError):
        registry.dispatch("flash_attention", (q, k, k))
    q, k = q[..., :32], k[..., :32].contiguous()
    with pytest.raises(ValueError):
        registry.dispatch("flash_attention", (q.contiguous(), k, k), common={"window": 8})
    assert registry.launch_counts() == {n: 0 for n in registry.names()}


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["paged", "dense", "async"])
def test_reduced_model_served_on_card_matches_cpu(gen, kind):
    """Reduced llama3-8b in float32: greedy streams and dispatches through
    the kernels on the card equal the plain versions on the CPU, on the
    synchronous paged path, the dense engine and the paged engine under
    ``overlap=True`` with chunked prefill (prompts up to 30 tokens)."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.models.registry import get_arch
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    cpu_params = arch.init(seed=0, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, device)
        if kind == "dense":
            eng = InferenceEngine(arch, params, n_lanes=3, max_prompt_len=16, max_len=48,
                                  device=device)
        else:
            eng = PagedInferenceEngine(arch, params, n_lanes=3, max_prompt_len=16,
                                       max_len=48, page_size=8, device=device)
        skw = dict(overlap=True, chunk_tokens=6) if kind == "async" else {}
        sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2),
                                            **skw)
        rng = np.random.default_rng(1)
        lens = [int(n) for n in rng.integers(3, 17, size=5)] + [23, 30]
        reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=n).astype(np.int32),
                        max_new_tokens=12, template="long" if n > 16 else "short")
                for i, n in enumerate(lens)]
        registry.reset_launches()
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        out[device] = ({r.rid: r.generated for r in reqs}, eng.dispatches,
                       registry.launch_counts())
    assert out["cuda"][:2] == out["cpu"][:2]
    launched = out["cuda"][2]
    assert launched["flash_attention"] > 0
    if kind in ("dense", "async"):
        assert launched["decode_attention"] > 0
    if kind != "dense":
        assert launched["paged_decode_attention"] > 0
    assert out["cpu"][2] == {n: 0 for n in registry.names()}


# ---------------------------------------------------------------- ssd_scan

SCAN_TOLS = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}


def _scan(gen, shape, dtype):
    b, c, h = shape[:3]
    states = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    decay = torch.sigmoid(torch.randn((b, c, h), generator=gen, device="cuda"))
    return states, decay


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 8, 64, 64, 128), (2, 8, 4, 16, 32), (1, 16, 2, 8, 8),
                                   (3, 4, 5, 32, 16), (1, 32, 1, 64, 64), (8, 1, 64, 64, 128),
                                   (2, 1, 3, 5, 7)])
def test_ssd_scan_kernel_matches_plain(gen, dtype, shape):
    """mamba2-1.3b's prefill shape, the reference's sweep shapes, one
    chunk (C = 1), and P * N = 35 (a ragged last block)."""
    states, decay = _scan(gen, shape, dtype)
    before = ssd_scan_cuda.launches
    prev, final = ssd_scan_cuda(states, decay)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 1
    assert prev.dtype == dtype and prev.shape == states.shape
    assert final.dtype == torch.float32 and final.shape == shape[:1] + shape[2:]
    assert bool(torch.isfinite(prev).all()) and bool(torch.isfinite(final).all())
    assert not prev[:, 0].any()  # the state entering the first chunk is zero
    rprev, rfinal = ssd_scan_ref(states, decay)
    tol = SCAN_TOLS[dtype]
    torch.testing.assert_close(prev.float(), rprev, rtol=tol, atol=1e-6)
    torch.testing.assert_close(final, rfinal, rtol=1e-6, atol=1e-6)


def test_ssd_scan_refuses_operands_outside_supports(gen):
    """An initial state (the Pallas kernel takes none), bf16 or misshapen
    decay, float16 or 4-D states, strided operands: ValueError on the
    card, nothing launched, no plain fallback."""
    states, decay = _scan(gen, (2, 3, 4, 8, 8), torch.float32)
    init = torch.zeros((2, 4, 8, 8), device="cuda")
    registry.reset_launches()
    with pytest.raises(ValueError):
        ssd_scan_op(states, decay, init)
    with pytest.raises(ValueError):
        ssd_scan_cuda(states, decay, init)
    bad = [
        (states, decay.bfloat16()),
        (states, decay[:, :2].contiguous()),
        (states.half(), decay),
        (states[..., 0].contiguous(), decay),
        (states.transpose(3, 4), decay),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            registry.dispatch("ssd_scan", args)
    assert registry.launch_counts() == {n: 0 for n in registry.names()}


@pytest.mark.parametrize("l", [5, 21, 256])
def test_ssd_chunked_on_the_card_launches_the_scan_once(gen, l):
    """``ssd_chunked`` on CUDA tensors goes through the kernel once per
    call, one chunk (l = 5) included, and matches the CPU's plain run
    (1e-4: einsums and exponentials in another order)."""
    from repro_torch.models.ssm import ssd_chunked

    b, h, p, n = 2, 4, 8, 16
    x = torch.randn((b, l, h, p), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    B, C = (torch.randn((b, l, n), generator=gen, device="cuda") for _ in range(2))
    registry.reset_launches()
    y, final = ssd_chunked(x, dt, A, B, C, chunk=8)
    torch.cuda.synchronize()
    assert registry.launch_counts()["ssd_scan"] == 1
    cy, cfinal = ssd_chunked(*(t.cpu() for t in (x, dt, A, B, C)), chunk=8)
    torch.testing.assert_close(y.cpu(), cy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(final.cpu(), cfinal, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("overlap", [False, True])
def test_reduced_mamba2_served_on_card_matches_cpu(gen, overlap):
    """Reduced mamba2 in float32 on the dense engine: greedy streams and
    the four counters through the ``ssd_scan`` kernel on the card equal
    the plain scan on the CPU, synchronous and with ``overlap=True`` and
    ``chunk_tokens`` (prompts up to 30 tokens)."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.models.registry import get_arch
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    arch = get_arch("mamba2-1.3b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    cpu_params = arch.init(seed=0, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        eng = InferenceEngine(arch, _to(cpu_params, device), n_lanes=3, max_prompt_len=16,
                              max_len=48, device=device)
        skw = dict(overlap=True, chunk_tokens=6) if overlap else {}
        sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2),
                                            **skw)
        rng = np.random.default_rng(2)
        lens = [int(n) for n in rng.integers(3, 17, size=5)] + [23, 30]
        reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=n).astype(np.int32),
                        max_new_tokens=12, template="long" if n > 16 else "short")
                for i, n in enumerate(lens)]
        registry.reset_launches()
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        out[device] = ({r.rid: r.generated for r in reqs},
                       [getattr(eng, a) for a in ("dispatches", "decode_steps",
                                                  "prefill_calls", "kv_bytes_moved")],
                       registry.launch_counts())
    assert out["cuda"][:2] == out["cpu"][:2]
    assert out["cuda"][2]["ssd_scan"] > 0
    assert out["cpu"][2] == {n: 0 for n in registry.names()}
