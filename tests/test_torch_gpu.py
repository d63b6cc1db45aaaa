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
                                   (2, 8, 1, 32, 8, 3), (4, 64, 4, 256, 16, 6),
                                   (8, 8, 2, 128, 8, 16), (8, 8, 2, 128, 32, 8),
                                   (4, 8, 2, 40, 12, 6), (4, 8, 2, 36, 5, 9)])
def test_paged_kernel_matches_plain(gen, dtype, shape):
    """The serving shape and two small ones, a group of 16 at D 256, pages
    of 8, 16 and 32 keys (boxes of 8 and 16 keys), pages of 12 keys at D
    40 (boxes of 4 keys: 640 bytes in float32, TMA; 320 in bf16, not a
    128-byte multiple, so the element-wise copy) and of 5 keys at D 36
    (boxes of one row, 144 or 72 bytes: the element-wise copy)."""
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
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_kernel_lengths_at_page_and_block_edges(gen, dtype, ps):
    """Lengths 0, 1, a page boundary -1, 0 and +1, the whole table and one
    that ends inside the last block of its cluster; every table entry at
    or past ceil(length / ps) points at the trash page P - 1, filled with
    large values that would show if any of its rows were attended; a
    repeated call gives the same bits."""
    from repro_torch.kernels.paged_attention.ops import _cluster

    b, hq, hkv, d, np_ = 8, 8, 2, 128, 8
    c, kpb = _cluster(b, hkv, np_, ps)
    assert c > 1  # the last block of a cluster below starts at (c - 1) * kpb
    lengths = [0, 1, ps - 1, ps, ps + 1, np_ * ps, (c - 1) * kpb + ps // 2 + 1, 3 * ps]
    q, kp, vp, tabs, lens = _paged(gen, b, hq, hkv, d, ps, np_, dtype, lengths)
    kp, vp = (torch.cat([x, torch.full_like(x[:1], 1e3)]) for x in (kp, vp))
    trash = kp.shape[0] - 1  # in no table's first ceil(length / ps) entries
    pages = (lens.long() + ps - 1) // ps
    tabs = torch.where(torch.arange(np_, device="cuda")[None, :] < pages[:, None], tabs,
                       torch.full_like(tabs, trash))
    assert bool((tabs == trash).any())
    out = paged_decode_attention_cuda(q, kp, vp, tabs, lens)
    again = paged_decode_attention_cuda(q, kp, vp, tabs, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out).all()) and not out[0].any()
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), paged_decode_ref(q, kp, vp, tabs, lens).float(),
                               rtol=tol, atol=tol)


def test_paged_kernel_refuses_operands_outside_supports(gen):
    """Float lengths or block tables, a group of 32 query heads, D above
    256, strided pages and mixed dtypes raise ValueError on the card;
    nothing is launched."""
    q = torch.zeros((2, 8, 64), device="cuda")
    kp = torch.zeros((9, 16, 2, 64), device="cuda")
    tabs = torch.ones((2, 4), dtype=torch.int32, device="cuda")
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    strided = kp.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros((9, 16, 2, 512), device="cuda")
    registry.reset_launches()
    bad = [
        (q, kp, kp, tabs, lens.float()),                              # float lengths
        (q, kp, kp, tabs.float(), lens),                              # float tables
        (torch.zeros((2, 64, 64), device="cuda"), kp, kp, tabs, lens),  # G = 32
        (torch.zeros((2, 8, 512), device="cuda"), wide, wide, tabs, lens),  # D > 256
        (q, strided, strided, tabs, lens),                            # strided pages
        (q.bfloat16(), kp, kp, tabs, lens),                           # mixed dtypes
    ]
    for args in bad:
        with pytest.raises(ValueError):
            registry.dispatch("paged_decode_attention", args)
    assert registry.launch_counts() == {n: 0 for n in registry.names()}


def test_configure_kernel_from_two_threads(gen):
    """Two threads launch one kernel instance (paged decode, bf16 rows
    that are not 16-byte multiples, a group of 12: used by no other test
    here, so its shared-memory attribute is first set inside this test)
    at two shared-memory sizes, D 36 and D 100, many times and at once:
    no launch is refused and every output equals the plain version."""
    import sys
    import threading

    cases = [_paged(gen, 2, 12, 1, d, 8, 4, torch.bfloat16, [5, 32]) for d in (36, 100)]
    wants = [paged_decode_ref(*a).float() for a in cases]
    errors = []

    def run(order):
        try:
            for _ in range(50):
                for i in order:
                    got = paged_decode_attention_cuda(*cases[i])
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got.float(), wants[i], rtol=1e-2, atol=1e-2)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(o,)) for o in ((0, 1), (1, 0))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors


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
                                   (2, 16, 1, 16), (1, 16, 1, 128)])
def test_decode_kernel_matches_plain(gen, dtype, t, shape):
    """Any T (no block size that must divide it), GQA groups of 4, 2 and
    16, lengths 0 (zeros, never NaN), 1, T and ragged values between.  A
    batch-1 lane has T - 5 keys, so at T 512 each of its cluster's 8 blocks
    holds keys (at G 16 too: 8 x 16 maxima and sums in the combine)."""
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 257, 512])
def test_flash_tensor_core_instance_at_tile_edges(gen, s, d, causal):
    """The bf16 tensor-core instance at query counts on both sides of its
    64-row tiles, in the model's strided layout."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    q, k, v = (torch.randn((2, s, h, d), generator=gen, device="cuda").bfloat16().transpose(1, 2)
               for h in (8, 2, 2))
    assert flash_ops._instance(q.dtype, d, flash_ops._aligned(q, k, v)) == flash_ops._TENSOR_CORES
    out = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, causal=causal).float(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 2, 65, 300, 128), (2, 8, 1, 1, 129, 64),
                                   (1, 4, 4, 130, 513, 32)])
def test_flash_kernel_keys_beyond_queries(gen, dtype, shape):
    """T > S without the causal mask: every query row sees all T keys,
    including a ragged last key tile."""
    b, hq, hkv, s, t, d = shape
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, hkv, t, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    out = flash_attention_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, causal=False).float(),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


def test_flash_misaligned_bf16_rows_take_the_cuda_cores(gen):
    """bf16 rows that are not 16-byte aligned leave the tensor cores for the
    CUDA-core instance and still match the plain version."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    wide = torch.randn((2, 64, 4, 132), generator=gen, device="cuda").bfloat16()
    q = wide[..., 2:130].transpose(1, 2)
    k = wide[:, :, :2, 2:130].transpose(1, 2)
    assert not flash_ops._aligned(q, k, k)
    out = flash_attention_cuda(q, k, k, causal=True)
    torch.testing.assert_close(out.float(), attention_ref(q, k, k, causal=True).float(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [4096, 8192])
def test_decode_kernel_long_caches(gen, dtype, t):
    """Caches past the cluster's capacity in one tile a block (8 x 64
    keys): each block walks several tiles; lengths 0, 1 and T."""
    b, hq, hkv, d = 3, 32, 8, 128
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.as_tensor([0, 1, t], dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and not out[0].any()
    torch.testing.assert_close(out.float(), decode_ref(q, k, v, lens).float(),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "paged_decode_attention"])
def test_repeated_calls_are_bit_identical(gen, kernel):
    """Fixed summation orders (no atomics; the decode clusters combine
    their blocks in rank order): two calls give the same bits."""
    if kernel == "paged_decode_attention":
        args = _paged(gen, 8, 32, 8, 128, 16, 32, torch.bfloat16,
                      [0, 1, 512, 300, 64, 65, 129, 511])
        first, second = (paged_decode_attention_cuda(*args) for _ in range(2))
    elif kernel == "flash_attention":
        q, k, v = (torch.randn((4, 256, h, 128), generator=gen, device="cuda").bfloat16()
                   .transpose(1, 2) for h in (32, 8, 8))
        first, second = (flash_attention_cuda(q, k, v, causal=True) for _ in range(2))
    else:
        q = torch.randn((8, 32, 128), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((8, 512, 8, 128), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        lens = torch.as_tensor([0, 1, 512, 300, 64, 65, 129, 511], dtype=torch.int32,
                               device="cuda")
        first, second = (decode_attention_cuda(q, k, v, lens) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


# ----------------------------------------------------------- batched_gather

V_FULL = 128256  # llama3-8b's vocabulary: row offsets beyond 2^31 elements


_GATHER_CASES = [
    pytest.param(V_FULL, d, n, dtype, torch.int32, False, id=f"{name}-n{n}-d{d}")
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))
    for n in (1, 7, 4096) for d in (8, 64, 4096)
] + [
    pytest.param(3000, 4104, 4095, torch.bfloat16, torch.int64, False, id="ragged"),
    pytest.param(V_FULL, 4096, 65536, torch.bfloat16, torch.int32, False, id="beyond_l2"),
    pytest.param(1000, 64, 1000, torch.float32, torch.int32, True, id="unaligned"),
]


@pytest.mark.parametrize("v, d, n, dtype, id_dtype, unaligned", _GATHER_CASES)
def test_batched_gather_kernel_matches_plain(gen, v, d, n, dtype, id_dtype, unaligned):
    """Bit-exact against the plain version, with the last row among the
    ids: on the full 128256-row table (its last row's offset needs 64-bit
    arithmetic at D = 4096) at 1, 7 and 4096 ids; N not a multiple of the
    rows a block takes, with int64 ids and rows of two slices (D 4104
    bf16, 8208 bytes); N 65536 at the llama3-8b table's width (an output
    beyond L2); a table view that is contiguous but not 16-byte aligned
    (the element-wise copy)."""
    from repro_torch.kernels.batched_gather.ops import batched_gather_cuda
    from repro_torch.kernels.batched_gather.ref import gather_ref

    table = torch.randn((v, d), generator=gen, device="cuda").to(dtype)
    if unaligned:
        table = torch.randn((v * d + 1,), generator=gen, device="cuda")[1:].view(v, d)
        assert table.is_contiguous() and table.data_ptr() % 16 != 0
    ids = torch.randint(0, v, (n,), generator=gen, device="cuda").to(id_dtype)
    ids[-1] = v - 1
    got = batched_gather_cuda(table, ids)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, d)
    assert torch.equal(got, gather_ref(table, ids))


@pytest.mark.parametrize("shape", [(2, 3), (5,), ()])
def test_batched_gather_kernel_takes_any_ids_shape(gen, shape):
    """int64 ids of any shape, a row length (D = 7 bf16, 14 bytes) that
    takes the scalar path: ids.shape + (D,), bit-exact."""
    from repro_torch.kernels.batched_gather.ops import batched_gather_cuda
    from repro_torch.kernels.batched_gather.ref import gather_ref

    table = torch.randn((50, 7), generator=gen, device="cuda").bfloat16()
    ids = torch.randint(0, 50, shape, generator=gen, device="cuda")
    got = batched_gather_cuda(table, ids)
    assert got.shape == shape + (7,)
    assert torch.equal(got, gather_ref(table, ids))


def test_batched_gather_refuses_operands_outside_supports(gen):
    """float16 and 3-D tables, float or empty ids, a strided table, ids on
    another device raise ValueError on the card; nothing is launched."""
    table = torch.zeros((16, 8), device="cuda")
    ids = torch.zeros(4, dtype=torch.int32, device="cuda")
    registry.reset_launches()
    bad = [
        (table.half(), ids),
        (torch.zeros((2, 16, 8), device="cuda"), ids),
        (table, ids.float()),
        (table, ids[:0]),
        (torch.zeros((8, 16), device="cuda").t(), ids),
        (table, ids.cpu()),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            registry.dispatch("batched_gather", args)
    assert registry.launch_counts() == {n: 0 for n in registry.names()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("via", ["query", "op"])
def test_batched_gather_gradient_matches_plain(gen, dtype, via):
    """The gradient (float32 scatter-add, cast to the table's dtype) of the
    ``table_gather`` query, as the model's embedding calls it, and of the
    ``batched_gather`` op, as fission's batched execution calls it, on the
    card against the same scatter-add on the CPU.  Repeated ids sum in
    another order (atomics): float32 1e-5, bf16 2^-7 relative (one bf16
    ulp after the float32 sum)."""
    from repro_torch.core.query import async_query, table_gather_spec
    from repro_torch.kernels.batched_gather.ops import gather_op
    from repro_torch.kernels.batched_gather.ref import gather_ref

    table = torch.randn((300, 64), generator=gen, device="cuda").to(dtype)
    ids = torch.randint(0, 30, (4, 128), generator=gen, device="cuda", dtype=torch.int32)
    up = torch.randn((4, 128, 64), generator=gen, device="cuda").to(dtype)
    t = table.clone().requires_grad_()
    rows = (async_query(table_gather_spec, t, ids) if via == "query"
            else gather_op(t, ids))
    (got,) = torch.autograd.grad(rows, t, up)
    tc = table.cpu().float().requires_grad_()
    (want,) = torch.autograd.grad(gather_ref(tc, ids.cpu()), tc, up.cpu().float())
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.cpu().float(), want.to(dtype).float(), rtol=tol, atol=tol)


def test_batched_gather_counts_its_launches(gen):
    """One launch per call on CUDA operands; the plain version on CPU
    operands counts nothing."""
    from repro_torch.kernels.batched_gather.ops import batched_gather_cuda, gather_op

    table = torch.randn((40, 16), generator=gen, device="cuda")
    ids = torch.arange(10, device="cuda")
    registry.reset_launches()
    gather_op(table, ids)
    gather_op(table, ids.reshape(2, 5))
    gather_op(table.cpu(), ids.cpu())
    assert batched_gather_cuda.launches == 2
    assert registry.launch_counts()["batched_gather"] == 2


def test_fission_on_the_card_launches_the_gather_once(gen):
    """A loop of 64 single-row queries: the plain scan launches the kernel
    64 times, the fissioned one once, with the same result."""
    from repro_torch.core.fission import fission_scan, scan
    from repro_torch.core.query import async_query, table_gather_spec

    table = torch.randn((1000, 32), generator=gen, device="cuda")
    ids = ((torch.arange(64, device="cuda") * 37) % 1000).to(torch.int32)

    def body(c, i):
        return c + async_query(table_gather_spec, table, i).sum(), None

    out = {}
    for fn in (scan, fission_scan):
        registry.reset_launches()
        out[fn.__name__] = (fn(body, torch.zeros((), device="cuda"), ids)[0],
                            registry.launch_counts()["batched_gather"])
    assert out["scan"][1] == 64 and out["fission_scan"][1] == 1
    torch.testing.assert_close(out["scan"][0], out["fission_scan"][0], rtol=1e-5, atol=1e-5)


def test_grad_vmap_and_nesting_through_fission_on_the_card(gen):
    """``fission_scan`` on CUDA operands under ``torch.autograd.grad``,
    ``torch.vmap`` and an outer ``fission_scan``: the batched execution
    (the ``batched_gather`` op) carries a gradient, a batching rule and a
    fake, as the reference's Pallas op does, and matches the plain scan."""
    from repro_torch.core.fission import FissionReport, fission_scan, scan
    from repro_torch.core.query import async_query, table_gather_spec

    table = torch.randn((128, 16), generator=gen, device="cuda")
    ids = ((torch.arange(16, device="cuda") * 37) % 128).to(torch.int32)

    def loss(t, scan_fn):
        return scan_fn(lambda c, i: (c + (async_query(table_gather_spec, t, i) ** 2).sum(),
                                     None), torch.zeros((), device="cuda"), ids)[0]

    grads = []
    for fn in (scan, fission_scan):
        t = table.clone().requires_grad_()
        grads.append(torch.autograd.grad(loss(t, fn), t)[0])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)

    def summed(scan_fn):
        return lambda ii: scan_fn(lambda c, i: (c + async_query(table_gather_spec, table,
                                                                 i).sum(), None),
                                  torch.zeros((), device="cuda"), ii)[0]

    stacked = torch.stack([ids, (ids + 1) % 128, (ids + 2) % 128])
    torch.testing.assert_close(torch.vmap(summed(fission_scan))(stacked),
                               torch.stack([summed(scan)(r) for r in stacked]),
                               rtol=1e-5, atol=1e-5)

    def outer(scan_fn):
        def body(c, i):
            s, _ = scan_fn(lambda c2, j: (c2 + async_query(table_gather_spec, table,
                                                           j).sum(), None),
                           torch.zeros((), device="cuda"), (i + torch.arange(
                               4, device="cuda", dtype=torch.int32)) % 128)
            return c + s + async_query(table_gather_spec, table, i)[0], None
        return body

    rep = FissionReport()
    got = fission_scan(outer(fission_scan), torch.zeros((), device="cuda"), ids,
                       report=rep)[0]
    want = scan(outer(scan), torch.zeros((), device="cuda"), ids)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert rep.n_queries_batched == 1  # the outer query; the inner loop fissions alone


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_gradients_match_plain(gen, dtype):
    """q, k and v gradients of the flash op (kernel forward, plain
    recompute in the backward) against autograd of the plain version on
    the same operands, in the model's strided layout."""
    from repro_torch.kernels.flash_attention.ops import attention_op

    q, k, v = (torch.randn((2, 96, h, 64), generator=gen, device="cuda").to(dtype)
               .transpose(1, 2).requires_grad_() for h in (8, 2, 2))
    up = torch.randn((2, 8, 96, 64), generator=gen, device="cuda").to(dtype)
    registry.reset_launches()
    got = torch.autograd.grad(attention_op(q, k, v, causal=True), (q, k, v), up)
    assert registry.launch_counts()["flash_attention"] == 1
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True), (q, k, v), up)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=TOLS[dtype], atol=TOLS[dtype])


def test_head_gradient_on_the_card(gen):
    """The bf16 head's gradient on the card (``_MatmulF32``) equals the CPU
    branch's (float32 products of the widened operands, rounded once to
    bf16), up to one bf16 ulp (2^-7 relative: float32 sums in another
    order can round the other way)."""
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_arch

    cfg = dataclasses.replace(get_arch("llama3-8b").cfg, d_model=256, vocab_size=1000)
    x = torch.randn((2, 3, 256), generator=gen, device="cuda").bfloat16()
    w = (0.1 * torch.randn((256, 1000), generator=gen, device="cuda")).bfloat16()
    up = torch.randn((2, 3, 1000), generator=gen, device="cuda")
    grads = {}
    for device in ("cuda", "cpu"):
        xd, wd = (a.to(device).requires_grad_() for a in (x, w))
        out = transformer._head(cfg, {"lm_head": {"w": wd}}, xd)
        grads[device] = torch.autograd.grad(out, (xd, wd), up.to(device))
    for g, want in zip(grads["cuda"], grads["cpu"]):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.cpu().float(), want.float(), rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.parametrize("fission", [False, True])
def test_reduced_train_step_on_card_matches_cpu(gen, fission):
    """Reduced llama3-8b, float32, ``query_embedding``, 4 microbatches, 2
    steps: losses and parameters on the card (kernels) equal the CPU's
    (plain versions) to 1e-4; ``batched_gather`` launches once per step
    fissioned and 4 times unfissioned."""
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.models.registry import get_arch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg.reduced(),
                                                             query_embedding=True))
    stream = SyntheticLMStream(arch.cfg.vocab_size, seq_len=16, batch=8, seed=0)
    cpu_params = arch.init(seed=0, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, device) if device == "cuda" else _clone(cpu_params)
        init_state, step = make_train_step(arch, AdamWConfig(lr=1e-3),
                                           TrainStepConfig(microbatches=4, fission=fission))
        state = init_state(params)
        losses, launches = [], []
        for i in range(2):
            registry.reset_launches()
            params, state, m = step(params, state, stream.batch_at(i))
            losses.append(float(m["loss"]))
            launches.append(registry.launch_counts()["batched_gather"])
        out[device] = (losses, params, launches)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    for a, b in zip(_leaves(out["cuda"][1]), _leaves(out["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert out["cuda"][2] == [1 if fission else 4] * 2


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])
