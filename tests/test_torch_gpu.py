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

import contextlib
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
                                   (4, 8, 2, 40, 12, 6), (4, 8, 2, 36, 5, 9),
                                   (4, 16, 2, 64, 16, 8), (4, 32, 2, 64, 8, 16),
                                   (8, 64, 8, 128, 16, 16), (8, 32, 2, 128, 16, 32),
                                   (4, 24, 2, 80, 32, 4), (32, 32, 2, 128, 16, 512, 3072)])
def test_paged_kernel_matches_plain(gen, dtype, shape):
    """The serving shape and two small ones, a group of 16 at D 256, pages
    of 8, 16 and 32 keys (boxes of 8 and 16 keys), pages of 12 keys at D
    40 (boxes of 4 keys: 640 bytes in float32, TMA; 320 in bf16, not a
    128-byte multiple, so the element-wise copy) and of 5 keys at D 36
    (boxes of one row, 144 or 72 bytes: the element-wise copy).  Groups of
    8 and 16 at D 64 and 128, 12 at D 80 and 16 at D 256 (in bf16 the
    tensor-core instance), and chatglm3-6b's tick in the long-document
    cell: 32 lanes, 32/2, 512-page tables, lengths 3072 to 8192 (an
    optional seventh entry is the shortest nonzero length)."""
    b, hq, hkv, d, ps, np_, *lo = shape
    lengths = [0] + [int(x) for x in np.linspace(lo[0] if lo else 1, np_ * ps, b - 1)]
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


@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_tensor_cores_at_tile_and_block_edges(gen, g, ps):
    """The tensor-core instance (bf16, 32 lanes, 2 kv heads, D 128, 8192
    keys a table: clusters of 4 blocks of 2048 keys) at lengths 0, 1, the
    edges of a page, of a warp's 16-key slice and of a 64-key tile (15/16/
    17, 63/64/65), of every block (2047/2048/2049 and on) and the full
    table; every table entry at or past ceil(length / ps) points at a
    trash page of large values that would show if any of its rows were
    attended; a repeated call gives the same bits."""
    from repro_torch.kernels.paged_attention.ops import _cluster

    b, hkv, d, np_ = 32, 2, 128, 8192 // ps
    assert _cluster(b, hkv, np_, ps) == (4, 2048)
    edges = [0, 1, 15, 16, 17, 63, 64, 65, 2047, 2048, 2049, 4095, 4096, 4097, 6143, 6144,
             6145, 8191, 8192]
    lengths = edges + [int(x) for x in np.linspace(3000, 8000, b - len(edges))]
    q, kp, vp, tabs, lens = _paged(gen, b, g * hkv, hkv, d, ps, np_, torch.bfloat16, lengths)
    kp, vp = (torch.cat([x, torch.full_like(x[:1], 1e3)]) for x in (kp, vp))
    trash = kp.shape[0] - 1
    pages = (lens.long() + ps - 1) // ps
    tabs = torch.where(torch.arange(np_, device="cuda")[None, :] < pages[:, None], tabs,
                       torch.full_like(tabs, trash))
    before = paged_decode_attention_cuda.mma_launches
    out = paged_decode_attention_cuda(q, kp, vp, tabs, lens)
    again = paged_decode_attention_cuda(q, kp, vp, tabs, lens)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.mma_launches == before + 2
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out).all()) and not out[0].any()
    torch.testing.assert_close(out.float(), paged_decode_ref(q, kp, vp, tabs, lens).float(),
                               rtol=1e-2, atol=1e-2)


def test_paged_mma_launches_count_the_tensor_core_instance(gen):
    """A group of 16 in bf16 takes the tensor-core instance and adds one to
    ``mma_launches`` beside ``launches``; a group of 1 (deepseek-moe-16b's
    heads) and a group of 16 in float32 add to ``launches`` only."""
    cases = [(_paged(gen, 4, 32, 2, 128, 16, 4, torch.bfloat16, [0, 1, 40, 64]), 1),
             (_paged(gen, 4, 16, 16, 128, 16, 4, torch.bfloat16, [0, 1, 40, 64]), 0),
             (_paged(gen, 4, 32, 2, 128, 16, 4, torch.float32, [0, 1, 40, 64]), 0)]
    for args, mma in cases:
        launches, mma_launches = (paged_decode_attention_cuda.launches,
                                  paged_decode_attention_cuda.mma_launches)
        paged_decode_attention_cuda(*args)
        torch.cuda.synchronize()
        assert paged_decode_attention_cuda.launches == launches + 1
        assert paged_decode_attention_cuda.mma_launches == mma_launches + mma


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 8, 128, 256), (3, 4, 2, 64, 130),
                                   (2, 16, 1, 16, 77), (1, 16, 1, 128, 512)])
def test_decode_kernel_lse_matches_plain(gen, dtype, shape):
    """``return_lse``: the output is the same bits as the launch without
    it, and the float32 log-sum-exp is the plain version's within 1e-4
    (both sum exponentials in float32 from the same operands), ``-inf``
    for a length-0 lane; one launch a call."""
    b, hq, hkv, d, t = shape
    lengths = ([0, t, 1] + [int(x) for x in np.linspace(2, t - 1, max(b - 3, 0))])[:b]
    if b == 1:
        lengths = [t - 5]
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    before = decode_attention_cuda.launches
    out, lse = decode_attention_cuda(q, k, v, lens, return_lse=True)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    assert lse.dtype == torch.float32 and lse.shape == (b, hq)
    assert torch.equal(out, decode_attention_cuda(q, k, v, lens))
    want_out, want_lse = decode_ref(q, k, v, lens, return_lse=True)
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)
    if 0 in lengths:
        assert bool(torch.isneginf(lse[lengths.index(0)]).all())
    live = lens > 0
    torch.testing.assert_close(lse[live], want_lse[live], rtol=1e-4, atol=1e-4)


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
                                    "paged_decode_attention", "paged_decode_attention_g16"])
def test_repeated_calls_are_bit_identical(gen, kernel):
    """Fixed summation orders (no atomics; the decode clusters combine
    their blocks in rank order, the tensor-core instance its warps in warp
    order first): two calls give the same bits."""
    if kernel == "paged_decode_attention":
        args = _paged(gen, 8, 32, 8, 128, 16, 32, torch.bfloat16,
                      [0, 1, 512, 300, 64, 65, 129, 511])
        first, second = (paged_decode_attention_cuda(*args) for _ in range(2))
    elif kernel == "paged_decode_attention_g16":
        args = _paged(gen, 32, 32, 2, 128, 16, 512, torch.bfloat16,
                      [0, 1, 8192] + [int(x) for x in np.linspace(3072, 8191, 29)])
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
        registry.dispatch("flash_attention", (q.contiguous(), k, k),
                          common={"causal": False, "window": 8})
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


def _reduced(name):
    from repro_torch.models.registry import get_arch

    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    return arch, arch.init(seed=0, device="cpu")


def test_shared_tail_on_card_matches_cpu(gen):
    """A prefix hit on reduced llama3-8b in float32: ``_shared_tail``'s
    logits and dense cache on the card (the ``decode_attention`` kernel,
    one launch a layer per tail token) equal the CPU's (plain version),
    and so does the admitted request's first token."""
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    arch, cpu_params = _reduced("llama3-8b")
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 256, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 256, size=n).astype(np.int32)])
               for n in (5, 9)]
    out = {}
    for device in ("cuda", "cpu"):
        eng = PagedInferenceEngine(arch, _to(cpu_params, device), n_lanes=2, max_prompt_len=32,
                                   max_len=48, page_size=8, prefix_share=True, device=device)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        eng.admit(reqs)
        assert eng.prefix_hits == 1
        idx = torch.as_tensor(eng.pool.pages(reqs[1].lane)[:2], device=device)
        registry.reset_launches()
        logits, dcache = eng._shared_tail(idx, prompts[1][None, 16:], 16)
        launched = registry.launch_counts()
        out[device] = (logits.cpu(), {k: a.cpu() for k, a in dcache["layers"].items()},
                       [r.generated for r in reqs], launched)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    for k in out["cpu"][1]:
        torch.testing.assert_close(out["cuda"][1][k], out["cpu"][1][k], rtol=1e-4, atol=1e-4)
    assert out["cuda"][2] == out["cpu"][2]
    assert out["cuda"][3]["decode_attention"] == arch.cfg.n_layers * 9
    assert out["cpu"][3] == {n: 0 for n in registry.names()}


@pytest.mark.parametrize("prefetch", [1, 2])
def test_paged_spill_restore_on_card_gives_back_the_page_bytes(gen, prefetch):
    """A lane spilled to the host (CPU tensors), its pages reused by a
    newcomer, then restored into new frames: once the prefetch tail is
    flushed, the lane's pages hold the same bytes as before the spill."""
    from repro_torch.serving.engine import HostSpillPool
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    arch, cpu_params = _reduced("llama3-8b")
    eng = PagedInferenceEngine(arch, _to(cpu_params, "cuda"), n_lanes=3, max_prompt_len=16,
                               max_len=48, page_size=8, kv_spill=HostSpillPool(4),
                               prefetch_pages=prefetch, device="cuda")
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=n).astype(np.int32),
                    max_new_tokens=30) for i, n in enumerate((15, 7))]
    eng.admit(reqs)
    for _ in range(12):
        eng.decode_tick()
    r = reqs[0]
    length = int(eng.lengths[r.lane])
    npg = -(-length // 8)

    def rows(lane):
        idx = torch.as_tensor(eng.pool.pages(lane)[:npg], device="cuda")
        return {k: a[:, idx].clone() for k, a in eng.cache["layers"].items()}

    before = rows(r.lane)
    assert eng.spill(r.lane, r.rid)
    (_t, entry), = eng.kv_spill._lru.values()
    assert all(t.device.type == "cpu" for t in entry["rows"]["layers"].values())
    newcomer = Request(rid=9, prompt=rng.integers(1, 256, size=16).astype(np.int32))
    eng.admit([newcomer])
    for _ in range(3):
        eng.decode_tick()
    eng.retire(newcomer.lane)
    lane = eng.try_restore(r.rid)
    assert lane is not None and (lane in eng._pending_restore) == (npg > prefetch)
    eng._flush_restores()
    torch.cuda.synchronize()
    for k, a in rows(lane).items():
        assert torch.equal(a, before[k])


@pytest.mark.parametrize("kind", ["paged-prefix", "paged-spill"])
def test_reduced_paged_modes_on_card_match_cpu(gen, kind):
    """Prefix sharing and an oversubscribed pool with host spill, through
    the scheduler on reduced llama3-8b in float32: greedy streams and
    counters on the card (kernels) equal the CPU's (plain versions)."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.engine import HostSpillPool
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    arch, cpu_params = _reduced("llama3-8b")
    out = {}
    for device in ("cuda", "cpu"):
        rng = np.random.default_rng(7)
        shared = rng.integers(1, 256, size=16 if kind == "paged-prefix" else 0)
        ekw = (dict(prefix_share=True) if kind == "paged-prefix"
               else dict(n_pages=9, kv_spill=HostSpillPool(8), prefetch_pages=1))
        eng = PagedInferenceEngine(arch, _to(cpu_params, device), n_lanes=3, max_prompt_len=32,
                                   max_len=48, page_size=8, device=device, **ekw)
        sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2))
        reqs = [Request(rid=i, prompt=np.concatenate(
                    [shared, rng.integers(1, 256, size=int(n))]).astype(np.int32),
                        max_new_tokens=30) for i, n in enumerate(rng.integers(3, 14, size=6))]
        registry.reset_launches()
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        out[device] = ({r.rid: r.generated for r in reqs},
                       [getattr(eng, a) for a in ("dispatches", "decode_steps", "prefill_calls",
                                                  "kv_bytes_moved", "prefix_hits",
                                                  "page_evictions")],
                       [sched.stats.kv_spilled, sched.stats.kv_restored],
                       registry.launch_counts())
    assert out["cuda"][:3] == out["cpu"][:3]
    launched = out["cuda"][3]
    assert launched["paged_decode_attention"] > 0
    if kind == "paged-prefix":
        assert out["cuda"][1][4] >= 1 and launched["decode_attention"] > 0
    else:
        assert out["cuda"][1][5] >= 1 and out["cuda"][2][0] == out["cuda"][2][1] >= 1


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


def test_reduced_mamba2_paged_dense_compute_on_card_matches_cpu(gen):
    """mamba2 on the paged engine's dense-compute mode, with straggler
    spills and restores of whole state lanes: greedy streams, counters and
    the pool's snapshot on the card (``ssd_scan`` kernel) equal the CPU's."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.engine import HostSpillPool
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    arch, cpu_params = _reduced("mamba2-1.3b")
    out = {}
    for device in ("cuda", "cpu"):
        eng = PagedInferenceEngine(arch, _to(cpu_params, device), n_lanes=3, max_prompt_len=16,
                                   max_len=48, page_size=8, kv_spill=HostSpillPool(4),
                                   device=device)
        sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2),
                                            lane_timeout=4)
        rng = np.random.default_rng(9)
        reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=int(n)).astype(np.int32),
                        max_new_tokens=12) for i, n in enumerate(rng.integers(3, 17, size=6))]
        registry.reset_launches()
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        out[device] = ({r.rid: r.generated for r in reqs},
                       [getattr(eng, a) for a in ("dispatches", "decode_steps",
                                                  "prefill_calls", "kv_bytes_moved")],
                       eng.pool.snapshot(), [sched.stats.kv_spilled, sched.stats.kv_restored],
                       registry.launch_counts())
    assert out["cuda"][:4] == out["cpu"][:4]
    assert out["cuda"][3][0] == out["cuda"][3][1] >= 1
    assert out["cuda"][4]["ssd_scan"] > 0 and out["cuda"][4]["paged_decode_attention"] == 0


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


# ------------------------------------------- the paper's layer on the card
def _score_program():
    from repro_torch.core.hir import Assign, Loop, Program, Query

    return Program(inputs=("items", "log"), body=[
        Loop(item_var="t", iter_var="items", body=[
            Query(target="s", query_name="embed.score", params=("t",)),
            Assign(target="log", fn=lambda lg, s: lg + (float(s),), args=("log", "s")),
        ])])


@pytest.mark.parametrize("pad", [False, True])
def test_model_service_over_batched_gather_on_card_matches_cpu(gen, pad):
    """``ModelService`` whose query gathers a table row through
    ``batched_gather`` and scores it: synchronous and transformed runs on
    the card give the CPU's results (rtol 1e-5), and the kernel launches
    once per single query and once per batch, exactly."""
    from repro_torch.core.hir import Interpreter, transform_program
    from repro_torch.core.runtime import AsyncQueryRuntime
    from repro_torch.core.services import ModelService
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.kernels.batched_gather.ops import gather_op

    rng = np.random.default_rng(0)
    table = rng.standard_normal((1000, 64), dtype=np.float32)
    w = rng.standard_normal(64, dtype=np.float32)
    ids = rng.integers(0, 1000, 300)
    out = {}
    for device in ("cuda", "cpu"):
        tt, tw = torch.as_tensor(table, device=device), torch.as_tensor(w, device=device)

        def batch_fn(t):
            return (gather_op(tt, t).float() * tw).sum(-1)

        items = list(torch.as_tensor(ids, device=device).unbind(0))
        runs = []
        for transformed in (False, True):
            svc = ModelService(lambda t: batch_fn(t[None])[0], batch_fn, pad_batches=pad)
            registry.reset_launches()
            if transformed:
                rt = AsyncQueryRuntime(svc, n_threads=4,
                                       strategy=GrowingUpperThreshold(initial_upper=8, bt=3))
                try:
                    env = Interpreter(rt).run(transform_program(_score_program(), overlap=True),
                                              {"items": items, "log": ()})
                finally:
                    rt.drain()
                    rt.shutdown()
                assert svc.stats.batches >= 1
            else:
                env = Interpreter(svc).run(_score_program(), {"items": items, "log": ()})
            launched = registry.launch_counts()["batched_gather"]
            st = svc.stats
            assert st.single_queries + st.batched_items == len(ids)
            assert launched == ((st.single_queries + st.batches) if device == "cuda" else 0)
            runs.append(env["log"])
        out[device] = runs
    want = (table[ids] * w).sum(-1)
    for runs in out.values():
        for got in runs:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _bridge_arch():
    from repro_torch.models.registry import get_arch

    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg.reduced(),
                                                             vocab_size=65536))
    return arch, arch.init(seed=0, device="cpu")


@pytest.mark.parametrize("trace", ["admin_workflow", "user_flow", "rag_pipeline"])
def test_reduced_app_trace_on_card_matches_cpu(gen, trace):
    """An app trace through ``SchedulerQueryService`` on reduced llama3-8b
    in float32 (vocabulary 65536): synchronous and transformed, each
    query's token tuple, the drives and the observables on the card equal
    the CPU's, and synchronous = transformed on each."""
    from repro_torch.core.app_traces import all_traces
    from repro_torch.core.hir import Interpreter, transform_program
    from repro_torch.core.runtime import AsyncQueryRuntime
    from repro_torch.core.strategies import PureBatch
    from repro_torch.serving.hir_bridge import SchedulerQueryService
    from repro_torch.serving.paged_kv import PagedInferenceEngine

    arch, cpu_params = _bridge_arch()
    tr = {t.name: t for t in all_traces()}[trace]
    out = {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, device)
        sides, launched = {}, {}
        for side in ("sync", "async"):
            eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=8, max_len=16,
                                       page_size=8, device=device)
            svc = SchedulerQueryService(eng)
            registry.reset_launches()
            if side == "sync":
                env = Interpreter(svc).run(tr.program, dict(tr.inputs))
            else:
                rt = AsyncQueryRuntime(svc, n_threads=4, strategy=PureBatch())
                try:
                    env = Interpreter(rt).run(transform_program(tr.program), dict(tr.inputs))
                finally:
                    rt.drain()
                    rt.shutdown()
            launched[side] = (registry.launch_counts(), eng.dispatches, eng.decode_steps)
            sides[side] = ({k: env.get(k) for k in tr.observe}, svc.stats.round_trips,
                           svc.stats.tokens)
        out[device] = sides
        assert sides["sync"][0] == sides["async"][0]
        assert sides["sync"][1] == tr.n_queries > sides["async"][1]
        if device == "cuda":
            L = arch.cfg.n_layers
            for counts, dispatches, ticks in launched.values():
                assert counts["paged_decode_attention"] == ticks * L
                assert counts["flash_attention"] == (dispatches - ticks) * L
    assert out["cuda"] == out["cpu"]


def test_reduced_paged_chaos_on_card_matches_cpu(gen):
    """``ChaosEngine`` over the paged engine with a spill pool, reduced
    llama3-8b in float32: the seeded faults, the recovery counters and the
    greedy streams on the card equal the CPU's, and equal a fault-free
    run's."""
    from repro_torch.core.faults import ChaosEngine, ChaosPlan, chaos_seed
    from repro_torch.core.resilience import Resilience
    from repro_torch.core.strategies import PureAsync
    from repro_torch.serving.engine import HostSpillPool
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    arch, cpu_params = _reduced("llama3-8b")
    out = {}
    for device in ("cuda", "cpu"):
        for chaos in (False, True):
            rng = np.random.default_rng(1)
            eng = PagedInferenceEngine(arch, _to(cpu_params, device), n_lanes=4,
                                       max_prompt_len=16, max_len=48, page_size=8,
                                       device=device, kv_spill=HostSpillPool(8))
            if chaos:
                eng = ChaosEngine(eng, ChaosPlan(seed=chaos_seed(0), decode_fault_rate=0.25,
                                                 prefill_fault_rate=0.25))
            sched = ContinuousBatchingScheduler(
                eng, strategy=PureAsync(),
                resilience=Resilience(quarantine_ticks=1) if chaos else None)
            reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=int(n)).astype(np.int32),
                            max_new_tokens=24) for i, n in enumerate(rng.integers(3, 17, size=6))]
            for r in reqs:
                sched.submit(r)
            sched.producer_done()
            sched.run_until_drained()
            st = sched.stats
            out[device, chaos] = ({r.rid: r.generated for r in reqs},
                                  getattr(eng, "injected_decode_faults", 0),
                                  getattr(eng, "injected_prefill_faults", 0),
                                  st.quarantined, st.prefill_retries, st.kv_spilled,
                                  st.kv_restored, eng.decode_steps)
    assert out["cuda", True] == out["cpu", True]
    streams, dec, pre, quarantined, retries, spilled, restored, _ = out["cuda", True]
    assert dec >= 1 and pre >= 1 and quarantined >= 1 and retries >= 1
    assert spilled == restored
    assert streams == out["cuda", False][0] == out["cpu", False][0]


# ------------------------------------------------- the decoder family (MoE)

def _moe_layer(name: str, dtype, capacity_factor: float = 1.25):
    from repro_torch.models.moe import moe_params
    from repro_torch.models.registry import get_arch
    cfg = dataclasses.replace(get_arch(name).cfg.reduced(), param_dtype=dtype,
                              compute_dtype=dtype, capacity_factor=capacity_factor)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    return cfg, moe_params(gen, cfg, "cpu")


@pytest.mark.parametrize("cf", [1.25, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_moe_on_card_matches_cpu(gen, name, dtype, cf):
    """``moe`` on the card against its CPU result on the same weights and
    input, with and without dropped routes: float32 1e-4, bf16 2e-2 x max
    |y| (the card's bf16 products round their own float32 sums)."""
    from repro_torch.models.moe import moe
    cfg, p = _moe_layer(name, dtype, cf)
    x = torch.randn((3, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    x = x.to(cfg.cdtype)
    y_cpu, aux_cpu = moe(p, cfg, x)
    y, aux = moe(_to(p, "cuda"), cfg, x.cuda())
    torch.cuda.synchronize()
    assert y.dtype == cfg.cdtype and p["router"]["w"].dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 2e-2 * float(y_cpu.float().abs().max())
    torch.testing.assert_close(y.float().cpu(), y_cpu.float(), rtol=0, atol=tol)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_on_card_is_bit_repeatable(gen, dtype):
    """Two calls on the same input give the same bits: the dispatch writes
    each slot once and the combine sums over k in a fixed order (no atomic
    scatter-add), at a prefill shape with drops and at a decode shape."""
    from repro_torch.models.moe import moe
    cfg, p = _moe_layer("deepseek-moe-16b", dtype, 0.5)
    p = _to(p, "cuda")
    for b, s in ((8, 64), (8, 1)):
        x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(cfg.cdtype)
        first = moe(p, cfg, x)[0]
        assert all(torch.equal(first, moe(p, cfg, x)[0]) for _ in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq, hkv", [(16, 16), (20, 20), (32, 2)])
def test_attention_kernels_at_the_new_configs_groups(gen, dtype, hq, hkv):
    """The three attention kernels against their plain versions at the
    head layouts of deepseek-moe-16b and olmo-1b (16/16, G 1), qwen1.5-4b
    (20/20, G 1) and chatglm3-6b (32/2, G 16, the decode kernels' largest
    group), D 128: flash over a 256-token bucket, dense decode at 8 lanes
    and 1 (a chunk), paged decode at 8 lanes of 32 pages of 16."""
    tol = TOLS[dtype]
    b, s, d = 8, 256, 128
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
               for h in (hq, hkv, hkv))
    torch.testing.assert_close(flash_attention_cuda(q, k, v, causal=True).float(),
                               attention_ref(q, k, v, causal=True).float(), rtol=tol, atol=tol)
    for lanes, t in ((8, 512), (1, 300)):
        qd = torch.randn((lanes, hq, d), generator=gen, device="cuda").to(dtype)
        kd, vd = (torch.randn((lanes, t, hkv, d), generator=gen, device="cuda").to(dtype)
                  for _ in range(2))
        lens = torch.as_tensor(np.linspace(1, t, lanes).astype(np.int32) if lanes > 1
                               else np.array([t - 5], np.int32), device="cuda")
        torch.testing.assert_close(decode_attention_cuda(qd, kd, vd, lens).float(),
                                   decode_ref(qd, kd, vd, lens).float(), rtol=tol, atol=tol)
    lengths = [0] + [int(x) for x in np.linspace(1, 32 * 16, b - 1)]
    args = _paged(gen, b, hq, hkv, d, 16, 32, dtype, lengths)
    torch.testing.assert_close(paged_decode_attention_cuda(*args).float(),
                               paged_decode_ref(*args).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "olmo-1b", "qwen1.5-4b", "chatglm3-6b"])
def test_reduced_config_served_on_card_matches_cpu(gen, name):
    """A reduced config in float32 on the paged engine: the card (kernels)
    and the CPU (plain versions) give the same greedy streams and counters;
    qwen's and chatglm's QKV biases drawn nonzero."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.models.registry import get_arch
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    cpu_params = arch.init(seed=0, device="cpu")
    if arch.cfg.qkv_bias:
        g = torch.Generator().manual_seed(2)
        for b in ("bq", "bk", "bv"):
            a = cpu_params["layers"]["attn"][b]
            a.copy_(0.5 * torch.randn(a.shape, generator=g))
    out = {}
    for device in ("cuda", "cpu"):
        rng = np.random.default_rng(1)
        eng = PagedInferenceEngine(arch, _to(cpu_params, device), n_lanes=4,
                                   max_prompt_len=16, max_len=48, page_size=8, device=device)
        sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2))
        reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=int(n)).astype(np.int32),
                        max_new_tokens=16) for i, n in enumerate(rng.integers(3, 17, size=6))]
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        out[device] = ({r.rid: r.generated for r in reqs}, eng.dispatches, eng.decode_steps)
    assert out["cuda"] == out["cpu"]


# ------------------------------------------- hymba, qwen2-vl, seamless-m4t

# (dtype, D): bf16 at D 64 and 128 on the tensor cores, bf16 at D 32 and
# float32 at D 64 on the CUDA cores.
_INSTANCES = [(torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 32),
              (torch.float32, 64)]


def _model_layout(gen, b, s, heads, d, dtype):
    return tuple(torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
                 .transpose(1, 2) for h in heads)


@pytest.mark.parametrize("window", [1, 7, 64, 200, 4096])
@pytest.mark.parametrize("dtype, d", _INSTANCES)
def test_flash_window_matches_plain(gen, dtype, d, window):
    """The band mask (hymba's sliding window) in both instances at G 5 and
    a ragged S of 200: against the plain version; a window of S or more
    gives the causal kernel's bits; a window of 1 gives each query its own
    value row exactly."""
    q, k, v = _model_layout(gen, 2, 200, (10, 2, 2), d, dtype)
    before = flash_attention_cuda.launches
    out = flash_attention_cuda(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    tol = TOLS[dtype]
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, window=window).float(),
                               rtol=tol, atol=tol)
    if window >= 200:
        assert torch.equal(out, flash_attention_cuda(q, k, v, causal=True))
    if window == 1:
        assert torch.equal(out, v.repeat_interleave(5, dim=1))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dtype, d", _INSTANCES)
def test_flash_positions_match_plain(gen, dtype, d, window):
    """The causal mask on positions (an M-RoPE prefill: a 9 x 9 patch grid
    at one temporal position, then text), banded or not, in both
    instances: against the plain version; positions ``arange(S)`` give the
    index mask's result."""
    s = 150
    q, k, v = _model_layout(gen, 2, s, (12, 2, 2), d, dtype)
    pos = torch.cat([torch.zeros(81, dtype=torch.int64),
                     torch.arange(1, s - 80)]).to("cuda").expand(2, s)
    out = flash_attention_cuda(q, k, v, causal=True, window=window, positions=pos)
    tol = TOLS[dtype]
    torch.testing.assert_close(
        out.float(), attention_ref(q, k, v, window=window, positions=pos).float(),
        rtol=tol, atol=tol)
    ar = torch.arange(s, device="cuda").expand(2, s)
    torch.testing.assert_close(
        flash_attention_cuda(q, k, v, causal=True, window=window, positions=ar).float(),
        flash_attention_cuda(q, k, v, causal=True, window=window).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s, t", [(512, 512), (64, 512), (8, 500)])
def test_flash_encoder_and_cross_shapes(gen, dtype, s, t):
    """seamless-m4t's layouts, MHA 16/16 at D 64 without a mask: the
    encoder (S = T) and cross attention over a memory of another length."""
    q = _model_layout(gen, 2, s, (16,), 64, dtype)[0]
    k, v = _model_layout(gen, 2, t, (16, 16), 64, dtype)
    out = flash_attention_cuda(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, causal=False).float(),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 25, 5, 64, 1024), (8, 12, 2, 128, 300),
                                   (8, 16, 16, 64, 512), (1, 25, 5, 64, 1024)])
def test_decode_kernel_at_the_new_groups(gen, dtype, shape):
    """Dense decode at hymba's group 5 (not a power of two) over its
    1024-row ring, qwen2-vl's 6 at D 128 and seamless's 1 at D 64, with
    ragged lengths, 0 and T among them."""
    b, hq, hkv, d, t = shape
    lengths = ([0, 1, t] + [int(x) for x in np.linspace(2, t - 1, max(b - 3, 0))])[:b]
    if b == 1:
        lengths = [t]
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), decode_ref(q, k, v, lens).float(),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 8, 25, 64, 16), (2, 3, 25, 64, 16)])
def test_ssd_scan_kernel_at_hymba_shape(gen, dtype, shape):
    """``ssd_scan`` at hymba's states (H 25, P 64, N 16: p * n = 1024,
    against mamba2's 8192)."""
    states, decay = _scan(gen, shape, dtype)
    prev, final = ssd_scan_cuda(states, decay)
    rprev, rfinal = ssd_scan_ref(states, decay)
    ptol = (1e-6, 1e-6) if dtype == torch.float32 else (2.0 ** -7, 1e-6)
    torch.testing.assert_close(prev.float(), rprev.float(), rtol=ptol[0], atol=ptol[1])
    torch.testing.assert_close(final, rfinal, rtol=1e-6, atol=1e-6)


def _family_batch(cfg, rng, b: int, s: int):
    """A prefill batch for ``cfg`` from numpy: tokens; or 16 patch
    embeddings on a 4 x 4 grid at temporal position 0, then text; or
    source frames and target tokens."""
    if cfg.is_encoder_decoder:
        return {"src_embeds": rng.standard_normal((b, 24, cfg.d_model)).astype(np.float32),
                "tgt_tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend != "none":
        pos = np.zeros((3, b, s), np.int64)
        grid = np.arange(16)
        pos[1, :, :16], pos[2, :, :16] = grid // 4, grid % 4
        pos[:, :, 16:] = 4 + np.arange(s - 16)
        return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32),
                "positions": pos}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("name", ["hymba-1.5b", "qwen2-vl-2b", "seamless-m4t-medium"])
def test_new_family_steps_on_card_match_cpu(gen, name):
    """A reduced hymba (window 16: the band, then 24 decode steps across
    ring wraps), qwen2-vl (patch embeddings, 3-row positions) and
    seamless-m4t (encoder, cross attention) in float32: ``Arch.prefill``
    and greedy ``decode_step``s on the card (kernels) against the CPU
    (plain versions), logits within 1e-4."""
    arch, cpu_params = _reduced(name)
    cfg = arch.cfg
    batch = _family_batch(cfg, np.random.default_rng(0), 2, 40)
    out = {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, device)
        registry.reset_launches()
        logits, cache = arch.prefill(params, {k: torch.as_tensor(a, device=device)
                                              for k, a in batch.items()}, max_len=72)
        steps = [logits]
        s = 40 if not cfg.is_encoder_decoder else batch["tgt_tokens"].shape[1]
        lengths = torch.full((2,), s, dtype=torch.int32, device=device)
        for _ in range(24):
            tok = steps[-1].argmax(-1).to(torch.int32)
            logits, cache = arch.decode_step(params, tok, cache, lengths)
            steps.append(logits)
            lengths = lengths + 1
        out[device] = (torch.stack(steps).cpu(), registry.launch_counts())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    launched = out["cuda"][1]
    assert launched["flash_attention"] > 0 and launched["decode_attention"] > 0
    assert (launched["ssd_scan"] > 0) == (name == "hymba-1.5b")


@pytest.mark.parametrize("kind", ["hymba-dense", "hymba-paged", "vlm-paged"])
def test_new_families_served_on_card_match_cpu(gen, kind):
    """Reduced hymba on the dense engine (chunked prompts too) and the paged
    engine's dense-compute mode, reduced qwen2-vl on the paged engine, in
    float32: greedy streams and dispatches on the card equal the CPU's."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    arch, cpu_params = _reduced("qwen2-vl-2b" if kind == "vlm-paged" else "hymba-1.5b")
    out = {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, device)
        if kind == "hymba-dense":
            eng = InferenceEngine(arch, params, n_lanes=3, max_prompt_len=32, max_len=64,
                                  device=device)
        else:
            eng = PagedInferenceEngine(arch, params, n_lanes=3, max_prompt_len=32,
                                       max_len=64, page_size=8, device=device)
        skw = dict(overlap=True, chunk_tokens=8) if kind == "hymba-dense" else {}
        sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2),
                                            **skw)
        rng = np.random.default_rng(1)
        lens = [int(n) for n in rng.integers(3, 33, size=5)] + [40]
        reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=n).astype(np.int32),
                        max_new_tokens=24) for i, n in enumerate(lens)]
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
    if kind == "vlm-paged":
        assert launched["paged_decode_attention"] > 0
    else:
        assert launched["decode_attention"] > 0 and launched["ssd_scan"] > 0


# ---------------------------------------------------------- ssd_scan_bwd

def _scan_bwd_case(gen, shape, dtype, with_final):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda

    states, decay = _scan(gen, shape, dtype)
    prev, _final = ssd_scan_cuda(states, decay)
    g_prev = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g_final = (torch.randn(shape[:1] + shape[2:], generator=gen, device="cuda")
               if with_final else None)
    return states, decay, (g_prev, g_final, prev, decay)


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 8, 64, 64, 128), (8, 8, 25, 64, 16), (2, 3, 5, 5, 7),
                                   (1, 1, 2, 3, 5), (2, 8, 4, 16, 32)])
def test_ssd_scan_bwd_kernel_matches_plain(gen, shape, dtype, with_final):
    """The adjoint kernel at mamba2's and hymba's training shapes and
    ragged ones: ``d_states`` and ``d_initial`` are the plain version's
    bits (the same unfused float32 multiply and add), ``d_decay`` within
    1e-5 of its largest entry (a sum in another order); against autograd
    of ``ssd_scan_ref`` too (bf16: autograd's ``d_decay`` takes the float32
    ``prev``, 2^-7); one launch a call, the same bits on a second call."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_bwd_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref

    states, decay, args = _scan_bwd_case(gen, shape, dtype, with_final)
    before = ssd_scan_bwd_cuda.launches
    out = ssd_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert ssd_scan_bwd_cuda.launches == before + 1
    assert out[0].dtype == dtype and out[1].dtype == out[2].dtype == torch.float32
    want = ssd_scan_bwd_ref(*args)
    torch.testing.assert_close(out[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(out[2], want[2], rtol=0, atol=0)
    scale = float(want[1].abs().max())
    torch.testing.assert_close(out[1], want[1], rtol=0, atol=1e-5 * scale + 1e-30)
    leaves = [states.float().requires_grad_(), decay.clone().requires_grad_()]
    aprev, afinal = ssd_scan_ref(*leaves)
    pairs = [(aprev, args[0].float()),
             (afinal, args[1] if with_final else torch.zeros_like(afinal))]
    pairs = [(o, g) for o, g in pairs if o.requires_grad]  # C = 1: prev is the zero start
    auto = torch.autograd.grad([o for o, _g in pairs], leaves, [g for _o, g in pairs])
    torch.testing.assert_close(out[0], auto[0].to(dtype), rtol=0, atol=0)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out[1], auto[1], rtol=0, atol=tol * scale + 1e-30)
    again = ssd_scan_bwd_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, out))


def test_ssd_scan_bwd_refuses_operands_outside_supports(gen):
    """A ``g_prev`` of another dtype or shape, a bf16 or misshapen
    ``g_final``, strided operands, an initial-state-free forward's decay
    in bf16: ValueError on the card, nothing launched."""
    _s, decay, (g_prev, g_final, prev, _d) = _scan_bwd_case(
        gen, (2, 3, 4, 8, 8), torch.float32, True)
    registry.reset_launches()
    bad = [
        (g_prev.bfloat16(), g_final, prev, decay),
        (g_prev[:, :2].contiguous(), g_final, prev, decay),
        (g_prev, g_final.bfloat16(), prev, decay),
        (g_prev, g_final[:1].contiguous(), prev, decay),
        (g_prev.transpose(3, 4), g_final, prev, decay),
        (g_prev, g_final, prev, decay.bfloat16()),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            registry.dispatch("ssd_scan_bwd", args)
    assert registry.launch_counts() == {n: 0 for n in registry.names()}


@pytest.mark.parametrize("l", [5, 21, 256])
def test_ssd_chunked_gradient_on_the_card(gen, l):
    """``ssd_chunked``'s gradient on CUDA tensors launches the scan once
    and its adjoint once, and matches the CPU's plain run (1e-4 of each
    gradient's largest entry: einsums and exponentials in another
    order)."""
    from repro_torch.models.ssm import ssd_chunked

    b, h, p, n = 2, 4, 8, 16
    x = torch.randn((b, l, h, p), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    B, C = (torch.randn((b, l, n), generator=gen, device="cuda") for _ in range(2))
    up = torch.randn((b, l, h, p), generator=gen, device="cuda")
    grads = {}
    for device in ("cuda", "cpu"):
        leaves = [t.to(device).requires_grad_() for t in (x, dt, A, B, C)]
        registry.reset_launches()
        y, _final = ssd_chunked(*leaves, chunk=8)
        grads[device] = torch.autograd.grad((y * up.to(device)).sum(), leaves)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = registry.launch_counts()
            assert (counts["ssd_scan"], counts["ssd_scan_bwd"]) == (1, 1)
    for g, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g.cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def _train_batch(cfg, seed: int, b: int = 4, s: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    if cfg.is_encoder_decoder:
        src = rng.standard_normal((b, 20, cfg.d_model)).astype(np.float32)
        return {"src_embeds": src, "tgt_tokens": tokens, "labels": tokens}
    if cfg.frontend != "none":
        pos = np.zeros((3, b, s), np.int32)
        pos[1, :, :16], pos[2, :, :16] = np.arange(16) // 4, np.arange(16) % 4
        pos[:, :, 16:] = 4 + np.arange(s - 16)
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": emb, "positions": pos, "labels": tokens}
    return {"tokens": tokens, "labels": tokens}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["mamba2-1.3b", "hymba-1.5b", "deepseek-moe-16b",
                                  "qwen2-vl-2b", "seamless-m4t-medium"])
def test_reduced_family_train_step_on_card_matches_cpu(gen, name, remat):
    """Each family reduced, float32, 2 train steps on the card (kernels)
    and on the CPU (plain versions): losses and parameters within 1e-4;
    the SSM and hybrid configs launch ``ssd_scan_bwd`` once a layer a
    step, the others never."""
    from repro_torch.models.registry import get_arch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg.reduced(), remat=remat))
    cpu_params = arch.init(seed=0, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, device) if device == "cuda" else _clone(cpu_params)
        init_state, step = make_train_step(arch, AdamWConfig(lr=1e-3), TrainStepConfig())
        state = init_state(params)
        losses, bwd = [], []
        for i in range(2):
            registry.reset_launches()
            params, state, m = step(params, state, _train_batch(arch.cfg, i))
            losses.append(float(m["loss"]))
            bwd.append(registry.launch_counts()["ssd_scan_bwd"])
        out[device] = (losses, params, bwd)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    for a, b in zip(_leaves(out["cuda"][1]), _leaves(out["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    mixers = arch.cfg.n_layers if arch.cfg.family == "ssm" or arch.cfg.hybrid else 0
    assert out["cuda"][2] == [mixers] * 2


def test_checkpoint_restart_on_the_card(gen, tmp_path):
    """Reduced mamba2, float32, int8 moments: a checkpoint after step 2
    written asynchronously while the run goes on, restored into fresh
    tensors on the card: the first resumed step's loss equals the
    uninterrupted run's bit for bit; the next within 1e-5 relative (the
    embedding gradient sums with atomics)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.registry import get_arch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    arch = get_arch("mamba2-1.3b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    init_state, step = make_train_step(arch, AdamWConfig(lr=1e-3, moments_dtype="int8"),
                                       TrainStepConfig())
    params = arch.init(seed=0, device="cuda")
    state = init_state(params)
    losses = []
    with CheckpointManager(tmp_path) as mgr:
        for i in range(4):
            params, state, m = step(params, state, _train_batch(arch.cfg, i))
            losses.append(float(m["loss"]))
            if i == 1:
                mgr.save(2, params, state)
        mgr.wait()
        fresh = arch.init(seed=1, device="cuda")
        at, p, s = mgr.restore_latest(fresh, init_state(fresh))
    assert at == 2 and next(_leaves(p)).is_cuda
    resumed = []
    for i in range(2, 4):
        p, s, m = step(p, s, _train_batch(arch.cfg, i))
        resumed.append(float(m["loss"]))
    assert resumed[0] == losses[2]
    np.testing.assert_allclose(resumed[1], losses[3], rtol=1e-5, atol=0)


def test_moe_bf16_gradient_on_card_matches_cpu(gen):
    """The bf16 MoE layer's gradient on the card (its expert products
    through ``_BmmF32``, bf16 operands with float32 results) against the
    CPU's (operands widened to float32): every weight's and the input's
    gradient within 2e-2 of its largest entry, as the forward's bf16
    tolerance in ``test_moe_on_card_matches_cpu``."""
    from repro_torch.models.moe import moe
    cfg, p = _moe_layer("deepseek-moe-16b", "bfloat16")
    x = torch.randn((3, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    up = torch.randn((3, 16, cfg.d_model), generator=torch.Generator().manual_seed(2))
    grads = {}
    for device in ("cuda", "cpu"):
        leaves = {k: v.to(device).requires_grad_() for k, v in _flat(p).items()}
        xd = x.to(device, cfg.cdtype).requires_grad_()
        y, aux = moe(_unflat(leaves), cfg, xd)
        loss = (y.float() * up.to(device)).sum() + aux
        grads[device] = torch.autograd.grad(loss, list(leaves.values()) + [xd])
    for g, want in zip(grads["cuda"], grads["cpu"]):
        assert g.dtype == want.dtype
        torch.testing.assert_close(g.float().cpu(), want.float(), rtol=0,
                                   atol=2e-2 * float(want.float().abs().max()) + 1e-30)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


# ------------------------------------------------ compiled dispatches (graphs)

GRAPH_ARCHS = ("llama3-8b", "deepseek-moe-16b", "mamba2-1.3b", "hymba-1.5b")


def _graph_drive(arch, params, kind):
    """One reduced run on the card through ``serving/graphs.py``'s steps:
    ``main`` (synchronous paged engine), ``async`` (``overlap=True`` with
    chunks, fused where the arch pages its compute), ``prefix``
    (``prefix_share``) or ``spill`` (an oversubscribed pool, or in
    dense-compute mode ``lane_timeout``).  Returns (streams, counters,
    launches, the engine)."""
    from repro_torch.core.strategies import GrowingUpperThreshold, OneOrAll
    from repro_torch.serving.engine import HostSpillPool
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    paged = arch.cfg.name.startswith(("llama", "deepseek"))
    ekw = dict(n_lanes=3, max_prompt_len=16, max_len=48, page_size=8)
    skw, strat = {}, GrowingUpperThreshold(initial_upper=2)
    rng = np.random.default_rng(4)
    lens, new = (4, 9, 3, 12, 6), 8
    if kind == "async":
        skw, lens = dict(overlap=True, chunk_tokens=4), (5, 13, 7, 15, 3, 11)
    elif kind == "prefix":  # a 16-token prefix (2 pages) and tails of 3-12 tokens
        ekw.update(n_lanes=4, max_prompt_len=32, prefix_share=True)
    elif kind == "spill":
        strat, lens, new = OneOrAll(), (6, 5, 9), 16
        ekw["kv_spill"] = HostSpillPool(8)
        if paged:
            ekw.update(max_len=32, n_pages=6, prefetch_pages=2)
        else:
            skw = dict(lane_timeout=3)
    prefix = rng.integers(1, 200, size=16)
    prompts = [np.concatenate([prefix, rng.integers(1, 200, size=n)]) if kind == "prefix"
               else rng.integers(1, 200, size=n) for n in lens]
    eng = PagedInferenceEngine(arch, params, device="cuda", **ekw)
    sched = ContinuousBatchingScheduler(eng, strategy=strat, **skw)
    reqs = [Request(rid=i, prompt=p.astype(np.int32), max_new_tokens=new)
            for i, p in enumerate(prompts)]
    registry.reset_launches()
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained(max_ticks=2000)
    torch.cuda.synchronize()
    counters = {a: getattr(eng, a) for a in ("dispatches", "decode_steps", "fused_folds",
                                             "kv_bytes_moved", "prefix_hits")}
    counters.update(spilled=sched.stats.kv_spilled, restored=sched.stats.kv_restored,
                    spec_chunks=sched.stats.spec_chunks)
    return [r.generated for r in reqs], counters, registry.launch_counts(), eng


@pytest.mark.parametrize("name, kind", [
    (n, k) for n in GRAPH_ARCHS for k in ("main", "async", "prefix", "spill")
    if k != "prefix" or n in ("llama3-8b", "deepseek-moe-16b")])
def test_graphs_match_eager_on_card(gen, name, kind):
    """Reduced configs in float32 on the card: the compiled dispatches give
    ``eager()``'s streams, counters and launch counts exactly (each step's
    first call runs it and counts its launches, the replays after it count
    their kernels), on the main, async, prefix-hit and spill paths; the
    graphs were recorded and replayed, every tick but the first a
    replay."""
    from repro_torch.serving import graphs

    arch, cpu_params = _reduced(name)
    params = _to(cpu_params, "cuda")
    got = _graph_drive(arch, params, kind)
    with graphs.eager():
        want = _graph_drive(arch, params, kind)
    assert got[:3] == want[:3]
    eng = got[3]
    steps = [eng._tick_step, *eng._chunk_steps.values(), *eng._prefill_steps.steps.values()]
    assert all(s.captured and s.replays == s.calls - 1 for s in steps if s.calls)
    assert eng._tick_step.calls == got[1]["decode_steps"]
    assert eng._tick_step.replays == got[1]["decode_steps"] - 1
    assert want[3]._tick_step.calls == 0  # run under eager(): nothing recorded
    if kind == "async":
        assert got[1]["spec_chunks"] >= 2
        assert sum(s.replays for s in eng._chunk_steps.values()) > 0
    if kind == "prefix":
        assert got[1]["prefix_hits"] >= 2
    if kind == "spill":
        assert got[1]["restored"] == got[1]["spilled"] >= 1


@pytest.mark.parametrize("name", GRAPH_ARCHS)
def test_graph_tick_logits_equal_eager(gen, name):
    """The second tick's logits from the replayed graph against the same
    tick under ``eager()`` on an engine given the same prompts: within
    1e-3 x max |logit| (expected equal: the same kernels on the same
    inputs)."""
    from repro_torch.serving import graphs
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    arch, cpu_params = _reduced(name)
    params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in (5, 11)]
    logits = []
    for mode in ("graph", "eager"):
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            eng = PagedInferenceEngine(arch, params, n_lanes=3, max_prompt_len=16,
                                       max_len=48, page_size=8, device="cuda")
            eng.admit([Request(rid=i, prompt=p, max_new_tokens=8)
                       for i, p in enumerate(prompts)])
            eng.decode_tick()
            eng.decode_tick()
            logits.append(eng._tick_step.out[0].clone())
    torch.cuda.synchronize()
    top = float(logits[1].abs().max())
    assert float((logits[0] - logits[1]).abs().max()) <= 1e-3 * top


def test_chunk_steps_replay_on_two_streams_at_once(gen):
    """The main stream's and the engine stream's chunk steps replayed by
    two threads at once (each its own staged cache, many chunks) give the
    caches and logits the same chunks give one after the other under
    ``eager()``."""
    import threading

    from repro_torch.models import transformer as tf
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import InferenceEngine

    arch, cpu_params = _reduced("llama3-8b")
    params = _to(cpu_params, "cuda")
    eng = InferenceEngine(arch, params, n_lanes=2, max_prompt_len=16, max_len=64,
                          device="cuda")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 200, size=60).astype(np.int32) for _ in range(2)]

    def start(p):
        _l, cache = tf.prefill(arch.cfg, params, torch.as_tensor(p[None, :4], device="cuda"),
                               max_len=64)
        return cache, torch.tensor([4], dtype=torch.int32, device="cuda")

    def run(p, side, out, key):
        cache, length = start(p)
        with eng._side() if side else contextlib.nullcontext():
            for lo in range(4, 60, 7):
                logits, cache, length = eng._extend(cache, p[None, lo:min(lo + 7, 60)],
                                                    length)
            torch.cuda.current_stream().synchronize()
        out[key] = (logits, cache)

    got, want = {}, {}
    threads = [threading.Thread(target=run, args=(p, side, got, side))
               for p, side in zip(prompts, (False, True))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with graphs.eager():
        for p, side in zip(prompts, (False, True)):
            run(p, side, want, side)
    torch.cuda.synchronize()
    assert set(got) == {False, True}
    for side in (False, True):
        assert torch.equal(got[side][0], want[side][0])
        for name, stack in want[side][1].items():
            for k, a in stack.items():
                assert torch.equal(got[side][1][name][k], a)


@pytest.mark.parametrize("first", ["eager", "graph"])
@pytest.mark.parametrize("paged", [False, True])
def test_switching_modes_on_one_engine_keeps_the_graphs_outputs(gen, paged, first):
    """One engine runs its first two ticks and chunks in one mode and the
    next two in the other (``eager()`` then replays, and the reverse):
    each tick's tokens and logits and each chunk's logits equal those of a
    fresh engine that only replays, the first call outside ``eager()``
    records the tick and every later one replays it, returning the
    recorded graph's outputs."""
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    arch, cpu_params = _reduced("llama3-8b")
    params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in (5, 11)]
    chunk = rng.integers(1, 200, size=(1, 6)).astype(np.int32)

    def run(modes):
        kw = dict(page_size=8) if paged else {}
        eng = (PagedInferenceEngine if paged else InferenceEngine)(
            arch, params, n_lanes=3, max_prompt_len=16, max_len=48, device="cuda", **kw)
        eng.admit([Request(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)])
        got = []
        for mode in modes:
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                toks = eng.decode_tick()
                tick = eng._tick_step.out[0].clone()
                part, _c, _l = eng._extend(arch.init_cache(1, 48, "cuda"), chunk,
                                           torch.zeros(1, dtype=torch.int32, device="cuda"))
            got.append((toks, tick, part))
        step = eng._tick_step
        assert (step.out is step._graph_out) == (modes[-1] == "graph")
        assert (step.calls, step.replays) == (modes.count("graph"), modes.count("graph") - 1)
        return got

    other = "graph" if first == "eager" else "eager"
    got = run([first, first, other, other])
    want = run(["graph"] * 4)
    torch.cuda.synchronize()
    for (toks, tick, part), (w_toks, w_tick, w_part) in zip(got, want):
        assert toks == w_toks
        assert float((tick - w_tick).abs().max()) <= 1e-3 * float(w_tick.abs().max())
        assert float((part - w_part).abs().max()) <= 1e-3 * float(w_part.abs().max())


# ---------------------------------------- compiled prefill, fission, ModelService

def _same_staged(got, want) -> None:
    assert torch.equal(got.first, want.first)
    for name, stack in want.cache.items():
        for key, a in stack.items():
            assert torch.equal(got.cache[name][key], a), (name, key)


@pytest.mark.parametrize("name", ["llama3-8b", "mamba2-1.3b", "hymba-1.5b", "qwen2-vl-2b"])
def test_prefill_replay_equals_eager_prefill(gen, name):
    """Reduced configs in float32: a bucket's first prefill dispatch runs
    the step function once for real and records it (one call of
    ``_prefill`` outside the capture and one inside), the next replays it
    (no call); both give the first tokens and KV cache of the same
    dispatch under ``eager()`` bit for bit (the same kernels on the same
    inputs; hymba's bucket of 16 is its window, so the ring re-layout
    runs)."""
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.request import Request

    arch, cpu_params = _reduced(name)
    params = _to(cpu_params, "cuda")
    eng = InferenceEngine(arch, params, n_lanes=4, max_prompt_len=16, max_len=48,
                          device="cuda")
    rng = np.random.default_rng(10)
    reqs = [Request(rid=i, prompt=rng.integers(1, 200, size=n).astype(np.int32))
            for i, n in enumerate((5, 11, 3))]
    runs, inner = [], eng._prefill

    def noted(*args):
        runs[-1].append(torch.cuda.is_current_stream_capturing())
        return inner(*args)

    eng._prefill = noted
    got = []
    for _ in range(2):
        runs.append([])
        got.append(eng.prefill_dispatch(reqs))
    runs.append([])
    with graphs.eager():
        want = eng.prefill_dispatch(reqs)
    torch.cuda.synchronize()
    assert runs == [[False, True], [], [False]]
    assert list(eng._prefill_steps.steps) == [(4, 16)]
    step = eng._prefill_steps.steps[(4, 16)]
    assert step.captured and (step.calls, step.replays) == (2, 1)
    for g in got:
        _same_staged(g, want)


def test_prefill_capture_on_a_second_thread_while_ticks_replay(gen):
    """A second thread dispatches prefills of new buckets (each captured on
    the engine's stream, as the speculation thread does) while the main
    thread replays decode ticks: the staged results equal the same
    dispatches under ``eager()`` and the ticks' tokens equal an engine's
    that ran them alone."""
    import threading

    from repro_torch.serving import graphs
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    arch, cpu_params = _reduced("llama3-8b")
    params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(11)
    lanes = [rng.integers(1, 200, size=n).astype(np.int32) for n in (6, 9)]
    side = [rng.integers(1, 200, size=n).astype(np.int32) for n in (3, 7, 13, 2)]

    def engine():
        eng = PagedInferenceEngine(arch, params, n_lanes=4, max_prompt_len=16, max_len=64,
                                   page_size=8, device="cuda")
        eng.admit([Request(rid=i, prompt=p) for i, p in enumerate(lanes)])
        return eng

    def ticks(eng, n=30):
        return [eng.decode_tick() for _ in range(n)]

    eng, alone = engine(), engine()
    staged, errors = [], []

    def speculate():
        try:
            for i, p in enumerate(side):
                staged.append(eng.prefill_dispatch([Request(rid=10 + i, prompt=p)]))
        except BaseException as e:  # re-raised on the main thread below
            errors.append(e)

    t = threading.Thread(target=speculate)
    t.start()
    got_ticks = ticks(eng)
    t.join(timeout=300)
    assert not t.is_alive() and not errors, errors
    want_ticks = ticks(alone)
    with graphs.eager():
        want = [eng.prefill_dispatch([Request(rid=10 + i, prompt=p)])
                for i, p in enumerate(side)]
    torch.cuda.synchronize()
    assert got_ticks == want_ticks
    assert sorted(eng._prefill_steps.steps) == [(1, 2), (1, 4), (1, 8), (1, 16), (2, 16)]
    for g, w in zip(staged, want):
        _same_staged(g, w)


@pytest.mark.parametrize("donate", [False, True])
def test_cached_fission_plan_equals_retracing_on_card(gen, donate):
    """Reduced llama3-8b in float32, 3 fissioned steps at 4 microbatches:
    the compiled step, which traces its body at its first call and
    replays its graph after it, against the step under ``eager()``
    tracing every step — one and three ``trace_body`` calls, the same
    first loss bit for bit and the later ones within 1e-6 relative (the
    embedding gradient's scatter-add uses atomics), parameters within
    1e-5."""
    from repro_torch.serving import graphs
    from repro_torch.core import fission as fission_mod
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    arch, _p = _reduced("llama3-8b")
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, query_embedding=True))
    cpu_params = arch.init(seed=0, device="cpu")
    rng = np.random.default_rng(12)
    batches = [{"tokens": t, "labels": t} for t in
               (rng.integers(0, 256, size=(8, 16)).astype(np.int32) for _ in range(3))]
    runs = {}
    real = fission_mod.trace_body
    for retrace in (False, True):
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fission_mod, "trace_body",
                       lambda *a, **k: (calls.append(1), real(*a, **k))[1])
            params = _to(cpu_params, "cuda")
            init, step = make_train_step(arch, AdamWConfig(lr=1e-3),
                                         TrainStepConfig(microbatches=4, donate=donate))
            state, losses = init(params), []
            registry.reset_launches()
            with graphs.eager() if retrace else contextlib.nullcontext():
                for b in batches:
                    if retrace:
                        step.plans.clear()
                    params, state, m = step(params, state, b)
                    losses.append(float(m["loss"]))
            torch.cuda.synchronize()
        assert registry.launch_counts()["batched_gather"] == len(batches)
        runs[retrace] = (losses, params, len(calls))
    (lc, pc, nc), (lr, pr, nr) = runs[False], runs[True]
    assert (nc, nr) == (1, 3)
    assert lc[0] == lr[0]
    np.testing.assert_allclose(lc, lr, rtol=1e-6)
    for a, b in zip(_leaves(pc), _leaves(pr)):
        assert float((a - b).abs().max()) <= 1e-5


def test_model_service_replays_under_four_threads_equal_eager(gen):
    """``ModelService`` over ``batched_gather``, called by 4 threads at once
    (single queries and batches of 3, 5 and 9 ids), keeps one compiled
    step per shape (4 steps): each result equals the same call's under
    ``eager()`` bit for bit, every call was one gather launch, and every
    call but a step's first one replay."""
    import threading

    from repro_torch.core.services import ModelService
    from repro_torch.kernels.batched_gather.ops import gather_op
    from repro_torch.serving import graphs

    table = torch.randn(1000, 64, generator=gen, device="cuda")
    w = torch.randn(64, generator=gen, device="cuda")

    def batch_fn(t):
        return (gather_op(table, t).float() * w).sum(-1)

    rng = np.random.default_rng(13)
    plans = [[[torch.tensor(int(i), device="cuda") for i in rng.integers(0, 1000, size=n)]
              for n in rng.choice([1, 3, 5, 9], size=12)] for _ in range(4)]

    def run(svc, plan, out):
        for ids in plan:
            if len(ids) == 1:
                out.append([svc.execute("q", (ids[0],))])
            else:
                out.append(svc.execute_batch_async("q", [(i,) for i in ids])())

    svc = ModelService(lambda t: batch_fn(t[None])[0], batch_fn)
    got = [[] for _ in plans]
    registry.reset_launches()
    threads = [threading.Thread(target=run, args=(svc, p, o)) for p, o in zip(plans, got)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    calls = sum(len(p) for p in plans)
    assert len(svc.steps) == 1
    cache = next(iter(svc.steps.values()))
    assert cache.calls == calls == registry.launch_counts()["batched_gather"]
    assert cache.replays == calls - 4
    assert len(cache.steps) == 4 and all(s.captured for s in cache.steps.values())
    want = [[] for _ in plans]
    with graphs.eager():
        for p, o in zip(plans, want):
            run(ModelService(lambda t: batch_fn(t[None])[0], batch_fn), p, o)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        for a, b in zip(g, wnt):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


# ----------------------------------------------------- the compiled train step

TRAIN_GRAPH_CASES = {"llama3-8b": dict(microbatches=4), "mamba2-1.3b": {},
                     "deepseek-moe-16b": {}}


def _compiled_train(arch, cpu_params, ts_kw: dict, batches, eager: bool):
    """3 steps of the compiled train step on the card, replayed or under
    ``graphs.eager()``: per step (loss, grad norm, launches), the final
    parameters, the step."""
    from repro_torch.serving import graphs
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    params = _to(cpu_params, "cuda")
    init, step = make_train_step(arch, AdamWConfig(lr=1e-3), TrainStepConfig(**ts_kw))
    state, out = init(params), []
    with graphs.eager() if eager else contextlib.nullcontext():
        for b in batches:
            registry.reset_launches()
            params, state, m = step(params, state, b)
            torch.cuda.synchronize()
            out.append((float(m["loss"]), float(m["grad_norm"]), registry.launch_counts()))
    return out, params, step


@pytest.mark.parametrize("name", list(TRAIN_GRAPH_CASES))
def test_train_step_replays_equal_eager(gen, name):
    """Reduced llama3-8b (``query_embedding``, 4 microbatches, fissioned),
    mamba2-1.3b and deepseek-moe-16b in float32, 3 steps: the compiled
    step runs its first call and replays its graph once a step after it;
    its launches per step equal ``eager()``'s; the first loss equals
    ``eager()``'s bit for bit; later losses, grad norms and every
    parameter bit for bit where two ``eager()`` runs repeat each other bit
    for bit, and within 1e-4 where they do not (a scatter-add with
    atomics)."""
    arch, _p = _reduced(name)
    if name == "llama3-8b":
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, query_embedding=True))
    cpu_params = arch.init(seed=0, device="cpu")
    batches = [_train_batch(arch.cfg, i) for i in range(3)]
    kw = TRAIN_GRAPH_CASES[name]
    got, gp, step = _compiled_train(arch, cpu_params, kw, batches, eager=False)
    e1, ep1, _s = _compiled_train(arch, cpu_params, kw, batches, eager=True)
    e2, ep2, _s = _compiled_train(arch, cpu_params, kw, batches, eager=True)
    assert (step.calls, step.replays, len(step.cache.steps)) == (3, 2, 1)
    assert [g[2] for g in got] == [e[2] for e in e1]
    assert got[0][0] == e1[0][0]
    for g, a, b in zip(got, e1, e2):
        for k in (0, 1):
            if a[k] == b[k]:
                assert g[k] == a[k]
            else:
                assert abs(g[k] - a[k]) <= 1e-4 * max(1.0, abs(a[k]))
    for g, a, b in zip(_leaves(gp), _leaves(ep1), _leaves(ep2)):
        if torch.equal(a, b):
            assert torch.equal(g, a)
        else:
            torch.testing.assert_close(g, a, rtol=1e-4, atol=1e-4)


def test_a_step_that_cannot_be_recorded_raises(gen):
    """A step whose function reads a value back to the host (``.item()``)
    runs its first call for real, then its recording raises instead of
    falling back; a later call raises without running the function; the
    card goes on working."""
    from repro_torch.serving import graphs

    x = torch.arange(4, dtype=torch.float32, device="cuda")
    inputs = graphs.StaticInputs({"n": (1,)}, torch.device("cuda"))
    ran = []

    def fn():
        ran.append(torch.cuda.is_current_stream_capturing())
        return x * float(x.sum().item())

    step = graphs.CompiledStep(fn, inputs, [], torch.device("cuda"))
    with pytest.raises(RuntimeError):
        step()
    assert ran == [False, True] and not step.captured
    assert not torch.cuda.is_current_stream_capturing()
    with pytest.raises(RuntimeError, match="recording failed"):
        step()
    assert ran == [False, True]
    assert (x * 2).sum().item() == 12.0


# ------------------------------------------------------- depth k on the card

def _depth_streams(arch, params, depth: int, paged: bool) -> tuple:
    """Reduced llama3-8b's depth traffic (single-request bets over four
    templates, three prompts longer than ``max_prompt_len`` chunked) at
    ``spec_depth`` ``depth`` on the card → (streams by rid, stats)."""
    from repro_torch.core.strategies import PureAsync
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    kw = dict(n_lanes=4, max_prompt_len=16, max_len=48, device="cuda")
    eng = PagedInferenceEngine(arch, params, page_size=8, **kw) if paged else \
        InferenceEngine(arch, params, **kw)
    sched = ContinuousBatchingScheduler(eng, strategy=PureAsync(), overlap=True,
                                        spec_depth=depth, chunk_tokens=8)
    rng = np.random.default_rng(2)
    lens = [int(n) for n in rng.integers(4, 17, size=21)] + [23, 27, 30]
    reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=n).astype(np.int32),
                    max_new_tokens=int(rng.integers(2, 12)), template=f"t{i % 4}")
            for i, n in enumerate(lens)]
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    assert all(r.done for r in reqs)
    return {r.rid: list(r.generated) for r in reqs}, sched.stats


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_depth_four_on_card_equals_depth_one_and_eager(gen, paged):
    """Four speculation threads over the compiled engine on the card (the
    prefill steps' first calls recorded from whichever thread dispatches,
    chunk steps on two streams, the paged engine's fused chunk ticks):
    every request's stream equals depth 1's and a depth-4 run under
    ``graphs.eager()``; no speculation crash; the ledger balances."""
    from repro_torch.serving import graphs

    arch, cpu_params = _reduced("llama3-8b")
    params = _to(cpu_params, "cuda")
    base, _st = _depth_streams(arch, params, 1, paged)
    got, st = _depth_streams(arch, params, 4, paged)
    with graphs.eager():
        eager, _st = _depth_streams(arch, params, 4, paged)
    assert got == base == eager
    assert st.spec_crashes == 0 and st.spec_chunks >= 1
    assert st.spec_dispatched == st.spec_committed + st.spec_aborted


def test_depth_spill_demo_on_card_equals_eager(gen):
    """The serving example's depth-2 demo (chunked prefill, host KV spill)
    on the card: streams per rid equal to the same demo under
    ``graphs.eager()``, its prompt chunked and every spilled lane
    restored."""
    from repro_torch.examples.serve_continuous_batching import depth_spill_demo
    from repro_torch.serving import graphs

    arch, cpu_params = _reduced("llama3-8b")
    params = _to(cpu_params, "cuda")
    done, st = depth_spill_demo(arch, params, verbose=False)
    with graphs.eager():
        edone, _est = depth_spill_demo(arch, params, verbose=False)
    assert {r.rid: r.generated for r in done} == {r.rid: r.generated for r in edone}
    assert st.spec_chunks >= 1 and st.kv_restored == st.kv_spilled and st.spec_crashes == 0


def test_graphs_of_one_thread_replayed_on_two_streams_keep_apart(gen):
    """Two compiled matrix products recorded by one thread, each at its
    first call on a stream of its own, then replayed beside each other on
    those streams 200 times: each replay equals its first call bit for
    bit.  Recorded on one capture stream they shared one cuBLAS workspace,
    and split-K products replayed at once wrote each other's partial
    sums."""
    from repro_torch.serving import graphs

    x = [torch.randn((8, 14336), generator=gen, device="cuda").to(torch.bfloat16)
         for _ in range(2)]
    w = torch.randn((14336, 4096), generator=gen, device="cuda").to(torch.bfloat16) * 0.01
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    steps, want = [], []
    for i, s in enumerate(streams):
        inputs = graphs.StaticInputs({"unused": (1,)}, torch.device("cuda"))
        step = graphs.CompiledStep(lambda i=i: x[i] @ w, inputs, [], torch.device("cuda"))
        with torch.cuda.stream(s):
            want.append(step().clone())
        steps.append(step)
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(200):
        for i, (s, step) in enumerate(zip(streams, steps)):
            with torch.cuda.stream(s):
                outs[i].append(step().clone())
    torch.cuda.synchronize()
    assert all(st.replays == 200 for st in steps)
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i]), i
