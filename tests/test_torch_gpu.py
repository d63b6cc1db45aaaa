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
