"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

Run on a machine with a card and nvcc (the kernels build on first use):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors.  Tolerances: float32, 1e-4 (sums and exponentials in another
order, observed about 1e-6); bf16, 1e-2 (both sides accumulate in float32
and round once to bf16, one bf16 ulp of an O(1) value).  This file
imports no JAX: the machine with the card has none.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention.ops import paged_decode_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_decode_ref

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


def test_reduced_model_served_on_card_matches_cpu(gen):
    """Reduced llama3-8b in float32: greedy streams and dispatches through
    the kernels on the card equal the plain versions on the CPU."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.models.registry import get_arch
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    cpu_params = arch.init(seed=0, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, device)
        eng = PagedInferenceEngine(arch, params, n_lanes=3, max_prompt_len=16, max_len=32,
                                   page_size=8, device=device)
        sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2))
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(1, 256, size=int(n)).astype(np.int32),
                        max_new_tokens=24) for i, n in enumerate(rng.integers(3, 17, size=5))]
        registry.reset_launches()
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        out[device] = ([r.generated for r in reqs], eng.dispatches, registry.launch_counts())
    assert out["cuda"][:2] == out["cpu"][:2]
    assert out["cuda"][2]["paged_decode_attention"] > 0 and out["cuda"][2]["flash_attention"] > 0
    assert out["cpu"][2] == {n: 0 for n in registry.names()}
