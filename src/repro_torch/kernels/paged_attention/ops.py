"""Paged decode attention: the plain version and the CUDA kernel behind one op.

:func:`paged_decode_op` is what the model calls.  Through the registry it
runs :func:`~repro_torch.kernels.paged_attention.ref.paged_decode_ref` on
CPU tensors and :func:`paged_decode_attention_cuda` (the hand-written
kernel in ``csrc/paged_decode_attention.cu``, which replaces the Pallas
``paged_decode_attention_kernel``) on CUDA tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.paged_attention.ref import paged_decode_ref

__all__ = ["paged_decode_op", "paged_decode_attention_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 48 * 1024  # the kernel uses static-sized shared memory only


def _smem_bytes(g: int, d: int, ps: int) -> int:
    # Mirrors smem_bytes() in csrc/paged_decode_attention.cu.
    return 4 * (2 * g * d + ps * (d + 1) + ps * d + g * ps + 3 * g)


def _supports(q, k_pages, v_pages, block_tables, lengths) -> bool:
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        return False
    b, hq, d = q.shape
    _, ps, hkv, dk = k_pages.shape
    return (all(t.device == q.device for t in (k_pages, v_pages, block_tables, lengths))
            and q.dtype in _DTYPES and k_pages.dtype == q.dtype
            and v_pages.dtype == q.dtype and dk == d and hkv > 0
            and hq % hkv == 0 and block_tables.dim() == 2
            and block_tables.shape[0] == b and tuple(lengths.shape) == (b,)
            and q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous()
            and _smem_bytes(hq // hkv, d, ps) <= _MAX_SMEM)


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_decode_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:  # declare the C signature once per process
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, lengths):
    """Launch the CUDA kernel: q (B, Hq, D); k/v_pages (P, ps, Hkv, D);
    block_tables (B, NP); lengths (B,) → (B, Hq, D) in q.dtype.  Attends
    positions [0, lengths); a length-0 row is zeros.  Table entries below
    ceil(length / ps) must be page ids in [0, P) (not checked: that would
    cost a device sync).  Raises on operands the kernel does not take."""
    if not (q.is_cuda and _supports(q, k_pages, v_pages, block_tables, lengths)):
        raise ValueError("paged_decode_attention_cuda: unsupported operands")
    b, hq, d = q.shape
    _, ps, hkv, _ = k_pages.shape
    tabs = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _lib().paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tabs.data_ptr(), lens.data_ptr(), out.data_ptr(),
            b, hq, hkv, d, ps, tabs.shape[1], _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check("paged_decode_attention", code)
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0


def _sample(rng: np.random.Generator) -> registry.OpSample:
    """The reference's ``_sample`` shapes, drawn with numpy: shuffled
    physical pages, page 0 reserved so padding slots stay valid."""
    b, np_, ps, hkv, d = 2, 8, 16, 2, 64
    n_pages = b * np_ + 1
    q = rng.standard_normal((b, 4, d), dtype=np.float32)
    k_pages = rng.standard_normal((n_pages, ps, hkv, d), dtype=np.float32)
    v_pages = rng.standard_normal((n_pages, ps, hkv, d), dtype=np.float32)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(b, np_).astype(np.int32)
    lengths = rng.integers(1, np_ * ps + 1, size=(b,)).astype(np.int32)
    return registry.OpSample(args=(q, k_pages, v_pages, tables, lengths))


registry.register("paged_decode_attention", ref=paged_decode_ref,
                  kernel=paged_decode_attention_cuda, supports=_supports,
                  sample=_sample)


def paged_decode_op(q, k_pages, v_pages, block_tables, lengths):
    """Single-token GQA decode attention over a paged KV pool."""
    return registry.dispatch(
        "paged_decode_attention", (q, k_pages, v_pages, block_tables, lengths))
