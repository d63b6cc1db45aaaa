"""Paged decode attention: the plain version and the CUDA kernel behind one op.

:func:`paged_decode_op` is what the model calls.  Through the registry it
runs :func:`~repro_torch.kernels.paged_attention.ref.paged_decode_ref` on
CPU tensors and :func:`paged_decode_attention_cuda` (the hand-written
kernel in ``csrc/paged_decode_attention.cu``, which replaces the Pallas
``paged_decode_attention_kernel``) on CUDA tensors.  One launch a call:
each (lane, kv head) is a thread-block cluster whose blocks split the
lane's pages (:func:`_cluster`) and combine their softmax states in
shared memory; the wrapper allocates only the output.  The kernel has two
bodies, both hand-written, and :func:`_instance` picks one: bf16 groups of
8 to 16 query heads per kv head on the tensor cores (``mma.sync``, the
group's heads as the rows of a tile), everything else on the CUDA cores
(the body the dense decode kernel shares).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.decode_attention.ops import (_MAX_CLUSTER, _MAX_D, _MAX_GROUP,
                                                      _MIN_KEYS, _TARGET_BLOCKS)
from repro_torch.kernels.paged_attention.ref import paged_decode_ref

__all__ = ["paged_decode_op", "paged_decode_attention_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CUDA_CORES, _TENSOR_CORES = 0, 1  # the C entry's `instance` argument
_MMA_MIN_GROUP = 8  # query heads per kv head from which the tensor cores take the call
_MMA_LOCK = threading.Lock()


def _supports(q, k_pages, v_pages, block_tables, lengths) -> bool:
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        return False
    b, hq, d = q.shape
    n_pages, ps, hkv, dk = k_pages.shape
    return (all(t.device == q.device for t in (k_pages, v_pages, block_tables, lengths))
            and q.dtype in _DTYPES and k_pages.dtype == q.dtype
            and v_pages.dtype == q.dtype and dk == d and 0 < d <= _MAX_D
            and 0 < hkv <= 65535 and hq % hkv == 0 and hq // hkv <= _MAX_GROUP
            and 0 < b <= 65535 and n_pages > 0 and ps > 0
            and not block_tables.is_floating_point() and block_tables.dim() == 2
            and block_tables.shape[0] == b and 0 < block_tables.shape[1] * ps < 2 ** 31
            and not lengths.is_floating_point() and tuple(lengths.shape) == (b,)
            and q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous())


def _cluster(b: int, hkv: int, np_: int, ps: int) -> tuple[int, int]:
    """(blocks per cluster C, keys per block) for B lanes of Hkv kv heads
    over block tables of NP pages of ps keys: the dense kernel's rule
    (``decode_attention.ops._cluster``) in whole pages.  C doubles, up to
    ``_MAX_CLUSTER``, while the grid has fewer than ``_TARGET_BLOCKS``
    blocks, each block would still get at least ``_MIN_KEYS`` keys and
    the last block of the doubled cluster would still get a page."""
    c = 1
    while c < _MAX_CLUSTER and b * hkv * c < _TARGET_BLOCKS:
        ppb = -(-np_ // (2 * c))  # pages per block after doubling
        if ppb * ps < _MIN_KEYS or (2 * c - 1) * ppb >= np_:
            break
        c *= 2
    return c, -(-np_ // c) * ps


def _instance(dtype: torch.dtype, g: int, d: int, ps: int, aligned: bool = True) -> int:
    """The kernel instance for a group of ``g`` query heads per kv head at
    head dim ``d`` over pages of ``ps`` keys: the tensor cores for bf16 at
    G >= 8 with D a multiple of 16 (up to 256), pages a multiple of 8 keys
    and q and the pages 16-byte aligned (``aligned``); the CUDA cores
    otherwise.  A key costs the CUDA cores 4·G·D float32 flops against
    4·D bytes: at G 16 that is 80 % of their rate at the card's byte rate,
    while below 8 most rows of a 16-row tile would be padding.  Float32
    stays off the tensor cores: they would round its operands to TF32."""
    if (dtype == torch.bfloat16 and g >= _MMA_MIN_GROUP and d % 16 == 0 and d <= 256
            and ps % 8 == 0 and aligned):
        return _TENSOR_CORES
    return _CUDA_CORES


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_decode_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:  # declare the C signature once per process
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp] + [ci] * 11 + [vp]
        fn.restype = ci
    return lib


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, lengths):
    """Launch the CUDA kernel: q (B, Hq, D); k/v_pages (P, ps, Hkv, D),
    contiguous; block_tables (B, NP) and lengths (B,) integer → (B, Hq, D)
    in q.dtype.  Attends positions [0, lengths) (clipped to [0, NP * ps]);
    a length-0 row is zeros.  Table entries below ceil(length / ps) must
    be page ids in [0, P) (not checked: that would cost a device sync);
    entries at or past it are never read.  Raises on operands the kernel
    does not take.  ``launches`` counts every call; ``mma_launches`` the
    eager calls and graph captures that took the tensor-core instance."""
    if not (q.is_cuda and _supports(q, k_pages, v_pages, block_tables, lengths)):
        raise ValueError("paged_decode_attention_cuda: unsupported operands")
    instance = _instance(q.dtype, q.shape[1] // k_pages.shape[2], q.shape[2],
                         k_pages.shape[1], _aligned(q, k_pages, v_pages))
    out = _launch(q, k_pages, v_pages, block_tables, lengths, instance)
    registry.count_launch(paged_decode_attention_cuda)
    if instance == _TENSOR_CORES:
        with _MMA_LOCK:
            paged_decode_attention_cuda.mma_launches += 1
    return out


paged_decode_attention_cuda.launches = 0
paged_decode_attention_cuda.mma_launches = 0


def _launch(q, k_pages, v_pages, block_tables, lengths, instance: int):
    """One launch of the given instance on operands ``_supports`` takes,
    counted nowhere (``chip_smoke.py`` times the CUDA-core instance beside
    the tensor-core one on the same operands)."""
    b, hq, d = q.shape
    n_pages, ps, hkv, _ = k_pages.shape
    np_ = block_tables.shape[1]
    cluster, kpb = _cluster(b, hkv, np_, ps)
    tabs = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _lib().paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tabs.data_ptr(), lens.data_ptr(), out.data_ptr(),
            b, hq, hkv, d, n_pages, ps, np_, cluster, kpb, _DTYPES[q.dtype], instance,
            torch.cuda.current_stream().cuda_stream)
    build.check("paged_decode_attention", code)
    return out


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
