"""Dense-cache decode attention: the plain version and the CUDA kernel behind one op.

:func:`decode_op` is what the model's one-token decode step calls.  Through
the registry it runs :func:`~repro_torch.kernels.decode_attention.ref.decode_ref`
on CPU tensors and :func:`decode_attention_cuda` (the hand-written kernel
in ``csrc/decode_attention.cu``, which replaces the Pallas
``decode_attention_kernel``) on CUDA tensors.  Unlike the Pallas kernel it
takes any cache length T (no ``bk`` that must divide T).  One launch a
call: each (lane, kv head) is a thread-block cluster whose blocks split
the keys and combine their softmax states in shared memory; the wrapper
allocates only the output.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.decode_attention.ref import decode_ref

__all__ = ["decode_op", "decode_attention_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 16   # query heads per kv head (the kernel's largest instance)
_MAX_D = 256      # head dims the kernel's shared buffers hold
_TARGET_BLOCKS = 256  # about two blocks for each of the H100's 132 SMs
_MIN_KEYS = 32        # keys per block below which a further split stops
_MAX_CLUSTER = 8      # blocks per cluster (the portable limit)


def _supports(q, k, v, lengths) -> bool:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        return False
    b, hq, d = q.shape
    bk, t, hkv, dk = k.shape
    return (all(x.device == q.device for x in (k, v, lengths))
            and q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype
            and not lengths.is_floating_point() and tuple(lengths.shape) == (b,)
            and bk == b and dk == d and 0 < d <= _MAX_D and t > 0
            and 0 < hkv <= 65535 and hq % hkv == 0 and hq // hkv <= _MAX_GROUP
            and 0 < b <= 65535
            and q.is_contiguous() and k.is_contiguous() and v.is_contiguous())


def _cluster(b: int, hkv: int, t: int) -> tuple[int, int]:
    """(blocks per cluster C, keys per block) for B lanes of Hkv kv heads
    over a cache of T keys: C doubles, up to ``_MAX_CLUSTER``, while the
    grid has fewer than ``_TARGET_BLOCKS`` blocks and each block would
    still get at least ``_MIN_KEYS`` keys."""
    c = 1
    while (c < _MAX_CLUSTER and b * hkv * c < _TARGET_BLOCKS
           and -(-t // (2 * c)) >= _MIN_KEYS):
        c *= 2
    return c, -(-t // c)


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention
    if fn.argtypes is None:  # declare the C signature once per process
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def decode_attention_cuda(q, k, v, lengths):
    """Launch the CUDA kernel: q (B, Hq, D); k/v (B, T, Hkv, D), contiguous;
    lengths (B,) integer → (B, Hq, D) in q.dtype.  Attends positions
    [0, lengths) (clipped to [0, T]); a length-0 row is zeros.  Raises on
    operands the kernel does not take."""
    if not (q.is_cuda and _supports(q, k, v, lengths)):
        raise ValueError("decode_attention_cuda: unsupported operands")
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    cluster, kpb = _cluster(b, hkv, t)
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _lib().decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            b, t, hq, hkv, d, cluster, kpb, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check("decode_attention", code)
    registry.count_launch(decode_attention_cuda)
    return out


decode_attention_cuda.launches = 0


def _sample(rng: np.random.Generator) -> registry.OpSample:
    """The reference's ``_sample`` shapes, drawn with numpy."""
    q = rng.standard_normal((2, 4, 64), dtype=np.float32)
    k = rng.standard_normal((2, 128, 2, 64), dtype=np.float32)
    v = rng.standard_normal((2, 128, 2, 64), dtype=np.float32)
    lengths = rng.integers(1, 129, size=(2,)).astype(np.int32)
    return registry.OpSample(args=(q, k, v, lengths))


registry.register("decode_attention", ref=decode_ref,
                  kernel=decode_attention_cuda, supports=_supports,
                  sample=_sample)


def decode_op(q, k, v, lengths):
    """Single-token GQA decode attention over a dense KV cache."""
    return registry.dispatch("decode_attention", (q, k, v, lengths))
