"""Causal GQA attention: the plain version and the CUDA kernel behind one op.

:func:`attention_op` is what the model's prefill calls.  Through the
registry it runs :func:`~repro_torch.kernels.flash_attention.ref.attention_ref`
on CPU tensors and :func:`flash_attention_cuda` (the hand-written kernel in
``csrc/flash_attention.cu``, which replaces the Pallas ``flash_attention``)
on CUDA tensors.  Operands may be strided views; only the D axis must be
contiguous.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_op", "flash_attention_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)  # the kernel's compiled D instances


def _supports(q, k, v, *, causal: bool = True, window: int = 0) -> bool:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return False
    b, hq, _, d = q.shape
    bk, hkv, _, dk = k.shape
    return (window == 0 and k.device == q.device and v.device == q.device
            and q.dtype in _DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype and bk == b and dk == d and d in _HEAD_DIMS
            and hkv > 0 and hq % hkv == 0 and b * hq <= 65535
            and q.shape[2] > 0 and k.shape[2] > 0
            and q.stride(-1) == 1 and k.stride(-1) == 1 and v.stride(-1) == 1)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:  # declare the C signature once per process
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                       ctypes.POINTER(ctypes.c_longlong), ci, ci, vp]
        fn.restype = ci
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the CUDA kernel: q (B, Hq, S, D), k/v (B, Hkv, T, D), any
    strides with a contiguous D axis → (B, Hq, S, D) in q.dtype, laid out
    like q.  Raises on operands the kernel does not take (a sliding
    ``window`` among them)."""
    if not (q.is_cuda and _supports(q, k, v, causal=causal, window=window)):
        raise ValueError("flash_attention_cuda: unsupported operands")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # keeps q's strides for a dense permuted view
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, out) for i in range(3)))
    with torch.cuda.device(q.device):
        code = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, s, t, d, strides, int(causal), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check("flash_attention", code)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def _sample(rng: np.random.Generator) -> registry.OpSample:
    """The reference's ``_sample`` shapes, drawn with numpy."""
    q = rng.standard_normal((1, 4, 128, 64), dtype=np.float32)
    k = rng.standard_normal((1, 2, 128, 64), dtype=np.float32)
    v = rng.standard_normal((1, 2, 128, 64), dtype=np.float32)
    return registry.OpSample(args=(q, k, v), common={"causal": True})


registry.register("flash_attention", ref=attention_ref,
                  kernel=flash_attention_cuda, supports=_supports,
                  sample=_sample)


def attention_op(q, k, v, *, causal: bool = True, window: int = 0):
    """Batched multi-head (GQA) attention over full sequences."""
    return registry.dispatch("flash_attention", (q, k, v),
                             common={"causal": causal, "window": window})
