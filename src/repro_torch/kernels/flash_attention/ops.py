"""GQA attention: the plain version and the CUDA kernel behind one op.

:func:`attention_op` (the custom op ``repro_torch::flash_attention``) is
what the model's prefill and training forward call.  Through the registry
it runs :func:`~repro_torch.kernels.flash_attention.ref.attention_ref` on
CPU tensors and :func:`flash_attention_cuda` (the hand-written kernel in
``csrc/flash_attention.cu``, which replaces the Pallas ``flash_attention``)
on CUDA tensors.  The mask is causal (top-left aligned), a causal band
(``window`` > 0: hymba's sliding window), causal on ``positions`` instead
of indices (M-RoPE prefills), or none (an encoder, cross attention over
a memory of another length).  Operands may be strided views; only the D
axis must be contiguous.  The output is laid out like q on both devices.
The kernel has two instances, both hand-written: bf16 at D 64 or 128 on
the tensor cores (wgmma), everything else on the CUDA cores;
:func:`_instance` picks one.

Being a custom op, it traces as one node (``register_fake``), so a traced
loop body keeps the launch instead of freezing its output, and it has a
gradient (``register_autograd``): the backward recomputes the plain
version and differentiates it, on every device.  The JAX package has no
backward kernel either; its gradient is XLA's autodiff of plain attention.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import build, registry
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_op", "flash_attention_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)  # the kernel's compiled D instances
_CUDA_CORES, _TENSOR_CORES = 0, 1  # the C entry's `instance` argument


def _supports(q, k, v, *, causal: bool = True, window: int = 0,
              positions=None) -> bool:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return False
    b, hq, s, d = q.shape
    bk, hkv, t, dk = k.shape
    if positions is not None and not (
            causal and s == t and positions.device == q.device
            and not positions.is_floating_point() and tuple(positions.shape) == (b, s)):
        return False
    return (window >= 0 and (causal or window == 0)
            and k.device == q.device and v.device == q.device
            and q.dtype in _DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype and bk == b and dk == d and d in _HEAD_DIMS
            and hkv > 0 and hq % hkv == 0 and b * hq <= 65535
            and q.shape[2] > 0 and k.shape[2] > 0
            and q.stride(-1) == 1 and k.stride(-1) == 1 and v.stride(-1) == 1)


def _instance(dtype: torch.dtype, d: int, aligned: bool = True) -> int:
    """The kernel instance for operands of ``dtype`` and head dim ``d``:
    the tensor cores for bf16 at D 64 or 128 whose rows are 16-byte
    aligned (``aligned``: every pointer a multiple of 16 bytes and every
    batch, head and sequence stride a multiple of 8 elements); the CUDA
    cores otherwise.  Float32 stays off the tensor cores: they would
    round its operands to TF32 (about 1e-3)."""
    if dtype == torch.bfloat16 and d in (64, 128) and aligned:
        return _TENSOR_CORES
    return _CUDA_CORES


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 and all(t.stride(i) % 8 == 0 for i in range(3))
               for t in ts)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:  # declare the C signature once per process
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                       ctypes.POINTER(ctypes.c_longlong), ci, ci, vp, ctypes.c_longlong,
                       ci, ci, vp]
        fn.restype = ci
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         positions=None):
    """Launch the CUDA kernel: q (B, Hq, S, D), k/v (B, Hkv, T, D), any
    strides with a contiguous D axis → (B, Hq, S, D) in q.dtype, laid out
    like q.  ``window`` > 0 (causal only) bands the mask; ``positions``
    (B, S) integers (causal, S == T) mask on positions instead of indices.
    Raises on operands the kernel does not take."""
    if not (q.is_cuda and _supports(q, k, v, causal=causal, window=window,
                                     positions=positions)):
        raise ValueError("flash_attention_cuda: unsupported operands")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # keeps q's strides for a dense permuted view
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, out) for i in range(3)))
    instance = _instance(q.dtype, d, _aligned(q, k, v, out))
    pos = None if positions is None else positions.to(torch.int32).contiguous()
    with torch.cuda.device(q.device):
        code = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, s, t, d, strides, int(causal), int(window),
            None if pos is None else pos.data_ptr(), s, _DTYPES[q.dtype],
            instance, torch.cuda.current_stream().cuda_stream)
    build.check("flash_attention", code)
    registry.count_launch(flash_attention_cuda)
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


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: int, positions: Optional[torch.Tensor]) -> torch.Tensor:
    out = registry.dispatch("flash_attention", (q, k, v),
                            common={"causal": causal, "window": window,
                                    "positions": positions})
    if out.stride() != q.stride():  # the plain version's is contiguous
        out = torch.empty_like(q).copy_(out)
    return out


@_flash_op.register_fake
def _(q, k, v, causal, window, positions):
    return torch.empty_like(q)


def _setup_grad(ctx, inputs, output) -> None:
    q, k, v, causal, window, positions = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window, ctx.positions = causal, window, positions
    # on DTensors, the placements the sharding rule ran the op under
    ctx.placements = output.placements if isinstance(output, DTensor) else None


def _ref_grad(q, k, v, grad, causal, window, positions):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window, positions=positions)
        return torch.autograd.grad(out, leaves, grad)


def _grad(ctx, grad):
    """Recompute the plain version and differentiate it.  On DTensors each
    rank differentiates its own shard, which the op's sharding rule made a
    whole attention problem (batch rows, or heads with their kv heads)."""
    q, k, v = ctx.saved_tensors
    if not isinstance(q, DTensor):
        dq, dk, dv = _ref_grad(q, k, v, grad, ctx.causal, ctx.window, ctx.positions)
        return dq, dk, dv, None, None, None
    mesh, pl = q.device_mesh, ctx.placements
    q, k, v, grad = (t.redistribute(mesh, pl) for t in (q, k, v, grad))
    pos = ctx.positions
    if isinstance(pos, DTensor):  # batch-sharded with the batch, else whole
        pos = pos.redistribute(mesh, [p if p == Shard(0) else Replicate() for p in pl])
    local = _ref_grad(q.to_local(), k.to_local(), v.to_local(), grad.to_local(),
                      ctx.causal, ctx.window,
                      pos.to_local() if isinstance(pos, DTensor) else pos)
    dq, dk, dv = (DTensor.from_local(g.contiguous(), mesh, pl, run_check=False)
                  for g in local)
    return dq, dk, dv, None, None, None


_flash_op.register_autograd(_grad, setup_context=_setup_grad)


def attention_op(q, k, v, *, causal: bool = True, window: int = 0, positions=None):
    """Batched multi-head (GQA) attention over full sequences: causal,
    banded (``window``), causal on ``positions`` (B, S), or full."""
    return _flash_op(q, k, v, causal, window, positions)
