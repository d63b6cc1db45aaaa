"""Batched row gather: the plain version and the CUDA kernel behind one op.

:func:`gather_op` (the custom op ``repro_torch::batched_gather``) is the
set-oriented executor of the ``table_gather`` query
(:mod:`repro_torch.core.query`): one call for every id the fissioned loop
collected.  Through the registry it runs
:func:`~repro_torch.kernels.batched_gather.ref.gather_ref` on CPU tensors
and :func:`batched_gather_cuda` (the hand-written kernel in
``csrc/batched_gather.cu``, which replaces the Pallas ``batched_gather``)
on CUDA tensors, which it takes in float32 or bf16 with int32 or int64
ids of any shape and count N >= 1.  Anything else on the card raises
``ValueError``; nothing falls back to the plain version there.  An id
outside [0, V) is the caller's contract, as in the reference: the kernel
does not check it and nothing reads the ids back to the host.

Being a custom op, it traces as one node (``register_fake``), has a
gradient (``register_autograd``: the float32 scatter-add of
:func:`~repro_torch.kernels.batched_gather.ref.scatter_add_ref`, plain
PyTorch on every device) and a batching rule (``register_vmap``: a
batched id tensor is one larger gather).  The ``table_gather`` query op
calls it below autograd, but fission's batched execution calls it
directly: under ``torch.autograd.grad`` or ``torch.vmap`` of a fissioned
loop, and under an outer fission's trace (where it must be one node that
is not a query, as the reference's Pallas op is), it needs these rules of
its own, since the ctypes launch has none.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.batched_gather.ref import gather_ref, scatter_add_ref

__all__ = ["gather_op", "batched_gather_cuda", "setup_gather_grad", "gather_grad"]

_DTYPES = (torch.float32, torch.bfloat16)
_ID_DTYPES = (torch.int32, torch.int64)


def _supports(table, ids) -> bool:
    return (table.dim() == 2 and table.dtype in _DTYPES and ids.dtype in _ID_DTYPES
            and ids.device == table.device and table.shape[0] > 0
            and table.shape[1] > 0 and ids.numel() > 0 and table.is_contiguous())


def _lib() -> ctypes.CDLL:
    lib = build.load("batched_gather")
    fn = lib.batched_gather
    if fn.argtypes is None:  # declare the C signature once per process
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, cl, cl, ci, ci, vp]
        fn.restype = ci
    return lib


def batched_gather_cuda(table, ids):
    """Launch the CUDA kernel: table (V, D) float32 or bf16, contiguous;
    ids int32 or int64 of any shape with at least one element → ids.shape
    + (D,) in the table's dtype.  Raises on operands the kernel does not
    take."""
    if not (table.is_cuda and _supports(table, ids)):
        raise ValueError("batched_gather_cuda: unsupported operands")
    flat = ids.reshape(-1).contiguous()
    d = table.shape[1]
    out = torch.empty((flat.shape[0], d), dtype=table.dtype, device=table.device)
    row_bytes = d * table.element_size()
    unit = (16 if row_bytes % 16 == 0 and table.data_ptr() % 16 == 0
            else table.element_size())  # out is a fresh allocation: aligned
    with torch.cuda.device(table.device):
        code = _lib().batched_gather(
            table.data_ptr(), flat.data_ptr(), out.data_ptr(), flat.shape[0], row_bytes,
            flat.element_size(), unit, torch.cuda.current_stream().cuda_stream)
    build.check("batched_gather", code)
    registry.count_launch(batched_gather_cuda)
    return out.reshape(ids.shape + (d,))


batched_gather_cuda.launches = 0


def _sample(rng: np.random.Generator) -> registry.OpSample:
    """The reference's ``_sample`` shapes, drawn with numpy: table (128,
    32) float32, 64 int32 ids."""
    table = rng.standard_normal((128, 32), dtype=np.float32)
    ids = rng.integers(0, 128, size=(64,)).astype(np.int32)
    return registry.OpSample(args=(table, ids))


registry.register("batched_gather", ref=gather_ref, kernel=batched_gather_cuda,
                  supports=_supports, sample=_sample)


@torch.library.custom_op("repro_torch::batched_gather", mutates_args=())
def gather_op(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Batched row gather ``table[ids]`` (the loop-context table fetch)."""
    return registry.dispatch("batched_gather", (table, ids))


@gather_op.register_fake
def _(table, ids):
    return table.new_empty(ids.shape + table.shape[1:])


def setup_gather_grad(ctx, inputs, output) -> None:
    """``setup_context`` of a gather ``(table, ids) -> rows``."""
    table, ids = inputs
    ctx.save_for_backward(ids)
    ctx.table_shape, ctx.table_dtype = table.shape, table.dtype


def gather_grad(ctx, grad):
    """Backward of a gather: the scatter-add into the table, none for ids."""
    (ids,) = ctx.saved_tensors
    return scatter_add_ref(grad, ids, ctx.table_shape, ctx.table_dtype), None


gather_op.register_autograd(gather_grad, setup_context=setup_gather_grad)


@gather_op.register_vmap
def _(info, in_dims, table, ids):
    t_dim, i_dim = in_dims
    if t_dim is None:  # a batch of id sets over one table: one larger gather
        return gather_op(table, ids.movedim(i_dim, 0)), 0
    ids = ids.movedim(i_dim, 0) if i_dim is not None else ids.expand(
        (table.shape[t_dim],) + ids.shape)
    return torch.stack([gather_op(t, i) for t, i in zip(table.movedim(t_dim, 0), ids)]), 0
