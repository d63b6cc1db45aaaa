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

The op also writes the new token's K/V into the caches first (``k_new``,
``v_new``, ``slot``).  It is a custom op (``repro_torch::decode_attention``,
which declares the two caches it writes), so fake tensors and traces see
it without a launch.  On DTensor caches :func:`decode_op` runs it on each
rank's local shards under the caches' own placements
(:func:`repro_torch.distributed.op_rules.decode_placements`: q and the new
K/V follow the cache), so a sharded cache is written where it lives; a
cache it would have to move raises ``ValueError``.

With ``return_lse`` the kernel also gives each query head's log-sum-exp
of its scaled scores over ``[0, lengths)`` (float32 (B, Hq), ``-inf`` for
a length-0 lane): the statistic that combines partial decodes over
disjoint rows of one lane (:mod:`repro_torch.distributed.split_kv`).
``repro_torch::decode_attention_lse`` is that form of the op; it writes
nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels import build, registry
from repro_torch.kernels.decode_attention.ref import decode_ref

__all__ = ["decode_op", "decode_lse_op", "decode_attention_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 16   # query heads per kv head (the kernel's largest instance)
_MAX_D = 256      # head dims the kernel's shared buffers hold
_TARGET_BLOCKS = 256  # about two blocks for each of the H100's 132 SMs
_MIN_KEYS = 32        # keys per block below which a further split stops
_MAX_CLUSTER = 8      # blocks per cluster (the portable limit)


def _supports(q, k, v, lengths, return_lse: bool = False) -> bool:
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
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def decode_attention_cuda(q, k, v, lengths, return_lse: bool = False):
    """Launch the CUDA kernel: q (B, Hq, D); k/v (B, T, Hkv, D), contiguous;
    lengths (B,) integer → (B, Hq, D) in q.dtype, and with ``return_lse``
    also the float32 (B, Hq) log-sum-exp of the scaled scores.  Attends
    positions [0, lengths) (clipped to [0, T]); a length-0 row is zeros
    (and its log-sum-exp ``-inf``).  Raises on operands the kernel does not
    take."""
    if not (q.is_cuda and _supports(q, k, v, lengths)):
        raise ValueError("decode_attention_cuda: unsupported operands")
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    cluster, kpb = _cluster(b, hkv, t)
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        code = _lib().decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, t, hq, hkv, d, cluster, kpb, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check("decode_attention", code)
    registry.count_launch(decode_attention_cuda)
    return (out, lse) if return_lse else out


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


def _write(k_cache, v_cache, k_new, v_new, slot) -> None:
    """The new token's K/V (B, Hkv, D) into row ``slot`` (B,) of each lane."""
    if k_new is None:
        return
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache.index_put_((rows, slot), k_new.to(k_cache.dtype))
    v_cache.index_put_((rows, slot), v_new.to(v_cache.dtype))


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=("k_cache", "v_cache"))
def _decode_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               lengths: torch.Tensor, k_new: Optional[torch.Tensor],
               v_new: Optional[torch.Tensor], slot: Optional[torch.Tensor]) -> torch.Tensor:
    _write(k_cache, v_cache, k_new, v_new, slot)
    return registry.dispatch("decode_attention", (q, k_cache, v_cache, lengths))


@_decode_op.register_fake
def _(q, k_cache, v_cache, lengths, k_new, v_new, slot):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::decode_attention_lse", mutates_args=())
def _decode_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return registry.dispatch("decode_attention", (q, k, v, lengths),
                             common={"return_lse": True})


@_decode_lse_op.register_fake
def _(q, k, v, lengths):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


def _plain_call(q) -> bool:
    """Plain tensors outside any dispatch mode: the op's body runs directly
    (``torch.library``'s dispatch of an op that mutates its arguments
    costs a decode tick tens of microseconds a layer on the host)."""
    return type(q) is torch.Tensor and _get_current_dispatch_mode() is None


def decode_lse_op(q, k, v, lengths):
    """The decode of :func:`decode_op` without a cache write, → ``(out,
    lse)``: ``lse`` (B, Hq) float32 is each head's log-sum-exp of its
    scaled scores over ``[0, lengths)``, ``-inf`` where a lane has none."""
    if _plain_call(q):
        return registry.dispatch("decode_attention", (q, k, v, lengths),
                                 common={"return_lse": True})
    return _decode_lse_op(q, k, v, lengths)


def _decode_sharded(q, k, v, lengths, k_new, v_new, slot):
    """The decode on each rank's local shards of DTensor caches, which stay
    where they are (module docstring)."""
    from repro_torch.distributed.op_rules import decode_placements, placed

    mesh, kv_pl = k.device_mesh, tuple(k.placements)
    if not isinstance(v, DTensor) or tuple(v.placements) != kv_pl:
        raise ValueError("decode: the K and V caches must be DTensors placed alike")
    q_pl, len_pl = decode_placements(mesh, kv_pl, q.shape[1], k.shape[2])
    new_pl = None if k_new is None else q_pl
    slot_pl = None if slot is None else len_pl
    run = local_map(_decode_local, out_placements=list(q_pl),
                    in_placements=(q_pl, kv_pl, kv_pl, len_pl, new_pl, new_pl, slot_pl),
                    device_mesh=mesh)  # redistributes nothing: a mismatch raises
    return run(placed(q, mesh, q_pl), k, v, placed(lengths, mesh, len_pl),
               placed(k_new, mesh, q_pl), placed(v_new, mesh, q_pl), placed(slot, mesh, len_pl))


def _decode_local(q, k, v, lengths, k_new, v_new, slot):
    if _plain_call(q):
        _write(k, v, k_new, v_new, slot)
        return registry.dispatch("decode_attention", (q, k, v, lengths))
    return _decode_op(q, k, v, lengths, k_new, v_new, slot)


def decode_op(q, k, v, lengths, *, k_new=None, v_new=None, slot=None):
    """Single-token GQA decode attention over a dense KV cache; with
    ``k_new``/``v_new`` (B, Hkv, D) and ``slot`` (B,) it first writes the
    new token into the caches, in place.  Plain tensors outside any
    dispatch mode (the serving engines' every tick) run the op's body
    directly; fake tensors and traces go through the op; DTensor caches
    are decoded on each rank's shards, where they live."""
    if isinstance(k, DTensor):
        return _decode_sharded(q, k, v, lengths, k_new, v_new, slot)
    return _decode_local(q, k, v, lengths, k_new, v_new, slot)
