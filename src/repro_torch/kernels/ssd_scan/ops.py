"""SSD inter-chunk state scan: the plain version and the CUDA kernel behind one op.

:func:`ssd_scan_op` (the custom op ``repro_torch::ssd_scan``) is what the
port's ``ssd_chunked`` calls for Mamba-2's only sequential dependency.
Through the registry it runs
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_scan_ref` on CPU tensors and
:func:`ssd_scan_cuda` (the hand-written kernel in ``csrc/ssd_scan.cu``,
which replaces the Pallas ``ssd_scan``) on CUDA tensors.  Like the Pallas
kernel, the CUDA kernel starts every scan from zero: an ``initial_state``
on the card raises ``ValueError``.

Being a custom op, it traces as one node (``register_fake``), so a traced
microbatch body keeps the launch, and it has a gradient
(``register_autograd``): the recurrence's adjoint, the registry's
``ssd_scan_bwd`` op (the custom op ``repro_torch::ssd_scan_bwd``, one node
too), which runs :func:`~repro_torch.kernels.ssd_scan.ref.ssd_scan_bwd_ref`
on the CPU and :func:`ssd_scan_bwd_cuda` (the second entry of
``csrc/ssd_scan.cu``) on the card.  The JAX package has no backward kernel:
XLA differentiates its ``lax.scan``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref

__all__ = ["ssd_scan_op", "ssd_scan_cuda", "ssd_scan_bwd_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # the kernels' block size: one partial sum of d_decay a block


def _supports(states, decay, initial_state=None) -> bool:
    if initial_state is not None or states.dim() != 5 or decay.dim() != 3:
        return False
    b, c, h, p, n = states.shape
    return (decay.device == states.device
            and states.dtype in _DTYPES and decay.dtype == torch.float32
            and tuple(decay.shape) == (b, c, h)
            and 0 < b <= 65535 and c > 0 and 0 < h <= 65535 and 0 < p * n < 2**31
            and states.is_contiguous() and decay.is_contiguous())


def _supports_bwd(g_prev, g_final, prev, decay) -> bool:
    if g_prev.shape != prev.shape or g_prev.dtype != prev.dtype or not g_prev.is_contiguous():
        return False
    if g_final is not None and not (
            g_final.dtype == torch.float32 and g_final.is_contiguous()
            and g_final.device == prev.device
            and tuple(g_final.shape) == tuple(prev.shape[:1] + prev.shape[2:])):
        return False
    return g_prev.device == prev.device and _supports(prev, decay)


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    if lib.ssd_scan.argtypes is None:  # declare the C signatures once per process
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.ssd_scan.restype = ci
        lib.ssd_scan_bwd.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        lib.ssd_scan_bwd.restype = ci
    return lib


def ssd_scan_cuda(states, decay, initial_state=None):
    """Launch the CUDA kernel: states (B, C, H, P, N) float32 or bf16,
    decay (B, C, H) float32, both contiguous → (prev (B, C, H, P, N) in
    states' dtype, final (B, H, P, N) float32).  Raises on operands the
    kernel does not take, ``initial_state`` included."""
    if not (states.is_cuda and _supports(states, decay, initial_state)):
        raise ValueError("ssd_scan_cuda: unsupported operands")
    b, c, h, p, n = states.shape
    prev = torch.empty_like(states)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=states.device)
    with torch.cuda.device(states.device):
        code = _lib().ssd_scan(
            states.data_ptr(), decay.data_ptr(), prev.data_ptr(), final.data_ptr(),
            b, c, h, p * n, _DTYPES[states.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check("ssd_scan", code)
    registry.count_launch(ssd_scan_cuda)
    return prev, final


ssd_scan_cuda.launches = 0


def ssd_scan_bwd_cuda(g_prev, g_final, prev, decay):
    """Launch the adjoint: g_prev (B, C, H, P, N) in prev's dtype (float32
    or bf16), g_final (B, H, P, N) float32 or None (zeros), the forward's
    prev and decay (B, C, H) float32, all contiguous → (d_states in prev's
    dtype, d_decay (B, C, H) float32, d_initial (B, H, P, N) float32).
    ``d_decay`` is summed in a fixed order: a repeated call gives the same
    bits.  Raises on operands the kernel does not take."""
    if not (prev.is_cuda and _supports_bwd(g_prev, g_final, prev, decay)):
        raise ValueError("ssd_scan_bwd_cuda: unsupported operands")
    b, c, h, p, n = prev.shape
    n_blocks = -(-(p * n) // _THREADS)
    dev = prev.device
    d_states = torch.empty_like(prev)
    d_decay = torch.empty((b, c, h), dtype=torch.float32, device=dev)
    d_initial = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    partial = torch.empty((b, c, h, n_blocks), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _lib().ssd_scan_bwd(
            g_prev.data_ptr(), None if g_final is None else g_final.data_ptr(),
            prev.data_ptr(), decay.data_ptr(), d_states.data_ptr(), d_decay.data_ptr(),
            d_initial.data_ptr(), partial.data_ptr(), b, c, h, p * n, n_blocks,
            _DTYPES[prev.dtype], torch.cuda.current_stream().cuda_stream)
    build.check("ssd_scan_bwd", code)
    registry.count_launch(ssd_scan_bwd_cuda)
    return d_states, d_decay, d_initial


ssd_scan_bwd_cuda.launches = 0


def _decay(rng: np.random.Generator, shape) -> np.ndarray:
    return (1.0 / (1.0 + np.exp(-rng.standard_normal(shape, dtype=np.float32)))).astype(
        np.float32)


def _sample(rng: np.random.Generator) -> registry.OpSample:
    """The reference's ``_sample`` shapes, drawn with numpy: states
    (2, 8, 4, 16, 32), decay ``sigmoid(normal)`` (2, 8, 4)."""
    states = rng.standard_normal((2, 8, 4, 16, 32), dtype=np.float32)
    return registry.OpSample(args=(states, _decay(rng, (2, 8, 4))))


def _sample_bwd(rng: np.random.Generator) -> registry.OpSample:
    """The forward sample's shapes: cotangents ``g_prev`` and ``g_final``,
    the forward's ``prev`` and ``decay``."""
    shape = (2, 8, 4, 16, 32)
    g_prev, prev = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    g_final = rng.standard_normal((2, 4, 16, 32), dtype=np.float32)
    return registry.OpSample(args=(g_prev, g_final, prev, _decay(rng, shape[:3])))


registry.register("ssd_scan", ref=ssd_scan_ref, kernel=ssd_scan_cuda,
                  supports=_supports, sample=_sample)
registry.register("ssd_scan_bwd", ref=ssd_scan_bwd_ref, kernel=ssd_scan_bwd_cuda,
                  supports=_supports_bwd, sample=_sample_bwd)


def _prev_dtype(states: torch.Tensor) -> torch.dtype:
    """``prev``'s dtype: the states' on the card, float32 from the plain
    version on the CPU."""
    return states.dtype if states.device.type == "cuda" else torch.float32


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _scan_op(states: torch.Tensor, decay: torch.Tensor,
             initial_state: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    return registry.dispatch("ssd_scan", (states, decay),
                             common={"initial_state": initial_state})


@_scan_op.register_fake
def _(states, decay, initial_state):
    b, c, h, p, n = states.shape
    return (torch.empty(states.shape, dtype=_prev_dtype(states), device=states.device),
            states.new_empty((b, h, p, n), dtype=torch.float32))


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _scan_bwd_op(g_prev: torch.Tensor, g_final: Optional[torch.Tensor], prev: torch.Tensor,
                 decay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return registry.dispatch("ssd_scan_bwd", (g_prev, g_final, prev, decay))


@_scan_bwd_op.register_fake
def _(g_prev, g_final, prev, decay):
    b, c, h, p, n = prev.shape
    return (torch.empty_like(prev), decay.new_empty((b, c, h)),
            prev.new_empty((b, h, p, n), dtype=torch.float32))


def _setup_grad(ctx, inputs, output) -> None:
    _states, decay, initial_state = inputs
    ctx.save_for_backward(output[0], decay)
    ctx.has_initial = initial_state is not None
    # An output no loss reads (the model's final state) gets None, not
    # zeros: the kernel then reads no g_final.
    ctx.set_materialize_grads(False)


def _grad(ctx, g_prev, g_final):
    prev, decay = ctx.saved_tensors
    g_prev = torch.zeros_like(prev) if g_prev is None else g_prev.to(prev.dtype).contiguous()
    if g_final is not None:
        g_final = g_final.float().contiguous()
    d_states, d_decay, d_initial = _scan_bwd_op(g_prev, g_final, prev, decay)
    return d_states, d_decay, (d_initial if ctx.has_initial else None)


_scan_op.register_autograd(_grad, setup_context=_setup_grad)


def ssd_scan_op(states, decay, initial_state: Optional[torch.Tensor] = None):
    """Inter-chunk SSD state scan → (state entering each chunk, final),
    with its gradient.  Operands are made contiguous first (a copy when
    they are not)."""
    return _scan_op(states.contiguous(), decay.contiguous(), initial_state)
