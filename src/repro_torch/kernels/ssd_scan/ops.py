"""SSD inter-chunk state scan: the plain version and the CUDA kernel behind one op.

:func:`ssd_scan_op` is what the port's ``ssd_chunked`` calls for Mamba-2's
only sequential dependency.  Through the registry it runs
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_scan_ref` on CPU tensors and
:func:`ssd_scan_cuda` (the hand-written kernel in ``csrc/ssd_scan.cu``,
which replaces the Pallas ``ssd_scan``) on CUDA tensors.  Like the Pallas
kernel, the CUDA kernel starts every scan from zero: an ``initial_state``
on the card raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["ssd_scan_op", "ssd_scan_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _supports(states, decay, initial_state=None) -> bool:
    if initial_state is not None or states.dim() != 5 or decay.dim() != 3:
        return False
    b, c, h, p, n = states.shape
    return (decay.device == states.device
            and states.dtype in _DTYPES and decay.dtype == torch.float32
            and tuple(decay.shape) == (b, c, h)
            and 0 < b <= 65535 and c > 0 and 0 < h <= 65535 and 0 < p * n < 2**31
            and states.is_contiguous() and decay.is_contiguous())


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan
    if fn.argtypes is None:  # declare the C signature once per process
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
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


def _sample(rng: np.random.Generator) -> registry.OpSample:
    """The reference's ``_sample`` shapes, drawn with numpy: states
    (2, 8, 4, 16, 32), decay ``sigmoid(normal)`` (2, 8, 4)."""
    states = rng.standard_normal((2, 8, 4, 16, 32), dtype=np.float32)
    decay = 1.0 / (1.0 + np.exp(-rng.standard_normal((2, 8, 4), dtype=np.float32)))
    return registry.OpSample(args=(states, decay.astype(np.float32)))


registry.register("ssd_scan", ref=ssd_scan_ref, kernel=ssd_scan_cuda,
                  supports=_supports, sample=_sample)


def ssd_scan_op(states, decay, initial_state: Optional[torch.Tensor] = None):
    """Inter-chunk SSD state scan → (state entering each chunk, final).
    Operands are made contiguous first (a copy when they are not)."""
    return registry.dispatch("ssd_scan", (states.contiguous(), decay.contiguous()),
                             common={"initial_state": initial_state})
