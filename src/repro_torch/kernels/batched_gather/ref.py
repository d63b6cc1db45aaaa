"""Plain PyTorch versions of the row gather and of its gradient.

Port of :func:`repro.kernels.batched_gather.ref.gather_ref` (``jnp.take``
along axis 0).  :func:`gather_ref` is the plain version of the
``batched_gather`` op (:mod:`.ops`); :func:`scatter_add_ref` is the op's
backward on every device.  The JAX package has no backward kernel: there
XLA transposes ``take`` into a scatter-add, which this restates.
"""
from __future__ import annotations

import torch

__all__ = ["gather_ref", "scatter_add_ref"]


def gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, D), ids of any shape, integer → ids.shape + (D,) in the
    table's dtype."""
    return table.index_select(0, ids.reshape(-1)).reshape(ids.shape + table.shape[1:])


def scatter_add_ref(grad: torch.Tensor, ids: torch.Tensor, shape, dtype) -> torch.Tensor:
    """The gather's gradient with respect to the table: ``grad`` (ids.shape
    + (D,)) added row by row into a float32 zero table of ``shape`` at
    ``ids``, then cast to ``dtype``.  Out of place (``index_add``, not
    ``index_add_``): a traced loop body may hold it, and fission refuses
    bodies that write into their inputs."""
    rows = grad.reshape(-1, shape[-1]).float()
    zero = torch.zeros(shape, dtype=torch.float32, device=grad.device)
    return zero.index_add(0, ids.reshape(-1), rows).to(dtype)
