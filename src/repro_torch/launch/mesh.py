"""Production meshes for the port, as :class:`DeviceMesh` objects.

Port of :mod:`repro.launch.mesh`.  The meshes are made by FUNCTIONS, so
importing this module creates no process group; the caller starts one
first (``torch.distributed.init_process_group``: NCCL or gloo on real
ranks, the ``fake`` backend for :mod:`repro_torch.launch.dryrun`).

  single : (data=16, model=16)          = 256 ranks
  multi  : (pod=2, data=16, model=16)   = 512 ranks

Axis roles are the reference's: ``pod`` and ``data`` carry data
parallelism and FSDP parameter sharding, ``model`` tensor parallelism
and MoE expert parallelism; ``dp`` in the rule table
(:mod:`repro_torch.distributed.sharding`) resolves to (pod, data) on the
multi-pod mesh and (data,) on the single one.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_test_mesh", "HW"]


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(n_data: int = 2, n_model: int = 2, device_type: str = "cuda") -> DeviceMesh:
    """A small (data, model) mesh over the process group's first
    ``n_data * n_model`` ranks (tests, the card's shared-card ranks)."""
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


# Roofline constants of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
# rates, at the full 700 W power limit), per card.
HW = {
    "peak_bf16_flops": 989e12,   # H100 SXM: 989 TFLOP/s bf16 dense
    "hbm_bw": 3.35e12,           # H100 SXM: 3.35 TB/s HBM3
    "nvlink_bw": 450e9,          # H100 SXM: NVLink 900 GB/s, 450 GB/s each way
    "hbm_bytes": 80e9,           # H100 SXM: 80 GB
}
