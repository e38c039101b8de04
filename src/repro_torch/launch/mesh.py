"""Production mesh construction on ``torch.distributed``.

Single pod = 16 x 16 = 256 ranks (axes ``data x model``); two pods = 512
ranks (``pod x data x model``), the JAX package's mesh shapes, kept so
that the sharding specs (``sharding/specs.py``) stay equal to its own.
On H100 nodes of 8 GPUs each, a 16-wide ``model`` axis spans two nodes,
so its collectives cross the inter-node network as well as NVLink.

The mesh is built by :func:`make_production_mesh`, never when this module
is imported: the process group must exist first (``torchrun`` or
``torch.distributed.init_process_group`` with an address, a world size
and a rank).
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["HBM_BW", "HBM_BYTES", "LINK_BW", "PEAK_FLOPS_BF16",
           "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have} — start "
            f"{n} processes (torchrun) and initialise the process group "
            f"before building the mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


# NVIDIA H100 SXM hardware constants (roofline targets; the data sheet's
# dense peaks at 700 W)
PEAK_FLOPS_BF16 = 989e12          # per GPU
HBM_BW = 3.35e12                  # bytes/s per GPU
LINK_BW = 450e9                   # NVLink 4, bytes/s per GPU per direction
HBM_BYTES = 80 * 10 ** 9          # 80 GB per GPU
