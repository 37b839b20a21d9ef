"""Production meshes over ``torch.distributed`` ranks (port of the
reference's ``launch/mesh.py``), and the H100's rates for rooflines.

The meshes are FUNCTIONS, not module constants, so importing this module
touches no process group. Each builds a ``DeviceMesh`` over the default
process group, which the caller has initialised (``torchrun`` sets its
rank and world in the environment; a single process calls
``torch.distributed.init_process_group`` itself), with the reference's
axis names.
"""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(data 16, model 16), or (pod 2, data 16, model 16): 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_local_mesh(device: str = "cuda"):
    """A 1 x 1 mesh with the production axis names: one rank."""
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit), per card.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12        # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12              # B/s, HBM3
NVLINK_BW = 450e9             # B/s each way: NVLink 4, 18 links x 25 GB/s
#                               (the data sheet's 900 GB/s is both ways)
