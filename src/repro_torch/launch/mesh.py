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
NET_BW = 50e9                 # B/s each way: one 400 Gb/s NDR InfiniBand port
#                               a GPU (ConnectX-7), as in a DGX H100 (DGX
#                               H100 data sheet)
GPUS_PER_NODE = 8             # an HGX / DGX H100 node: 8 cards on NVLink
HBM_BYTES = 80e9              # device memory (data sheet: 80 GB)


def link_bw(shape: dict, axis: str) -> float:
    """The rate of the link a collective over ``axis`` of a mesh of
    ``shape`` ({axis: size}, mesh order, ranks laid out row-major)
    crosses: NVLink when the axis's ranks lie within one node of
    ``GPUS_PER_NODE`` consecutive ranks, else the network. An axis of the
    (16, 16) production meshes crosses nodes: ``model`` spans 16 ranks,
    ``data`` and ``pod`` stride over 16. A group that is no axis of the
    mesh crosses the network."""
    if axis not in shape:
        return NET_BW
    names = list(shape)
    stride = 1
    for a in names[names.index(axis) + 1:]:
        stride *= shape[a]
    return NVLINK_BW if stride * shape[axis] <= GPUS_PER_NODE else NET_BW
