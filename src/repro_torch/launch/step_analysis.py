"""Per-device FLOPs, HBM bytes, collectives and memory of one eager step
(the port's counterpart of the reference's ``launch/hlo_analysis.py``).

The reference compiles a step with XLA and parses the partitioned HLO
text: loop trip counts, fusion boundaries, collective ops. An eager
torch step has no program text, so :func:`analyze` runs the step once,
on meta tensors (or DTensors over meta tensors on a fake-backend mesh),
under one ``TorchDispatchMode`` that sees every op a rank runs:

* ``flops``: ``torch.utils.flop_counter``'s formulas for the aten ops
  and, for a kernel launch (a ``repro_torch::`` op, ``kernels.kernel_op``),
  the kernel's own cost function (``kernels/costs.py``). A launch is one
  op at its real shapes; its plain version's ops never run.
* ``hbm_bytes``: each op's input and output bytes. Views move nothing;
  an indexed read (``index``, ``gather``, ``embedding``) moves twice
  its result, an indexed write (``index_put_``, ``scatter``) twice its
  values (and its indices once), a fill or copy writes its output and reads only its source,
  and a kernel launch moves its cost function's bytes.
* ``collective_bytes`` / ``collective_counts``: the ``c10d`` and
  ``_c10d_functional`` ops, by kind and (``collective_bytes_by_axis``)
  by mesh axis (``world`` for a group that is no axis), at the size of
  their largest buffer; an all-reduce moves twice that (a ring's
  reduce-scatter and all-gather), as in the reference.
* ``argument_bytes``: the local shards of the step's arguments (params,
  optimizer state, batch, cache).
* ``peak_bytes``: the most bytes of live storage at any point of the
  step, the arguments counted live throughout; a storage lives until
  its last tensor is freed (weak references, as ``MemTracker`` keeps
  them).

Every number is per device already: the ops a DTensor dispatches run
on the rank's local shards. The reference's CPU-XLA corrections are not
ported: ``dual_dtype_loop_state`` (f32 twins of bf16 loop state that
XLA's CPU emitter keeps), ``collective_bytes_tpu`` (f32 collectives
counted at bf16 width) and the all-reduce-as-reduce-scatter rewrite
each mend an artifact of XLA's CPU lowering, and an eager torch step
has none: its dtypes and collectives are the ones the card runs.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

aten = torch.ops.aten

# collective op names (c10d and _c10d_functional) -> the reference's kinds
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
_INDEXED_READS = {aten.index.Tensor, aten.index_select.default,
                  aten.gather.default, aten.embedding.default}
_INDEXED_WRITES = {aten.index_put_.default, aten.index_put.default,
                   aten._index_put_impl_.default, aten.scatter_.src,
                   aten.scatter_.value, aten.scatter.src,
                   aten.scatter_add_.default, aten.scatter_add.default,
                   aten.index_add_.default, aten.index_copy_.default}
_WRITE_ONLY = {aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default,
               aten.copy_.default}
# ops about a tensor's metadata, never its data (FlopCounterMode's list)
_METADATA = {aten.is_contiguous.default, aten.is_contiguous.memory_format,
             aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default,
             aten.sym_stride.default, aten.storage_offset.default,
             aten.sym_storage_offset.default, aten.numel.default,
             aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default, torch.ops.prim.device.default}


@dataclass
class StepStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=lambda: defaultdict(float))
    collective_counts: dict = field(default_factory=lambda: defaultdict(int))
    collective_bytes_by_axis: dict = field(
        default_factory=lambda: defaultdict(float))
    argument_bytes: int = 0
    peak_bytes: int = 0
    kernel_launches: dict = field(default_factory=lambda: defaultdict(int))
    n_ops: int = 0

    def as_record(self) -> dict:
        return {"flops_per_device": self.flops,
                "hbm_bytes_per_device": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "collective_bytes_by_axis":
                    dict(self.collective_bytes_by_axis),
                "kernel_launches": dict(self.kernel_launches),
                "n_ops": self.n_ops}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree) -> list:
    return [_local(t) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def argument_bytes(*args) -> int:
    """Bytes of the local shards of every tensor in ``args`` (each tensor
    once)."""
    seen = {id(t): _nbytes(t) for t in _tensors(args)}
    return sum(seen.values())


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def op_bytes(func, args, kwargs, out) -> float:
    """HBM bytes an eager op moves (the module docstring's rules)."""
    if _is_view(func):
        return 0.0
    ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t,
                                                                torch.Tensor)]
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if func in _INDEXED_READS:
        idx = sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
        return 2.0 * sum(_nbytes(t) for t in outs) + idx
    if func in _INDEXED_WRITES:
        return sum((2.0 if t.is_floating_point() else 1.0) * _nbytes(t)
                   for t in ins[1:])
    if func in _WRITE_ONLY:
        return float(sum(_nbytes(t) for t in ins[1:])
                     + sum(_nbytes(t) for t in outs))
    return float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))


def _group_name(leaves):
    """The process group's name among a collective's arguments: a string
    for ``_c10d_functional``, a boxed ``ProcessGroup`` for ``c10d``."""
    for a in reversed(leaves):         # the group comes after the op
        if isinstance(a, str):
            return a
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in \
                a._type().qualified_name():
            return dist.ProcessGroup.unbox(a).group_name
    return None


class _Live:
    """Bytes of live storage: a storage counts from the op that made it
    (or from the start, for an argument) until it is freed."""

    def __init__(self):
        self.now = self.peak = 0
        self._refs: dict = {}

    def add(self, storage, nbytes: int) -> None:
        key = id(storage)
        if key in self._refs:
            return
        self._refs[key] = weakref.ref(storage, lambda _, k=key, n=nbytes:
                                      self._free(k, n))
        self.now += nbytes
        self.peak = max(self.peak, self.now)

    def _free(self, key, nbytes: int) -> None:
        self._refs.pop(key, None)
        self.now -= nbytes


class _Analysis(TorchDispatchMode):
    def __init__(self, stats: StepStats, axes: dict):
        super().__init__()
        self.stats, self.axes, self.live = stats, axes, _Live()

    def track(self, tensors, *, whole: bool) -> None:
        for t in tensors:
            st = t.untyped_storage()
            self.live.add(st, st.nbytes() if whole else _nbytes(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            return NotImplemented       # DTensor runs it as local ops
        if any(isinstance(t, FakeTensor) for t in leaves):
            return func(*args, **kwargs)  # DTensor's shape propagation
        packet = func._overloadpacket
        if packet not in flop_registry and func.namespace == "aten":
            with self:                    # count what it decomposes into
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        s = self.stats
        s.n_ops += 1
        kind = COLLECTIVE_KINDS.get(func._schema.name.split("::")[-1]) \
            if func.namespace in ("c10d", "_c10d_functional") else None
        if kind is not None:
            size = max((_nbytes(t) for t in tree_leaves((args, out))
                        if isinstance(t, torch.Tensor)), default=0)
            moved = (2.0 if kind == "all-reduce" else 1.0) * size
            s.collective_bytes[kind] += moved
            s.collective_counts[kind] += 1
            s.collective_bytes_by_axis[self.axes.get(_group_name(leaves),
                                                     "world")] += moved
        elif packet in kernels.COSTS:
            flops, nbytes = kernels.COSTS[packet](*args, **kwargs)
            s.flops += flops
            s.hbm_bytes += nbytes
            s.kernel_launches[func._schema.name.split("::")[-1]] += 1
        elif func.namespace != "_c10d_functional":
            if packet in flop_registry:
                s.flops += flop_registry[packet](*args, **kwargs,
                                                 out_val=out)
            s.hbm_bytes += op_bytes(func, args, kwargs, out)
        if not _is_view(func):
            self.track([t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)
                        and not isinstance(t, FakeTensor)], whole=True)
        self.stats.peak_bytes = self.live.peak
        return out


def mesh_axes(mesh) -> dict:
    """{process-group name: mesh axis} of a DeviceMesh (empty for None)."""
    if mesh is None:
        return {}
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


def analyze(fn, *args, mesh=None, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once under the analysis; returns
    (fn's result, :class:`StepStats`). ``mesh``: the DeviceMesh whose
    axes name the collectives' groups. The arguments' local shards are
    ``argument_bytes`` and live from the start."""
    stats = StepStats(argument_bytes=argument_bytes(args, kwargs))
    mode = _Analysis(stats, mesh_axes(mesh))
    arg_tensors = _tensors((args, kwargs))
    with mode:
        mode.track(arg_tensors, whole=False)
        out = fn(*args, **kwargs)
    stats.peak_bytes = mode.live.peak
    return out, stats
