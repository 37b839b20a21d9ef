"""Divisibility-aware sharding policy on a torch ``DeviceMesh`` (port of
the reference's ``sharding/rules.py``): 2-D (FSDP x TP) weights, batch-
or sequence-sharded activations / caches.

The spec logic is the reference's, line for line:

* weight matrices: input dim over the FSDP axes ``("pod","data")``,
  output dim over ``"model"`` — except output projections (``w_o`` /
  ``w_out``), whose *input* dim takes ``"model"`` (Megatron pairing, so
  column-parallel -> row-parallel needs no resharding).
* MoE experts: expert dim over ``"model"`` when divisible (EP, kimi-k2),
  else expert d_ff over ``"model"`` (TP, grok-1); rows over FSDP.
* activations: batch over ``("pod","data")``.
* decode KV cache: sequence over ``"model"`` (flash-decoding split);
  batch=1 long-context shards the sequence over *all* axes.
* any dim that does not divide its axes falls back to replication
  (e.g. whisper's vocab 51865, hymba's 32001).

A spec is a :class:`P`, a tuple with one entry per tensor dim: ``None``,
an axis name, or a tuple of axis names. The reference's two mechanisms
map onto torch as follows:

* GSPMD placements and ``with_sharding_constraint`` hints become DTensor
  placements (:meth:`ParallelPlan.placements`): ``param_shardings`` /
  ``input_shardings`` distribute trees, ``constrain_residual``
  redistributes the residual stream between train layers.
* a ``shard_map`` body becomes a local body: it takes
  :meth:`ParallelPlan.local_block` of each input (a plain tensor, never a
  DTensor, so every kernel sees local tensors) and closes with explicit
  collectives over ``mesh.get_group(axis)``: ``psum`` -> ``all_reduce``,
  a tiled ``all_gather`` -> ``all_gather_into_tensor``, ``axis_index``
  -> ``get_local_rank``, ``pmean`` -> ``all_reduce`` then divide.
* GSPMD's partitioning of a dense product by its weight's placement
  becomes a Megatron body (:meth:`ParallelPlan.col_linear`,
  :meth:`ParallelPlan.row_linear`, :meth:`ParallelPlan.embed`): a weight
  split over ``model`` is multiplied as this rank's block, and only
  activations cross ranks. A weight whole over ``model`` is gathered
  (over the FSDP axes only) and the product is computed on every rank.
  The recurrent mixers' bodies compute this rank's heads or channels
  (:meth:`ParallelPlan.col_block`, :meth:`ParallelPlan.row_scatter`, a
  reduce-scatter of a row-split product's partial sums,
  :meth:`ParallelPlan.col_whole`, :meth:`ParallelPlan.model_block`).
  Under a decode plan within ``DECODE_TP_WEIGHT_BUDGET`` no weight is
  split over the FSDP axes, so a decode step gathers no projection
  weight (only the mixers' small ``mu``, ``bonus_u`` and ``A_log``).

Gradients follow one convention: a tensor that is the same on every rank
of an axis carries, on each of them, its whole gradient. The collectives
used on the train path keep it (:meth:`ParallelPlan.psum`: all-reduce
forward, identity backward; :meth:`ParallelPlan.psum_grad`: identity
forward, all-reduce backward; :meth:`ParallelPlan.pmean`; the head
gather; :meth:`ParallelPlan.scatter_along`: reduce-scatter forward,
all-gather backward), and a block a rank reads of a param hands back a
gradient that is partial over the axes its rows are split over
(``rows``), and over ``model`` inside a body that splits its work there.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field, replace
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name or a
    tuple of axis names); trailing dims left out are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def _names(entry) -> tuple:
    """A spec entry (or an axis tuple) as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes):
    """A tuple of axis names as a spec entry: None, a name or the tuple."""
    axes = _names(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axsize(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    shape = mesh_shape(mesh)
    return math.prod(shape[n] for n in names)


DECODE_TP_WEIGHT_BUDGET = 6 * 2**30   # bytes/device for gather-free decode


def layer_slice(t, l: int):
    """Layer ``l`` of an L-stacked leaf. A DTensor's L dim is never
    sharded, so its layer stays a DTensor with the same mesh. Outside
    autograd a stacked DTensor's layers are built once and kept with it
    (views of its local tensor, so in-place updates show through): a
    decode step would otherwise rebuild every layer's DTensor."""
    if not isinstance(t, DTensor):
        return t[l]
    if _tracked(t):
        return _layer_dtensor(t, l)
    key = id(t)
    if key not in _LAYERS:
        _LAYERS[key] = [_layer_dtensor(t, i) for i in range(t.shape[0])]
        weakref.finalize(t, _LAYERS.pop, key, None)
    return _LAYERS[key][l]


_LAYERS: dict = {}          # id of a live stacked DTensor -> its layers


def _layer_dtensor(t, l: int):
    pl = []
    for p in t.placements:
        assert not (isinstance(p, Shard) and p.dim == 0), t.placements
        pl.append(Shard(p.dim - 1) if isinstance(p, Shard) else p)
    shape = tuple(t.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(t.to_local()[l], t.device_mesh, pl,
                              run_check=False, shape=shape, stride=stride)


# ----------------------------------------------------------- collectives
# all_gather_into_tensor's and reduce_scatter_tensor's newer names, where
# the installed torch has them
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

class _Sum(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward: the gradient of the
    replicated sum is already whole on every rank."""

    @staticmethod
    def forward(ctx, x, plan, axes):
        return plan.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; all-reduce backward: a replicated input whose
    uses are split over the axes gets each rank's share of its gradient."""

    @staticmethod
    def forward(ctx, x, plan, axes):
        ctx.plan, ctx.axes = plan, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.all_reduce(g, ctx.axes), None, None


class _Mean(torch.autograd.Function):
    """Mean over the axes' ranks; each rank's input takes 1/n of the
    (replicated) output's gradient."""

    @staticmethod
    def forward(ctx, x, plan, axes):
        ctx.n = plan.axis_size(axes)
        return plan.all_reduce(x, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _Gather(torch.autograd.Function):
    """Tiled all-gather along ``dim`` forward; backward keeps this rank's
    chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, plan, dim, axes):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.start = plan.flat_index(axes) * x.shape[dim]
        return plan.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim`` forward: each rank its chunk of
    the ranks' partial sums; backward the tiled all-gather of the chunks'
    gradients, since every rank's partial feeds every chunk."""

    @staticmethod
    def forward(ctx, x, plan, dim, axes):
        ctx.plan, ctx.dim, ctx.axes = plan, dim, axes
        return plan.reduce_scatter(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.all_gather(g, ctx.dim, ctx.axes), None, None, None


# ===================================================================== plan
@dataclass
class ParallelPlan:
    mesh: Any                              # DeviceMesh | None
    batch_axes: tuple = ("data",)          # includes "pod" when present
    model_axis: str = "model"
    moe_mode: str | None = None            # "ep" | "tp" | None
    kind: str = "train"                    # train | prefill | decode
    weight_fsdp: tuple = ("data",)         # axes sharding weight rows
    _cfg: Any = field(default=None, repr=False)
    # runtime, set per call by the model: the mesh axes the activations'
    # batch rows are split over (() = every row on every rank)
    rows: tuple = ()
    # the mesh's axis sizes, this rank's coordinates and the axes' groups,
    # looked up once (a step asks for them hundreds of times); shared by
    # the plans ``bind`` makes
    _memo: dict = field(default_factory=dict, repr=False, compare=False)

    # ------------------------------------------------------------- factory
    @classmethod
    def make(cls, mesh, cfg, shape_kind: str = "train"):
        if mesh is None:
            return cls(None, (), moe_mode=None, kind=shape_kind,
                       weight_fsdp=(), _cfg=cfg)
        shape = mesh_shape(mesh)
        batch_axes = tuple(n for n in ("pod", "data") if n in shape)
        moe_mode = None
        if cfg is not None and cfg.n_experts:
            nm = shape["model"]
            moe_mode = "ep" if cfg.n_experts % nm == 0 else "tp"
            if moe_mode == "tp":
                assert cfg.moe_d_ff % nm == 0, "MoE unshardable on this mesh"
        # Decode latency rule (§Perf, deepseek-7b x decode_32k): FSDP row
        # sharding forces a per-layer weight all-gather per TOKEN at
        # decode. When the weights fit the model axis alone, replicate
        # them over the batch axes instead — gather-free decode. Models
        # too large for that (nemotron/grok/kimi) keep 2-D sharding and
        # pay the gather: capacity wins over latency.
        weight_fsdp = batch_axes
        if shape_kind == "decode" and cfg is not None:
            per_dev = 2 * cfg.n_params() / shape["model"]
            if per_dev <= DECODE_TP_WEIGHT_BUDGET:
                weight_fsdp = ()
        return cls(mesh, batch_axes, moe_mode=moe_mode, kind=shape_kind,
                   weight_fsdp=weight_fsdp, _cfg=cfg)

    # ------------------------------------------------------------- helpers
    def _cached(self, key, compute):
        key = (id(self.mesh),) + key
        if key not in self._memo:
            self._memo[key] = compute()
        return self._memo[key]

    def axis_size(self, names) -> int:
        return self._cached(("size", names),
                            lambda: _axsize(self.mesh, names))

    def _div(self, dim: int, names):
        """Return axes (possibly reduced or None) that evenly divide dim."""
        if self.mesh is None:
            return None
        if isinstance(names, str):
            names = (names,)
        while names:
            if dim % _axsize(self.mesh, names) == 0:
                return names if len(names) > 1 else names[0]
            names = names[1:]   # drop leading (biggest-group) axis
        return None

    def placements(self, spec) -> tuple:
        """DTensor placements of ``spec``, one per mesh dim: Shard(d) on
        every mesh axis that tensor dim d's entry names, Replicate on the
        others. An entry's axes are in mesh order, so a dim split over
        two axes is split row-major, as in the reference."""
        out = []
        for name in self.mesh.mesh_dim_names:
            pl = Replicate()
            for dim, entry in enumerate(spec):
                if name in _names(entry):
                    pl = Shard(dim)
            out.append(pl)
        return tuple(out)

    def bind(self, rows) -> "ParallelPlan":
        """This plan for one call whose activations are split over
        ``rows``."""
        return replace(self, rows=_names(rows))

    def _rows_spec(self, ndim: int, dim: int = 0) -> P:
        return P(*([None] * dim), _entry(self.rows),
                 *([None] * (ndim - dim - 1)))

    def constrain_residual(self, x):
        """Sequence-parallel residual stream: between blocks, activations
        (B, S, d) are sharded batch x seq over (batch_axes, model) so the
        remat residual stack shrinks by the model-axis size (Megatron-SP).
        A block reads its input back whole over ``model``
        (:meth:`act_local`). Any other tensor passes unchanged."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        b = self._div(x.shape[0], self.batch_axes)
        s = self._div(x.shape[1], (self.model_axis,))
        return x.redistribute(self.mesh, self.placements(P(b, s, None)))

    def act_dtensor(self, x, dim: int = 0, model_dim: int | None = None):
        """This rank's rows (along ``dim``), and with ``model_dim`` its
        block along that dim over ``model``, as the DTensor they are part
        of."""
        spec = list(self._rows_spec(x.ndim, dim))
        if model_dim is not None:
            spec[model_dim] = self.model_axis
        return DTensor.from_local(x, self.mesh, self.placements(P(*spec)),
                                  run_check=False)

    def act_local(self, x):
        """A DTensor activation back as this rank's rows, whole over the
        other axes."""
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, self.placements(
            self._rows_spec(x.ndim))).to_local()

    # ------------------------------------------------------------- params
    def param_spec(self, path: tuple, shape: tuple) -> P:
        """path: tuple of str keys from the params tree root."""
        names = [str(getattr(k, "key", k)) for k in path]
        leaf = names[-1]
        fsdp, model = self.weight_fsdp, self.model_axis
        stacked = "blocks" in names  # leading L axis
        dims = list(shape[1:]) if stacked else list(shape)
        nd = len(dims)

        def build(spec_tail):
            full = ([None] + spec_tail) if stacked else spec_tail
            return P(*full)

        if nd <= 1:
            return build([None] * nd)

        is_moe = "moe" in names and leaf in ("w_in", "w_out", "w_gate")
        if is_moe and nd == 3:
            E, a, b = dims
            if self.moe_mode == "ep":
                e_ax = self._div(E, model)
                # rows = input dim of the matmul
                r = 1 if leaf != "w_out" else 2
                tail = [e_ax, None, None]
                tail[r] = self._div(dims[r], fsdp)
                return build(tail)
            # tp mode: d_ff dim over model, other dim over fsdp
            f_dim = 2 if leaf != "w_out" else 1
            o_dim = 1 if leaf != "w_out" else 2
            tail = [None, None, None]
            tail[f_dim] = self._div(dims[f_dim], model)
            tail[o_dim] = self._div(dims[o_dim], fsdp)
            return build(tail)

        if leaf == "embed":
            return P(self._div(dims[0], model), self._div(dims[1], fsdp))
        if leaf in ("lm_head",):
            return P(self._div(dims[0], fsdp), self._div(dims[1], model))
        if leaf in ("pos_embed",):
            return build([None, self._div(dims[-1], fsdp)]) if nd == 2 \
                else P(None, None)
        if leaf == "router":
            return build([None] * nd)

        if nd == 2:
            din, dout = dims
            # Head-boundary-aware attention TP (§Perf, qwen2-vl x
            # prefill_32k): column-sharding q/k/v projections is only
            # legal along whole heads. Slicing through a head's hd makes
            # the score dot PARTIAL over the contracting dim, which the
            # partitioner completes with an all-reduce of the full
            # (B,H,S,T) score tensor per layer per chunk (observed 1.3 TB
            # per prefill step). When heads don't divide the model axis,
            # replicate those columns instead (the projections are small)
            # and let sequence parallelism carry the attention sharding.
            nm = _axsize(self.mesh, model)
            cfg = self._cfg
            if cfg is not None and leaf in ("w_q", "w_kv", "w_o"):
                heads_ok = cfg.n_heads % nm == 0
                kv_ok = cfg.n_kv_heads % nm == 0 or cfg.n_kv_heads == 0
                if leaf == "w_q" and not heads_ok:
                    return build([self._div(din, fsdp), None])
                if leaf == "w_kv" and not kv_ok:
                    return build([self._div(din, fsdp), None])
                if leaf == "w_o" and not heads_ok:
                    return build([None, self._div(dout, fsdp)])
            if leaf in ("w_o", "w_out", "w_v"):   # row-parallel outputs
                return build([self._div(din, model), self._div(dout, fsdp)])
            return build([self._div(din, fsdp), self._div(dout, model)])
        return build([None] * nd)

    def param_shardings(self, params):
        """The params tree with every leaf distributed by its
        :meth:`param_spec` (DTensors on the mesh); unchanged without a
        mesh."""
        if self.mesh is None:
            return params
        return _map_with_path(
            lambda path, leaf: distribute_tensor(
                leaf, self.mesh,
                self.placements(self.param_spec(path, leaf.shape))),
            params)

    # ------------------------------------------------------------- batches
    def batch_spec(self, leaf_path: tuple, shape: tuple) -> P:
        if not shape:
            return P()
        b = self._div(shape[0], self.batch_axes)
        return P(b, *([None] * (len(shape) - 1)))

    def cache_spec(self, leaf_path: tuple, shape: tuple) -> P:
        """Decode caches: (L, B, T, ...) K/V seq-sharded over model;
        batch=1 shards T over every axis."""
        name = str(getattr(leaf_path[-1], "key", leaf_path[-1]))
        L, B = shape[0], shape[1]
        b = self._div(B, self.batch_axes)
        if name in ("k", "v"):
            T = shape[2]
            if b is None:
                seq = self._div(T, self.batch_axes + (self.model_axis,))
            else:
                seq = self._div(T, self.model_axis)
            return P(None, b, seq, None, None)
        if name in ("xk", "xv"):
            return P(None, b, None, None, None)
        if name == "state":          # rwkv (L,B,H,hd,hd)
            h = self._div(shape[2], self.model_axis)
            return P(None, b, h, None, None)
        if name == "ssm_state":      # (L,B,di,N)
            di = self._div(shape[2], self.model_axis)
            return P(None, b, di, None)
        return P(*([None, b] + [None] * (len(shape) - 2)))

    def input_shardings(self, specs: dict):
        """The input tree (a train / prefill batch, or decode (token,
        cache, cache_len)) distributed: leaves under a ``cache`` key by
        :meth:`cache_spec`, the others by :meth:`batch_spec`; unchanged
        without a mesh."""
        if self.mesh is None:
            return specs

        def assign(path, leaf):
            spec = self.cache_spec(path, leaf.shape) if "cache" in path \
                else self.batch_spec(path, leaf.shape)
            return distribute_tensor(leaf, self.mesh, self.placements(spec))

        return _map_with_path(assign, specs)

    # ------------------------------------------------------------- runtime
    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (the reference's axis_index)."""
        return self._cached(("coord", axis),
                            lambda: self.mesh.get_local_rank(axis))

    def group(self, axis: str):
        return self._cached(("group", axis),
                            lambda: self.mesh.get_group(axis))

    def flat_index(self, axes) -> int:
        """Row-major index of this rank over a tuple of axes."""
        idx = 0
        for a in _names(axes):
            idx = idx * self.axis_size(a) + self.coord(a)
        return idx

    def shard_of(self, t, dim: int):
        """(axes, start, size): the mesh axes dim ``dim`` of ``t`` is split
        over (in mesh order), this rank's first index along it and its
        length. A plain tensor is whole on every rank."""
        if not isinstance(t, DTensor):
            return (), 0, t.shape[dim]
        axes = tuple(n for n, p in zip(t.device_mesh.mesh_dim_names,
                                       t.placements)
                     if isinstance(p, Shard) and p.dim == dim)
        size = t.shape[dim] // self.axis_size(axes)
        return axes, self.flat_index(axes) * size, size

    def _grad_placements(self, pl, model_partial: bool) -> tuple:
        out = []
        for name, p in zip(self.mesh.mesh_dim_names, pl):
            if isinstance(p, Shard):
                out.append(p)
            elif name in self.rows or (model_partial
                                       and name == self.model_axis):
                out.append(Partial())
            else:
                out.append(Replicate())
        return tuple(out)

    def local_block(self, t, spec, *, model_partial: bool = False):
        """This rank's block of ``t`` under ``spec``: what a ``shard_map``
        body with that in_spec receives, as a plain tensor. A DTensor is
        redistributed to ``spec`` (no copy when it is laid out so) and its
        local tensor returned; a plain tensor, whole on every rank, is
        narrowed. ``model_partial``: the body splits its work over
        ``model``, so this rank's gradient of a block replicated there is
        a partial sum."""
        if isinstance(t, DTensor):
            pl = self.placements(spec)
            if not _tracked(t):
                # outside autograd, placements that differ only on mesh
                # dims of one rank leave the local tensor as it is (as
                # DTensor's redistribution would, after its planning,
                # which costs ~0.1 ms of host time a weight)
                if any(a != b and self.axis_size(name) > 1 for name, a, b
                       in zip(self.mesh.mesh_dim_names, t.placements, pl)):
                    t = t.redistribute(self.mesh, pl)
                return t.to_local()
            if tuple(t.placements) != pl:
                t = t.redistribute(self.mesh, pl)
            return t.to_local(
                grad_placements=self._grad_placements(pl, model_partial))
        for dim, entry in enumerate(spec):
            axes = _names(entry)
            if axes:
                size = t.shape[dim] // self.axis_size(axes)
                t = t.narrow(dim, self.flat_index(axes) * size, size)
        return t

    def gather(self, t, *, model_partial: bool = False):
        """``t`` whole on this rank (the FSDP all-gather of a weight)."""
        return self.local_block(t, P(), model_partial=model_partial)

    def gather_tree(self, tree, *, model_partial: bool = False):
        if isinstance(tree, dict):
            return {k: self.gather_tree(v, model_partial=model_partial)
                    for k, v in tree.items()}
        return self.gather(tree, model_partial=model_partial)

    # An axis of one rank takes no collective, as in DTensor's own
    # redistribution: on the card a one-rank NCCL call costs 0.04-0.25 ms
    # of host time, ~70 ms of a 36-layer decode step.
    def all_reduce(self, t, axes):
        """Sum over the ranks of ``axes``, one axis at a time (no grad)."""
        axes = [a for a in _names(axes) if self.axis_size(a) > 1]
        if axes:
            t = t.clone()
        for a in axes:
            dist.all_reduce(t, group=self.group(a))
        return t

    def all_gather(self, t, dim: int, axes):
        """Tiled all-gather along ``dim`` over ``axes``, row-major: the
        innermost axis first (no grad). The result is contiguous: a
        permuted layout would send the products that read it down other
        GEMM routes, and their rounding would differ from the plan-free
        path's."""
        for a in reversed(_names(axes)):
            if self.axis_size(a) == 1:
                continue
            x = t.movedim(dim, 0).contiguous()
            out = x.new_empty((self.axis_size(a) * x.shape[0],)
                              + tuple(x.shape[1:]))
            _all_gather_single(out, x, group=self.group(a))
            t = out.movedim(0, dim)
        return t.contiguous()

    def reduce_scatter(self, t, dim: int, axes):
        """Sum over the ranks of ``axes``, each rank keeping its chunk
        along ``dim`` in :meth:`all_gather`'s row-major order: the
        outermost axis first (no grad). The result is contiguous."""
        for a in _names(axes):
            n = self.axis_size(a)
            if n == 1:
                continue
            x = t.movedim(dim, 0).contiguous()
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            _reduce_scatter_single(out, x, group=self.group(a))
            t = out.movedim(0, dim)
        return t.contiguous()

    # Outside autograd the collectives below skip their autograd
    # Functions, whose bookkeeping is most of a one-rank step's host time.
    def psum(self, x, axes):
        """``psum`` of a partial result whose gradient is whole on every
        rank."""
        if not _tracked(x):
            return self.all_reduce(x, axes)
        return _Sum.apply(x, self, _names(axes))

    def psum_grad(self, x, axes):
        """Enter a body that splits its work over ``axes``: identity, the
        gradient summed over them."""
        if not _tracked(x):
            return x
        return _SumGrad.apply(x, self, _names(axes))

    def pmean(self, x, axes):
        return _Mean.apply(x, self, _names(axes))

    def gather_along(self, x, dim: int, axes):
        """Tiled all-gather of a body's output chunks along ``dim``."""
        if not _tracked(x):
            return self.all_gather(x, dim, axes)
        return _Gather.apply(x, self, dim, _names(axes))

    def scatter_along(self, x, dim: int, axes):
        """Reduce-scatter of a body's partial sums along ``dim``: this
        rank's chunk of their sum."""
        if not _tracked(x):
            return self.reduce_scatter(x, dim, axes)
        return _Scatter.apply(x, self, dim, _names(axes))

    # ------------------------------------------------- tensor-parallel bodies
    def split_dim(self, w):
        """The dim of ``w`` split over the model axis: a DTensor placed so
        by :meth:`param_spec`; None for a plain tensor (whole on every
        rank) or a weight replicated over ``model``."""
        if not isinstance(w, DTensor):
            return None
        p = w.placements[w.device_mesh.mesh_dim_names.index(self.model_axis)]
        return p.dim if isinstance(p, Shard) else None

    def col_linear(self, x, w, *, gather: bool = True):
        """``x @ w`` for a weight (d_in, d_out) whose columns may be split
        over ``model``: this rank's columns, gathered back along the last
        dim (``gather``) or left as this rank's block. A weight whole over
        ``model`` is multiplied whole on every rank."""
        if self.split_dim(w) != 1:
            return x @ self.gather(w)
        m = self.model_axis
        y = self.psum_grad(x, m) @ self.local_block(w, P(None, m))
        return self.gather_along(y, -1, m) if gather else y

    def divides(self, n: int) -> bool:
        """Whether ``n`` heads or channels split evenly over ``model``."""
        return n % self.axis_size(self.model_axis) == 0

    def model_block(self, t, dim: int):
        """This rank's block of ``t`` along ``dim``, cut into as many
        blocks as ``model`` has ranks: a weight's block of a dim its
        placement splits over ``model`` is its local block; a small param
        whole over ``model`` (a norm, a decay) is cut locally; one split
        over ``model`` along another dim (``bonus_u``'s hd, ``A_log``'s
        N) is redistributed: an all-to-all, which DTensor does as an
        all-gather and a chunk on a CPU mesh."""
        return self.local_block(t, P(*([None] * dim), self.model_axis))

    def state_block(self, state, dim: int, n: int):
        """This rank's ``n`` heads / channels along ``dim`` of a recurrent
        state (no grad): the state itself when it holds only them (the
        local tensor of a state placed by ``cache_spec``), else their
        block of a state whole on every rank. Returns (block, whole)."""
        if state.shape[dim] == n:
            return state, False
        start = self.coord(self.model_axis) * n
        return state.narrow(dim, start, n).contiguous(), True

    # col_block / row_scatter: ``x`` is replicated over ``model`` and has
    # entered the body once (:meth:`psum_grad`), so each use here hands
    # back this rank's share of its gradient and the entry sums them: one
    # all-reduce for a body's several products, not one each
    def col_block(self, x, w):
        """This rank's column block of ``x @ w`` (its heads or channels),
        from its block of ``w``'s columns."""
        return x @ self.model_block(w, 1)

    def col_whole(self, x, w):
        """``x @ w`` whole on every rank, every rank reading it for its own
        block of the work: this rank's columns, gathered, where ``w``'s
        columns split over ``model``, else the whole product."""
        m = self.model_axis
        if self.split_dim(w) != 1:
            return x @ self.gather(w, model_partial=True)
        y = self.gather_along(x @ self.local_block(w, P(None, m)), -1, m)
        return self.psum_grad(y, m)     # its uses here are this rank's

    def row_scatter(self, x, w):
        """This rank's column block of ``x @ w`` for a weight whose rows
        may be split over ``model``: this rank's slice of ``x``'s last dim
        times its rows is a partial sum of every column, and the partials
        are reduce-scattered over ``model``. A weight whole over ``model``
        takes :meth:`col_block`."""
        if self.split_dim(w) != 0:
            return self.col_block(x, w)
        m = self.model_axis
        wb = self.local_block(w, P(m, None))
        n = wb.shape[0]
        x = x.narrow(-1, self.coord(m) * n, n)
        return self.scatter_along(x @ wb, -1, m)

    def row_linear(self, h, w, *, local: bool = False):
        """``h @ w`` for a weight (d_in, d_out) whose rows may be split over
        ``model``: this rank's rows times its slice of ``h``'s last dim
        (``local``: ``h`` is that slice already), summed over ``model``.
        A weight whole over ``model`` is multiplied whole on every rank,
        or, for a local ``h``, as the rows that slice meets."""
        m = self.model_axis
        if not local:
            if self.split_dim(w) != 0:
                return h @ self.gather(w)
            n = w.shape[0] // self.axis_size(m)
            h = self.psum_grad(h, m).narrow(-1, self.coord(m) * n, n)
        return self.psum(h @ self.model_block(w, 0), m)

    def embed(self, table, ids):
        """``table[ids]`` for a table (V, d) whose rows may be split over
        ``model``: each rank looks up the ids in its rows, zeros the
        others, and the lookups are summed over ``model``."""
        if self.split_dim(table) != 0:
            return self.gather(table)[ids]
        m = self.model_axis
        tb = self.local_block(table, P(m, None))
        loc = ids - self.coord(m) * tb.shape[0]
        mine = (loc >= 0) & (loc < tb.shape[0])
        out = tb[torch.where(mine, loc, 0)] * mine[..., None].to(tb.dtype)
        return self.psum(out, m)


def _tracked(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)
