"""The rank mesh, its collectives and the tensor-parallel slicing of a
state dict, in PyTorch.

Counterpart of ``ecad_tpu/parallel/mesh.py`` (:35-102). The reference lays
devices out as a ``jax.sharding.Mesh`` with axes ``dp`` (data parallel
over the (candidate × prompt × image) work), ``sp`` (sequence parallel
over the image / joint tokens, materialized only when > 1) and ``tp``
(Megatron tensor parallel over heads and MLP width, minormost), and lets
GSPMD insert the collectives. Here the same layout is over the processes
of a ``torch.distributed`` group: `create_mesh` arranges the ranks
row-major as (dp, sp, tp), builds a ``DeviceMesh`` for it, and a `Mesh`
carries each axis's process group and this rank's place on it. The models
hold their rank's slice of the weights (`shard_params`, which follows the
reference's logical axes: HEADS and MLP onto tp, EMBED and KV whole) and
call the collectives explicitly: one all-reduce over tp after each
row-parallel product, one all-gather of K and V over sp in self- and joint
attention (`models.common.sharded_attention`).

The collectives take the tensors as they are on every backend: gloo
takes CUDA tensors for all-reduce (sum, max), all-gather and broadcast
(on an H100; only its send / recv refuse them, which `parallel.pipeline`
stages). Every collective adds its payload to `Mesh.traffic`, so a run can
report the bytes it moved. The reference's ``replicated`` sharding has no
counterpart: a tensor that is not sharded is whole on every rank.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .distributed import process_count, process_index

AXES = ("dp", "sp", "tp")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def rank_layout(dp: Optional[int], tp: int, sp: int, world: int) -> np.ndarray:
    """The ranks 0..world-1 laid out as the reference lays out devices:
    row-major (dp, sp, tp), tp minormost; (dp, tp) when sp == 1. Raises
    the reference's ValueError when dp·sp·tp is not the world size."""
    if dp is None:
        dp = world // (tp * sp)
    if dp * tp * sp != world:
        raise ValueError(f"dp*sp*tp={dp * sp * tp} != {world} ranks")
    arr = np.arange(world)
    return arr.reshape(dp, tp) if sp == 1 else arr.reshape(dp, sp, tp)


class Mesh:
    """This rank's view of a dp × (sp ×) tp layout: each axis's size, this
    rank's coordinate on it and its process group, and the collectives the
    models call. An axis the mesh does not have has size 1; a collective
    over an axis without a process group (one process) returns its input,
    one over a group runs, of one rank too (a one-rank NCCL group runs its
    calls on the card)."""

    def __init__(self, layout: np.ndarray, rank: int, groups: Optional[dict] = None,
                 names: Optional[tuple] = None) -> None:
        self.axis_names = names or (("dp", "tp") if layout.ndim == 2 else AXES)
        self.layout = layout
        self.shape = dict(zip(self.axis_names, layout.shape))
        self.rank = rank
        where = np.argwhere(layout == rank)[0]
        self._coord = {n: int(i) for n, i in zip(self.axis_names, where)}
        self._groups = groups or {}
        self.traffic: Counter = Counter()  # "op/axis" → payload bytes
        self.calls: Counter = Counter()  # "op/axis" → calls

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self._coord.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group along `axis`, in order."""
        if axis not in self._coord:
            return [self.rank]
        idx = [self._coord[n] if n != axis else slice(None) for n in self.axis_names]
        return [int(r) for r in self.layout[tuple(idx)]]

    def _note(self, op: str, axis: str, t: torch.Tensor) -> None:
        self.traffic[f"{op}/{axis}"] += t.numel() * t.element_size()
        self.calls[f"{op}/{axis}"] += 1

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """The elementwise `op` ("sum" or "max") of `x` over `axis`, in x's
        dtype (an int32 sum is exact)."""
        if self.group(axis) is None:
            return x
        self._note(f"all_reduce_{op}", axis, x)
        x = x.contiguous()
        dist.all_reduce(x, _OPS[op], group=self.group(axis))
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every rank's `x` along `axis`, concatenated along `dim` in the
        axis's order (``lax.all_gather(..., tiled=True)``)."""
        n = self.size(axis)
        if self.group(axis) is None:
            return x
        self._note("all_gather", axis, x)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def broadcast(self, x: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """`x` of the rank at coordinate `src` along `axis`, on every rank
        of the axis (in place)."""
        if self.group(axis) is None:
            return x
        self._note("broadcast", axis, x)
        root = self.axis_ranks(axis)[src]
        dist.broadcast(x, root, group=self.group(axis))
        return x

    def shard(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's contiguous chunk of `x` along `dim` over `axis` (a
        view; `x.shape[dim]` must divide)."""
        n = self.size(axis)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"{axis}={n} does not divide dim {dim} of {tuple(x.shape)}")
        return x.chunk(n, dim=dim)[self.coord(axis)]


def create_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1) -> Mesh:
    """dp × (sp ×) tp over the processes of the group (`distributed.initialize`
    first; one process without it), laid out by `rank_layout`. With more
    than one process each axis gets its process group from a
    ``DeviceMesh`` (``cuda`` under NCCL, else ``cpu``)."""
    layout = rank_layout(dp, tp, sp, process_count())
    return mesh_over(layout, ("dp", "tp") if layout.ndim == 2 else AXES)


def mesh_over(layout: np.ndarray, names: tuple) -> Mesh:
    """A `Mesh` with axes `names` over the group's ranks laid out as
    `layout` (the processes' group must hold layout.size ranks); without a
    process group (one process), a mesh without groups."""
    if not dist.is_initialized():
        return Mesh(layout, 0, names=names)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, layout.shape, mesh_dim_names=names)
    groups = {n: dm.get_group(n) for n in names}
    return Mesh(layout, process_index(), groups, names)


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This dp rank's rows of a batch-major tensor (the reference's
    ``NamedSharding(mesh, P("dp"))``: contiguous blocks)."""
    return mesh.shard(x, "dp", 0)


def tp_sites(model: nn.Module) -> dict[str, tuple]:
    """The model's tensor-parallel sites: module name → its split, (0,
    widths) for a column-parallel projection (its output features, the
    reference's HEADS / MLP output axis), (1, widths) for a row-parallel
    one (its input features); `widths` are the whole segments of that
    axis, each sliced alike (FLUX's single-block ``proj_out`` reads
    [attention ‖ MLP])."""
    return {name: m.tp_split for name, m in model.named_modules()
            if getattr(m, "tp_split", None) is not None}


def shard_params(state: dict, model: nn.Module, mesh: Mesh) -> dict:
    """The whole model's state dict `state` → the state dict of `model`,
    the same architecture built for `mesh` (its sites marked by
    `tp_sites`): each marked weight sliced to this rank's chunk of every
    segment of its split axis (bias and dequant scale too where they have
    that axis), every other tensor whole. The slices are copies, so
    `state` can be freed."""
    tp, coord = mesh.size("tp"), mesh.coord("tp")
    sites = tp_sites(model)
    out = {}
    for key, want in model.state_dict().items():
        site, _, _ = key.rpartition(".")
        full = state[key]
        split = sites.get(site)
        if split is not None and full.dim() > split[0]:
            dim, widths = split
            pieces = [p.chunk(tp, dim=dim)[coord] for p in full.split(list(widths), dim=dim)]
            full = torch.cat(pieces, dim=dim).clone()
        if tuple(full.shape) != tuple(want.shape):
            raise ValueError(f"{key}: {tuple(full.shape)} does not fit {tuple(want.shape)}")
        out[key] = full
    return out
