"""Process meshes and the collectives of SPMD serving on
``torch.distributed`` (PyTorch port of ``pytorch_models_tpu/parallel/mesh.py``).

The JAX package runs a mesh as ONE process over a named grid of devices
(``shard_map``); PyTorch runs one process per rank. A :class:`Mesh` lays the
ranks of an initialized default process group out row-major on a named grid
(rank r holds the coordinate ``np.unravel_index(r, shape)``, the last axis
fastest, as the JAX package's device grid) and makes, once, one process
group per line of ranks along each axis of size > 1: every rank makes every
group in one order, as ``torch.distributed`` requires.

The collectives are the counterparts of ``lax.psum``, ``lax.pmax``, a
``shard_map``'s row-sharded ``out_specs``, ``lax.all_to_all`` and
``lax.ppermute``: :func:`psum`, :func:`pmax`, :func:`all_gather` (along
any dim), :func:`reduce_scatter`, :func:`broadcast`, :func:`all_to_all`
(a contiguous leading split; ``all_to_all.calls`` counts the calls) and
:meth:`Mesh.send` / :meth:`Mesh.recv` along an axis. Training
differentiates through the autograd pairs at the end of this module: each
forward collective with its conjugate as the backward (all-gather <->
reduce-scatter, all_to_all <-> the reverse all_to_all, Megatron's f / g:
identity <-> all-reduce); the pipeline's send <-> recv of the gradient is
``pipeline.gpipe_apply``'s. The backend is the default group's: NCCL when
each rank has its own card, gloo for CPU tensors and for ranks that share
one card (NCCL refuses two ranks on one device). Under gloo a CUDA tensor is
staged through host memory for the collective alone; every matmul and
kernel stays on the card.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist


def _factor3(n: int) -> tuple[int, int, int]:
    """Split n ranks into (dp, pp, tp): tp <= 2 on the innermost axis, then
    pp <= 2, the remainder to dp (the JAX package's rule, kept as the port's
    own copy)."""
    def largest_pow2_divisor(x: int, cap: int) -> int:
        d = 1
        while d * 2 <= cap and x % (d * 2) == 0:
            d *= 2
        return d

    tp = largest_pow2_divisor(n, 2)
    rem = n // tp
    pp = largest_pow2_divisor(rem, 2)
    dp = rem // pp
    return dp, pp, tp


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is None:
        return t
    if _staged(t, group):
        # gloo: the collective's tensor goes through host memory (ranks may share one card, which NCCL refuses)
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        return h.to(t.device)
    dist.all_reduce(t, op=op, group=group)
    return t


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (None: ``t`` itself),
    on every rank; ``t`` is reduced in place unless it is staged."""
    return _all_reduce(t, dist.ReduceOp.SUM, group)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks of ``group``, as :func:`psum`."""
    return _all_reduce(t, dist.ReduceOp.MAX, group)


def _host(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the collective takes it: contiguous, in host memory when staged."""
    return t.cpu() if _staged(t, group) else t.contiguous()  # gloo: staged through host memory


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order, on
    ``t``'s device (None: ``t`` itself)."""
    if group is None:
        return t
    src = _host(t.movedim(dim, 0), group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device).movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, split evenly along
    ``dim``: this rank's chunk (its group-rank index), on ``t``'s device."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = _host(t.movedim(dim, 0), group)
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, dim)


def broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """The ``t`` of global rank ``src``, on every rank of ``group`` (a new
    tensor; ``t`` is left as it is)."""
    if group is None:
        return t
    buf = t.cpu() if _staged(t, group) else t.clone()
    dist.broadcast(buf, src=src, group=group)
    return buf.to(t.device)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over ``group``: ``t``'s leading dim splits into
    one contiguous chunk per rank; chunk ``i`` goes to group rank ``i``, and
    the output's chunk ``i`` is the one group rank ``i`` sent here (its own
    inverse). ``all_to_all.calls`` counts the calls (None: ``t`` itself,
    not counted)."""
    if group is None:
        return t
    src = _host(t, group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    all_to_all.calls += 1
    return out.to(t.device)


all_to_all.calls = 0


class Mesh:
    """This rank's place on a named grid of the default process group's
    ranks: ``shape`` (axis name -> size, in grid order), ``index(axis)``
    (the rank's coordinate), ``group(axis)`` (the process group of the
    rank's line along ``axis``; None for an axis of size 1), ``size(axis)``
    (1 for an axis the mesh does not have) and ``device``
    (where the rank computes)."""

    def __init__(self, shape: dict, device) -> None:
        if not dist.is_initialized():
            raise RuntimeError("a Mesh is built over an initialized default process group "
                               "(torch.distributed.init_process_group)")
        self.shape = dict(shape)
        sizes = tuple(self.shape.values())
        world = dist.get_world_size()
        if world != math.prod(sizes):
            raise ValueError(f"mesh {self.shape} needs {math.prod(sizes)} ranks, the process group has {world}")
        self.device = torch.device(device)
        rank = dist.get_rank()
        self._index = {a: int(c) for a, c in zip(self.shape, np.unravel_index(rank, sizes))}
        self._groups: dict = {}
        self._lines: dict = {}  # axis -> the global ranks of this rank's line along it
        grid = np.arange(world).reshape(sizes)
        for i, axis in enumerate(self.shape):
            self._groups[axis] = None
            self._lines[axis] = [rank]
            if sizes[i] == 1:
                continue
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):  # every rank makes every group, in order
                g = dist.new_group(line.tolist())
                if rank in line:
                    self._groups[axis], self._lines[axis] = g, line.tolist()

    def _axis(self, axis: str) -> str:
        if axis not in self.shape:
            raise KeyError(f"mesh {tuple(self.shape)} has no axis {axis!r}")
        return axis

    def group(self, axis: str):
        """The process group along ``axis``; None for an axis of size 1. An
        axis the mesh does not have raises (a collective on it would
        silently return its input)."""
        return self._groups[self._axis(axis)]

    def index(self, axis: str) -> int:
        return self._index[self._axis(axis)]

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        return psum(t, self.group(axis))

    def pmax(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        return pmax(t, self.group(axis))

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` on this rank's line."""
        return self._lines[axis][index]

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """:func:`all_gather` over ``axis``; a host tensor goes through this
        rank's card where the backend is NCCL (which takes CUDA tensors only)."""
        g = self.group(axis)
        if g is not None and not t.is_cuda and dist.get_backend(g) == "nccl":
            return all_gather(t.to(self.device), g, dim).cpu()
        return all_gather(t, g, dim)

    def broadcast(self, t: torch.Tensor, axis: str, index: int) -> torch.Tensor:
        """:func:`broadcast` over ``axis`` from the rank at ``index`` along it."""
        return broadcast(t, self.group(axis), self.global_rank(axis, index))

    def send(self, t: torch.Tensor, axis: str, index: int) -> None:
        """Send ``t`` to the rank at ``index`` along ``axis`` (blocking)."""
        g = self.group(axis)
        dist.send(_host(t, g), dst=self.global_rank(axis, index), group=g)

    def recv(self, like: torch.Tensor, axis: str, index: int) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device received from the
        rank at ``index`` along ``axis`` (blocking)."""
        g = self.group(axis)
        buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if _staged(like, g) else like.device)
        dist.recv(buf, src=self.global_rank(axis, index), group=g)
        return buf.to(like.device)


def _rank_device(device):
    """``device``, or (None) this rank's CUDA card: ``LOCAL_RANK`` (set by
    ``torchrun``), else the global rank, modulo the cards visible, so ranks
    that outnumber the cards share them. Without a card it raises: the
    port's entry points run on the card unless the caller asks for the CPU."""
    if device is not None:
        device = torch.device(device)
        return torch.device("cuda", torch.cuda.current_device()) if device == torch.device("cuda") else device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the mesh's ranks run on the GPU by default; pass device='cpu'")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, shape: tuple[int, ...] | None = None,
              axes: tuple[str, ...] = ("dp", "pp", "tp"), device=None) -> Mesh:
    """A :class:`Mesh` over the default process group's ranks, the JAX
    package's ``make_mesh`` with ranks for devices: ``n_devices`` ranks
    (default: the world size, which must equal it), shaped ``shape`` (default
    ``_factor3``'s split over ``("dp", "pp", "tp")``) and named ``axes``.
    ``device``: where this rank computes (default: its CUDA card)."""
    n = n_devices or dist.get_world_size()
    if shape is None:
        if axes != ("dp", "pp", "tp"):
            raise ValueError(f"a mesh over axes {axes} needs its shape")
        shape = _factor3(n)
    if len(shape) != len(axes) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} over axes {axes} does not hold {n} ranks")
    mesh = Mesh(dict(zip(axes, shape)), _rank_device(device))
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


# ---------------------------------------------------------------------------
# autograd pairs: each collective with its conjugate as the backward
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):  # an even all_to_all is its own inverse
        return all_to_all(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):  # Megatron's f
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return psum(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):  # Megatron's g
    @staticmethod
    def forward(ctx, t, group):
        return psum(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather_grad(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` along ``dim``; the backward reduce-scatters."""
    return t if group is None else _AllGather.apply(t, group, dim)


def reduce_scatter_grad(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`reduce_scatter` along ``dim``; the backward all-gathers."""
    return t if group is None else _ReduceScatter.apply(t, group, dim)


def all_to_all_grad(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all`; the backward sends each gradient chunk back."""
    return t if group is None else _AllToAll.apply(t, group)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the identity; the backward all-reduces the gradient."""
    return t if group is None else _CopyToGroup.apply(t, group)


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the all-reduce (sum); the backward is the identity."""
    return t if group is None else _ReduceFromGroup.apply(t, group)
