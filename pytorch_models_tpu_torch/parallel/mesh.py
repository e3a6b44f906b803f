"""Process meshes and the collectives of SPMD serving on
``torch.distributed`` (PyTorch port of ``pytorch_models_tpu/parallel/mesh.py``).

The JAX package runs a mesh as ONE process over a named grid of devices
(``shard_map``); PyTorch runs one process per rank. A :class:`Mesh` lays the
ranks of an initialized default process group out row-major on a named grid
(rank r holds the coordinate ``np.unravel_index(r, shape)``, the last axis
fastest, as the JAX package's device grid) and makes, once, one process
group per line of ranks along each axis of size > 1: every rank makes every
group in one order, as ``torch.distributed`` requires.

The three collectives the serving slice needs are the counterparts of
``lax.psum``, ``lax.pmax`` and a ``shard_map``'s row-sharded ``out_specs``:
:func:`psum`, :func:`pmax` and :func:`all_gather` (rows, along dim 0). The
backend is the default group's: NCCL when each rank has its own card,
gloo for CPU tensors and for ranks that share one card (NCCL refuses two
ranks on one device). Under gloo a CUDA tensor is staged through host
memory for the collective alone; every matmul and kernel stays on the card.
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


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0 in group-rank order, on
    ``t``'s device (None: ``t`` itself)."""
    if group is None:
        return t
    src = t.cpu() if _staged(t, group) else t.contiguous()  # gloo: staged through host memory
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


class Mesh:
    """This rank's place on a named grid of the default process group's
    ranks: ``shape`` (axis name -> size, in grid order), ``index(axis)``
    (the rank's coordinate), ``group(axis)`` (the process group of the
    rank's line along ``axis``; None for an axis of size 1) and ``device``
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
        grid = np.arange(world).reshape(sizes)
        for i, axis in enumerate(self.shape):
            self._groups[axis] = None
            if sizes[i] == 1:
                continue
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):  # every rank makes every group, in order
                g = dist.new_group(line.tolist())
                if rank in line:
                    self._groups[axis] = g

    def group(self, axis: str):
        return self._groups[axis]

    def index(self, axis: str) -> int:
        return self._index[axis]

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        return psum(t, self.group(axis))

    def pmax(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        return pmax(t, self.group(axis))

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """:func:`all_gather` over ``axis``; a host tensor goes through this
        rank's card where the backend is NCCL (which takes CUDA tensors only)."""
        g = self.group(axis)
        if g is not None and not t.is_cuda and dist.get_backend(g) == "nccl":
            return all_gather(t.to(self.device), g).cpu()
        return all_gather(t, g)


def _rank_device(device):
    """``device``, or (None) this rank's CUDA card: ``LOCAL_RANK`` (set by
    ``torchrun``), else the global rank, modulo the cards visible, so ranks
    that outnumber the cards share them. Without a card it raises: the
    port's entry points run on the card unless the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
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
