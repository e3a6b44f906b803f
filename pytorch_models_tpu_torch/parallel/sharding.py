"""Parameter partition specs and per-rank shards (PyTorch port of
``pytorch_models_tpu/parallel/sharding.py``).

A spec is the counterpart of a ``PartitionSpec``: a tuple with one entry per
leading dimension of a leaf, an axis name of the mesh (that dimension is
split evenly over the axis's ranks) or None (kept whole); ``()`` is
replicated. Rules match parameter paths written as the JAX package's
``keystr`` writes them (``['decoder']['layers'][0]['sa']['q']['w']``; the
port's per-layer lists add the ``[i]``). :func:`shard_params` returns THIS
rank's local slices on the mesh's device: the port's processes each hold
their own shard, where JAX places one global array over the devices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Split(NamedTuple):
    """The spec of a LIST node split over a mesh axis (the port's stages are
    lists, where the JAX package splits a leading stage axis): the rank keeps
    its contiguous chunk of the list's entries, each under its spec of
    ``items`` (one per entry)."""

    axis: str
    items: list


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a dict/list tree; ``path`` as ``keystr``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}['{k}']") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_spec(path: str, leaf) -> tuple:
    # only matrix kernels are sharded; biases, norms and embeddings replicated
    if leaf.ndim < 2 or not path.endswith("['w']"):
        return ()
    pad = (None,) * (leaf.ndim - 2)
    if any(k in path for k in ("['q']", "['k']", "['v']", "['fc1']")):
        return (*pad, None, "tp")  # split the output (head) dim
    if any(k in path for k in ("['o']", "['fc2']", "['wo']")):
        return (*pad, "tp", None)  # split the input dim
    return ()


def decoder_lm_pspecs(params) -> dict:
    """Spec tree mirroring a decoder-LM / encoder parameter tree: Megatron
    kernels (q/k/v/fc1 column, o/fc2/wo row), everything else replicated."""
    return tree_map_with_path(_leaf_spec, params)


def shard_params(params, specs, mesh):
    """This rank's local slices of ``params`` under ``specs`` (a tree of the
    same structure), contiguous on ``mesh.device``; a replicated leaf
    already there is shared, not copied."""
    def take(leaf: torch.Tensor, spec: tuple) -> torch.Tensor:
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = mesh.shape[axis]
            if leaf.shape[dim] % n:
                raise ValueError(f"dimension {dim} of a {tuple(leaf.shape)} parameter does not split over {n} ranks")
            size = leaf.shape[dim] // n
            leaf = leaf.narrow(dim, mesh.index(axis) * size, size)
        return leaf.to(mesh.device).contiguous()

    def walk(p, s):
        if isinstance(s, Split):
            n = mesh.shape[s.axis]
            if len(p) % n:
                raise ValueError(f"{len(p)} entries do not split over {n} ranks")
            lo = mesh.index(s.axis) * (len(p) // n)
            return type(p)(walk(v, sv) for v, sv in zip(p[lo:lo + len(p) // n], s.items[lo:lo + len(p) // n]))
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v, sv) for v, sv in zip(p, s))
        return take(p, s)

    return walk(params, specs)


def shard_decoder_lm_params(params, mesh):
    """This rank's shard of a decoder-LM parameter tree under
    :func:`decoder_lm_pspecs` over ``mesh``."""
    return shard_params(params, decoder_lm_pspecs(params), mesh)
