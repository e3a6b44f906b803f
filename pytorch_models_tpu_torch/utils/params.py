"""Parameter trees and checkpoint state-dict handling (PyTorch port).

Parameters are plain nested dicts of tensors with the JAX package's layouts:
linear weights ``(in, out)``, LayerNorm ``{"scale", "bias"}``, merged-head
projections. The one structural difference: a layer stack is a LIST of
per-layer dicts (``p["decoder"]["layers"][i]``) instead of leaves stacked
along a leading layer axis, because PyTorch runs the stack as a Python loop
rather than a ``lax.scan``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_MISSING = object()


def to_tensor(x: Any, device=None) -> torch.Tensor:
    """numpy array / tensor / array-like -> tensor (no copy where possible)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        a = np.ascontiguousarray(np.asarray(x))
        if a.dtype.name == "bfloat16":  # JAX's (ml_dtypes) bfloat16: exact through fp32
            return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.to(device=device)


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor/array leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Cast all floating leaves of a parameter tree to ``dtype``."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


# the linear kernels weight-only int8 quantizes: a ``"w"`` leaf whose key
# path names one of these (the JAX package's ``quantize_tree_int8`` list)
_PROJ_KEYS = ("q", "k", "v", "o", "fc1", "fc2", "wo", "mlp", "proj", "classifier", "upsample")


def quantize_tree_int8(tree: Any, _path: tuple = ()) -> Any:
    """Weight-only int8: every linear kernel ``["w"]`` (ndim >= 2, floating,
    under a projection key of ``_PROJ_KEYS``) becomes ``{"w_q": int8, "w_s":
    fp32 (1, out)}``, symmetric per output channel, as the JAX package's
    ``quantize_tree_int8`` does: ``w_s = absmax / 127`` over the input dim in
    the weight's own dtype (1 where the column is zero), then cast to fp32;
    ``w_q = clip(round(w / w_s), -127, 127)``. Conv kernels, embeddings and
    norms keep their tensors. ``ops.layers.linear`` dequantizes on the fly."""
    if isinstance(tree, dict):
        return {k: quantize_tree_int8(v, _path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_tree_int8(v, _path) for v in tree)
    leaf = tree
    if (not _path or _path[-1] != "w" or not isinstance(leaf, torch.Tensor) or leaf.ndim < 2
            or not leaf.is_floating_point() or not any(k in _PROJ_KEYS for k in _path)):
        return leaf
    scale = leaf.abs().amax(dim=leaf.ndim - 2, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale).float()
    q = torch.round(leaf.float() / scale).clamp(-127, 127).to(torch.int8)
    return {"w_q": q, "w_s": scale}


def is_int8(lin: dict) -> bool:
    """True for a linear whose kernel weight-only int8 quantized."""
    return isinstance(lin.get("w"), dict) and "w_q" in lin["w"]


# the keys under which the JAX package stacks per-layer / per-block params for a ``lax.scan``
_STACKED_KEYS = ("layers", "blocks")


def from_jax_params(np_tree: Any, device=None) -> Any:
    """The JAX package's parameter pytree, as numpy arrays, -> the port's tree.

    Every dict under a ``"layers"`` key (the transformer stacks) or a
    ``"blocks"`` key (MLP-Mixer's blocks, each ConvNeXt stage's) holds
    stacked leaves ``(L, ...)`` of a ``lax.scan``; it becomes a list of ``L``
    per-block dicts. Lists (MaxViT's stages, DETR's box head) stay lists.
    Weight-only int8 leaves (``{"w_q", "w_s"}``) carry across as they are:
    int8 and fp32 tensors.
    """

    def convert(tree, key=None):
        if isinstance(tree, dict):
            if key in _STACKED_KEYS:
                n = _stack_len(tree)
                return [convert(_index_tree(tree, i)) for i in range(n)]
            return {k: convert(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [convert(v) for v in tree]
        return to_tensor(tree, device)

    return convert(np_tree)


def to_jax_params(tree: Any) -> Any:
    """The port's parameter tree -> the JAX package's, as numpy arrays: the
    inverse of :func:`from_jax_params` (each list under a ``"layers"`` or
    ``"blocks"`` key stacked back into ``(L, ...)`` leaves; bf16 as fp32)."""

    def convert(t, key=None):
        if isinstance(t, dict):
            return {k: convert(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            items = [convert(v) for v in t]
            return stack_trees(items) if key in _STACKED_KEYS else items
        return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()

    return convert(tree)


def stack_trees(trees: list) -> Any:
    """Same-structured numpy trees -> one tree of leaves stacked on a new
    leading axis (``utils.stack_layers`` of the JAX package)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _stack_len(tree: dict) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(np.asarray(tree).shape[0])


def _index_tree(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


class StateDict:
    """A source checkpoint wrapper with strict-consumption semantics.

    ``pop`` returns tensors on the CPU; ``finalize`` raises if
    any key is left over (the counterpart of the JAX package's
    ``utils.params.StateDict``).
    """

    def __init__(self, d: dict[str, Any]):
        self._d = dict(d)

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def keys(self):
        return self._d.keys()

    def pop(self, key: str, default: Any = _MISSING) -> torch.Tensor:
        if key not in self._d:
            if default is _MISSING:
                raise KeyError(f"missing checkpoint key: {key!r}")
            return default
        return to_tensor(self._d.pop(key))

    def pop_linear(self, key_prefix: str) -> dict:
        """Pop a torch ``nn.Linear``'s (out, in) weight and bias as an (in, out) kernel."""
        return {"w": self.pop(f"{key_prefix}.weight").t().contiguous(), "b": self.pop(f"{key_prefix}.bias")}

    def pop_ln(self, key_prefix: str) -> dict:
        return {"scale": self.pop(f"{key_prefix}.weight"), "bias": self.pop(f"{key_prefix}.bias")}

    def pop_conv1d(self, key_prefix: str, bias: bool = True) -> dict:
        """Pop a torch ``nn.Conv1d``'s (out, in, k) weight [and bias] as a (k, in, out) kernel."""
        p = {"w": self.pop(f"{key_prefix}.weight").permute(2, 1, 0).contiguous()}
        if bias:
            p["b"] = self.pop(f"{key_prefix}.bias")
        return p

    def pop_conv2d(self, key_prefix: str, bias: bool = True) -> dict:
        """Pop a torch ``nn.Conv2d``'s OIHW ``(out, in, kh, kw)`` weight [and bias] as an HWIO kernel."""
        p = {"w": self.pop(f"{key_prefix}.weight").permute(2, 3, 1, 0).contiguous()}
        if bias:
            p["b"] = self.pop(f"{key_prefix}.bias")
        return p

    def finalize(self) -> None:
        if self._d:
            raise ValueError(f"unconsumed checkpoint keys: {sorted(self._d.keys())}")
