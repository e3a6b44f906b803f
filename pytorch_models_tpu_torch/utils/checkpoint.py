"""Reading ``torch.save`` checkpoints under the JAX package's allowlist.

``torch.load(weights_only=True)`` refuses anything but tensors and plain
containers, and so also ``argparse.Namespace``, which DETR's official
checkpoints carry as ``args``. :func:`load_torch_checkpoint` widens it by
exactly the non-torch globals the JAX package's own reader takes
(``pytorch_models_tpu/utils/torch_ckpt.py`` ``_SAFE_GLOBALS``), and first
refuses any global of a zip checkpoint's pickle outside that list and the
``torch`` modules, as that reader does: ``os.system`` and also
``_codecs.encode``, which ``weights_only`` alone would take.
"""

from __future__ import annotations

import argparse
import pickle
import pickletools
import zipfile
from collections import OrderedDict

import numpy as np
import torch

_np_multiarray = (getattr(np, "_core", None) or np.core).multiarray

# (module, name) of the non-torch globals a checkpoint may name: the JAX reader's _SAFE_GLOBALS
_SAFE_GLOBALS = {
    ("collections", "OrderedDict"): OrderedDict,
    ("argparse", "Namespace"): argparse.Namespace,  # DETR's training checkpoints carry 'args'
    ("numpy.core.multiarray", "_reconstruct"): _np_multiarray._reconstruct,
    ("numpy.core.multiarray", "scalar"): _np_multiarray.scalar,
    ("numpy._core.multiarray", "_reconstruct"): _np_multiarray._reconstruct,
    ("numpy._core.multiarray", "scalar"): _np_multiarray.scalar,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
}

# what torch's weights-only unpickler must be told of: the globals above under
# the names a checkpoint gives them, and the numpy dtype classes that a
# pickled dtype is built into (they are never named by the pickle itself)
_TORCH_SAFE_GLOBALS = [(obj, f"{module}.{name}") for (module, name), obj in _SAFE_GLOBALS.items()] + sorted(
    {type(np.dtype(c)) for c in "?bBhHiIlLqQefdgFD"}, key=str)

_PUSHES_STRING = {"SHORT_BINUNICODE", "BINUNICODE", "BINUNICODE8", "UNICODE",
                  "SHORT_BINSTRING", "BINSTRING", "STRING"}
_PUSHES_NOTHING = {"PROTO", "FRAME", "MEMOIZE", "PUT", "BINPUT", "LONG_BINPUT", "STOP"}


def pickle_globals(data: bytes) -> list[tuple[str, str]]:
    """Every ``(module, name)`` a pickle names, by ``GLOBAL`` or
    ``STACK_GLOBAL`` (whose two strings are followed through the memo).
    Raises ``pickle.UnpicklingError`` where a name is not a literal string."""
    found, pushed, memo = [], [], {}
    for op, arg, _ in pickletools.genops(data):
        name = op.name
        if name == "GLOBAL":
            module, _, attr = arg.partition(" ")
            found.append((module, attr))
            pushed.append(None)
        elif name == "STACK_GLOBAL":
            if len(pushed) < 2 or not all(isinstance(s, str) for s in pushed[-2:]):
                raise pickle.UnpicklingError("refusing a STACK_GLOBAL whose names are not literal strings")
            found.append((pushed[-2], pushed[-1]))
            pushed[-2:] = [None]
        elif name in _PUSHES_STRING:
            pushed.append(arg)
        elif name == "MEMOIZE":
            memo[len(memo)] = pushed[-1] if pushed else None
        elif name in ("PUT", "BINPUT", "LONG_BINPUT"):
            memo[arg] = pushed[-1] if pushed else None
        elif name in ("GET", "BINGET", "LONG_BINGET"):
            pushed.append(memo.get(arg))
        elif name not in _PUSHES_NOTHING:
            pushed.append(None)
    return found


def _check_globals(data: bytes) -> None:
    """Raise ``pickle.UnpicklingError`` unless every global of the pickle
    lies in a ``torch`` module or on the allowlist (the JAX reader's rule;
    torch's weights-only rules then hold within the ``torch`` modules)."""
    for module, name in pickle_globals(data):
        if not (module.startswith("torch") or (module, name) in _SAFE_GLOBALS):
            raise pickle.UnpicklingError(
                f"refusing to unpickle global {module}.{name}: not on the checkpoint allowlist")


def load_torch_checkpoint(path: str) -> dict:
    """A ``torch.save`` checkpoint (``.pth`` / ``.pt`` / ``.th`` / ``.bin``)
    as it was saved, its tensors on the CPU. A zip checkpoint's pickle is
    held to the allowlist first; then ``torch.load(weights_only=True)``
    reads it with the allowlist's globals added (a legacy, non-zip file
    gets only that, as the JAX package hands such files to ``torch.load``)."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            pkl = next(n for n in zf.namelist() if n.endswith("/data.pkl") or n == "data.pkl")
            _check_globals(zf.read(pkl))
    with torch.serialization.safe_globals(_TORCH_SAFE_GLOBALS):
        return torch.load(path, map_location="cpu", weights_only=True)
