"""Shared plumbing of the PyTorch port's examples (``torch_*.py``): the
command line and the checkpoint-cache check. The JAX examples' ``_common.py``
imports ``jax``; nothing here does."""

from __future__ import annotations

import argparse


def setup(description: str, argv: list[str] | None = None) -> argparse.Namespace:
    """``--pretrained`` and ``--cpu``; ``args.device`` is what the port's
    constructors take: None (the CUDA card, raising without one) or "cpu"."""
    ap = argparse.ArgumentParser(description=description, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pretrained", action="store_true",
                    help="official weights from the checkpoint cache ($PYTORCH_MODELS_TPU_CACHE; nothing is "
                         "downloaded); default: random weights, demonstrating the API only")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    args.device = "cpu" if args.cpu else None
    return args


def require_cached(*names: str) -> None:
    """Raises FileNotFoundError naming the first of ``names`` (paths under
    the checkpoint cache, as the port's loaders name them) that the cache
    lacks: ``--pretrained`` reads the cache only, it never downloads."""
    from pytorch_models_tpu_torch.utils.download import cache_dir

    for name in names:
        path = cache_dir() / name
        if not path.is_file():
            raise FileNotFoundError(f"--pretrained: {path} is not in the checkpoint cache "
                                    "(set PYTORCH_MODELS_TPU_CACHE to a directory that holds it); "
                                    "this example downloads nothing")


def shape_dtype(t) -> str:
    """A tensor's shape and dtype as the JAX examples print an array's."""
    return f"{tuple(t.shape)} {str(t.dtype).removeprefix('torch.')}"
