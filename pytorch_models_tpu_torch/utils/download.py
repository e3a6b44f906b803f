"""Cached HTTP download of pretrained checkpoints (the port's own copy of
``pytorch_models_tpu/utils/download.py``).

Files are cached under ``$PYTORCH_MODELS_TPU_CACHE`` (default
``~/.cache/pytorch_models_tpu``) under the same names as the JAX package
gives them, so one cache serves both packages. A file already in the cache
is returned without touching the network; ``requests`` is imported only on
a miss.
"""

from __future__ import annotations

import os
from pathlib import Path


def cache_dir(subdir: str = "") -> Path:
    root = Path(os.environ.get("PYTORCH_MODELS_TPU_CACHE", Path.home() / ".cache" / "pytorch_models_tpu"))
    d = root / subdir if subdir else root
    d.mkdir(parents=True, exist_ok=True)
    return d


def hub_download(url: str, subdir: str = "", file_name: str | None = None) -> str:
    """Download ``url`` into the local cache (skipping if present); return the path.

    ``file_name`` overrides the cached name: HF checkpoints are all served as
    ``pytorch_model.bin`` and would otherwise collide. The download goes to
    a ``.part`` file renamed into place, so a failed one never reads as a hit.
    """
    save_path = cache_dir(subdir) / (file_name or url.rstrip("/").split("/")[-1])
    if save_path.exists():
        return str(save_path)

    import requests  # only on a cache miss

    tmp = save_path.with_suffix(save_path.suffix + ".part")
    with requests.get(url, stream=True, timeout=60) as r:
        r.raise_for_status()
        with open(tmp, "wb") as f:
            for chunk in r.iter_content(chunk_size=1 << 20):
                f.write(chunk)
    os.replace(tmp, save_path)
    return str(save_path)


def load_hf_checkpoint(model_tag: str) -> dict:
    """Fetch and read an HF checkpoint as a state dict of CPU tensors:
    ``pytorch_model.bin`` first, cached as ``{tag with / -> _}.bin``; only
    where the hub answers 404 for it, ``model.safetensors`` (modern repos
    often ship only that), read by ``safetensors.torch``."""
    base = f"https://huggingface.co/{model_tag}/resolve/main"
    safe_name = model_tag.replace("/", "_")
    bin_path = cache_dir() / (safe_name + ".bin")
    if not bin_path.exists():
        import requests

        try:
            hub_download(f"{base}/pytorch_model.bin", file_name=bin_path.name)
        except requests.HTTPError as e:
            if e.response is None or e.response.status_code != 404:
                raise  # a real failure: do not mask it with a second download
            path = hub_download(f"{base}/model.safetensors", file_name=safe_name + ".safetensors")
            from safetensors.torch import load_file

            return load_file(path, device="cpu")
    from .checkpoint import load_torch_checkpoint

    return load_torch_checkpoint(str(bin_path))
