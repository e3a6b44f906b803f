"""t5x / TensorStore (zarr) checkpoint loader over HTTP: the port's own copy
of ``pytorch_models_tpu/models/text/t5x_loader.py``, numpy only.

The ``checkpoint`` index file is msgpack-decoded; small tensors are inline
msgpack ExtType buffers, large tensors are chunked gzip zarr files fetched
concurrently (16-thread pool + pooled HTTP session), reassembled by
chunk-index slicing and truncated to the true shape. Results are cached
as an ``.npz`` under ``cache`` (relative to the working directory, as in
the JAX package), and a cached file is read without any import of
``msgpack`` or ``requests``.
"""

from __future__ import annotations

import gzip
import itertools
import math
from pathlib import Path

import numpy as np

BASE_URL = "https://storage.googleapis.com/t5-data/pretrained_models/t5x/"


def url_join(*args: str) -> str:
    return "/".join(x.rstrip("/") for x in args)


def get_checkpoint_location(variant: str, size: str) -> str:
    """The checkpoint path of a t5x variant and size."""
    if variant in ("t5_1_1", "mt5"):
        prefix, n_steps = f"{variant}_", 1000000
    elif variant == "t5_1_1_lm_adapted":
        prefix, n_steps = "t5_1_1_lm100k_", 1100000
    elif variant == "mt5_lm_adapted":
        prefix, n_steps = "mt5_lm_adapted/", 1100000
    elif variant == "flan_t5":
        prefix = "flan_t5_"
        n_steps = dict(small=1198000, base=1184000, large=1164000, xl=1138000, xxl=1114000)[size]
    else:
        raise ValueError(f"Unsupported {variant=}")
    return f"{prefix}{size}/checkpoint_{n_steps}"


def load_t5x_checkpoint(location: str, n_threads: int = 16, cache: str = "checkpoints") -> dict[str, np.ndarray]:
    """Fetch and flatten a t5x checkpoint into ``{dotted_key: np.ndarray}``."""
    cache_path = Path(cache) / (location.replace("/", "_") + ".npz")
    if cache_path.exists():
        return dict(np.load(cache_path))

    from concurrent.futures import Future, ThreadPoolExecutor

    import msgpack
    import requests
    from requests.adapters import HTTPAdapter

    session = requests.Session()
    session.mount(BASE_URL, HTTPAdapter(pool_maxsize=n_threads))
    pool = ThreadPoolExecutor(n_threads)
    state_dict: dict[str, np.ndarray | Future] = {}

    def load_tensorstore(dct: dict) -> np.ndarray:
        path = dct["kvstore"]["path"]
        shape = dct["metadata"]["shape"]
        chunk_size = dct["metadata"]["chunks"]
        n_chunks = [math.ceil(s / cs) for s, cs in zip(shape, chunk_size)]
        out = np.empty([n * cs for n, cs in zip(n_chunks, chunk_size)], np.float32)
        for indices in itertools.product(*[range(x) for x in n_chunks]):
            filename = ".".join(str(x) for x in indices)
            data = session.get(url_join(BASE_URL, location, path, filename), timeout=120).content
            chunk = np.frombuffer(gzip.decompress(data), np.float32).reshape(chunk_size)
            out[tuple(slice(i * cs, (i + 1) * cs) for i, cs in zip(indices, chunk_size))] = chunk
        return out[tuple(slice(0, s) for s in shape)]

    def flatten(dct: dict, prefix: str | None = None) -> None:
        if "kvstore" in dct:
            state_dict[prefix] = pool.submit(load_tensorstore, dct)
            return
        for k, v in dct.items():
            new_prefix = k if prefix is None else f"{prefix}.{k}"
            if isinstance(v, msgpack.ExtType):
                shape, dtype, data = msgpack.unpackb(v.data)
                state_dict[new_prefix] = np.frombuffer(data, np.float32).reshape(shape)
            elif isinstance(v, dict):
                flatten(v, new_prefix)
            else:
                raise ValueError(f"unexpected checkpoint entry at {new_prefix}: {type(v)}")

    ckpt = msgpack.unpackb(session.get(url_join(BASE_URL, location, "checkpoint"), timeout=120).content)
    flatten(ckpt["optimizer"]["target"])
    for k, v in state_dict.items():
        if isinstance(v, Future):
            state_dict[k] = v.result()
    pool.shutdown()

    cache_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache_path, **state_dict)
    return state_dict
