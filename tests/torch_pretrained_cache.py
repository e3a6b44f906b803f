"""Helpers for the pretrained-loading tests of the PyTorch port.

A checkpoint cache (``$PYTORCH_MODELS_TPU_CACHE``) is filled with synthetic
files in each source's own format, under the names both packages give
them, so that every ``from_*(..., pretrained=True)`` of both packages reads
the same file and nothing is fetched:

- ``write_torch``: a ``torch.save`` zip (HF ``.bin``, OpenAI ``.pt``, the
  Facebook / Apple ``.pth`` / ``.th``) from numpy arrays;
- ``write_tf_bundle``: a TensorFlow tensor bundle (``.index`` SSTable +
  one ``.data-00000-of-00001`` shard) written with numpy alone;
- ``write_tiktoken``: a ``.tiktoken`` rank table;
- ``offline``: a cache miss fails without a socket (``requests.get`` and
  ``requests.Session.get`` raise ``requests.ConnectionError``).
"""

from __future__ import annotations

import base64
import socket
import struct
from pathlib import Path

import jax
import numpy as np
import torch

from pytorch_models_tpu.utils.params import to_np

CACHE_ENV = "PYTORCH_MODELS_TPU_CACHE"


def np_tree(tree):
    return jax.tree.map(to_np, tree)


def assert_trees_equal(got, expected, path="params"):
    """The port's tree against ``from_jax_params`` of JAX's: the same
    structure, and every leaf of the same dtype, shape and bits."""
    if isinstance(expected, dict):
        assert isinstance(got, dict) and set(got) == set(expected), f"{path}: keys {set(got)} != {set(expected)}"
        for k in expected:
            assert_trees_equal(got[k], expected[k], f"{path}/{k}")
    elif isinstance(expected, list):
        assert isinstance(got, list) and len(got) == len(expected), f"{path}: length"
        for i, (g, e) in enumerate(zip(got, expected)):
            assert_trees_equal(g, e, f"{path}/{i}")
    else:
        assert got.dtype == expected.dtype and tuple(got.shape) == tuple(expected.shape), \
            f"{path}: {got.dtype} {tuple(got.shape)} != {expected.dtype} {tuple(expected.shape)}"
        assert torch.equal(got.cpu(), expected.cpu()), f"{path}: values differ"


def cache_file(root, name: str, subdir: str = "") -> Path:
    d = Path(root) / subdir
    d.mkdir(parents=True, exist_ok=True)
    return d / name


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


def write_torch(path, obj) -> None:
    """``torch.save`` of a (nested) dict whose numpy arrays become tensors."""
    torch.save(_to_torch(obj), path)


def write_tiktoken(path, ranks: dict[bytes, int]) -> None:
    with open(path, "wb") as f:
        for tok, rank in ranks.items():
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")


# ---------------------------------------------------------------------------
# a TensorFlow tensor bundle, written with numpy alone
# ---------------------------------------------------------------------------

_TF_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2, np.dtype(np.int32): 3, np.dtype(np.int64): 9}


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, value) -> bytes:
    """A protobuf field: varint (int) or length-delimited (bytes)."""
    if isinstance(value, int):
        return _varint(num << 3) + _varint(value)
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def _crc_table() -> list[int]:
    table = []
    for n in range(256):
        for _ in range(8):
            n = (n >> 1) ^ (0x82F63B78 if n & 1 else 0)
        table.append(n)
    return table


_CRC32C = _crc_table()


def _masked_crc32c(data: bytes) -> int:
    """LevelDB's and TF's masked CRC-32C (Castagnoli)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _block(entries: list[tuple[bytes, bytes]]) -> bytes:
    """A LevelDB table block (no prefix sharing, one restart point) and its
    trailer: no compression, the masked crc32c of both."""
    out = b"".join(_varint(0) + _varint(len(k)) + _varint(len(v)) + k + v for k, v in entries)
    out += struct.pack("<II", 0, 1) + b"\x00"
    return out + struct.pack("<I", _masked_crc32c(out))


def write_tf_bundle(prefix: str, tensors: dict[str, np.ndarray]) -> None:
    """``<prefix>.index`` and ``<prefix>.data-00000-of-00001`` holding
    ``tensors`` (float32 / float64 / int32 / int64), as TF's
    ``BundleWriter`` lays them out: the raw little-endian bytes in one
    shard; the index an SSTable of the header (key "") and one
    ``BundleEntryProto`` per name, in byte order."""
    data, entries = bytearray(), [(b"", _field(1, 1))]  # BundleHeaderProto: num_shards 1
    for name in sorted(tensors):
        a = np.array(tensors[name], order="C")
        shape = b"".join(_field(2, _field(1, int(s))) for s in a.shape)
        entry = _field(1, _TF_DTYPES[a.dtype]) + _field(2, shape) + _field(4, len(data)) + _field(5, a.nbytes)
        entry += _varint(6 << 3 | 5) + struct.pack("<I", _masked_crc32c(a.tobytes()))  # fixed32 crc32c
        entries.append((name.encode(), entry))
        data += a.tobytes()
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        f.write(bytes(data))
    data_block = _block(entries)  # a handle's size leaves out the 5-byte trailer
    index_block = _block([(entries[-1][0], _varint(0) + _varint(len(data_block) - 5))])
    meta_block = _block([])
    idx_off = len(data_block)
    meta_off = idx_off + len(index_block)
    footer = _varint(meta_off) + _varint(len(meta_block) - 5) + _varint(idx_off) + _varint(len(index_block) - 5)
    footer = footer.ljust(40, b"\x00") + struct.pack("<Q", 0xDB4775248B80FB57)
    with open(f"{prefix}.index", "wb") as f:
        f.write(data_block + index_block + meta_block + footer)


# ---------------------------------------------------------------------------
# no network
# ---------------------------------------------------------------------------


def offline(monkeypatch, cache_root) -> None:
    """Point both packages at the (empty or filled) cache ``cache_root`` and
    make every fetch fail as an unreachable host does: ``requests.get`` and
    ``requests.Session.get`` raise ``requests.ConnectionError``, and a
    socket connection is refused outright."""
    import requests

    def unreachable(*args, **kwargs):
        raise requests.ConnectionError("no network in the tests")

    def refuse(*args, **kwargs):
        raise AssertionError("a network connection was attempted")

    monkeypatch.setenv(CACHE_ENV, str(cache_root))
    monkeypatch.setattr(requests, "get", unreachable)
    monkeypatch.setattr(requests.Session, "get", unreachable)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)

