"""TensorFlow checkpoint (tensor-bundle) reader without a tensorflow
dependency: the port's own copy of ``pytorch_models_tpu/utils/tf_ckpt.py``,
pure numpy, which MaxViT's ``from_google(pretrained=True)`` reads its
official checkpoints with. The bundle format:

- ``<prefix>.index`` is an SSTable (the LevelDB table format, as written by
  tensorflow/core/lib/table): a 48-byte footer holds varint64 BlockHandles to
  the metaindex and index blocks plus the magic 0xdb4775248b80fb57; the index
  block maps last-key-in-block -> data-block handle; data blocks hold
  prefix-compressed key/value entries with a trailing restart array. TF
  writes bundle indexes uncompressed (tensor_bundle.cc sets kNoCompression).
- Index values: key "" -> BundleHeaderProto; every other key is a tensor
  name -> BundleEntryProto {dtype, shape, shard_id, offset, size, crc32c}.
- ``<prefix>.data-XXXXX-of-YYYYY`` shards hold the raw little-endian tensor
  bytes at each entry's (offset, size).

Exposes the same two methods the converters use on ``tf.train.load_checkpoint``
readers: ``get_variable_to_shape_map()`` and ``get_tensor(name)``.
"""

from __future__ import annotations

import struct

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

try:
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BFLOAT16 = None

# TF DataType enum -> numpy dtype (tensorflow/core/framework/types.proto)
_DTYPES = {
    1: np.dtype(np.float32),
    2: np.dtype(np.float64),
    3: np.dtype(np.int32),
    4: np.dtype(np.uint8),
    5: np.dtype(np.int16),
    6: np.dtype(np.int8),
    9: np.dtype(np.int64),
    10: np.dtype(np.bool_),
    14: _BFLOAT16,
    17: np.dtype(np.uint16),
    19: np.dtype(np.float16),
    22: np.dtype(np.uint32),
    23: np.dtype(np.uint64),
}


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    """Decode one unsigned LEB128 varint; returns (value, new_pos)."""
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _block_entries(block: bytes):
    """Iterate (key, value) pairs of one LevelDB-format block."""
    if len(block) < 4:
        return
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + value_len]
        pos += value_len


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Block contents + 1-byte compression type + 4-byte crc32c."""
    ctype = data[offset + size]
    if ctype != 0:
        raise ValueError(f"compressed table block (type {ctype}); TF bundle indexes are uncompressed")
    return data[offset:offset + size]


def _proto_fields(buf: bytes):
    """Iterate (field_number, wire_type, value) of a serialized protobuf."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _varint(buf, pos)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> tuple[int, ...]:
    """TensorShapeProto: field 2 = repeated Dim {1: size}."""
    dims = []
    for field, _, val in _proto_fields(buf):
        if field == 2:
            size = 0
            for f2, _, v2 in _proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


class _BundleEntry:
    __slots__ = ("dtype", "shape", "shard_id", "offset", "size")

    def __init__(self, buf: bytes):
        self.dtype, self.shape, self.shard_id, self.offset, self.size = 0, (), 0, 0, 0
        for field, _, val in _proto_fields(buf):
            if field == 1:
                self.dtype = val
            elif field == 2:
                self.shape = _parse_shape(val)
            elif field == 3:
                self.shard_id = val
            elif field == 4:
                self.offset = val
            elif field == 5:
                self.size = val


class TFCheckpointReader:
    """Pure-Python stand-in for ``tf.train.load_checkpoint(prefix)``."""

    def __init__(self, prefix: str):
        self._prefix = prefix
        with open(prefix + ".index", "rb") as f:
            index = f.read()
        if len(index) < 48 or struct.unpack_from("<Q", index, len(index) - 8)[0] != _TABLE_MAGIC:
            raise ValueError(f"{prefix}.index is not a TF tensor-bundle index (bad magic)")
        footer = index[-48:]
        pos = 0
        _, pos = _varint(footer, pos)  # metaindex offset (unused)
        _, pos = _varint(footer, pos)  # metaindex size
        idx_off, pos = _varint(footer, pos)
        idx_size, pos = _varint(footer, pos)

        self._entries: dict[str, _BundleEntry] = {}
        header = None
        for _key, handle in _block_entries(_read_block(index, idx_off, idx_size)):
            off, hpos = _varint(handle, 0)
            size, _ = _varint(handle, hpos)
            for key, value in _block_entries(_read_block(index, off, size)):
                if key == b"":
                    header = value  # BundleHeaderProto
                else:
                    self._entries[key.decode()] = _BundleEntry(value)
        n_shards = 1
        if header is not None:
            for field, _, val in _proto_fields(header):
                if field == 1:  # num_shards
                    n_shards = val
        self._n_shards = max(n_shards, 1)
        self._shards: dict[int, object] = {}

    def _shard(self, shard_id: int):
        if shard_id not in self._shards:
            path = f"{self._prefix}.data-{shard_id:05d}-of-{self._n_shards:05d}"
            self._shards[shard_id] = open(path, "rb")
        return self._shards[shard_id]

    def get_variable_to_shape_map(self) -> dict[str, list[int]]:
        return {name: list(e.shape) for name, e in self._entries.items()}

    def get_variable_to_dtype_map(self) -> dict[str, np.dtype]:
        return {name: _DTYPES[e.dtype] for name, e in self._entries.items()}

    def has_tensor(self, name: str) -> bool:
        return name in self._entries

    def get_tensor(self, name: str) -> np.ndarray:
        e = self._entries[name]
        dtype = _DTYPES.get(e.dtype)
        if dtype is None:
            raise ValueError(f"unsupported TF dtype enum {e.dtype} for {name!r}")
        f = self._shard(e.shard_id)
        f.seek(e.offset)
        buf = f.read(e.size)
        arr = np.frombuffer(buf, dtype=dtype).reshape(e.shape)
        if _BFLOAT16 is not None and arr.dtype == _BFLOAT16:
            arr = arr.astype(np.float32)
        return arr

    def close(self):
        for f in self._shards.values():
            f.close()
        self._shards.clear()


def load_tf_checkpoint(prefix: str) -> TFCheckpointReader:
    """Open a TF tensor-bundle checkpoint (``tf.train.load_checkpoint`` equivalent)."""
    return TFCheckpointReader(prefix)
