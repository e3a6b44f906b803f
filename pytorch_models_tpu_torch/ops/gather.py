"""Row gather for embedding lookups (PyTorch port of
``pytorch_models_tpu/ops/gather.py``).

:func:`gather_rows` launches the hand-written CUDA kernel
(``csrc/gather.cu``) on CUDA tensors and runs :func:`gather_rows_plain` on
CPU tensors. Ids are clamped to ``[0, V)`` like ``jnp.take`` in the JAX
kernel, so an out-of-range id never reads outside the table.

The JAX package caps the kernel at 256 rows because its Pallas body unrolls
one DMA per row; the CUDA kernel launches one block per row and has no such
cap, so :func:`embed_rows` sends every lookup through it (prefill included).
"""

from __future__ import annotations

import torch

from . import _build

# None = auto (kernel for CUDA tensors); False forces plain indexing
USE_GATHER_KERNEL: bool | None = None


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table`` (V, D), ``idx`` (N,) int -> (N, D) rows, ids clamped to [0, V)."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table`` (V, D), ``idx`` (N,) int -> (N, D) rows via the CUDA kernel."""
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    _build.require(table.ndim == 2 and idx.ndim == 1, "gather_rows: table (V, D) and idx (N,)")
    _build.require(table.is_contiguous(), "gather_rows: table must be contiguous")
    _build.require(idx.device == table.device, "gather_rows: idx must be on the table's device")
    _build.require(not idx.is_floating_point(), "gather_rows: idx must be integer")
    v, d = table.shape
    idx64 = idx.to(torch.int64).contiguous()
    out = torch.empty((idx.shape[0], d), dtype=table.dtype, device=table.device)
    lib = _build.load_library()
    code = lib.pmt_gather_rows(table.data_ptr(), idx64.data_ptr(), out.data_ptr(), idx.shape[0], v,
                               d * table.element_size(), _build.stream_ptr(table))
    _build.check("pmt_gather_rows", code)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def embed_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``jnp.take(table, idx, axis=0)`` with any ``idx`` shape."""
    rows = gather_rows_plain if USE_GATHER_KERNEL is False else gather_rows
    return rows(table, idx.reshape(-1)).reshape(*idx.shape, table.shape[-1])
