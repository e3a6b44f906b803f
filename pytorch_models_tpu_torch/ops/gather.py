"""Row gather for embedding lookups (PyTorch port of
``pytorch_models_tpu/ops/gather.py``).

:func:`gather_rows` launches the hand-written CUDA kernel
(``csrc/gather.cu``) on CUDA tensors and runs :func:`gather_rows_plain` on
CPU tensors. Ids are clamped to ``[0, V)`` like ``jnp.take`` in the JAX
kernel, so an out-of-range id never reads outside the table.

:func:`embed_add` is the decoders' embedding in ONE launch of the same
source: token rows plus position rows cast to the token table's dtype,
``tok[ids] + pos[pos_ids].to(tok.dtype)``, bit for bit (the bf16 add rounds
the fp32 sum once, as torch's does), the ids read as int32 or int64, the
positions given per row or as ``start + (r % period)``; without a position
table it is the gather. :func:`embed_tokens` applies it to ids of any shape.

The JAX package caps the kernel at 256 rows because its Pallas body unrolls
one DMA per row; the CUDA kernel launches one block per row and has no such
cap, so :func:`embed_rows` sends every lookup through it (prefill included).
"""

from __future__ import annotations

import torch

from . import _build

# None = auto (kernel for CUDA tensors, plain for a table that autograd differentiates); False forces plain
# indexing; True forces the kernel's wrapper
USE_GATHER_KERNEL: bool | None = None


def _plain(*tables) -> bool:
    """The gate of :func:`embed_tokens` and :func:`embed_rows`."""
    return USE_GATHER_KERNEL is False or (USE_GATHER_KERNEL is None and _build.needs_grad(*tables))


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table`` (V, D), ``idx`` (N,) int -> (N, D) rows, ids clamped to [0, V)."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table`` (V, D), ``idx`` (N,) int -> (N, D) rows via the CUDA kernel."""
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    _build.require_no_grad("gather_rows", table)
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


def embed_add_plain(tok: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor | None = None,
                    pos_ids: torch.Tensor | None = None, start: int = 0, period: int = 1) -> torch.Tensor:
    """``tok`` (V, D), ``ids`` (N,) -> (N, D): ``tok[ids] + pos[p].to(tok.dtype)``
    with ``p = pos_ids`` (N,) or ``start + (r % period)`` for row ``r``; every
    id clamped to its table. Without ``pos``, the gather."""
    x = gather_rows_plain(tok, ids)
    if pos is None:
        return x
    if pos_ids is None:
        pos_ids = start + torch.arange(ids.shape[0], device=ids.device) % period
    return x + gather_rows_plain(pos, pos_ids).to(x.dtype)


def embed_add(tok: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor | None = None,
              pos_ids: torch.Tensor | None = None, start: int = 0, period: int = 1) -> torch.Tensor:
    """:func:`embed_add_plain` in one launch of the CUDA kernel (float32 or
    bfloat16 tables, int32 or int64 ids)."""
    if not tok.is_cuda:
        return embed_add_plain(tok, ids, pos, pos_ids, start, period)
    _build.require_no_grad("embed_add", tok, pos)
    _build.require(tok.ndim == 2 and ids.ndim == 1, "embed_add: tok (V, D) and ids (N,)")
    tensors = [tok, ids] + ([] if pos is None else [pos]) + ([] if pos_ids is None else [pos_ids])
    _build.require(all(t.device == tok.device and t.is_contiguous() for t in tensors),
                   "embed_add: contiguous tensors on one device")
    _build.require(all(t.dtype in (torch.int32, torch.int64) for t in (ids, pos_ids) if t is not None),
                   "embed_add: int32 or int64 ids")
    _build.require(period > 0, "embed_add: period must be positive")
    if pos is not None:
        _build.require(pos.ndim == 2 and pos.shape[1] == tok.shape[1], "embed_add: pos (Vp, D) beside tok (V, D)")
        _build.require(pos_ids is None or pos_ids.shape == ids.shape, "embed_add: pos_ids (N,) beside ids (N,)")
    n, (v, d) = ids.shape[0], tok.shape
    out = torch.empty((n, d), dtype=tok.dtype, device=tok.device)
    lib = _build.load_library()
    code = lib.pmt_embed_add(tok.data_ptr(), _build.dtype_code(tok), v, ids.data_ptr(), int(ids.dtype == torch.int64),
                             None if pos is None else pos.data_ptr(), -1 if pos is None else _build.dtype_code(pos),
                             0 if pos is None else pos.shape[0], None if pos_ids is None else pos_ids.data_ptr(),
                             int(pos_ids is not None and pos_ids.dtype == torch.int64), start, period, out.data_ptr(),
                             n, d, _build.stream_ptr(tok))
    _build.check("pmt_embed_add", code)
    embed_add.launches += 1
    return out


embed_add.launches = 0


def embed_tokens(tok: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor | None = None,
                 pos_ids: torch.Tensor | None = None, start: int | None = None) -> torch.Tensor:
    """A decoder's input embeddings over ``ids`` of any shape ``(..., S)``:
    ``tok[ids] + pos[p].to(tok.dtype)`` with ``p`` from ``pos_ids`` (the
    shape of ``ids``) or ``start + s`` at column ``s``; without ``pos``,
    ``tok[ids]``. One launch of :func:`embed_add` (``USE_GATHER_KERNEL =
    False``: its plain version)."""
    if pos is not None and (pos_ids is None) == (start is None):
        raise ValueError("embed_tokens: a position table takes exactly one of pos_ids and start")
    fn = embed_add_plain if _plain(tok, pos) else embed_add
    period = ids.shape[-1] if ids.ndim else 1
    flat_pos = None if pos_ids is None else pos_ids.reshape(-1).contiguous()
    out = fn(tok, ids.reshape(-1).contiguous(), pos, flat_pos, start or 0, period)
    return out.reshape(*ids.shape, tok.shape[-1])


def embed_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``jnp.take(table, idx, axis=0)`` with any ``idx`` shape."""
    rows = gather_rows_plain if _plain(table) else gather_rows
    return rows(table, idx.reshape(-1)).reshape(*idx.shape, table.shape[-1])
