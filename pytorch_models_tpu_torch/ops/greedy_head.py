"""Fused greedy head: argmax(x @ emb.T) without materialising the logits
(PyTorch port of ``pytorch_models_tpu/ops/greedy_head.py``, tied layout).

:func:`greedy_argmax_tied` launches the hand-written CUDA kernel
(``csrc/greedy_head.cu``) on CUDA tensors and runs
:func:`greedy_argmax_tied_plain` on CPU tensors. In bf16 the fp32-accumulated
scores are rounded to bf16 before comparing, as the logits of a bf16 head
matmul would be; ties go to the lowest index, like ``jnp.argmax``. The
untied ``(d, V)`` layout (T5's ``greedy_argmax``) is not ported yet.
"""

from __future__ import annotations

import torch

from . import _build

# cap on the first pass's dynamic shared memory: B*d fp32 inputs plus the
# 8 warps' (value, index) bests per row (csrc/greedy_head.cu)
_MAX_SMEM_BYTES = 200 * 1024


def greedy_argmax_tied_plain(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """``x`` (B, d), ``emb`` (V, d) -> (B,) int64 argmax of fp32 scores
    (rounded to bf16 first when ``x`` is bf16); first index wins ties."""
    s = torch.matmul(x.float(), emb.float().t())
    if x.dtype == torch.bfloat16:
        s = s.to(torch.bfloat16).float()
    return torch.argmax(s, dim=-1)


def greedy_argmax_tied(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """``x`` (B, d), ``emb`` (V, d) -> (B,) int64 = argmax(x @ emb.T, axis=-1)."""
    if not x.is_cuda:
        return greedy_argmax_tied_plain(x, emb)
    req = _build.require
    req(x.ndim == 2 and emb.ndim == 2 and x.shape[1] == emb.shape[1], "greedy_argmax_tied: x (B, d), emb (V, d)")
    req(x.dtype == emb.dtype, "greedy_argmax_tied: x and emb must share a dtype")
    req(emb.is_cuda and x.is_contiguous() and emb.is_contiguous(),
        "greedy_argmax_tied: contiguous CUDA tensors only")
    b, d = x.shape
    v = emb.shape[0]
    req((b * d + 16 * b) * 4 <= _MAX_SMEM_BYTES, f"greedy_argmax_tied: batch {b} x width {d} exceeds shared memory")
    lib = _build.load_library()
    n_chunks = -(-v // lib.pmt_greedy_chunk_rows())
    part_val = torch.empty((b, n_chunks), dtype=torch.float32, device=x.device)
    part_idx = torch.empty((b, n_chunks), dtype=torch.int32, device=x.device)
    out = torch.empty((b,), dtype=torch.int64, device=x.device)
    code = lib.pmt_greedy_argmax_tied(x.data_ptr(), emb.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
                                      out.data_ptr(), b, v, d, n_chunks, _build.dtype_code(x), _build.stream_ptr(x))
    _build.check("pmt_greedy_argmax_tied", code)
    greedy_argmax_tied.launches += 1
    return out


greedy_argmax_tied.launches = 0
