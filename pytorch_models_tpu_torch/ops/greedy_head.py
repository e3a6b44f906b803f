"""Fused greedy head: argmax(x @ emb.T) or argmax(x @ w) without
materialising the logits (PyTorch port of
``pytorch_models_tpu/ops/greedy_head.py``).

:func:`greedy_argmax_tied` (a ``(V, d)`` tied embedding, GPT-2, Whisper) and
:func:`greedy_argmax` (an untied ``(d, V)`` classifier, T5, read in its own
layout) launch the hand-written CUDA kernels of ``csrc/greedy_head.cu`` on
CUDA tensors and run their plain versions on CPU tensors. In bf16 the
fp32-accumulated scores are rounded to bf16 before comparing, as the logits
of a bf16 head matmul would be; ties go to the lowest index, like
``jnp.argmax``.
"""

from __future__ import annotations

import torch

from . import _build


def greedy_head_fits(batch: int, w: torch.Tensor, tied: bool) -> bool:
    """Whether the CUDA kernel serves ``batch`` rows against the head ``w``
    (tied ``(V, d)`` or untied ``(d, V)``) on ``w``'s device: asks the
    kernel's own planner, since its first pass holds the rows in shared
    memory. A CPU tensor always fits (the wrapper runs the plain version)."""
    if not w.is_cuda:
        return True
    if w.dtype not in (torch.float32, torch.bfloat16):
        return False
    width = w.shape[1] if tied else w.shape[0]
    with torch.cuda.device(w.device):
        return bool(_build.load_library().pmt_greedy_fits(batch, width, _build.dtype_code(w), int(tied)))


def _argmax_scores(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        s = s.to(torch.bfloat16).float()
    return torch.argmax(s, dim=-1)


def greedy_argmax_tied_plain(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """``x`` (B, d), ``emb`` (V, d) -> (B,) int64 argmax of fp32 scores
    (rounded to bf16 first when ``x`` is bf16); first index wins ties."""
    return _argmax_scores(x, torch.matmul(x.float(), emb.float().t()))


def greedy_argmax_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (B, d), ``w`` (d, V) -> (B,) int64 argmax of fp32 scores
    (rounded to bf16 first when ``x`` is bf16); first index wins ties."""
    return _argmax_scores(x, torch.matmul(x.float(), w.float()))


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
    lib = _build.load_library()
    req(lib.pmt_greedy_fits(b, d, _build.dtype_code(x), 1), f"greedy_argmax_tied: batch {b} x width {d} exceeds "
        "shared memory")
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


def greedy_argmax(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (B, d), ``w`` (d, V) -> (B,) int64 = argmax(x @ w, axis=-1)
    (an untied classifier head, e.g. T5's; ``w`` is read as it lies)."""
    if not x.is_cuda:
        return greedy_argmax_plain(x, w)
    req = _build.require
    req(x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[0], "greedy_argmax: x (B, d), w (d, V)")
    req(x.dtype == w.dtype, "greedy_argmax: x and w must share a dtype")
    req(w.is_cuda and x.is_contiguous() and w.is_contiguous(), "greedy_argmax: contiguous CUDA tensors only")
    b, d = x.shape
    v = w.shape[1]
    lib = _build.load_library()
    cols = lib.pmt_greedy_untied_cols(_build.dtype_code(x))
    req(lib.pmt_greedy_fits(b, d, _build.dtype_code(x), 0), f"greedy_argmax: width {d} exceeds shared memory")
    n_chunks = -(-v // cols)
    part_val = torch.empty((b, n_chunks), dtype=torch.float32, device=x.device)
    part_idx = torch.empty((b, n_chunks), dtype=torch.int32, device=x.device)
    out = torch.empty((b,), dtype=torch.int64, device=x.device)
    code = lib.pmt_greedy_argmax_untied(x.data_ptr(), w.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
                                        out.data_ptr(), b, v, d, n_chunks, _build.dtype_code(x), _build.stream_ptr(x))
    _build.check("pmt_greedy_argmax_untied", code)
    greedy_argmax.launches += 1
    return out


greedy_argmax.launches = 0
