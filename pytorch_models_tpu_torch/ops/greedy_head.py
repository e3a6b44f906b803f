"""Fused greedy head: argmax(x @ emb.T) or argmax(x @ w) without
materialising the logits (PyTorch port of
``pytorch_models_tpu/ops/greedy_head.py``).

:func:`greedy_argmax_tied` (a ``(V, d)`` tied embedding, GPT-2, Whisper) and
:func:`greedy_argmax` (an untied ``(d, V)`` classifier, T5, read in its own
layout) launch the hand-written CUDA kernel of ``csrc/greedy_head.cu`` (one
launch a call, the products on the tensor cores, the head read once for the
whole batch) on CUDA tensors and run their plain versions on CPU tensors.
In bf16 the fp32-accumulated scores are rounded to bf16 before comparing,
as the logits of a bf16 head matmul would be; ties go to the lowest index,
like ``jnp.argmax``.
"""

from __future__ import annotations

import torch

from . import _build


def greedy_head_fits(w: torch.Tensor) -> bool:
    """Whether the CUDA kernel serves the head ``w`` on its device: a
    float32 or bfloat16 head, at any batch and width (the kernel streams the
    batch rows with the head). A CPU tensor always fits (the wrapper runs
    the plain version)."""
    return not w.is_cuda or w.dtype in (torch.float32, torch.bfloat16)


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


def greedy_head_ranges(batch: int, w: torch.Tensor, tied: bool) -> list[int]:
    """The first vocab row of each CTA's range in a CUDA call at this shape:
    the kernel's planner (``pmt_greedy_split``) gives the CTA count ``G``
    and the rows ``N`` of a unit; CTA ``i`` owns the units
    ``[i * U // G, (i + 1) * U // G)``, ``U = ceil(V / N)``."""
    import ctypes

    v = w.shape[0] if tied else w.shape[1]
    split = (ctypes.c_int * 2)()
    with torch.cuda.device(w.device):
        code = _build.load_library().pmt_greedy_split(batch, v, _build.dtype_code(w), int(tied),
                                                      ctypes.addressof(split))
    _build.check("pmt_greedy_split", code)
    grid, unit = split
    units = -(-v // unit)
    return [unit * (i * units // grid) for i in range(grid)]


# per (device, stream): 1 + B int64 words, zero; every call leaves them zero
# (word 0 the CTAs' ticket, then one (score, index) key per batch row)
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _scratch(x: torch.Tensor) -> torch.Tensor:
    key = (x.device.index, _build.stream_ptr(x))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < x.shape[0] + 1:
        buf = _SCRATCH[key] = torch.zeros(max(x.shape[0], 64) + 1, dtype=torch.int64, device=x.device)
    return buf


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, tied: bool) -> torch.Tensor:
    _build.require_no_grad(name, x, w)
    req = _build.require
    req(x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[1 if tied else 0],
        f"{name}: x (B, d), " + ("emb (V, d)" if tied else "w (d, V)"))
    req(x.dtype == w.dtype, f"{name}: x and the head must share a dtype")
    req(x.dtype in (torch.float32, torch.bfloat16), f"{name}: float32 or bfloat16 only, got {x.dtype}")
    req(w.is_cuda and x.is_contiguous() and w.is_contiguous(), f"{name}: contiguous CUDA tensors only")
    b, d = x.shape
    v = w.shape[0] if tied else w.shape[1]
    lib = _build.load_library()
    out = torch.empty((b,), dtype=torch.int64, device=x.device)
    code = lib.pmt_greedy_argmax(x.data_ptr(), w.data_ptr(), _scratch(x).data_ptr(), out.data_ptr(), b, v, d,
                                 _build.dtype_code(x), int(tied), _build.stream_ptr(x))
    _build.check("pmt_greedy_argmax", code)
    return out


def greedy_argmax_tied(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """``x`` (B, d), ``emb`` (V, d) -> (B,) int64 = argmax(x @ emb.T, axis=-1)."""
    if not x.is_cuda:
        return greedy_argmax_tied_plain(x, emb)
    out = _launch("greedy_argmax_tied", x, emb, tied=True)
    greedy_argmax_tied.launches += 1
    return out


greedy_argmax_tied.launches = 0


def greedy_argmax(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (B, d), ``w`` (d, V) -> (B,) int64 = argmax(x @ w, axis=-1)
    (an untied classifier head, e.g. T5's; ``w`` is read as it lies)."""
    if not x.is_cuda:
        return greedy_argmax_plain(x, w)
    out = _launch("greedy_argmax", x, w, tied=False)
    greedy_argmax.launches += 1
    return out


greedy_argmax.launches = 0
