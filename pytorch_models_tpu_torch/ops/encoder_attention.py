"""Merged-head encoder attention, dense or causal, no bias (PyTorch port of
``pytorch_models_tpu/ops/encoder_attention.py``).

:func:`encoder_attention` launches the hand-written CUDA flash kernel
(``csrc/encoder_attention.cu``) on CUDA tensors and runs
:func:`encoder_attention_plain` on CPU tensors. q/k/v stay in the
projections' ``(B, L, H*D)`` layout; the softmax is fp32 with the finite
NEG_INF / safe-max rule of the JAX kernel, so a fully masked row is zeros.
"""

from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64,)  # every family of the JAX package uses 64


def encoder_attention_plain(q, k, v, n_heads: int, causal: bool = False):
    """The kernel's math in plain PyTorch: fp32 scores, mask, safe-max
    softmax and P @ V, cast back to the input dtype."""
    unbatched = q.ndim == 2
    if unbatched:
        q, k, v = q[None], k[None], v[None]
    b, lq, hd = q.shape
    lk = k.shape[-2]
    d = hd // n_heads
    qh = q.float().reshape(b, lq, n_heads, d).transpose(1, 2)
    kh = k.float().reshape(b, lk, n_heads, d).transpose(1, 2)
    vh = v.float().reshape(b, lk, n_heads, d).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF / 2)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    out = (torch.matmul(p, vh) / denom).transpose(1, 2).reshape(b, lq, hd).to(q.dtype)
    return out[0] if unbatched else out


def encoder_attention(q, k, v, n_heads: int, causal: bool = False):
    """q: (B, Lq, H*D), k/v: (B, Lk, H*D) -> (B, Lq, H*D) merged-head SDPA.
    Unbatched (L, H*D) inputs are promoted."""
    if not q.is_cuda:
        return encoder_attention_plain(q, k, v, n_heads, causal)
    _build.require(q.ndim in (2, 3), "encoder_attention: q must be (L, H*D) or (B, L, H*D)")
    unbatched = q.ndim == 2
    if unbatched:
        q, k, v = q[None], k[None], v[None]
    b, lq, hd = q.shape
    lk = k.shape[-2]
    d = hd // n_heads
    req = _build.require
    req(hd % n_heads == 0 and d in SUPPORTED_HEAD_DIMS, f"encoder_attention: head_dim {hd}/{n_heads} unsupported")
    req(k.shape == (b, lk, hd) and v.shape == (b, lk, hd), "encoder_attention: k/v shape")
    req(k.dtype == q.dtype and v.dtype == q.dtype, "encoder_attention: q, k, v must share a dtype")
    req(all(t.is_cuda and t.is_contiguous() for t in (q, k, v)),
        "encoder_attention: q, k, v must be contiguous CUDA tensors")
    out = torch.empty_like(q)
    lib = _build.load_library()
    code = lib.pmt_encoder_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk,
                                     n_heads, d, 1.0 / math.sqrt(d), int(causal), _build.dtype_code(q),
                                     _build.stream_ptr(q))
    _build.check("pmt_encoder_attention", code)
    encoder_attention.launches += 1
    return out[0] if unbatched else out


encoder_attention.launches = 0
