"""Merged-head encoder attention, dense or causal, no bias (PyTorch port of
``pytorch_models_tpu/ops/encoder_attention.py``).

:func:`encoder_attention` launches the hand-written CUDA flash kernel
(``csrc/encoder_attention.cu``, tensor cores: bf16 ``mma.sync``, fp32 in
3xTF32) on CUDA tensors and runs :func:`encoder_attention_plain` on CPU
tensors. q/k/v stay in the projections' ``(B, L, H*D)`` layout; the softmax
is fp32 with the finite NEG_INF / safe-max rule of the JAX kernel, so a
fully masked row is zeros. :func:`encoder_attention_eligible` is the shape
rule the auto gate (``ops/attention.py`` ``use_encoder_kernel``) asks.
"""

from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30
# head widths the kernel is built for: DETR 32; GPT-2, Whisper, T5, BERT, ViT-Ti..L 64; ViT-H 80
SUPPORTED_HEAD_DIMS = (32, 64, 80, 128)
# keys per tile of the online softmax, per dtype; the kernel walks the same tiles
# (csrc/encoder_attention.cu, reported by pmt_encoder_attention_k_tile)
K_TILE = {torch.float32: 32, torch.bfloat16: 64}


def encoder_attention_eligible(q: torch.Tensor, n_heads: int, attn_bias=None) -> bool:
    """The kernel's shape rule: no bias, (L, H*D) or (B, L, H*D) input, and a
    head width it is built for. Mosaic's ``H*D % 128`` rule of the JAX gate
    is a TPU layout rule and is not carried over."""
    if attn_bias is not None or q.ndim not in (2, 3):
        return False
    hd = q.shape[-1]
    return hd % n_heads == 0 and hd // n_heads in SUPPORTED_HEAD_DIMS


def encoder_attention_plain(q, k, v, n_heads: int, causal: bool = False):
    """The kernel's arithmetic in plain PyTorch, over the same key tiles
    (``K_TILE``): per tile fp32 scores x scale, the mask, the running max with
    the safe-max floor, the alpha rescale, ``l += sum(p)`` from the unrounded
    fp32 p, ``acc += round(p) @ v`` in fp32 with p rounded to the input dtype;
    then ``acc / l`` (``l == 0 -> 1``), cast to the input dtype."""
    unbatched = q.ndim == 2
    if unbatched:
        q, k, v = q[None], k[None], v[None]
    b, lq, hd = q.shape
    lk = k.shape[-2]
    d = hd // n_heads
    qh = q.float().reshape(b, lq, n_heads, d).transpose(1, 2)
    kh = k.float().reshape(b, lk, n_heads, d).transpose(1, 2)
    vh = v.float().reshape(b, lk, n_heads, d).transpose(1, 2)
    scale = 1.0 / math.sqrt(d)
    bk = K_TILE[torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32]
    m = torch.full((b, n_heads, lq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, n_heads, lq, d, dtype=torch.float32, device=q.device)
    rows = torch.arange(lq, device=q.device)[:, None]
    # a causal row's tiles past its own position change nothing (p = 0, alpha = 1)
    for kt in range(0, min(lk, lq) if causal else lk, bk):
        s = torch.matmul(qh, kh[:, :, kt:kt + bk].transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(kt, min(kt + bk, lk), device=q.device)[None, :]
            s = s.masked_fill(cols > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = m_new.clamp_min(NEG_INF / 2)  # fully masked rows stay finite
        p = torch.exp(s - m_safe)
        alpha = torch.exp(m - m_safe)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(q.dtype).float(), vh[:, :, kt:kt + bk])
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l).transpose(1, 2).reshape(b, lq, hd).to(q.dtype)
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
    req(encoder_attention_eligible(q, n_heads), f"encoder_attention: head_dim {hd}/{n_heads} unsupported")
    req(k.shape == (b, lk, hd) and v.shape == (b, lk, hd), "encoder_attention: k/v shape")
    req(k.dtype == q.dtype and v.dtype == q.dtype, "encoder_attention: q, k, v must share a dtype")
    req(all(t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)),
        "encoder_attention: q, k, v must be contiguous, 16-byte aligned CUDA tensors")
    out = torch.empty_like(q)
    lib = _build.load_library()
    code = lib.pmt_encoder_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk,
                                     n_heads, d, 1.0 / math.sqrt(d), int(causal), _build.dtype_code(q),
                                     _build.stream_ptr(q))
    _build.check("pmt_encoder_attention", code)
    encoder_attention.launches += 1
    return out[0] if unbatched else out


encoder_attention.launches = 0
