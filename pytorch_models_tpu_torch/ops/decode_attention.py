"""Single-position decode attention against a merged-head KV cache (PyTorch
port of ``pytorch_models_tpu/ops/decode_attention.py``).

:func:`decode_attention` launches the hand-written CUDA kernel
(``csrc/decode_attention.cu``) on CUDA tensors and runs
:func:`decode_attention_plain` on CPU tensors. Row ``b`` attends to cache
positions ``[pad_lens[b], ends[b])`` with an fp32 softmax; an empty range
gives zeros. An optional additive fp32 bias in the JAX kernel's key-major
layout, ``(1, L, H)`` shared across rows or ``(B, L, H)`` per row (T5's
rel-pos decode bias), is added to each fp32 score after the q scale and
before the mask. The JAX kernel pads the bias to 128 lanes (a Mosaic DMA
rule); the port takes it unpadded.
"""

from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64,)  # GPT-2, Whisper, T5: the decoders of the JAX package


def decode_attention_fits(cache: torch.Tensor, n_heads: int) -> bool:
    """The kernel's shape rule on a merged-head ``(B, L, H*D)`` cache: a head
    width it is built for. The JAX gate's ``H*D % 128`` and ``KV_BLOCK``
    rules are TPU layout rules and are not carried over."""
    if cache.ndim != 3:
        return False
    hd = cache.shape[-1]
    return hd % n_heads == 0 and hd // n_heads in SUPPORTED_HEAD_DIMS


def _row_i32(x, b: int, device) -> torch.Tensor:
    """(B,) int32 contiguous on ``device``; a tensor already so passes as is
    (the generator keeps ``pad_lens`` that way, so decode steps cast nothing)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32 and x.shape == (b,) and x.device == device:
        return x.contiguous()
    return torch.as_tensor(x, device=device).reshape(-1).to(torch.int32).expand(b).contiguous()


def decode_attention_plain(q, k_cache, v_cache, ends, n_heads: int, pad_lens=None, bias=None):
    """The kernel's math in plain PyTorch: q scaled in fp32 and rounded to
    the input dtype, fp32 scores [+ the fp32 key-major bias] and softmax
    with the safe max, fp32 P @ V."""
    b, _, hd = q.shape
    l_max = k_cache.shape[-2]
    d = hd // n_heads
    qf = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float().reshape(b, n_heads, d)
    kf = k_cache.float().reshape(b, l_max, n_heads, d)
    vf = v_cache.float().reshape(b, l_max, n_heads, d)
    s = torch.einsum("bhd,blhd->bhl", qf, kf)
    if bias is not None:
        s = s + bias.float().transpose(1, 2)  # (1|B, L, H) -> (1|B, H, L)
    col = torch.arange(l_max, device=q.device)[None, :]
    pads = torch.zeros(b, dtype=torch.int32, device=q.device) if pad_lens is None else _row_i32(pad_lens, b, q.device)
    valid = (col >= pads[:, None]) & (col < _row_i32(ends, b, q.device)[:, None])
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF / 2)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    out = torch.einsum("bhl,blhd->bhd", p, vf) / denom
    return out.reshape(b, 1, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, ends, n_heads: int, pad_lens=None, bias=None):
    """q: (B, 1, H*D); k_cache/v_cache: (B, L, H*D); ends: int or (B,) int;
    bias: None or fp32 ``(1|B, L, H)``.

    Attention over cache positions ``[pad_lens[b], ends[b])`` per row;
    returns the (B, 1, H*D) merged-head context. For self-attention decode at
    position ``pos`` pass ``ends = pos + 1``. ``launches`` counts every
    launch, ``bias_launches`` those with a bias.
    """
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, ends, n_heads, pad_lens, bias)
    b, lq, hd = q.shape
    l_max = k_cache.shape[-2]
    d = hd // n_heads
    req = _build.require
    req(lq == 1, "decode_attention: single-position queries only")
    req(decode_attention_fits(k_cache, n_heads), f"decode_attention: head_dim {hd}/{n_heads} unsupported")
    req(k_cache.shape == (b, l_max, hd) and v_cache.shape == (b, l_max, hd), "decode_attention: cache shape")
    req(k_cache.dtype == q.dtype and v_cache.dtype == q.dtype, "decode_attention: q and caches must share a dtype")
    req(all(t.is_cuda and t.is_contiguous() for t in (q, k_cache, v_cache)),
        "decode_attention: q and caches must be contiguous CUDA tensors")
    req(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
        "decode_attention: caches must start 16-byte aligned (the kernel's async copies)")
    if bias is not None:
        req(bias.ndim == 3 and bias.shape[0] in (1, b) and tuple(bias.shape[1:]) == (l_max, n_heads),
            f"decode_attention: bias must be (1|{b}, {l_max}, {n_heads}), got {tuple(bias.shape)}")
        req(bias.dtype == torch.float32 and bias.is_cuda and bias.is_contiguous(),
            "decode_attention: bias must be a contiguous fp32 CUDA tensor")
    dev = q.device
    ends_t, end_scalar = None, 0
    if isinstance(ends, int):
        end_scalar = ends
    else:
        ends_t = _row_i32(ends, b, dev)
    pads_t = None if pad_lens is None else _row_i32(pad_lens, b, dev)
    out = torch.empty_like(q)
    lib = _build.load_library()
    code = lib.pmt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        None if ends_t is None else ends_t.data_ptr(), end_scalar,
        None if pads_t is None else pads_t.data_ptr(),
        None if bias is None else bias.data_ptr(), 0 if bias is None or bias.shape[0] == 1 else l_max * n_heads,
        b, l_max, n_heads, d, 1.0 / math.sqrt(d), _build.dtype_code(q), _build.stream_ptr(q))
    _build.check("pmt_decode_attention", code)
    decode_attention.launches += 1
    if bias is not None:
        decode_attention.bias_launches += 1
    return out


decode_attention.launches = 0
decode_attention.bias_launches = 0


def decode_attention_cluster(b: int, l_max: int, n_heads: int) -> int:
    """CTAs per (row, head) the kernel's launch takes at this grid and cache
    length (a thread-block cluster; chosen from the shapes alone)."""
    return _build.load_library().pmt_decode_attention_cluster(b, l_max, n_heads)
