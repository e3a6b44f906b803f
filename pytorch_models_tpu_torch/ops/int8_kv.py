"""int8 KV caches and single-position decode attention over them (PyTorch
port of ``pytorch_models_tpu/ops/int8_kv.py``).

K/V are stored as per-key symmetric int8 with fp32 per-key scales; a decode
step scores with int8 x int8 -> int32 dot products and folds the V scales
into probabilities that are themselves quantized per 128-key block
(:func:`int8_decode_attention_plain` spells the arithmetic out).

Layouts: caches ``(B, Lp, H*D)`` int8 with ``Lp`` a multiple of 128, scale
planes ``(B, Lp)`` fp32 (layer-stacked: ``(L, B, Lp, H*D)`` and ``(L, B,
Lp)``). The JAX package pads its scale planes' batch to 8 rows (``_b8``, a
TPU DMA rule); the port keeps ``B`` rows (:func:`int8_kv_from_jax` drops
the padding).

:func:`int8_decode_attention` launches the hand-written CUDA kernel
``csrc/int8_kv.cu`` (K6) on CUDA tensors and runs
:func:`int8_decode_attention_plain` on CPU tensors. The JAX function's
``cur_ks`` (a full-width scale for tensor-parallel shards) is not ported:
it waits for the port's ``parallel/``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build
from .decode_attention import NEG_INF, _row_i32

KV_BLOCK_INT8 = 128  # keys per quantization block of the probabilities


def quantize_rows(x: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 along ``dim``: ``(x_q int8, scales fp32)``, the
    scales keeping ``dim`` (size 1). ``scale = (absmax == 0 ? 1 : absmax) *
    (1/127)``, ``x_q = clip(round(x / scale), -127, 127)`` with round half
    to even, bit for bit the JAX package's rule."""
    x32 = x.float()
    absmax = x32.abs().amax(dim, keepdim=True)
    scales = torch.where(absmax == 0, torch.ones_like(absmax), absmax) * (1.0 / 127.0)
    return torch.round(x32 / scales).clamp(-127, 127).to(torch.int8), scales


def make_int8_kv_cache(b: int, l_max: int, hd: int, device=None):
    """``(k_q, v_q, k_s, v_s)``: zeroed int8 caches ``(B, Lmax, H*D)`` and
    unit scale planes ``(B, Lmax)`` fp32."""
    if l_max % KV_BLOCK_INT8:
        raise ValueError(f"l_max must be a multiple of {KV_BLOCK_INT8}, got {l_max}")
    kq = torch.zeros((b, l_max, hd), dtype=torch.int8, device=device)
    ks = torch.ones((b, l_max), dtype=torch.float32, device=device)
    return kq, kq.clone(), ks, ks.clone()


def write_int8_kv(k_q, v_q, k_s, v_s, k_new, v_new, pos: int) -> None:
    """Quantize this step's ``(B, 1, H*D)`` K/V per key and write cache slot
    ``pos`` and its scales, in place (the JAX function returns new arrays)."""
    prefill_int8_kv(k_q, v_q, k_s, v_s, k_new, v_new, pos)


def prefill_int8_kv(k_q, v_q, k_s, v_s, k_chunk, v_chunk, start_pos: int = 0) -> None:
    """Quantize a ``(B, S, H*D)`` chunk per key and write it at
    ``[start_pos, start_pos + S)``, in place."""
    s = k_chunk.shape[1]
    for cache, scales, chunk in ((k_q, k_s, k_chunk), (v_q, v_s, v_chunk)):
        q, sc = quantize_rows(chunk)
        cache[:, start_pos:start_pos + s] = q
        scales[:, start_pos:start_pos + s] = sc[..., 0]


def quantize_kv_caches(caches: dict) -> dict:
    """Full-precision ``{"k", "v"}`` caches ``(..., Lp, H*D)`` (as a prefill
    wrote them) -> ``{"k", "v"}`` int8 and ``{"ks", "vs"}`` fp32 ``(...,
    Lp)`` per-key scales; other keys (a cross cache's ``len``) pass
    through. Unwritten slots are zeros and quantize harmlessly (0, 1/127)."""
    k_q, k_s = quantize_rows(caches["k"])
    v_q, v_s = quantize_rows(caches["v"])
    out = {"k": k_q, "v": v_q, "ks": k_s[..., 0].contiguous(), "vs": v_s[..., 0].contiguous()}
    out.update({key: val for key, val in caches.items() if key not in ("k", "v")})
    return out


def int8_kv_from_jax(cache: dict, batch: int, device=None) -> dict:
    """A JAX int8 cache dict (numpy arrays; ``ks``/``vs`` planes with the
    batch padded to 8 rows, ``(..., B8, Lmax)``) -> the port's layout: the
    padding rows dropped, every array a tensor on ``device``."""
    out = {}
    for key, val in cache.items():
        a = np.asarray(val)
        if key in ("ks", "vs"):
            a = a[..., :batch, :]
        out[key] = torch.from_numpy(np.array(a)).to(device)
    return out


def int8_decode_attention_plain(q, k_q, v_q, k_s, v_s, ends, n_heads: int, pad_lens=None, cur_k=None, cur_v=None,
                                bias=None):
    """The kernel's arithmetic in plain PyTorch (the JAX package's
    ``_int8_attention_oracle_impl``, op for op; int8 dot products in float64,
    where they are exact).

    q scaled by ``1/sqrt(D)`` in fp32 and quantized per (row, head); keys
    walked in 128-key blocks: ``s = (f32(q_i8 . k_i8) * k_s) * sq`` [+ the
    key-major ``(Lk, H)`` fp32 ``bias``], NEG_INF outside ``[pad, end)``,
    an online softmax with the safe max, ``p * v_s`` quantized per (row,
    head, block) and ``acc = acc * alpha + ps * (p_i8 . v_i8)``. With
    ``cur_k``/``cur_v`` ``(B, H*D)`` the current position is folded in last:
    K quantized with the cache-write rule (absmax over the whole row), V in
    full precision, its bias row ``ends[0]``. An empty range gives zeros."""
    b, _, hd = q.shape
    d = hd // n_heads
    dev = q.device
    bk = KV_BLOCK_INT8
    ends_t = _row_i32(ends, b, dev).long()
    pads_t = torch.zeros(b, dtype=torch.long, device=dev) if pad_lens is None else _row_i32(pad_lens, b, dev).long()
    qs = (q[:, 0].float() * (1.0 / math.sqrt(d))).reshape(b, n_heads, d)
    q_i8, sq = quantize_rows(qs)  # (B, H, D), (B, H, 1)
    qd = q_i8.double()
    m = torch.full((b, n_heads), NEG_INF, device=dev)
    l = torch.zeros((b, n_heads), device=dev)
    acc = torch.zeros((b, n_heads, d), device=dev)
    first = int((pads_t.clamp_min(0) // bk).min())
    n_blocks = int(((ends_t + bk - 1) // bk).max())
    for i in range(first, n_blocks):
        sl = slice(i * bk, (i + 1) * bk)
        kb = k_q[:, sl].reshape(b, bk, n_heads, d).double()
        s_i = torch.einsum("bhd,bjhd->bhj", qd, kb).float()
        s = (s_i * k_s[:, None, sl].float()) * sq
        if bias is not None:
            s = s + bias[sl].float().t()[None]
        k_idx = torch.arange(i * bk, (i + 1) * bk, device=dev)[None, :]
        valid = (k_idx < ends_t[:, None]) & (k_idx >= pads_t[:, None])
        s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = m_new.clamp_min(NEG_INF / 2)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.exp(m - m_safe)
        l = alpha * l + p.sum(-1)
        p_i8, ps = quantize_rows(p * v_s[:, None, sl].float())
        pv = torch.einsum("bhj,bjhd->bhd", p_i8.double(), v_q[:, sl].reshape(b, bk, n_heads, d).double()).float()
        acc = acc * alpha[..., None] + ps * pv
        m = m_new
    if cur_k is not None:
        kc_i8, kc_s = quantize_rows(cur_k.float())  # (B, H*D), (B, 1)
        dot = torch.einsum("bhd,bhd->bh", qd, kc_i8.reshape(b, n_heads, d).double()).float()
        s_cur = (dot * kc_s) * sq[..., 0]
        if bias is not None:
            s_cur = s_cur + bias[int(ends_t[0])].float()[None]
        m_new = torch.maximum(m, s_cur)
        p_cur = torch.exp(s_cur - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p_cur
        acc = acc * alpha[..., None] + p_cur[..., None] * cur_v.float().reshape(b, n_heads, d)
    else:
        l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l[..., None]).reshape(b, 1, hd).to(q.dtype)


def int8_decode_attention(q, k_q, v_q, k_s, v_s, ends, n_heads: int, pad_lens=None, cur_k=None, cur_v=None,
                          bias=None):
    """Single-position attention over an int8 KV cache.

    q: (B, 1, H*D) fp32 or bf16; k_q/v_q: (B, Lk, H*D) int8 with ``Lk`` a
    multiple of 128; k_s/v_s: (B, Lk) fp32 per-key scales; ends: int or (B,)
    int. Row ``b`` attends to cache keys ``[pad_lens[b], ends[b])``; with
    ``cur_k``/``cur_v`` ((B, H*D), this step's unquantized K/V, q's dtype)
    the current position is folded in after the cache (the cache holds
    ``[0, pos)``, ``ends = pos``). ``bias``: None or a key-major ``(Lk, H)``
    fp32 bias shared by the rows. Returns the (B, 1, H*D) context in q's
    dtype. ``launches`` counts the kernel's launches."""
    if not q.is_cuda:
        return int8_decode_attention_plain(q, k_q, v_q, k_s, v_s, ends, n_heads, pad_lens, cur_k, cur_v, bias)
    b, lq, hd = q.shape
    l_k = k_q.shape[-2]
    req = _build.require
    req(lq == 1 and hd == n_heads * 64, f"int8_decode_attention: q must be (B, 1, H*64), got {tuple(q.shape)}")
    req(q.dtype in (torch.float32, torch.bfloat16), "int8_decode_attention: q fp32 or bf16")
    req(k_q.shape == (b, l_k, hd) and v_q.shape == k_q.shape and l_k % KV_BLOCK_INT8 == 0,
        f"int8_decode_attention: caches must be (B, Lk, H*D) with Lk a multiple of {KV_BLOCK_INT8}")
    req(k_q.dtype == torch.int8 and v_q.dtype == torch.int8, "int8_decode_attention: int8 caches")
    req(k_s.shape == (b, l_k) and v_s.shape == (b, l_k) and k_s.dtype == torch.float32 and v_s.dtype == torch.float32,
        "int8_decode_attention: scales must be (B, Lk) fp32")
    tensors = [q, k_q, v_q, k_s, v_s]
    if cur_k is not None:
        req(cur_v is not None and cur_k.shape == (b, hd) and cur_v.shape == (b, hd)
            and cur_k.dtype == q.dtype and cur_v.dtype == q.dtype,
            "int8_decode_attention: cur_k/cur_v must be (B, H*D) in q's dtype")
        tensors += [cur_k, cur_v]
    if bias is not None:
        req(tuple(bias.shape) == (l_k, n_heads) and bias.dtype == torch.float32,
            f"int8_decode_attention: bias must be ({l_k}, {n_heads}) fp32")
        tensors.append(bias)
    req(all(t.is_cuda and t.device == q.device and t.is_contiguous() for t in tensors),
        "int8_decode_attention: contiguous tensors on q's CUDA device only")
    req(all(t.data_ptr() % 16 == 0 for t in (k_q, v_q, k_s, v_s)),
        "int8_decode_attention: caches and scales must start 16-byte aligned (the kernel's async copies)")
    dev = q.device
    ends_t, end_scalar = None, 0
    if isinstance(ends, int):
        end_scalar = ends
    else:
        ends_t = _row_i32(ends, b, dev)
    if cur_k is not None and bias is not None:
        cur_pos = end_scalar if ends_t is None else int(ends_t[0])
        req(0 <= cur_pos < l_k, f"int8_decode_attention: the current position {cur_pos} has no bias row")
    pads_t = None if pad_lens is None else _row_i32(pad_lens, b, dev)
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = _build.load_library().pmt_int8_attention(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_s.data_ptr(), v_s.data_ptr(), ptr(ends_t), end_scalar,
        ptr(pads_t), ptr(cur_k), ptr(cur_v), ptr(bias), out.data_ptr(), b, l_k, n_heads, 1.0 / math.sqrt(64),
        _build.dtype_code(q), _build.stream_ptr(q))
    _build.check("pmt_int8_attention", code)
    int8_decode_attention.launches += 1
    return out


int8_decode_attention.launches = 0


def int8_decode_attention_cluster(b: int, l_k: int, n_heads: int) -> int:
    """CTAs per (row, head) the kernel's launch takes at this grid and cache
    length (a thread-block cluster; chosen from the shapes alone)."""
    return _build.load_library().pmt_int8_attention_cluster(b, l_k, n_heads)
