"""Shared transformer core: MHA, MLP, encoder/decoder layers and stacks
(PyTorch port of ``pytorch_models_tpu/transformer.py``).

Parameters are plain dicts of tensors in the JAX package's layouts; a layer
stack is a list of per-layer dicts run as a Python loop. KV caches are
merged-head ``(B, L_max, H*D)`` per layer — the shape the K/V projections
produce — with ``L_max = padded_cache_len(max_seq_len)``, so a cache built
here holds the same values at the same places as the JAX package's.
Cross-attention caches (:func:`precompute_cross_caches`) are a list of
per-layer ``{"k", "v", "len"}`` dicts, written once per encoded input. Both
kinds of cache live in ONE layer-stacked ``(L, B, Lp, H*D)`` buffer each for
K and V, and the per-layer dicts hold views of it: the per-op path reads and
writes through the views, the fused decode step (``ops/decode_step.py``)
reads the buffers, and neither copies.

Where the JAX package returns a new cache from ``dynamic_update_slice``,
this port writes the new K/V into the cache IN PLACE and returns the same
cache object: PyTorch tensors are mutable, and a copy per step would move
the whole cache.

Additive attention biases (T5's rel-pos and pad biases) follow the JAX
package's dispatch: a single-position self-attention bias goes to the
decode kernel in its key-major layout; a biased cross or uncached call takes
plain :func:`sdpa`, since neither kernel takes a bias there.

An int8 KV cache (``{"k", "v"}`` int8 + ``{"ks", "vs"}`` fp32 per-key
scales, ``ops/int8_kv.py``) sends a single-position read to the int8 decode
kernel: self-attention attends over the cached ``[pad, pos)`` with this
step's K/V unquantized as the current position, then writes them quantized
at ``pos``; cross-attention reads its write-once int8 cache.

Tensor parallelism (Megatron head sharding, ``parallel/``): with
``LayerConfig.tp_axis`` set to the tp process group, ``n_heads`` counts the
rank's LOCAL heads, q/k/v and the MLP's first matrix are column shards, and
the attention out-projection and the MLP's last matrix are row shards whose
partial sums :func:`reduce_linear` all-reduces, the bias added after the
sum: two all-reduces per layer. The int8 paths quantize with the absmax
all-reduced by max over the group, so every rank writes the levels a single
device writes for the full-width row, and the int8 decode kernel takes the
current key's full-width scale (``cur_ks``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .ops import ACT_FNS, layer_norm, linear, linear_init, ln_init, sdpa
from .ops import attention as _attn
from .ops.layers import linear_dtype


def resolve_heads(d_model: int, n_heads: int | None = None, head_dim: int | None = None) -> tuple[int, int]:
    """Head-count/dim inference exactly as the reference (transformer.py:20-26)."""
    if head_dim is None and n_heads is None:
        head_dim = 64
        n_heads = d_model // head_dim
    elif head_dim is None:
        head_dim = d_model // n_heads
    elif n_heads is None:
        n_heads = d_model // head_dim
    return n_heads, head_dim


@dataclass(frozen=True)
class LayerConfig:
    """Static hyperparameters of one encoder/decoder layer."""

    d_model: int
    n_heads: int
    head_dim: int
    cross_attn: bool = False
    bias: bool = True
    mlp_ratio: float = 4.0
    act: str = "gelu"
    pre_norm: bool = True
    norm_eps: float = 1e-5
    # tensor-parallel serving (parallel/): the tp ProcessGroup (None: no parallelism); n_heads / head_dim then
    # describe the rank's local heads, and the out-projection and the MLP's last matrix all-reduce over it
    tp_axis: object = None

    @staticmethod
    def make(d_model, n_heads=None, head_dim=None, **kw) -> "LayerConfig":
        n_heads, head_dim = resolve_heads(d_model, n_heads, head_dim)
        return LayerConfig(d_model, n_heads, head_dim, **kw)

    def with_(self, **kw) -> "LayerConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Multi-head attention
# ---------------------------------------------------------------------------


def mha_init(gen: torch.Generator, cfg: LayerConfig) -> dict:
    inner = cfg.n_heads * cfg.head_dim
    return {
        "q": linear_init(gen, cfg.d_model, inner, cfg.bias),
        "k": linear_init(gen, cfg.d_model, inner, cfg.bias),
        "v": linear_init(gen, cfg.d_model, inner, cfg.bias),
        "o": linear_init(gen, inner, cfg.d_model, cfg.bias),
    }


def split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """(..., L, H*D) -> (..., H, L, D)"""
    return x.reshape(*x.shape[:-1], n_heads, head_dim).transpose(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., H, L, D) -> (..., L, H*D)"""
    x = x.transpose(-2, -3)
    return x.reshape(*x.shape[:-2], -1)


def reduce_linear(p: dict, x: torch.Tensor, tp_axis) -> torch.Tensor:
    """Row-parallel linear: ``x`` (..., k/tp) @ ``w`` (k/tp, n), the partial
    sums all-reduced over the ``tp_axis`` group, then the replicated bias,
    added once to the complete sum. With ``tp_axis=None`` this is exactly
    :func:`linear`."""
    if tp_axis is None:
        return linear(p, x)
    from .parallel.mesh import psum

    out = psum(linear({"w": p["w"]}, x), tp_axis)
    if "b" in p:
        out += p["b"].to(out.dtype)
    return out


def mha_project_kv(p: dict, cfg: LayerConfig, kv: torch.Tensor, valid_lens=None, out: dict | None = None) -> dict:
    """Project ``kv`` (B, L, d) into a cross-attention cache ``{"k", "v",
    "len"}``: merged-head (B, Lp, H*D) K/V of the memory zero-padded to
    ``padded_cache_len(L)`` rows (as in the JAX package, so the caches hold
    the same values), and ``len`` (B,) int32, each row's count of valid
    memory positions (``valid_lens``, e.g. T5's right-padded prompts, or L),
    which masks the rest on every read path. With ``out`` (``{"k", "v"}``
    tensors of that shape) the projections are written into them."""
    length = kv.shape[-2]
    kv_p = torch.nn.functional.pad(kv, (0, 0, 0, padded_cache_len(length) - length))
    if valid_lens is None:
        lens = torch.full(kv.shape[:-2], length, dtype=torch.int32, device=kv.device)
    else:
        lens = torch.as_tensor(valid_lens, device=kv.device).to(torch.int32).expand(kv.shape[:-2]).contiguous()
    out = out or {"k": None, "v": None}
    return {"k": linear(p["k"], kv_p, out["k"]), "v": linear(p["v"], kv_p, out["v"]), "len": lens}


def _decode_kernel_bias(attn_bias: torch.Tensor | None, l_max: int, n_heads: int):
    """A single-position additive bias (T5's rel-pos decode bias) in the
    decode kernel's key-major layout, contiguous fp32: shared by the batch,
    (H, 1, L) -> (1, L, H), or per row, (B, H, 1, L) -> (B, L, H). Returns
    ``(kernel_bias, convertible)``; another shape is not convertible and
    takes the plain path."""
    if attn_bias is None:
        return None, True
    if attn_bias.shape == (n_heads, 1, l_max):
        return attn_bias.movedim(0, -1).to(torch.float32).contiguous(), True
    if attn_bias.ndim == 4 and attn_bias.shape[1:] == (n_heads, 1, l_max):
        return attn_bias[:, :, 0].transpose(1, 2).to(torch.float32).contiguous(), True
    return None, False


def mha_apply(
    p: dict,
    cfg: LayerConfig,
    q: torch.Tensor,
    k: torch.Tensor | None = None,
    v: torch.Tensor | None = None,
    attn_bias: torch.Tensor | None = None,
    causal: bool = False,
    cache: dict | None = None,
    cache_pos: int | None = None,
    pad_lens: torch.Tensor | None = None,
):
    """Self- or cross-attention with an optional additive bias, causal mask
    or KV cache.

    ``k`` defaults to ``q`` and ``v`` to ``k``; cross-attention passes the
    encoder memory as ``k``. ``attn_bias`` is added to the scores,
    broadcastable to ``(..., H, Lq, Lk)``. With ``cache`` and ``cache_pos`` (self-attention),
    the chunk's new K/V are written at cache slots ``[pos, pos+S)`` and
    attention is masked to ``key_pos <= pos + i``; returns ``(out, cache)``.
    ``cache_pos`` is an int, or a (B,) tensor of per-row slots ``pos_b``
    (speculative decoding's rows, each at its own position): row b's chunk is
    written at ``[pos_b, pos_b+S)`` and masked to ``key_pos <= pos_b + i``.
    ``pad_lens`` (B,) masks each row's left-pad slots ``< pad_lens[b]``. With
    ``cache`` but no ``cache_pos``, the cache is a precomputed cross-attention
    cache (:func:`mha_project_kv`) used as is; its ``len`` masks the padding.

    Dispatch, as in the JAX package: a single cached position goes to the
    decode kernel (self-attention with its bias in key-major layout; cross
    only without a bias); longer cached chunks (prefill) take the masked
    plain path; an uncached call (self, or cross over ``memory`` with Lq !=
    Lk) goes to the encoder-attention kernel when there is no bias. On a
    CUDA tensor the auto gates take a kernel only for a shape it serves
    (``encoder_attention_eligible``, ``decode_attention_fits``), else
    :func:`sdpa`; a forced ``USE_*_KERNEL = True`` reaches the wrapper, which
    raises for such a shape; ``False`` selects :func:`sdpa`.
    """
    k = q if k is None else k
    v = k if v is None else v

    if cache is not None and "ks" in cache:  # int8 KV cache: single-position decode only
        if attn_bias is not None:
            raise ValueError("int8 per-op attention takes no bias (as in the JAX package)")
        if q.shape[-2] != 1:
            raise ValueError("int8 KV caches serve single-position decode only")
        if cache_pos is not None:
            return _int8_self_decode_apply(p, cfg, k, v, q, cache, cache_pos, pad_lens), cache
        return _int8_cross_decode_apply(p, cfg, q, cache)

    if cache is not None and cache_pos is None:  # precomputed cross-attention K/V
        return _cross_cached_apply(p, cfg, q, cache, attn_bias)

    if cache is not None:
        k_new = linear(p["k"], k)  # (B, S, H*D) — merged, matches the cache
        v_new = linear(p["v"], v)
        # in place, where the JAX package returns a dynamic_update_slice copy
        s = q.shape[-2]
        per_row = isinstance(cache_pos, torch.Tensor)
        if per_row:  # row b's chunk at its own slots [pos_b, pos_b+S)
            cache_pos = cache_pos.long()
            slots = cache_pos[:, None] + torch.arange(s, device=q.device)
            rows = torch.arange(slots.shape[0], device=q.device)[:, None]
            cache["k"][rows, slots] = k_new.to(cache["k"].dtype)
            cache["v"][rows, slots] = v_new.to(cache["v"].dtype)
        else:
            cache["k"][..., cache_pos:cache_pos + s, :] = k_new.to(cache["k"].dtype)
            cache["v"][..., cache_pos:cache_pos + s, :] = v_new.to(cache["v"].dtype)
        ck, cv = cache["k"], cache["v"]
        l_max = ck.shape[-2]

        q_m = linear(p["q"], q)  # (B, S, H*D) — the decode kernel takes merged heads
        if s == 1 and _attn.use_decode_kernel(ck, cfg.n_heads, q_m, cv):
            kernel_bias, convertible = _decode_kernel_bias(attn_bias, l_max, cfg.n_heads)
            if convertible:
                from .ops.decode_attention import decode_attention

                out = decode_attention(q_m, ck.to(q_m.dtype), cv.to(q_m.dtype), cache_pos + 1, cfg.n_heads,
                                       pad_lens, kernel_bias)
                return reduce_linear(p["o"], out, cfg.tp_axis), cache

        qh = split_heads(q_m, cfg.n_heads, cfg.head_dim)
        kh = split_heads(ck.to(qh.dtype), cfg.n_heads, cfg.head_dim)
        vh = split_heads(cv.to(qh.dtype), cfg.n_heads, cfg.head_dim)
        row = torch.arange(s, device=q.device)[:, None]
        col = torch.arange(l_max, device=q.device)[None, :]
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        last = cache_pos[:, None, None, None] + row if per_row else cache_pos + row  # per row: (B, 1, S, 1)
        bias = torch.where(col <= last, zero, float("-inf"))
        if pad_lens is not None:
            # finite -1e30 (not -inf): a left-padded row's pad-region queries
            # see no valid keys; -inf would make their (discarded) softmax NaN
            pad_bias = torch.where(col >= pad_lens.to(torch.int64)[:, None], zero, -1e30)
            bias = bias + pad_bias[:, None, None, :]
        if attn_bias is not None:
            bias = attn_bias + bias
        out = sdpa(qh, kh, vh, bias)
        return reduce_linear(p["o"], merge_heads(out), cfg.tp_axis), cache

    q_m = linear(p["q"], q)
    k_m = linear(p["k"], k)
    v_m = linear(p["v"], v)
    if _attn.use_encoder_kernel(q_m, cfg.n_heads, attn_bias, k_m, v_m):
        from .ops.encoder_attention import encoder_attention

        return reduce_linear(p["o"], encoder_attention(q_m, k_m, v_m, cfg.n_heads, causal), cfg.tp_axis)
    qh = split_heads(q_m, cfg.n_heads, cfg.head_dim)
    kh = split_heads(k_m, cfg.n_heads, cfg.head_dim)
    vh = split_heads(v_m, cfg.n_heads, cfg.head_dim)
    return reduce_linear(p["o"], merge_heads(sdpa(qh, kh, vh, attn_bias, causal)), cfg.tp_axis)


def _int8_self_decode_apply(p: dict, cfg: LayerConfig, k, v, q, cache: dict, pos: int, pad_lens) -> torch.Tensor:
    """One position of self-attention over an int8 cache holding ``[0,
    pos)``: the int8 decode kernel attends with this step's K/V unquantized
    as the current position (K scored with the cache-write rule, so a key
    scores the same now and later from the cache), then the K/V are written
    quantized at ``pos``, in place. Under tensor parallelism the rank holds
    a width shard: the scales are the full row's (``quantize_rows`` over
    ``cfg.tp_axis``), and the kernel scores the current key with its
    full-width scale (``cur_ks``), as the JAX package does."""
    from .ops.int8_kv import int8_decode_attention, quantize_rows

    k_new = linear(p["k"], k)  # (B, 1, H*D)
    v_new = linear(p["v"], v)
    q_m = linear(p["q"], q)
    (kq, ks), (vq, vs) = (quantize_rows(t[:, 0], group=cfg.tp_axis) for t in (k_new, v_new))
    cur_k, cur_v = (t[:, 0].to(q_m.dtype).contiguous() for t in (k_new, v_new))
    out = int8_decode_attention(q_m, cache["k"], cache["v"], cache["ks"], cache["vs"], pos, cfg.n_heads, pad_lens,
                                cur_k, cur_v, cur_ks=ks)
    for key, q8, sc in (("k", kq, ks), ("v", vq, vs)):
        cache[key][:, pos] = q8
        cache[key + "s"][:, pos] = sc[:, 0]
    return reduce_linear(p["o"], out, cfg.tp_axis)


def _int8_cross_decode_apply(p: dict, cfg: LayerConfig, q, cache: dict) -> torch.Tensor:
    """One position of cross-attention over a write-once int8 cache; its
    ``len`` masks each row's memory (an empty row gives zeros)."""
    from .ops.int8_kv import int8_decode_attention

    q_m = linear(p["q"], q)
    return reduce_linear(p["o"], int8_decode_attention(q_m, cache["k"], cache["v"], cache["ks"], cache["vs"],
                                                       cache["len"], cfg.n_heads), cfg.tp_axis)


def _cross_cached_apply(p: dict, cfg: LayerConfig, q: torch.Tensor, cache: dict,
                        attn_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over a precomputed cross cache: one position without a
    bias -> the decode kernel with per-row ``ends = len``; otherwise (the
    prefill, or a bias) -> :func:`sdpa` with a finite -1e30 bias on slots
    ``>= len`` [+ ``attn_bias``]."""
    ck, cv, lens = cache["k"], cache["v"], cache["len"]
    s, l_max = q.shape[-2], ck.shape[-2]
    q_m = linear(p["q"], q)
    if s == 1 and attn_bias is None and _attn.use_decode_kernel(ck, cfg.n_heads, q_m, cv):
        from .ops.decode_attention import decode_attention

        return reduce_linear(p["o"], decode_attention(q_m, ck.to(q_m.dtype), cv.to(q_m.dtype), lens, cfg.n_heads),
                             cfg.tp_axis)
    qh = split_heads(q_m, cfg.n_heads, cfg.head_dim)
    kh = split_heads(ck.to(qh.dtype), cfg.n_heads, cfg.head_dim)
    vh = split_heads(cv.to(qh.dtype), cfg.n_heads, cfg.head_dim)
    col = torch.arange(l_max, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    len_bias = torch.where(col < lens.to(torch.int64)[:, None], zero, -1e30)[:, None, None, :]
    bias = len_bias if attn_bias is None else attn_bias + len_bias
    return reduce_linear(p["o"], merge_heads(sdpa(qh, kh, vh, bias)), cfg.tp_axis)


# ---------------------------------------------------------------------------
# MLP and layers
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, in_dim: int, hidden_dim: int) -> dict:
    return {"fc1": linear_init(gen, in_dim, hidden_dim), "fc2": linear_init(gen, hidden_dim, in_dim)}


def mlp_apply(p: dict, x: torch.Tensor, act: str = "gelu", tp_axis=None) -> torch.Tensor:
    """fc1 (a column shard under tensor parallelism), the activation, fc2 (a
    row shard, all-reduced over ``tp_axis``: :func:`reduce_linear`)."""
    return reduce_linear(p["fc2"], ACT_FNS[act](linear(p["fc1"], x)), tp_axis)


def layer_init(gen: torch.Generator, cfg: LayerConfig) -> dict:
    p = {
        "sa_norm": ln_init(cfg.d_model),
        "sa": mha_init(gen, cfg),
        "mlp_norm": ln_init(cfg.d_model),
        "mlp": mlp_init(gen, cfg.d_model, int(cfg.d_model * cfg.mlp_ratio)),
    }
    if cfg.cross_attn:
        p["ca_norm"] = ln_init(cfg.d_model)
        p["ca"] = mha_init(gen, cfg)
    return p


def encoder_layer_apply(p: dict, cfg: LayerConfig, x: torch.Tensor) -> torch.Tensor:
    """Bidirectional self-attention + MLP, pre- or post-norm."""
    eps = cfg.norm_eps
    if cfg.pre_norm:
        x = x + mha_apply(p["sa"], cfg, layer_norm(p["sa_norm"], x, eps))
        x = x + mlp_apply(p["mlp"], layer_norm(p["mlp_norm"], x, eps), cfg.act, cfg.tp_axis)
    else:
        x = layer_norm(p["sa_norm"], x + mha_apply(p["sa"], cfg, x), eps)
        x = layer_norm(p["mlp_norm"], x + mlp_apply(p["mlp"], x, cfg.act, cfg.tp_axis), eps)
    return x


def decoder_layer_apply(
    p: dict,
    cfg: LayerConfig,
    x: torch.Tensor,
    memory: torch.Tensor | None = None,
    self_cache: dict | None = None,
    cross_cache: dict | None = None,
    pos: int | None = None,
    pad_lens: torch.Tensor | None = None,
):
    """Causal self-attention [+ cross-attention over ``memory`` or a
    precomputed ``cross_cache``] + MLP, pre- or post-norm. Returns ``x``, or
    ``(x, cache)`` when a self-cache is given."""
    eps = cfg.norm_eps
    cached = self_cache is not None

    def sa(h):
        if cached:
            return mha_apply(p["sa"], cfg, h, cache=self_cache, cache_pos=pos, pad_lens=pad_lens)
        return mha_apply(p["sa"], cfg, h, causal=True), None

    def ca(h):
        if cross_cache is not None:
            return mha_apply(p["ca"], cfg, h, cache=cross_cache)
        return mha_apply(p["ca"], cfg, h, memory)

    if cfg.pre_norm:
        out, new_cache = sa(layer_norm(p["sa_norm"], x, eps))
        x = x + out
        if cfg.cross_attn:
            x = x + ca(layer_norm(p["ca_norm"], x, eps))
        x = x + mlp_apply(p["mlp"], layer_norm(p["mlp_norm"], x, eps), cfg.act, cfg.tp_axis)
    else:
        out, new_cache = sa(x)
        x = layer_norm(p["sa_norm"], x + out, eps)
        if cfg.cross_attn:
            x = layer_norm(p["ca_norm"], x + ca(x), eps)
        x = layer_norm(p["mlp_norm"], x + mlp_apply(p["mlp"], x, cfg.act, cfg.tp_axis), eps)
    return (x, new_cache) if cached else x


def encoder_init(gen: torch.Generator, n_layers: int, cfg: LayerConfig) -> dict:
    return {"layers": [layer_init(gen, cfg) for _ in range(n_layers)]}


def encoder_apply(p: dict, cfg: LayerConfig, x: torch.Tensor) -> torch.Tensor:
    for lp in p["layers"]:
        x = encoder_layer_apply(lp, cfg, x)
    return x


def decoder_init(gen: torch.Generator, n_layers: int, cfg: LayerConfig) -> dict:
    return {"layers": [layer_init(gen, cfg) for _ in range(n_layers)]}


def decoder_apply(
    p: dict,
    cfg: LayerConfig,
    x: torch.Tensor,
    memory: torch.Tensor | None = None,
    self_caches: list | None = None,
    cross_caches: list | None = None,
    pos: int | None = None,
    pad_lens: torch.Tensor | None = None,
):
    """Decoder stack over ``p["layers"]``, optionally KV-cached with a LIST of
    per-layer self caches (the JAX package's unrolled decode path) and a
    list of per-layer cross caches; returns ``(x, caches)`` when caching."""
    if self_caches is None:
        for lp in p["layers"]:
            x = decoder_layer_apply(lp, cfg, x, memory)
        return x
    crosses = [None] * len(self_caches) if cross_caches is None else cross_caches
    for lp, cache, cc in zip(p["layers"], self_caches, crosses, strict=True):
        x, _ = decoder_layer_apply(lp, cfg, x, memory, self_cache=cache, cross_cache=cc, pos=pos, pad_lens=pad_lens)
    return x, self_caches


def padded_cache_len(max_len: int) -> int:
    """KV-cache lengths are rounded up to a 128 multiple, as in the JAX
    package; slots beyond the true maximum are never attended."""
    return -(-max_len // 128) * 128


def make_kv_cache(n_layers: int, batch_shape: tuple, n_heads: int, max_len: int, head_dim: int,
                  dtype: torch.dtype = torch.float32, device=None):
    """Preallocate zeroed merged-head KV caches: ONE layer-stacked ``(L,
    *batch, Lp, H*D)`` buffer each for K and V. Returns ``(caches,
    stacked)``: the per-layer list of ``{"k": K[l], "v": V[l]}`` views that
    the per-op path reads and writes, and the ``{"k": K, "v": V}`` buffers
    the fused decode step reads."""
    shape = (n_layers, *batch_shape, padded_cache_len(max_len), n_heads * head_dim)
    stacked = {k: torch.zeros(shape, dtype=dtype, device=device) for k in ("k", "v")}
    return [{"k": stacked["k"][i], "v": stacked["v"][i]} for i in range(n_layers)], stacked


def precompute_cross_caches(p: dict, cfg: LayerConfig, memory: torch.Tensor, valid_lens=None):
    """Project encoder ``memory`` (B, L, d) into every decoder layer's
    cross-attention K/V once, straight into ONE layer-stacked ``(L, B, Lp,
    H*D)`` buffer each for K and V. ``valid_lens`` (B,) marks each row's
    count of valid memory positions (right-padded batches; default: L).
    Returns ``(caches, stacked)``: the per-layer list of
    :func:`mha_project_kv` caches, whose ``k``/``v`` are views of the
    buffers, and ``{"k", "v", "len"}`` with the buffers and the (B,) lengths
    every layer shares."""
    layers = p["layers"]
    shape = (len(layers), *memory.shape[:-2], padded_cache_len(memory.shape[-2]), cfg.n_heads * cfg.head_dim)
    dtype = linear_dtype(layers[0]["ca"]["k"])
    stacked = {k: torch.empty(shape, dtype=dtype, device=memory.device) for k in ("k", "v")}
    caches = [mha_project_kv(lp["ca"], cfg, memory, valid_lens, {"k": stacked["k"][i], "v": stacked["v"][i]})
              for i, lp in enumerate(layers)]
    stacked["len"] = caches[0]["len"]
    return caches, stacked
