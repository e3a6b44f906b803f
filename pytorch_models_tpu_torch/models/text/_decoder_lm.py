"""Shared decoder-only LM core for GPT-2 (PyTorch port of
``pytorch_models_tpu/models/text/_decoder_lm.py``).

Token + learned position embeddings -> causal decoder stack -> weight-tied
logits, plus the KV-cached batched forward the generator's decode loop runs,
per-op or as the fused one-kernel step (``ops/decode_step.py``) over
layer-stacked caches, and the int8 serving helpers the generators share
(the w8a8 head pack, int8 caches, cross operands, the embed fold).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import transformer as tfm
from ...ops import attention as _attn
from ...ops import layer_norm
from ...ops.gather import embed_tokens
from ...utils import tree_map


@dataclass(frozen=True)
class DecoderLMConfig:
    vocab_size: int
    max_seq_len: int
    n_layers: int
    d_model: int
    pre_norm: bool
    final_norm: bool
    act: str = "approximate_gelu"
    norm_eps: float = 1e-5

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, n_heads=self.d_model // 64, act=self.act,
                                    pre_norm=self.pre_norm, norm_eps=self.norm_eps)


def decoder_lm_init(gen: torch.Generator, cfg: DecoderLMConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (the JAX init's
    distributions: N(0, 1) token embeddings, zero position embeddings,
    torch-default uniform linears), then moved to ``device``."""
    p = {
        "token_embs": torch.randn(cfg.vocab_size, cfg.d_model, generator=gen),
        "pos_embs": torch.zeros(cfg.max_seq_len, cfg.d_model),
        "decoder": tfm.decoder_init(gen, cfg.n_layers, cfg.layer),
    }
    if cfg.final_norm:
        p["norm"] = tfm.ln_init(cfg.d_model)
    return tree_map(lambda t: t.to(device), p)


def _final_hidden(params: dict, cfg: DecoderLMConfig, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(params["norm"], x, cfg.norm_eps) if cfg.final_norm else x


def tied_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The weight-tied head over final hidden states ``x`` (..., d)."""
    return torch.matmul(x, params["token_embs"].to(x.dtype).t())


def _head(params: dict, cfg: DecoderLMConfig, x: torch.Tensor) -> torch.Tensor:
    return tied_logits(params, _final_hidden(params, cfg, x))


def decoder_lm_apply(params: dict, cfg: DecoderLMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full forward over ``(..., L)`` int tokens (batched or unbatched)."""
    x = params["token_embs"][tokens]
    x = x + params["pos_embs"][: tokens.shape[-1]].to(x.dtype)
    x = tfm.decoder_apply(params["decoder"], cfg.layer, x)
    return _head(params, cfg, x)


def decoder_lm_make_cache(cfg: DecoderLMConfig, batch_shape: tuple = (), dtype=torch.float32, device=None):
    """``(caches, stacked)``: the per-layer caches and the layer-stacked
    buffers they view (:func:`transformer.make_kv_cache`)."""
    lc = cfg.layer
    return tfm.make_kv_cache(cfg.n_layers, batch_shape, lc.n_heads, cfg.max_seq_len, lc.head_dim, dtype, device)


def _cached_stack(params, cfg: DecoderLMConfig, tokens, pos_ids, caches, pos: int, pad_lens):
    x = embed_tokens(params["token_embs"], tokens, params["pos_embs"], pos_ids)
    return tfm.decoder_apply(params["decoder"], cfg.layer, x, self_caches=caches, pos=pos, pad_lens=pad_lens)


def decoder_lm_hidden_cached_batch(params, cfg: DecoderLMConfig, tokens, pos_ids, caches, pos: int, pad_lens):
    """Batched cached forward up to the final (normed) hidden state — the
    greedy head kernel takes it from there without the (B, V) logits.

    ``tokens``: (B, S) placed at cache slots ``[pos, pos+S)``; ``pos_ids``:
    (B, S) per-row position-embedding indices; ``pad_lens``: (B,) left-pad
    length per row. Returns ``(hidden (B, S, d), caches)``.
    """
    x, caches = _cached_stack(params, cfg, tokens, pos_ids, caches, pos, pad_lens)
    return _final_hidden(params, cfg, x), caches


def decoder_lm_forward_cached_batch(params, cfg: DecoderLMConfig, tokens, pos_ids, caches, pos: int, pad_lens):
    """Batched cached forward with the tied head: ``(logits (B, S, V), caches)``."""
    x, caches = _cached_stack(params, cfg, tokens, pos_ids, caches, pos, pad_lens)
    return _head(params, cfg, x), caches


def decoder_lm_fused_ok(params: dict, cfg: DecoderLMConfig, batch: int) -> bool:
    """Gate for the one-kernel fused decode step (ops/decode_step.py): the
    flag (auto: the params lie on a CUDA device) and what the kernel serves."""
    from ...ops.decode_step import fused_step_eligible

    if not _attn.use_fused_step(params["token_embs"]) or not cfg.pre_norm:
        return False
    return fused_step_eligible(params["decoder"]["layers"], cfg.layer, batch, dtype=params["token_embs"].dtype)


def decoder_lm_pack(params: dict, cfg: DecoderLMConfig) -> tuple[dict, dict]:
    """Pack the layer stack and the tied greedy head for the fused step, once
    per generate call (the head per vocab row in int8 when the step runs
    w8a8, ``ops.attention.USE_A8_DECODE``). Returns ``(packed, head)``;
    without a final norm the head's norm is unit scale and zero bias."""
    from ...ops.decode_step import pack_decode_weights, pack_greedy_head

    dtype = params["token_embs"].dtype
    packed = pack_decode_weights(params["decoder"]["layers"], dtype)
    fnorm = params["norm"] if cfg.final_norm else {"scale": torch.ones(cfg.d_model, device=params["token_embs"].device)}
    return packed, pack_greedy_head(params["token_embs"], fnorm, dtype, a8=_attn.use_a8_decode(packed["wqkv"].dtype))


def kv_scales(caches: dict) -> dict | None:
    """The int8 scale planes of layer-stacked caches, or None."""
    return {"ks": caches["ks"], "vs": caches["vs"]} if "ks" in caches else None


def cross_operands(cross: dict, cdt: torch.dtype):
    """``(ck, cv, kv_scales_x)`` for a fused cross-attention step: int8
    caches (:func:`quantize_kv_caches`) pass through with their scale
    planes; full-precision ones in the compute dtype (an int8-weight model's
    bf16 projections into an fp32 step are cast once, by the caller, per
    generate call)."""
    if "ks" in cross:
        return cross["k"], cross["v"], kv_scales(cross)
    return cross["k"].to(cdt), cross["v"].to(cdt), None


def embed_or_fold(token_embs: torch.Tensor, pos_embs: torch.Tensor | None, tokens: torch.Tensor, pos_ids) -> tuple:
    """Embeddings for a fused decode step: ``(x (B, d), {})`` in one launch
    of the embedding kernel (K3's ``embed_add``), or, with ``ops.attention.USE_FUSED_EMBED``, ``(None,
    kwargs)`` for the step's embed phase (``emb``, ``tok_ids`` (B,) and,
    with a position table, ``pos_rows``). ``tokens``: (B, 1); ``pos_ids``:
    (B, 1) ids into ``pos_embs``, or None without a position table."""
    from ...ops.decode_step import pack_embed_tables

    if _attn.use_fused_embed(tokens.shape[0]):
        kw = {"emb": pack_embed_tables(token_embs, pos_embs, token_embs.dtype), "tok_ids": tokens[:, 0]}
        if pos_embs is not None:
            kw["pos_rows"] = pos_ids[:, 0]
        return None, kw
    return embed_tokens(token_embs, tokens[:, 0], pos_embs, None if pos_embs is None else pos_ids[:, 0]), {}


def _fused_call(params, packed, cfg: DecoderLMConfig, tokens, pos_ids, caches: dict, pos: int, pad_lens, head):
    from ...ops.decode_step import fused_decode_step

    lc = cfg.layer
    x, emb_kw = embed_or_fold(params["token_embs"], params["pos_embs"], tokens, pos_ids)
    return fused_decode_step(x, packed, caches["k"], caches["v"], pos, pad_lens, lc.n_heads, lc.act, cfg.norm_eps,
                             head=head, a8=_attn.use_a8_decode(packed["wqkv"].dtype), kv_scales=kv_scales(caches),
                             **emb_kw)


def decoder_lm_fused_tok_batch(params, packed, head, cfg: DecoderLMConfig, tokens, pos_ids, caches: dict, pos: int,
                               pad_lens):
    """Fused decode step WITH the greedy head: embeddings -> one kernel (layer
    stack + final norm + argmax) -> next token ids ``(B,)``. ``caches`` is the
    layer-stacked ``{"k", "v"}: (L, B, Lp, H*D)`` (int8 with ``{"ks",
    "vs"}``); this step's K/V are written at ``pos`` in place."""
    return _fused_call(params, packed, cfg, tokens, pos_ids, caches, pos, pad_lens, head)[1]


def decoder_lm_hidden_fused_batch(params, packed, cfg: DecoderLMConfig, tokens, pos_ids, caches: dict, pos: int,
                                  pad_lens):
    """One fused decode step without the head: the final (normed) hidden
    state ``(B, 1, d)``; caches as in :func:`decoder_lm_fused_tok_batch`."""
    x, _ = _fused_call(params, packed, cfg, tokens, pos_ids, caches, pos, pad_lens, None)
    return _final_hidden(params, cfg, x)[:, None, :]
