"""Shared decoder-only LM core for GPT-2 (PyTorch port of
``pytorch_models_tpu/models/text/_decoder_lm.py``).

Token + learned position embeddings -> causal decoder stack -> weight-tied
logits, plus the KV-cached batched forward the generator's decode loop runs,
per-op or as the fused one-kernel step (``ops/decode_step.py``) over
layer-stacked caches. The int8 helpers of the JAX module are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import transformer as tfm
from ...ops import attention as _attn
from ...ops import layer_norm
from ...ops.gather import embed_rows
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


def _head(params: dict, cfg: DecoderLMConfig, x: torch.Tensor) -> torch.Tensor:
    x = _final_hidden(params, cfg, x)
    return torch.matmul(x, params["token_embs"].to(x.dtype).t())


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
    x = embed_rows(params["token_embs"], tokens)
    x = x + embed_rows(params["pos_embs"], pos_ids).to(x.dtype)
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
    return fused_step_eligible(params["decoder"]["layers"], cfg.layer, batch)


def decoder_lm_pack(params: dict, cfg: DecoderLMConfig) -> tuple[dict, dict]:
    """Pack the layer stack and the tied greedy head for the fused step, once
    per generate call. Returns ``(packed, head)``; without a final norm the
    head's norm is unit scale and zero bias."""
    from ...ops.decode_step import pack_decode_weights, pack_greedy_head

    dtype = params["token_embs"].dtype
    packed = pack_decode_weights(params["decoder"]["layers"], dtype)
    fnorm = params["norm"] if cfg.final_norm else {"scale": torch.ones(cfg.d_model, device=params["token_embs"].device)}
    return packed, pack_greedy_head(params["token_embs"], fnorm, dtype)


def _fused_embed(params, tokens, pos_ids):
    """(B, 1) tokens and position ids -> (B, d) embeddings through K3 (the
    in-kernel embed phase of the JAX kernel is not ported)."""
    x = embed_rows(params["token_embs"], tokens[:, 0])
    return x + embed_rows(params["pos_embs"], pos_ids[:, 0]).to(x.dtype)


def decoder_lm_fused_tok_batch(params, packed, head, cfg: DecoderLMConfig, tokens, pos_ids, caches: dict, pos: int,
                               pad_lens):
    """Fused decode step WITH the greedy head: embeddings -> one kernel (layer
    stack + final norm + argmax) -> next token ids ``(B,)``. ``caches`` is the
    layer-stacked ``{"k", "v"}: (L, B, Lp, H*D)``; this step's K/V are
    written at ``pos`` in place."""
    from ...ops.decode_step import fused_decode_step

    lc = cfg.layer
    _, tok = fused_decode_step(_fused_embed(params, tokens, pos_ids), packed, caches["k"], caches["v"], pos, pad_lens,
                               lc.n_heads, lc.act, cfg.norm_eps, head=head)
    return tok


def decoder_lm_hidden_fused_batch(params, packed, cfg: DecoderLMConfig, tokens, pos_ids, caches: dict, pos: int,
                                  pad_lens):
    """One fused decode step without the head: the final (normed) hidden
    state ``(B, 1, d)``; caches as in :func:`decoder_lm_fused_tok_batch`."""
    from ...ops.decode_step import fused_decode_step

    lc = cfg.layer
    x, _ = fused_decode_step(_fused_embed(params, tokens, pos_ids), packed, caches["k"], caches["v"], pos, pad_lens,
                             lc.n_heads, lc.act, cfg.norm_eps)
    return _final_hidden(params, cfg, x)[:, None, :]
