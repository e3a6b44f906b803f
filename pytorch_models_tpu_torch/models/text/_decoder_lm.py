"""Shared decoder-only LM core for GPT-2 (PyTorch port of
``pytorch_models_tpu/models/text/_decoder_lm.py``).

Token + learned position embeddings -> causal decoder stack -> weight-tied
logits, plus the KV-cached batched forward the generator's decode loop runs.
The fused one-kernel decode step, packed weights and int8 helpers of the JAX
module are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import transformer as tfm
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


def decoder_lm_make_cache(cfg: DecoderLMConfig, batch_shape: tuple = (), dtype=torch.float32,
                          device=None) -> list[dict]:
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
