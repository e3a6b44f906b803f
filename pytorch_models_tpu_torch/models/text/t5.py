"""T5 v1.1 / Flan-T5 (PyTorch port of ``pytorch_models_tpu/models/text/t5.py``).

T5 has its own block stack, distinct from the shared core:
- RMSNorm without mean subtraction, computed in fp32;
- a GEGLU gated MLP with tanh GELU;
- a log-bucketed relative position bias (32 buckets, max distance 128),
  shared across the layers of a stack;
- bias-free projections, with q/k kernels pre-scaled by ``64**0.25`` at load
  so that the standard 1/sqrt(d) attention matches T5X's unscaled attention.

``T5Generator`` decodes greedily with KV caches in ONE loop for every route:
each step is ONE fused kernel (``ops/decode_step.py``: RMSNorm, rel-pos self
bias, cross-attention, GEGLU, final RMSNorm and the untied greedy head) when
``USE_FUSED_STEP`` (auto: CUDA tensors) and the kernel's shape rules allow,
otherwise the per-op step (the decode kernel with the key-major bias, the
untied greedy head kernel). A single prompt runs as a batch of one.
int8 serving on the fused route, as in the JAX package:
``model.quantize_int8()`` (w8a16; ``USE_A8_DECODE`` for w8a8 and the a8
head over the dequantized classifier), ``USE_INT8_KV`` (the empty self
cache starts int8; at most 128 (row, head) pairs per group of 8 rows, the
JAX package's routing rule) and ``USE_INT8_KV_CROSS``. An int8 classifier
takes the head matmul + argmax on the per-op route. Teacher-forced scoring
runs the uncached encoder-decoder. Beam search (``generate_beam_tokens``)
decodes its W beams through the fused step headless, or per-op. Continuous
batching is ``models/text/t5_continuous.py``. ``SpeculativeT5Generator``
decodes greedily with a draft T5 (models/text/speculative.py's core): the
target verifies k drafts in one per-op chunk, and a one-row call's draft
steps are K7-T5 launches at B=1. Not ported yet: the t5x checkpoint reader
(``from_t5x(pretrained=True)``) and the sentencepiece tokenizer: the string
methods need a tokenizer the caller passes in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ... import transformer as tfm
from ...ops import ACT_FNS, linear, linear_init
from ...ops import attention as _attn
from ...ops.gather import embed_rows
from ...ops.greedy_head import greedy_argmax
from ...utils import StateDict, tree_map
from ...utils.module import InferenceModel, resolve_device
from .generator import DONE_CHECK_EVERY

_F32_EPS = float(np.finfo(np.float32).eps)
NEG_INF = -1e10  # the mask value of the T5 reference

SIZES = dict(
    small=(512, 6, 8, 1024),
    base=(768, 12, 12, 2048),
    large=(1024, 16, 24, 2816),
    xl=(2048, 32, 24, 5120),
    xxl=(4096, 64, 24, 10240),
)


@dataclass(frozen=True)
class T5Config:
    vocab_size: int
    dim: int
    n_heads: int
    n_layers: int
    mlp_dim: int
    n_buckets: int = 32
    max_distance: int = 128
    norm_eps: float = 1e-5
    # tensor-parallel serving (parallel/serving.py): each rank holds local_heads = n_heads / tp heads (and its rows
    # of the rel-pos tables) and all-reduces over the tp process group tp_axis after the o / wo projections
    local_heads: int | None = None
    tp_axis: object = None

    @property
    def layer(self) -> tfm.LayerConfig:
        heads = self.n_heads if self.local_heads is None else self.local_heads
        return tfm.LayerConfig(self.dim, heads, 64, bias=False, tp_axis=self.tp_axis)


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """T5 LayerNorm: no mean subtraction, fp32 statistics; the normed value
    is rounded to x's dtype, then scaled in that dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * p["scale"].to(x.dtype)


def relative_position_buckets(rel_pos: torch.Tensor, bidirectional: bool, n_buckets: int, max_distance: int):
    """Log-bucketed relative positions, ``rel_pos`` = key - query (integer
    tensor). The log is taken in fp32 with float32's machine epsilon and
    truncated toward zero, so the buckets equal the JAX package's."""
    if bidirectional:
        nb = n_buckets // 2
        offset = torch.where(rel_pos > 0, nb, 0)
        pos = rel_pos.abs()
    else:
        nb = n_buckets
        offset = torch.zeros_like(rel_pos)
        pos = (-rel_pos).clamp_min(0)
    max_exact = nb // 2
    scale = (nb - max_exact) / math.log(max_distance / max_exact)
    val_large = max_exact + (torch.log(pos.float() / max_exact + _F32_EPS) * scale).to(torch.int32)
    val_large = val_large.clamp_max(nb - 1)
    return torch.where(pos < max_exact, pos, val_large) + offset


def relative_position_bias(bias: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor, bidirectional: bool,
                           cfg: T5Config) -> torch.Tensor:
    """Bias lookup -> (H, Lq, Lk). ``bias``: the (H, n_buckets) table."""
    rel = k_pos[None, :] - q_pos[:, None]
    return bias[:, relative_position_buckets(rel, bidirectional, cfg.n_buckets, cfg.max_distance)]


# ---------------------------------------------------------------------------
# Blocks and stacks
# ---------------------------------------------------------------------------


def _t5_mlp_init(gen: torch.Generator, dim: int, mlp_dim: int) -> dict:
    return {
        "w": linear_init(gen, dim, mlp_dim, bias=False),
        "v": linear_init(gen, dim, mlp_dim, bias=False),
        "wo": linear_init(gen, mlp_dim, dim, bias=False),
    }


def _t5_mlp_apply(p: dict, x: torch.Tensor, tp_axis=None) -> torch.Tensor:
    """GEGLU: ``w`` and ``v`` column shards, ``wo`` a row shard all-reduced
    over ``tp_axis`` under tensor parallelism."""
    return tfm.reduce_linear(p["wo"], ACT_FNS["approximate_gelu"](linear(p["w"], x)) * linear(p["v"], x), tp_axis)


def t5_block_init(gen: torch.Generator, cfg: T5Config, cross_attn: bool) -> dict:
    p = {
        "sa_norm": {"scale": torch.ones(cfg.dim)},
        "sa": tfm.mha_init(gen, cfg.layer),
        "mlp_norm": {"scale": torch.ones(cfg.dim)},
        "mlp": _t5_mlp_init(gen, cfg.dim, cfg.mlp_dim),
    }
    if cross_attn:
        p["ca_norm"] = {"scale": torch.ones(cfg.dim)}
        p["ca"] = tfm.mha_init(gen, cfg.layer)
    return p


def t5_block_apply(
    p: dict,
    cfg: T5Config,
    x: torch.Tensor,
    memory: torch.Tensor | None = None,
    attn_bias: torch.Tensor | None = None,
    ca_bias: torch.Tensor | None = None,
    self_cache: dict | None = None,
    cross_cache: dict | None = None,
    pos: int | None = None,
    pad_lens: torch.Tensor | None = None,
):
    """Self-attention [+ cross-attention over ``memory`` or a precomputed
    ``cross_cache``] + GEGLU MLP, each pre-RMSNorm. Returns ``x``, or ``(x,
    cache)`` with a self cache (written in place at ``pos``)."""
    lc = cfg.layer
    if self_cache is not None:
        out, new_cache = tfm.mha_apply(p["sa"], lc, rms_norm(p["sa_norm"], x), attn_bias=attn_bias,
                                       cache=self_cache, cache_pos=pos, pad_lens=pad_lens)
        x = x + out
    else:
        new_cache = None
        x = x + tfm.mha_apply(p["sa"], lc, rms_norm(p["sa_norm"], x), attn_bias=attn_bias)
    if "ca" in p:
        h = rms_norm(p["ca_norm"], x)
        if cross_cache is not None:
            x = x + tfm.mha_apply(p["ca"], lc, h, attn_bias=ca_bias, cache=cross_cache)
        else:
            x = x + tfm.mha_apply(p["ca"], lc, h, memory, attn_bias=ca_bias)
    x = x + _t5_mlp_apply(p["mlp"], rms_norm(p["mlp_norm"], x), lc.tp_axis)
    return (x, new_cache) if self_cache is not None else x


def t5_stack_init(gen: torch.Generator, cfg: T5Config, cross_attn: bool) -> dict:
    """A stack's layers, its final norm and its rel-pos table (zeros at init,
    as in the JAX package)."""
    return {
        "attn_bias": torch.zeros(cfg.n_heads, cfg.n_buckets),
        "layers": [t5_block_init(gen, cfg, cross_attn) for _ in range(cfg.n_layers)],
        "norm": {"scale": torch.ones(cfg.dim)},
    }


def t5_encoder_apply(p: dict, cfg: T5Config, x: torch.Tensor, pad_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional stack with the rel-pos bias [+ ``pad_bias``, e.g.
    (B, 1, 1, L) with NEG_INF on padded keys] + final RMSNorm."""
    positions = torch.arange(x.shape[-2], device=x.device)
    bias = relative_position_bias(p["attn_bias"], positions, positions, True, cfg)
    if pad_bias is not None:
        bias = bias + pad_bias
    for lp in p["layers"]:
        x = t5_block_apply(lp, cfg, x, attn_bias=bias)
    return rms_norm(p["norm"], x)


def t5_decoder_apply(p: dict, cfg: T5Config, x: torch.Tensor, memory: torch.Tensor,
                     ca_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced causal stack (rel-pos bias + NEG_INF above the
    diagonal) with cross-attention over ``memory`` [+ ``ca_bias``] + final
    RMSNorm."""
    length = x.shape[-2]
    positions = torch.arange(length, device=x.device)
    bias = relative_position_bias(p["attn_bias"], positions, positions, False, cfg)
    bias = bias + torch.full((length, length), NEG_INF, device=x.device).triu(1)
    for lp in p["layers"]:
        x = t5_block_apply(lp, cfg, x, memory=memory, attn_bias=bias, ca_bias=ca_bias)
    return rms_norm(p["norm"], x)


def t5_init(gen: torch.Generator, cfg: T5Config, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` with the JAX init's
    distributions (N(0, 1) token embeddings, torch-default uniform linears,
    unit norms, zero rel-pos tables), then moved to ``device``."""
    p = {
        "token_embs": torch.randn(cfg.vocab_size, cfg.dim, generator=gen),
        "encoder": t5_stack_init(gen, cfg, False),
        "decoder": t5_stack_init(gen, cfg, True),
        "classifier": linear_init(gen, cfg.dim, cfg.vocab_size, bias=False),
    }
    return tree_map(lambda t: t.to(device), p)


def t5_encode(params: dict, cfg: T5Config, tokens: torch.Tensor, pad_bias: torch.Tensor | None = None):
    return t5_encoder_apply(params["encoder"], cfg, params["token_embs"][tokens], pad_bias)


def t5_decode(params: dict, cfg: T5Config, tokens: torch.Tensor, memory: torch.Tensor,
              ca_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced decode -> logits through the untied classifier."""
    x = t5_decoder_apply(params["decoder"], cfg, params["token_embs"][tokens], memory, ca_bias=ca_bias)
    return linear(params["classifier"], x)


def _pad_bias(n_enc: torch.Tensor, p_len: int) -> torch.Tensor:
    """(B,) prompt lengths -> (B, 1, 1, P) fp32: 0 on valid keys, NEG_INF on padding."""
    valid = torch.arange(p_len, device=n_enc.device)[None, :] < n_enc[:, None]
    return torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]


# ---------------------------------------------------------------------------
# KV-cached greedy generation
# ---------------------------------------------------------------------------


def _t5_fused_ok(params: dict, cfg: T5Config, batch: int) -> bool:
    """Gate for the one-kernel fused decode step (ops/decode_step.py)."""
    from ...ops.decode_step import fused_step_eligible

    if not _attn.use_fused_step(params["token_embs"]):
        return False
    return fused_step_eligible(params["decoder"]["layers"], cfg.layer, batch, cross=True, gated=True,
                               dtype=params["token_embs"].dtype)


def _t5_key_major_bias(bias_table: torch.Tensor) -> torch.Tensor:
    """(H, P, L) rel-pos decode bias -> key-major (P, L, H) fp32: row ``pos``
    is the fused step's ``sbias``. Not lane-padded (the JAX package pads it
    to 128 lanes for Mosaic), and never group-tiled: the JAX package tiles
    it ``g`` times for its grouped int8 kernel (a TPU lane layout); the
    port's int8 units read ``(L, H)`` as it is."""
    return bias_table.permute(1, 2, 0).float().contiguous()


def _fused_t5_step(params: dict, packed: dict, head: dict | None, cfg: T5Config, tok: torch.Tensor, caches: dict,
                   cross: tuple, lens: torch.Tensor, bias_km: torch.Tensor, pos: int,
                   pad_lens: torch.Tensor | None = None) -> torch.Tensor:
    """One fused decode step: embeddings (K3, or the embed phase) -> ONE
    kernel (RMSNorm + rel-pos self bias + cross-attention + GEGLU, every
    layer [+ final RMSNorm + untied greedy argmax]) over the stacked caches
    (int8 with ``ks``/``vs``); ``tok`` (B,); ``cross`` is
    ``_decoder_lm.cross_operands``' ``(ck, cv, kv_scales_x)``; the self
    bias is row ``pos`` of the key-major table ``bias_km``; this step's K/V
    are written at ``pos``; ``pad_lens`` (B,) masks each row's left-pad
    slots (a left-padded pool). Returns the next token ids (B,) with
    ``head``, else (headless) the final-normed hidden state (B, d)."""
    from ...ops.decode_step import fused_cross_decode_step
    from ._decoder_lm import embed_or_fold, kv_scales

    lc = cfg.layer
    x, emb_kw = embed_or_fold(params["token_embs"], None, tok[:, None], None)  # T5's decoder has no position table
    ck, cv, kvx = cross
    x, nxt = fused_cross_decode_step(x, packed, caches["k"], caches["v"], ck, cv, lens, pos, pad_lens, lc.n_heads,
                                     "approximate_gelu", 1e-5, head=head, norm="rms", gated=True, sbias=bias_km[pos],
                                     a8=_attn.use_a8_decode(packed["wqkv"].dtype), kv_scales=kv_scales(caches),
                                     kv_scales_x=kvx, **emb_kw)
    return nxt if head is not None else rms_norm(params["decoder"]["norm"], x)


def _t5_decode_layers(dec: dict, cfg: T5Config, h: torch.Tensor, caches: list, cross_caches: list,
                      bias: torch.Tensor, pos: int, pad_lens: torch.Tensor | None = None) -> torch.Tensor:
    """One per-op decode step through every layer with per-layer caches (the
    cross caches' ``len`` masks each row's prompt padding; ``pad_lens``
    (B,) each row's left-pad slots)."""
    for lp, cache, cc in zip(dec["layers"], caches, cross_caches, strict=True):
        h, _ = t5_block_apply(lp, cfg, h, attn_bias=bias, self_cache=cache, cross_cache=cc, pos=pos, pad_lens=pad_lens)
    return h


@torch.inference_mode()
def _t5_generate_batch(params: dict, cfg: T5Config, enc_tokens: torch.Tensor, n_enc: torch.Tensor, max_tokens: int,
                       pad_id: int, eos_id: int):
    """Batched greedy generation over (B, P) right-padded prompts with (B,)
    lengths ``n_enc``. Decoder rows all start from the pad token at position
    0, so only the encoder and cross masks are per row; finished rows park on
    EOS. Returns ``(tokens (B, max_tokens), lengths (B,))`` on the host; row
    i is ``tokens[i, :lengths[i]]``, pad first."""
    b, p_len = enc_tokens.shape
    dev = enc_tokens.device
    memory = t5_encode(params, cfg, enc_tokens, _pad_bias(n_enc, p_len))

    dec = params["decoder"]
    lc = cfg.layer
    dtype = params["token_embs"].dtype
    # stacked buffers: the per-op step reads and writes per-layer views of them, the fused step the buffers
    self_caches, stacked = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, max_tokens, lc.head_dim, dtype, dev)
    cross, cross_stacked = tfm.precompute_cross_caches(dec, lc, memory, valid_lens=n_enc)
    # the (H, P, Lp) decode bias table once per call, not per step
    l_pad = tfm.padded_cache_len(max_tokens)
    bias_table = relative_position_bias(dec["attn_bias"], torch.arange(max_tokens, device=dev),
                                        torch.arange(l_pad, device=dev), False, cfg)
    fused = _t5_fused_ok(params, cfg, b)
    if fused:
        from ...ops.decode_step import pack_decode_weights, pack_greedy_head
        from ...ops.int8_kv import quantize_kv_caches
        from ._decoder_lm import cross_operands

        packed = pack_decode_weights(dec["layers"], dtype, cross=True, gated=True)
        head = pack_greedy_head(params["classifier"]["w"], dec["norm"], dtype, tied=False,
                                a8=_attn.use_a8_decode(packed["wqkv"].dtype))
        bias_km = _t5_key_major_bias(bias_table)
        # int8 self-KV: the cache starts empty (decoding starts at the pad token), so the quantized zeros are
        # its int8 state; the JAX package's rule of at most 128 (row, head) pairs per group of 8 rows decides
        if _attn.use_int8_kv(b) and min(b, 8) * lc.n_heads <= 128:
            stacked = quantize_kv_caches(stacked)
        # int8 cross-KV: T5 has no cross prefill, so the quantized caches are the only ones the loop reads
        cross_ops = cross_operands(quantize_kv_caches(cross_stacked) if _attn.use_int8_kv_cross(b) else cross_stacked,
                                   dtype)
    w_cls = params["classifier"]["w"]
    greedy_head = not isinstance(w_cls, dict) and _attn.use_greedy_head(b, w_cls, tied=False)

    buf = torch.zeros((b, max_tokens), dtype=torch.int64, device=dev)
    buf[:, 0] = pad_id
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    eos = torch.full((b,), eos_id, dtype=torch.int64, device=dev)
    pos = 0
    while pos < max_tokens - 1:
        # rows done early keep stepping (parked on EOS) until the next check:
        # the output is the same, and the host reads the flag less often
        if pos % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        tok = buf[:, pos]
        if fused:
            nxt = _fused_t5_step(params, packed, head, cfg, tok, stacked, cross_ops, cross_stacked["len"], bias_km, pos)
        else:
            h = embed_rows(params["token_embs"], tok[:, None])
            h = _t5_decode_layers(dec, cfg, h, self_caches, cross, bias_table[:, pos:pos + 1], pos)
            h = rms_norm(dec["norm"], h)[:, 0]
            if greedy_head:
                nxt = greedy_argmax(h, params["classifier"]["w"].to(h.dtype))
            else:
                nxt = torch.argmax(linear(params["classifier"], h), dim=-1)
        nxt = torch.where(done, eos, nxt)
        buf[:, pos + 1] = nxt
        done = done | (nxt == eos_id)
        pos += 1

    # per-row length: pad + generated up to the first EOS, else pad + every step
    out = buf.cpu().numpy()
    is_eos = out[:, 1:pos + 1] == eos_id
    lengths = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1) + 2, pos + 1)
    return out, lengths


def _t5_spec_decode_state(params: dict, cfg: T5Config, enc_tokens: torch.Tensor, n_enc: torch.Tensor, cache_len: int):
    """Encode (B, P) right-padded prompts of lengths ``n_enc`` (B,) and build
    one model's decode-side state for speculative decoding: the self caches
    (per-layer views of the stacked buffers), the cross caches and the
    (H, cache_len, Lp) decoder rel-pos bias table."""
    memory = t5_encode(params, cfg, enc_tokens, _pad_bias(n_enc, enc_tokens.shape[1]))
    dec = params["decoder"]
    lc = cfg.layer
    dev = enc_tokens.device
    caches, stacked = tfm.make_kv_cache(cfg.n_layers, (enc_tokens.shape[0],), lc.n_heads, cache_len, lc.head_dim,
                                        params["token_embs"].dtype, dev)
    cross, cross_stacked = tfm.precompute_cross_caches(dec, lc, memory, valid_lens=n_enc)
    bias = relative_position_bias(dec["attn_bias"], torch.arange(cache_len, device=dev),
                                  torch.arange(tfm.padded_cache_len(cache_len), device=dev), False, cfg)
    return SimpleNamespace(caches=caches, stacked=stacked, cross=cross, cross_stacked=cross_stacked, bias=bias)


def _t5_spec_chunk_forward(params: dict, cfg: T5Config, st, chunk: torch.Tensor, pos) -> torch.Tensor:
    """Per-op cached decoder forward of a (B, S) chunk at positions ``[pos,
    pos+S)`` (the verify chunk; S = 1 is a per-op draft step) over the state
    ``st`` of :func:`_t5_spec_decode_state`; ``pos`` an int, or (B,) per-row
    slots, whose rows take their own bias rows. Returns logits (B, S, V)."""
    s = chunk.shape[1]
    if isinstance(pos, torch.Tensor):
        bias = st.bias[:, pos.long()[:, None] + torch.arange(s, device=chunk.device)].transpose(0, 1)  # (B, H, S, Lp)
    else:
        bias = st.bias[:, pos:pos + s]
    dec = params["decoder"]
    h = _t5_decode_layers(dec, cfg, embed_rows(params["token_embs"], chunk), st.caches, st.cross, bias, pos)
    return linear(params["classifier"], rms_norm(dec["norm"], h))


@torch.inference_mode()
def _t5_spec_generate(params: dict, cfg: T5Config, draft_params: dict, draft_cfg: T5Config, enc_tokens: torch.Tensor,
                      n_enc: torch.Tensor, max_tokens: int, pad_id: int, eos_id: int, k: int, one_row: bool):
    """Greedy speculative seq2seq generation (models/text/speculative.py's
    core; token-identical to :func:`_t5_generate_batch` for any draft): a
    draft T5 proposes k tokens, the target verifies them in one per-op
    (k+1)-position decoder chunk. Both models encode the prompts with their
    own encoders; the buffers run to ``max_tokens + k`` so that the edge stop
    never cuts below the plain loop's cap. ``one_row`` (B = 1): host
    positions, each draft step ONE K7-T5 launch where its gate allows (the
    JAX package's drafts run per-op: the tokens are the same); else per-row
    positions, every step per-op. Returns ``(tokens (B, max_tokens + k),
    lengths, iterations)`` on the host; rows as the greedy generator's."""
    from .speculative import spec_greedy_decode_loop

    b, dev = enc_tokens.shape[0], enc_tokens.device
    l_buf = max_tokens + k
    t = _t5_spec_decode_state(params, cfg, enc_tokens, n_enc, l_buf)
    d = _t5_spec_decode_state(draft_params, draft_cfg, enc_tokens, n_enc, l_buf)
    fused = one_row and _t5_fused_ok(draft_params, draft_cfg, 1)
    if fused:
        from ...ops.decode_step import pack_decode_weights, pack_greedy_head
        from ._decoder_lm import cross_operands

        dtype = draft_params["token_embs"].dtype
        d_dec = draft_params["decoder"]
        packed = pack_decode_weights(d_dec["layers"], dtype, cross=True, gated=True)
        head = pack_greedy_head(draft_params["classifier"]["w"], d_dec["norm"], dtype, tied=False,
                                a8=_attn.use_a8_decode(packed["wqkv"].dtype))
        bias_km = _t5_key_major_bias(d.bias)
        cross_ops = cross_operands(d.cross_stacked, dtype)

    def verify_chunk(chunk, state, pos):
        return torch.argmax(_t5_spec_chunk_forward(params, cfg, t, chunk, pos), dim=-1), state

    def draft_step(tok, state, pos):
        if fused:
            return _fused_t5_step(draft_params, packed, head, draft_cfg, tok[:, 0], d.stacked, cross_ops,
                                  d.cross_stacked["len"], bias_km, pos), state
        return torch.argmax(_t5_spec_chunk_forward(draft_params, draft_cfg, d, tok, pos)[:, 0], dim=-1), state

    # decoder position 0 is the pad start token: the target's step there gives token 1, the draft's fills its cache
    buf = torch.zeros((b, l_buf), dtype=torch.int64, device=dev)
    buf[:, 0] = pad_id
    first, _ = verify_chunk(buf[:, :1], None, 0)
    draft_step(buf[:, :1], None, 0)
    buf[:, 1] = first[:, 0]
    pos0, limit = (2, max_tokens) if one_row else (torch.full((b,), 2, device=dev), torch.full((b,), max_tokens,
                                                                                                device=dev))
    return spec_greedy_decode_loop(draft_step, verify_chunk, None, None, buf, pos0, first[:, 0] == eos_id, limit, k,
                                   eos_id, l_buf)


@torch.inference_mode()
def _t5_beam(params: dict, cfg: T5Config, enc_tokens: torch.Tensor, n_enc: torch.Tensor, max_tokens: int, pad_id: int,
             eos_id: int, w: int, alpha: float):
    """Beam-search seq2seq generation for ONE prompt (``enc_tokens`` (1, P)
    right-padded, ``n_enc`` (1,) its length). The W beams ride the batched
    decode path (the fused step headless where it serves W rows: RMSNorm,
    GEGLU, the rel-pos self bias at ``pos - 1``; else per-op) through the
    model-agnostic loop of models/text/beam.py; the encoder memory is
    projected into cross K/V once and copied to the W rows. Returns ``(seqs
    (W, max_tokens), scores (W,), lengths (W,))`` on the device, best-first;
    rows as the greedy buffers (pad token at index 0, EOS counted)."""
    from .beam import beam_caches, beam_cross_caches, beam_decode_loop, reorder_caches

    memory = t5_encode(params, cfg, enc_tokens, _pad_bias(n_enc, enc_tokens.shape[1]))
    dec = params["decoder"]
    lc = cfg.layer
    dtype = params["token_embs"].dtype
    dev = enc_tokens.device
    _, stacked = tfm.make_kv_cache(cfg.n_layers, (w,), lc.n_heads, max_tokens, lc.head_dim, dtype, dev)
    caches = beam_caches(stacked)
    cross, cross_stacked = beam_cross_caches(tfm.precompute_cross_caches(dec, lc, memory, valid_lens=n_enc)[1], w)
    l_pad = tfm.padded_cache_len(max_tokens)
    bias_table = relative_position_bias(dec["attn_bias"], torch.arange(max_tokens, device=dev),
                                        torch.arange(l_pad, device=dev), False, cfg)
    fused = _t5_fused_ok(params, cfg, w)
    if fused:
        from ...ops.decode_step import pack_decode_weights
        from ._decoder_lm import cross_operands

        packed = pack_decode_weights(dec["layers"], dtype, cross=True, gated=True)
        bias_km = _t5_key_major_bias(bias_table)
        cross_ops = cross_operands(cross_stacked, dtype)

    def forward(tok, caches, pos):  # the token at buffer index pos - 1 -> cache and bias position pos - 1
        if fused:  # the headless step, the final RMSNorm included; the classifier here
            h = _fused_t5_step(params, packed, None, cfg, tok[:, 0], caches[1], cross_ops, cross_stacked["len"],
                               bias_km, pos - 1)
            return linear(params["classifier"], h), caches
        h = embed_rows(params["token_embs"], tok)
        h = _t5_decode_layers(dec, cfg, h, caches[0], cross, bias_table[:, pos - 1:pos], pos - 1)
        return linear(params["classifier"], rms_norm(dec["norm"], h))[:, 0], caches

    last_logits, caches = forward(torch.full((w, 1), pad_id, dtype=torch.int64, device=dev), caches, 1)
    buf = torch.zeros((w, max_tokens), dtype=torch.int64, device=dev)
    buf[:, 0] = pad_id
    return beam_decode_loop(forward, reorder_caches, caches, last_logits[0], buf, 1, max_tokens, w, eos_id, alpha)


@torch.inference_mode()
def _t5_score(params: dict, cfg: T5Config, enc_buf, n_enc, dec_buf, n_dec) -> torch.Tensor:
    """Teacher-forced seq2seq log-probs. ``enc_buf``: (B, P) right-padded
    inputs with lengths ``n_enc``; ``dec_buf``: (B, T) decoder rows ``[pad] +
    targets`` right-padded with target lengths ``n_dec``. Returns (B, T-1)
    fp32 ``log p(y_t | y_<t, x)``, zeroed past each row's targets."""
    pad_bias = _pad_bias(n_enc, enc_buf.shape[1])
    memory = t5_encode(params, cfg, enc_buf, pad_bias)
    logits = t5_decode(params, cfg, dec_buf, memory, ca_bias=pad_bias)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = torch.gather(logp, -1, dec_buf[:, 1:, None]).squeeze(-1)
    return ll * (torch.arange(dec_buf.shape[1] - 1, device=ll.device)[None, :] < n_dec[:, None])


class T5Model(InferenceModel):
    """Public surface of the JAX package's T5Model (``dropout`` is accepted
    and unused: inference only)."""

    def __init__(self, vocab_size: int, dim: int, n_heads: int, n_layers: int, mlp_dim: int,
                 dropout: float = 0.0, rng: int = 0, device=None) -> None:
        self.cfg = T5Config(vocab_size, dim, n_heads, n_layers, mlp_dim)
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = t5_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    @torch.inference_mode()
    def encode(self, tokens) -> torch.Tensor:
        return t5_encode(self.params, self.cfg, self._tokens(tokens))

    @torch.inference_mode()
    def decode(self, tokens, memory) -> torch.Tensor:
        return t5_decode(self.params, self.cfg, self._tokens(tokens), memory)

    def __call__(self, x, targets) -> torch.Tensor:
        return self.decode(targets, self.encode(x))

    forward = __call__

    @staticmethod
    def from_t5x(model_tag: str, *, pretrained: bool = False, **kwargs) -> "T5Model":
        variant, _, size = model_tag.rpartition("-")
        dim, n_heads, n_layers, mlp_dim = SIZES[size]
        vocab_size = 250112 if variant.startswith("mt5") else 32128
        if pretrained:
            raise NotImplementedError("the t5x checkpoint reader is not ported; load a flat t5x dict with "
                                      "load_t5x_state_dict instead")
        return T5Model(vocab_size, dim, n_heads, n_layers, mlp_dim, **kwargs)

    def load_t5x_state_dict(self, flat: dict) -> None:
        """Flattened t5x keys -> the parameter tree. t5x kernels are stored
        (in, out), the port's layout; q/k kernels are scaled by ``64**0.25`` to
        fold T5X's unscaled attention into the 1/sqrt(d) one."""
        sd = StateDict(flat)
        qk_scale = 64**0.25

        def lin(key, scale=1.0):
            return {"w": sd.pop(key) * scale}

        def attn(pfx: str) -> dict:
            return {"q": lin(f"{pfx}.query.kernel", qk_scale), "k": lin(f"{pfx}.key.kernel", qk_scale),
                    "v": lin(f"{pfx}.value.kernel"), "o": lin(f"{pfx}.out.kernel")}

        def stack(prefix: str, cross: bool) -> dict:
            layers = []
            for i in range(self.cfg.n_layers):
                b = f"{prefix}.layers_{i}"
                lp = {
                    "sa_norm": {"scale": sd.pop(f"{b}.pre_self_attention_layer_norm.scale" if cross
                                                else f"{b}.pre_attention_layer_norm.scale")},
                    "sa": attn(f"{b}.self_attention" if cross else f"{b}.attention"),
                    "mlp_norm": {"scale": sd.pop(f"{b}.pre_mlp_layer_norm.scale")},
                    "mlp": {"w": lin(f"{b}.mlp.wi_0.kernel"), "v": lin(f"{b}.mlp.wi_1.kernel"),
                            "wo": lin(f"{b}.mlp.wo.kernel")},
                }
                if cross:
                    lp["ca_norm"] = {"scale": sd.pop(f"{b}.pre_cross_attention_layer_norm.scale")}
                    lp["ca"] = attn(f"{b}.encoder_decoder_attention")
                layers.append(lp)
            return {
                "attn_bias": sd.pop(f"{prefix}.relpos_bias.rel_embedding"),
                "layers": layers,
                "norm": {"scale": sd.pop(f"{prefix}.{prefix}_norm.scale")},
            }

        p = {
            "token_embs": sd.pop("token_embedder.embedding"),
            "encoder": stack("encoder", False),
            "decoder": stack("decoder", True),
            "classifier": {"w": sd.pop("decoder.logits_dense.kernel")},
        }
        sd.finalize()
        self.params = tree_map(lambda t: t.to(device=self.device, dtype=torch.float32), p)


ENC_BUCKET = 64  # prompts are right-padded to a multiple of this (the JAX package's bucket)


class T5Generator:
    """Greedy and beam-search encoder-decoder generation and teacher-forced
    scoring over token ids. The string methods need a sentencepiece-style tokenizer
    (``Encode(text, add_eos=True)``, ``Decode(ids)``, ``pad_id()``,
    ``eos_id()``) passed in: the port ships none."""

    def __init__(self, model_tag: str | None = None, model: T5Model | None = None, tokenizer=None) -> None:
        self.model = model if model is not None else T5Model.from_t5x(model_tag, pretrained=True)
        self.tokenizer = tokenizer

    def _tok(self):
        if self.tokenizer is None:
            raise ValueError("string generation and scoring need a tokenizer; use the *_tokens methods for ids")
        return self.tokenizer

    def generate(self, prompt: str, max_tokens: int = 100) -> str:
        tok = self._tok()
        out = self.generate_tokens(tok.Encode(prompt, add_eos=True), max_tokens, tok.pad_id(), tok.eos_id())
        return tok.Decode(out)

    def generate_tokens(self, token_ids: list[int], max_tokens: int, pad_id: int, eos_id: int) -> list[int]:
        """Greedy continuation of one prompt (a batch of one): ``[pad] +
        generated``, up to and including the first EOS, at most
        ``max_tokens`` ids."""
        return self.generate_tokens_batch([token_ids], max_tokens, pad_id, eos_id)[0]

    def generate_beam(self, prompt: str, max_tokens: int = 100, beam_width: int = 4,
                      length_penalty: float = 0.0) -> str:
        """Beam-search generation of one prompt's continuation text."""
        tok = self._tok()
        out = self.generate_beam_tokens(tok.Encode(prompt, add_eos=True), max_tokens, tok.pad_id(), tok.eos_id(),
                                        beam_width, length_penalty)
        return tok.Decode(out)

    def generate_beam_tokens(self, token_ids: list[int], max_tokens: int, pad_id: int, eos_id: int,
                             beam_width: int = 4, length_penalty: float = 0.0, return_all: bool = False):
        """Beam-search continuation: the best token sequence (pad + generated
        + EOS, like :meth:`generate_tokens`), or ``(sequences, scores)`` for
        all ``beam_width`` beams with ``return_all`` (best first; scores are
        length-penalized log-probs: models/text/beam.py)."""
        from .beam import _check_beam

        _check_beam(beam_width, length_penalty)
        if max_tokens < 2:
            raise ValueError(f"beam generation needs max_tokens >= 2 (the pad token and one more), got {max_tokens}")
        n = len(token_ids)
        buf = np.zeros((1, -(-n // ENC_BUCKET) * ENC_BUCKET), np.int64)
        buf[0, :n] = token_ids
        dev = self.model.device
        seqs, scores, lens = (t.cpu().numpy() for t in _t5_beam(
            self.model.params, self.model.cfg, torch.from_numpy(buf).to(dev), torch.tensor([n], device=dev),
            max_tokens, pad_id, eos_id, beam_width, float(length_penalty)))
        outs = [seqs[i, : lens[i]].tolist() for i in range(beam_width)]
        return (outs, scores.tolist()) if return_all else outs[0]

    def score(self, prompt: str, target: str) -> list[float]:
        """Per-token ``log p(y_t | y_<t, x)`` of ``target`` given ``prompt``."""
        tok = self._tok()
        return self.score_tokens(tok.Encode(prompt, add_eos=True), tok.Encode(target, add_eos=True), tok.pad_id())

    def score_tokens(self, input_ids: list[int], target_ids: list[int], pad_id: int) -> list[float]:
        return self.score_tokens_batch([input_ids], [target_ids], pad_id)[0]

    def score_tokens_batch(self, input_lists: list[list[int]], target_lists: list[list[int]],
                           pad_id: int) -> list[list[float]]:
        """Batched teacher-forced scoring over right-padded rows."""
        b = len(input_lists)
        if b == 0 or len(target_lists) != b:
            raise ValueError("scoring needs one target per input, and at least one pair")
        if not all(target_lists):
            raise ValueError("scoring needs a non-empty target")
        p = -(-max(len(ts) for ts in input_lists) // ENC_BUCKET) * ENC_BUCKET
        t_len = -(-(max(len(ts) for ts in target_lists) + 1) // 16) * 16
        enc = np.zeros((b, p), np.int64)
        dec = np.zeros((b, t_len), np.int64)
        n_enc = np.zeros((b,), np.int64)
        n_dec = np.zeros((b,), np.int64)
        for i, (inp, tgt) in enumerate(zip(input_lists, target_lists)):
            enc[i, : len(inp)] = inp
            n_enc[i] = len(inp)
            dec[i, 0] = pad_id
            dec[i, 1: 1 + len(tgt)] = tgt
            n_dec[i] = len(tgt)
        dev = self.model.device
        enc_t, n_enc_t, dec_t, n_dec_t = (torch.from_numpy(a).to(dev) for a in (enc, n_enc, dec, n_dec))
        ll = _t5_score(self.model.params, self.model.cfg, enc_t, n_enc_t, dec_t, n_dec_t).cpu().numpy()
        return [ll[i, : n_dec[i]].tolist() for i in range(b)]

    def generate_batch(self, prompts: list[str], max_tokens: int = 100) -> list[str]:
        tok = self._tok()
        outs = self.generate_tokens_batch([tok.Encode(p, add_eos=True) for p in prompts], max_tokens, tok.pad_id(),
                                          tok.eos_id())
        return [tok.Decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int, pad_id: int,
                              eos_id: int) -> list[list[int]]:
        """Batched greedy generation; each row as :meth:`generate_tokens`."""
        if not token_lists:
            raise ValueError("generation needs at least one prompt")
        b = len(token_lists)
        pad = -(-max(len(ts) for ts in token_lists) // ENC_BUCKET) * ENC_BUCKET
        buf = np.zeros((b, pad), np.int64)
        n_enc = np.zeros((b,), np.int64)
        for i, ts in enumerate(token_lists):
            buf[i, : len(ts)] = ts
            n_enc[i] = len(ts)
        dev = self.model.device
        out, lengths = _t5_generate_batch(self.model.params, self.model.cfg, torch.from_numpy(buf).to(dev),
                                          torch.from_numpy(n_enc).to(dev), max_tokens, pad_id, eos_id)
        return [out[i, : lengths[i]].tolist() for i in range(b)]


class SpeculativeT5Generator:
    """``T5Generator`` accelerated by a draft T5 (e.g. t5-small drafting for
    t5-large): greedy and EXACT, token-identical to
    :meth:`T5Generator.generate_tokens` for any draft
    (models/text/speculative.py). Draft and target share the vocabulary and
    lie on one device. After a one-row call, ``last_iters`` holds its
    iteration count (verify chunks run) and ``last_accept_rate`` its
    measured acceptance (None without an iteration); both are None before
    the first."""

    def __init__(self, model: T5Model, draft_model: T5Model, tokenizer=None, k: int = 4) -> None:
        if model.cfg.vocab_size != draft_model.cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.model = model
        self.draft_model = draft_model
        self.tokenizer = tokenizer
        self.k = k
        self.last_iters: int | None = None
        self.last_accept_rate: float | None = None

    @classmethod
    def with_truncated_draft(cls, model: T5Model, tokenizer, n_layers: int, k: int = 4) -> SpeculativeT5Generator:
        """The draft is the target's own first ``n_layers`` of BOTH stacks
        (shared embeddings, rel-pos tables, final norms and classifier): no
        extra weights; the depth only moves the speed and the acceptance."""
        from .speculative import TruncatedDraft

        return cls(model, TruncatedDraft(model, n_layers, ("encoder", "decoder")), tokenizer, k)

    def _tok(self):
        if self.tokenizer is None:
            raise ValueError("string generation needs a tokenizer; use the *_tokens methods for ids")
        return self.tokenizer

    def generate(self, prompt: str, max_tokens: int = 100) -> str:
        tok = self._tok()
        return tok.Decode(self.generate_tokens(tok.Encode(prompt, add_eos=True), max_tokens, tok.pad_id(),
                                               tok.eos_id()))

    def _generate(self, token_lists: list[list[int]], max_tokens: int, pad_id: int, eos_id: int, one_row: bool):
        from .speculative import acceptance, cut_at_eos

        ns = [len(t) for t in token_lists]
        if not ns or min(ns) < 1:
            raise ValueError("generation needs at least one non-empty prompt")
        buf = np.zeros((len(ns), -(-max(ns) // ENC_BUCKET) * ENC_BUCKET), np.int64)  # RIGHT-padded rows
        for i, t in enumerate(token_lists):
            buf[i, :ns[i]] = t
        dev = self.model.device
        out, lengths, iters = _t5_spec_generate(
            self.model.params, self.model.cfg, self.draft_model.params, self.draft_model.cfg,
            torch.from_numpy(buf).to(dev), torch.tensor(ns, device=dev), max_tokens, pad_id, eos_id, self.k, one_row)
        if one_row:
            self.last_iters, self.last_accept_rate = iters, acceptance(int(lengths[0]) - 2, iters, self.k)
        return [cut_at_eos(out[i, : lengths[i]], 1, eos_id) for i in range(len(ns))]

    def generate_tokens(self, token_ids: list[int], max_tokens: int, pad_id: int, eos_id: int) -> list[int]:
        """Rows as :meth:`T5Generator.generate_tokens`: the pad token, then
        the generated ids up to and including the first EOS, at most
        ``max_tokens`` ids."""
        return self._generate([token_ids], max_tokens, pad_id, eos_id, True)[0]

    def generate_batch(self, prompts: list[str], max_tokens: int = 100) -> list[str]:
        tok = self._tok()
        outs = self.generate_tokens_batch([tok.Encode(p, add_eos=True) for p in prompts], max_tokens, tok.pad_id(),
                                          tok.eos_id())
        return [tok.Decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int, pad_id: int,
                              eos_id: int) -> list[list[int]]:
        """Batched :meth:`generate_tokens`: B rows draft and verify together
        with per-row acceptance, one batched per-op pass a step;
        token-identical per row to the one-row path."""
        return self._generate(token_lists, max_tokens, pad_id, eos_id, False)
