"""Whisper speech recognition (PyTorch port of
``pytorch_models_tpu/models/audio2text/whisper.py``, per-op path).

Encoder: Conv1d stem (stride 1 then 2) + GELU, position embeddings stored as
a loaded buffer, pre-norm encoder stack, final LayerNorm. Decoder: token +
learned position embeddings, pre-norm decoder stack with cross-attention,
weight-tied logits. ``WhisperGenerator`` transcribes 30 s segments greedily
with KV-cached self-attention and cross-attention K/V projected once per
segment.

Each greedy decode step runs as the JAX package runs it on its TPU: ONE
fused kernel (``ops/decode_step.py``: self-attention, cross-attention and
MLP of every layer, final LayerNorm, tied greedy head) over layer-stacked
self and cross caches, when ``USE_FUSED_STEP`` (auto: CUDA tensors) and the
kernel's shape rules allow; otherwise the per-op step. int8 serving, as
in the JAX package: ``model.quantize_int8()`` (w8a16; ``USE_A8_DECODE`` for
w8a8 and the int8 head), ``USE_INT8_KV`` (the self cache quantized after
the initial tokens' prefill) and ``USE_INT8_KV_CROSS`` (the cross caches
quantized once for the decode loop; the prefill reads them in full
precision), on the fused route. Beam search (``transcribe_beam_tokens``)
decodes its W beams through the fused step headless, or per-op. The text
methods take a ``WhisperTokenizer`` (``models/audio2text/tokenizer.py``).
Continuous batching is ``models/audio2text/continuous.py``.
``SpeculativeWhisperGenerator`` transcribes greedily with a draft Whisper
(models/text/speculative.py's core): the target verifies k drafts in one
per-op chunk, and a one-segment call's draft steps are K7 launches at B=1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import transformer as tfm
from ...ops import ACT_FNS, layer_norm
from ...ops import attention as _attn
from ...ops.gather import embed_tokens
from ...ops.greedy_head import greedy_argmax_tied
from ...ops.layers import conv1d, conv1d_init
from ...ops.mel import log_mel_spectrogram, use_mel_kernel
from ...utils import StateDict, tree_map
from ...utils.module import InferenceModel, resolve_device
from ..audio.spectrogram import MelSpectrogram
from ..text.generator import DONE_CHECK_EVERY

ENC_MAX_LEN = 3000  # mel frames
DEC_MAX_LEN = 448

# (n_layers, d_model)
VARIANTS = {
    "tiny": (4, 384),
    "tiny.en": (4, 384),
    "base": (8, 512),
    "base.en": (8, 512),
    "small": (12, 768),
    "small.en": (12, 768),
    "medium": (24, 1024),
    "medium.en": (24, 1024),
    "large-v1": (32, 1280),
    "large-v2": (32, 1280),
    "large-v3": (32, 1280),
}


@dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int
    n_layers: int
    d_model: int
    n_mels: int = 80
    # tensor-parallel serving (parallel/serving.py): each rank's local head count and the tp process group the
    # o / fc2 projections all-reduce over
    local_heads: int | None = None
    tp_axis: object = None

    def _heads(self) -> dict:
        return {} if self.local_heads is None else {"n_heads": self.local_heads, "head_dim": 64}

    @property
    def enc_layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, tp_axis=self.tp_axis, **self._heads())

    @property
    def dec_layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, cross_attn=True, tp_axis=self.tp_axis, **self._heads())


def whisper_init(gen: torch.Generator, cfg: WhisperConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` with the JAX init's
    distributions (N(0, 1) token embeddings, zero position embeddings,
    torch-default uniform linears and convs), then moved to ``device``."""
    d = cfg.d_model
    p = {
        "encoder": {
            "conv1": conv1d_init(gen, 3, cfg.n_mels, d),
            "conv2": conv1d_init(gen, 3, d, d),
            "pos_embs": torch.zeros(ENC_MAX_LEN // 2, d),
            **tfm.encoder_init(gen, cfg.n_layers, cfg.enc_layer),
            "norm": tfm.ln_init(d),
        },
        "decoder": {
            "token_embs": torch.randn(cfg.vocab_size, d, generator=gen),
            "pos_embs": torch.zeros(DEC_MAX_LEN, d),
            **tfm.decoder_init(gen, cfg.n_layers, cfg.dec_layer),
            "norm": tfm.ln_init(d),
        },
    }
    return tree_map(lambda t: t.to(device), p)


def whisper_encode(params: dict, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T) mel -> (B, T//2, d) memory."""
    p = params["encoder"]
    x = mel.transpose(1, 2)  # NLC
    x = ACT_FNS["gelu"](conv1d(p["conv1"], x, stride=1, padding=1))
    x = ACT_FNS["gelu"](conv1d(p["conv2"], x, stride=2, padding=1))
    x = x + p["pos_embs"][: x.shape[1]].to(x.dtype)
    x = tfm.encoder_apply(p, cfg.enc_layer, x)
    return layer_norm(p["norm"], x)


def _head(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["token_embs"].to(x.dtype).t())


def whisper_decode(params: dict, cfg: WhisperConfig, tokens: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decode: tokens (B, L) int -> logits (B, L, V)."""
    p = params["decoder"]
    x = p["token_embs"][tokens]
    x = x + p["pos_embs"][: tokens.shape[-1]].to(x.dtype)
    x = tfm.decoder_apply(p, cfg.dec_layer, x, memory=memory)
    return _head(p, layer_norm(p["norm"], x))


def _decoder_hidden_chunk(p: dict, lc: tfm.LayerConfig, cross: list, tokens: torch.Tensor, caches: list, pos: int,
                          pad_lens: torch.Tensor | None = None, pos_ids: torch.Tensor | None = None):
    """Embeddings + KV-cached decoder + final LayerNorm for a (B, S) chunk
    at cache slots ``[pos, pos+S)``: position-table rows ``pos + s``, or
    per row ``pos_ids`` (B, S) with ``pad_lens`` (B,) masking each row's
    left-pad slots (a left-padded pool). ``pos`` may be a (B,) tensor of
    per-row slots (speculative rows), whose position-table rows are ``pos_b
    + s``. Returns ``(hidden (B, S, d), caches)``."""
    if isinstance(pos, torch.Tensor) and pos_ids is None:
        pos_ids = pos.long()[:, None] + torch.arange(tokens.shape[-1], device=tokens.device)
    if pos_ids is None:
        x = embed_tokens(p["token_embs"], tokens, p["pos_embs"], start=pos)
    else:
        x = embed_tokens(p["token_embs"], tokens, p["pos_embs"], pos_ids=pos_ids)
    x, caches = tfm.decoder_apply(p, lc, x, self_caches=caches, cross_caches=cross, pos=pos, pad_lens=pad_lens)
    return layer_norm(p["norm"], x), caches


def _decoder_logits_chunk(p: dict, lc: tfm.LayerConfig, cross: list, tokens: torch.Tensor, caches: list, pos: int):
    """:func:`_decoder_hidden_chunk` + tied-embedding logits."""
    hn, caches = _decoder_hidden_chunk(p, lc, cross, tokens, caches, pos)
    return _head(p, hn), caches


def _whisper_fused_ok(p: dict, cfg: WhisperConfig, batch: int) -> bool:
    """Gate for the one-kernel fused decode step (ops/decode_step.py)."""
    from ...ops.decode_step import fused_step_eligible

    return _attn.use_fused_step(p["token_embs"]) and fused_step_eligible(p["layers"], cfg.dec_layer, batch, cross=True,
                                                                         dtype=p["token_embs"].dtype)


def _whisper_embed_or_fold(p: dict, tok: torch.Tensor, pos: int, pos_ids: torch.Tensor | None = None):
    """Decoder embeddings for a fused step at ``pos`` (position-table row
    ``pos``, or per row ``pos_ids`` (B,)): ``(x (B, d), {})`` in one launch
    of the embedding kernel (K3's ``embed_add``), or with
    ``USE_FUSED_EMBED`` ``(None, kwargs)`` for the step's embed phase."""
    from ...ops.decode_step import pack_embed_tables

    if _attn.use_fused_embed(tok.shape[0]):
        return None, {"emb": pack_embed_tables(p["token_embs"], p["pos_embs"], p["token_embs"].dtype),
                      "tok_ids": tok[:, 0], "pos_rows": pos if pos_ids is None else pos_ids}
    if pos_ids is None:
        return embed_tokens(p["token_embs"], tok, p["pos_embs"], start=pos)[:, 0], {}
    return embed_tokens(p["token_embs"], tok[:, 0], p["pos_embs"], pos_ids=pos_ids), {}


def _fused_whisper_step(p: dict, packed: dict, head: dict | None, cfg: WhisperConfig, tok: torch.Tensor, caches: dict,
                        cross: tuple, lens: torch.Tensor, pos: int, pad_lens: torch.Tensor | None = None,
                        pos_ids: torch.Tensor | None = None) -> torch.Tensor:
    """One fused decode step: embeddings (K3, or the step's embed phase) ->
    ONE kernel over the whole layer stack (self + cross attention + MLP
    [+ final LN + greedy argmax]). ``caches`` holds (L, B, Lp, H*D) stacked
    buffers (int8 with ``ks``/``vs``); ``cross`` is
    ``_decoder_lm.cross_operands``' ``(ck, cv, kv_scales_x)``, ``lens``
    (B,); this step's K/V are written at ``pos``. A left-padded pool passes
    ``pad_lens`` (B,) and each row's position-table row ``pos_ids`` (B,).
    Returns the next token ids (B,) with ``head``, else (headless) the
    final-normed hidden state (B, d)."""
    from ...ops.decode_step import fused_cross_decode_step
    from ..text._decoder_lm import kv_scales

    x, emb_kw = _whisper_embed_or_fold(p, tok, pos, pos_ids)
    lc = cfg.dec_layer
    ck, cv, kvx = cross
    x, nxt = fused_cross_decode_step(x, packed, caches["k"], caches["v"], ck, cv, lens, pos, pad_lens, lc.n_heads,
                                     lc.act, lc.norm_eps, head=head, a8=_attn.use_a8_decode(packed["wqkv"].dtype),
                                     kv_scales=kv_scales(caches), kv_scales_x=kvx, **emb_kw)
    return nxt if head is not None else layer_norm(p["norm"], x)


@torch.inference_mode()
def _generate_batch(params: dict, cfg: WhisperConfig, memory: torch.Tensor, initial_tokens: torch.Tensor,
                    max_tokens: int, eot_id: int):
    """Batched greedy transcription: ``memory`` (B, T, d), shared initial
    tokens, all rows in lockstep; finished rows park on EOT. Returns
    ``(tokens (B, max_tokens), lengths (B,))`` on the host."""
    p = params["decoder"]
    lc = cfg.dec_layer
    b = memory.shape[0]
    n_init = initial_tokens.shape[0]
    dev = memory.device

    # stacked buffers: the per-op path reads and writes per-layer views of them, the fused step the buffers
    self_caches, stacked = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, max_tokens, lc.head_dim,
                                             dtype=p["token_embs"].dtype, device=dev)
    cross, cross_stacked = tfm.precompute_cross_caches(p, lc, memory)
    fused = _whisper_fused_ok(p, cfg, b)
    if fused:
        from ...ops.decode_step import pack_decode_weights, pack_greedy_head
        from ...ops.int8_kv import quantize_kv_caches
        from ..text._decoder_lm import cross_operands

        cdt = p["token_embs"].dtype
        packed = pack_decode_weights(p["layers"], cdt, cross=True)
        head = pack_greedy_head(p["token_embs"], p["norm"], cdt, a8=_attn.use_a8_decode(packed["wqkv"].dtype))
        # int8 cross-KV: the decode loop reads quantized caches, the prefill below the full-precision ones
        dec_cross = quantize_kv_caches(cross_stacked) if _attn.use_int8_kv_cross(b) else cross_stacked
        cross_ops = cross_operands(dec_cross, cdt)

    buf = torch.zeros((b, max_tokens), dtype=torch.int64, device=dev)
    init_rows = initial_tokens.to(dev).expand(b, n_init)
    buf[:, :n_init] = init_rows
    logits, self_caches = _decoder_logits_chunk(p, lc, cross, init_rows, self_caches, 0)
    if fused and _attn.use_int8_kv(b):  # int8 self-KV: the prefilled cache quantized once
        stacked = quantize_kv_caches(stacked)
    first = torch.argmax(logits[:, n_init - 1], dim=-1)
    if n_init < max_tokens:
        buf[:, n_init] = first
    done = first == eot_id
    eot = torch.full_like(first, eot_id)
    greedy_head = _attn.use_greedy_head(b, p["token_embs"], tied=True)

    pos = n_init + 1
    while pos < max_tokens:
        # rows done early keep stepping (parked on EOT) until the next check:
        # the output is the same, and the host reads the flag less often
        if (pos - n_init - 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        tok = buf[:, pos - 1:pos]
        if fused:
            nxt = _fused_whisper_step(p, packed, head, cfg, tok, stacked, cross_ops, cross_stacked["len"], pos - 1)
        elif greedy_head:
            hn, self_caches = _decoder_hidden_chunk(p, lc, cross, tok, self_caches, pos - 1)
            nxt = greedy_argmax_tied(hn[:, 0], p["token_embs"].to(hn.dtype))
        else:
            logits, self_caches = _decoder_logits_chunk(p, lc, cross, tok, self_caches, pos - 1)
            nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt = torch.where(done, eot, nxt)
        buf[:, pos] = nxt
        done = done | (nxt == eot_id)
        pos += 1

    # per-row length: first EOT among actually generated slots, else `pos`
    out = buf.cpu().numpy()
    gen = out[:, n_init:pos]
    is_eot = gen == eot_id
    lengths = np.where(is_eot.any(axis=1), n_init + is_eot.argmax(axis=1) + 1, pos)
    return out, lengths


@torch.inference_mode()
def _speculative_generate(params: dict, cfg: WhisperConfig, draft_params: dict, draft_cfg: WhisperConfig,
                          memory: torch.Tensor, d_memory: torch.Tensor, initial_tokens: torch.Tensor, max_tokens: int,
                          eot_id: int, k: int, one_row: bool):
    """Greedy speculative transcription (models/text/speculative.py's core;
    token-identical to :func:`_generate_batch` for any draft): a draft
    Whisper proposes k tokens, the target verifies them in one per-op
    (k+1)-position decoder chunk. Each model attends its own encoding of the
    segments (``memory`` / ``d_memory``, (B, T, d)); shared initial tokens.
    The buffers run to ``min(max_tokens + k, DEC_MAX_LEN)``: at the
    position table's edge the loop stops up to k tokens early. ``one_row``
    (B = 1): host positions, each draft step ONE K7 launch (cross variant,
    in-kernel greedy head) where its gate allows; else per-row positions,
    every step per-op. Returns ``(tokens (B, l_buf), lengths, iterations)``
    on the host."""
    from ..text.speculative import spec_greedy_decode_loop

    p, dp = params["decoder"], draft_params["decoder"]
    lc, dlc = cfg.dec_layer, draft_cfg.dec_layer
    b, dev = memory.shape[0], memory.device
    n_init = initial_tokens.shape[0]
    l_buf = min(max_tokens + k, DEC_MAX_LEN)
    t_caches, _ = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, l_buf, lc.head_dim, p["token_embs"].dtype, dev)
    d_caches, d_stacked = tfm.make_kv_cache(draft_cfg.n_layers, (b,), dlc.n_heads, l_buf, dlc.head_dim,
                                            dp["token_embs"].dtype, dev)
    t_cross, _ = tfm.precompute_cross_caches(p, lc, memory)
    d_cross, d_cross_stacked = tfm.precompute_cross_caches(dp, dlc, d_memory)
    fused = one_row and _whisper_fused_ok(dp, draft_cfg, 1)
    if fused:
        from ...ops.decode_step import pack_decode_weights, pack_greedy_head
        from ..text._decoder_lm import cross_operands

        cdt = dp["token_embs"].dtype
        packed = pack_decode_weights(dp["layers"], cdt, cross=True)
        head = pack_greedy_head(dp["token_embs"], dp["norm"], cdt, a8=_attn.use_a8_decode(packed["wqkv"].dtype))
        cross_ops = cross_operands(d_cross_stacked, cdt)

    def verify_chunk(chunk, caches, pos):
        logits, caches = _decoder_logits_chunk(p, lc, t_cross, chunk, caches, pos)
        return torch.argmax(logits, dim=-1), caches

    def draft_step(tok, caches, pos):
        if fused:
            return _fused_whisper_step(dp, packed, head, draft_cfg, tok, d_stacked, cross_ops, d_cross_stacked["len"],
                                       pos), caches
        logits, caches = _decoder_logits_chunk(dp, dlc, d_cross, tok, caches, pos)
        return torch.argmax(logits[:, 0], dim=-1), caches

    init_rows = initial_tokens.to(dev).expand(b, n_init)
    hn, _ = _decoder_hidden_chunk(p, lc, t_cross, init_rows, t_caches, 0)
    first = torch.argmax(_head(p, hn[:, -1]), dim=-1)
    _decoder_hidden_chunk(dp, dlc, d_cross, init_rows, d_caches, 0)  # the draft's prefill
    buf = torch.zeros((b, l_buf), dtype=torch.int64, device=dev)
    buf[:, :n_init] = init_rows
    if n_init < l_buf:
        buf[:, n_init] = first
    pos0, limit = (n_init + 1, max_tokens) if one_row else (torch.full((b,), n_init + 1, device=dev),
                                                             torch.full((b,), max_tokens, device=dev))
    return spec_greedy_decode_loop(draft_step, verify_chunk, t_caches, d_caches, buf, pos0, first == eot_id, limit, k,
                                   eot_id, l_buf)


@torch.inference_mode()
def _beam(params: dict, cfg: WhisperConfig, memory: torch.Tensor, initial_tokens: torch.Tensor, max_tokens: int,
          eot_id: int, w: int, alpha: float):
    """Beam-search transcription over ONE encoded segment (``memory`` (1, T,
    d)). The W beams ride the batched decode path (the fused step headless
    where it serves W rows, else per-op) through the model-agnostic loop of
    models/text/beam.py. Cross-attention K/V are projected once and copied
    to the W rows; only the self caches reorder by parent beam. Returns
    ``(seqs (W, max_tokens), scores (W,), lengths (W,))`` on the device,
    best-first; lengths count prompt + generated + EOT, as greedy does."""
    from ..text.beam import beam_caches, beam_cross_caches, beam_decode_loop, reorder_caches

    p = params["decoder"]
    lc = cfg.dec_layer
    n_init = initial_tokens.shape[0]
    dev = memory.device
    _, stacked = tfm.make_kv_cache(cfg.n_layers, (w,), lc.n_heads, max_tokens, lc.head_dim,
                                   dtype=p["token_embs"].dtype, device=dev)
    caches = beam_caches(stacked)
    cross, cross_stacked = beam_cross_caches(tfm.precompute_cross_caches(p, lc, memory)[1], w)
    fused = _whisper_fused_ok(p, cfg, w)
    if fused:
        from ...ops.decode_step import pack_decode_weights
        from ..text._decoder_lm import cross_operands

        packed = pack_decode_weights(p["layers"], p["token_embs"].dtype, cross=True)
        cross_ops = cross_operands(cross_stacked, p["token_embs"].dtype)

    init_rows = initial_tokens.to(dev).expand(w, n_init)
    hn, _ = _decoder_hidden_chunk(p, lc, cross, init_rows, caches[0], 0)
    buf = torch.zeros((w, max_tokens), dtype=torch.int64, device=dev)
    buf[:, :n_init] = init_rows

    def forward(tok, caches, pos):
        if fused:  # the headless step: layer stack + cross-attention + the final LN; the head here
            return _head(p, _fused_whisper_step(p, packed, None, cfg, tok, caches[1], cross_ops, cross_stacked["len"],
                                                pos - 1)), caches
        hn, _ = _decoder_hidden_chunk(p, lc, cross, tok, caches[0], pos - 1)
        return _head(p, hn[:, 0]), caches

    return beam_decode_loop(forward, reorder_caches, caches, _head(p, hn[0, -1]), buf, n_init, max_tokens, w, eot_id,
                            alpha)


class Whisper(InferenceModel):
    def __init__(self, vocab_size: int, n_layers: int, d_model: int, n_mels: int = 80, dropout: float = 0.0,
                 rng: int = 0, device=None) -> None:
        # dropout: accepted at the JAX constructor's position for API parity; inference-only
        self.cfg = WhisperConfig(vocab_size, n_layers, d_model, n_mels)
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = whisper_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    @torch.inference_mode()
    def encode(self, mel) -> torch.Tensor:
        return whisper_encode(self.params, self.cfg, torch.as_tensor(mel, device=self.device))

    @torch.inference_mode()
    def __call__(self, mel, targets) -> torch.Tensor:
        targets = torch.as_tensor(targets, device=self.device).long()
        return whisper_decode(self.params, self.cfg, targets, self.encode(mel))

    forward = __call__

    @staticmethod
    def from_openai(model_tag: str, *, pretrained: bool = False, **kwargs) -> "Whisper":
        n_layers, d_model = VARIANTS[model_tag]
        if model_tag == "large-v3":
            n_mels, vocab_size = 128, 51866
        else:
            n_mels, vocab_size = 80, 51864 if model_tag.endswith(".en") else 51865
        if pretrained:
            raise NotImplementedError("pretrained Whisper weights need a download; load a state dict with "
                                      "load_openai_state_dict instead")
        return Whisper(vocab_size, n_layers, d_model, n_mels, **kwargs)

    def load_openai_state_dict(self, state_dict: dict) -> None:
        """OpenAI checkpoint keys (``key`` projections have no bias)."""
        sd = StateDict(state_dict)
        cfg = self.cfg

        def attn(pfx: str) -> dict:
            return {
                "q": sd.pop_linear(f"{pfx}.query"),
                "k": {"w": sd.pop(f"{pfx}.key.weight").t().contiguous(),
                      "b": sd.pop(f"{pfx}.key.bias", torch.zeros(cfg.d_model))},
                "v": sd.pop_linear(f"{pfx}.value"),
                "o": sd.pop_linear(f"{pfx}.out"),
            }

        def block(pfx: str, cross: bool) -> dict:
            lp = {
                "sa": attn(f"{pfx}.attn"),
                "sa_norm": sd.pop_ln(f"{pfx}.attn_ln"),
                "mlp": {"fc1": sd.pop_linear(f"{pfx}.mlp.0"), "fc2": sd.pop_linear(f"{pfx}.mlp.2")},
                "mlp_norm": sd.pop_ln(f"{pfx}.mlp_ln"),
            }
            if cross:
                lp["ca"] = attn(f"{pfx}.cross_attn")
                lp["ca_norm"] = sd.pop_ln(f"{pfx}.cross_attn_ln")
            return lp

        enc = {
            "conv1": sd.pop_conv1d("encoder.conv1"),
            "conv2": sd.pop_conv1d("encoder.conv2"),
            "pos_embs": sd.pop("encoder.positional_embedding"),
            "layers": [block(f"encoder.blocks.{i}", False) for i in range(cfg.n_layers)],
            "norm": sd.pop_ln("encoder.ln_post"),
        }
        dec = {
            "token_embs": sd.pop("decoder.token_embedding.weight"),
            "pos_embs": sd.pop("decoder.positional_embedding"),
            "layers": [block(f"decoder.blocks.{i}", True) for i in range(cfg.n_layers)],
            "norm": sd.pop_ln("decoder.ln"),
        }
        if "decoder.positional_embedding_mask" in sd:  # not modeled
            sd.pop("decoder.positional_embedding_mask")
        sd.finalize()
        self.params = tree_map(lambda t: t.to(device=self.device, dtype=torch.float32),
                               {"encoder": enc, "decoder": dec})


class WhisperPreprocessor(MelSpectrogram):
    """Log-mel frontend matching ``whisper.log_mel_spectrogram``.

    ``fused=None`` takes the log-mel kernel (``ops/mel.py``) when the input
    lies on (or, as an array, goes to) a CUDA device (``USE_MEL_KERNEL``
    overrides); ``fused=True`` always takes its wrapper, ``fused=False`` the
    rFFT route of the JAX package's XLA path. The clip at the global max − 8
    and the ``(x + 4) / 4`` scale stay plain, as in JAX.
    """

    def __init__(self, variant: str = "tiny", fused: bool | None = None, device=None) -> None:
        n_mels = 128 if variant == "large-v3" else 80
        super().__init__(400, 160, n_mels, 16_000, device)
        self.n_mels = n_mels
        self.fused = fused

    def __call__(self, x) -> torch.Tensor:
        """A tensor stays on its device; an array or list goes to ``device``
        (None: the CUDA card, as the models' default)."""
        x = self._waveform(x).float()
        fused = use_mel_kernel(x) if self.fused is None else self.fused
        if fused:
            x = log_mel_spectrogram(x.contiguous(), self.n_fft, self.hop_length, self.n_mels)[..., :-1]
        else:
            x = torch.log10(super().__call__(x)[..., :-1].clamp_min(0))
        global_max = x.reshape(*x.shape[:-2], -1).amax(-1)[..., None, None]
        x = torch.maximum(x, global_max - 8)
        return (x + 4) / 4


def _strip_generated(tokens: list[int], n_prompt: int, eot_id: int) -> list[int]:
    """Drop the initial prompt and the trailing EOT from a decode result."""
    gen = tokens[n_prompt:]
    if gen and gen[-1] == eot_id:
        gen = gen[:-1]
    return gen


def stage_segments(audios, n_samples: int, dev) -> torch.Tensor:
    """Segments -> (B, n_samples) fp32 on ``dev``, each cut or zero-padded
    to ``n_samples``; a tensor already so shaped on that device passes as
    is."""
    if isinstance(audios, torch.Tensor) and audios.ndim == 2 and audios.shape[1] == n_samples and audios.device == dev:
        return audios.float()
    rows = [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.float32)[:n_samples] for a in audios]
    return torch.from_numpy(np.stack([np.pad(a, (0, n_samples - len(a))) for a in rows])).to(dev)


def split_windows(audio, n_samples: int) -> np.ndarray:
    """Waveform (n,) -> (n_windows, n_samples) fixed windows, last padded."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim != 1:
        raise ValueError(f"long-form transcription takes a single (n,) waveform, got {audio.shape}")
    n_w = max(1, -(-len(audio) // n_samples))
    padded = np.zeros((n_w * n_samples,), np.float32)
    padded[: len(audio)] = audio
    return padded.reshape(n_w, n_samples)


class WhisperGenerator:
    """KV-cached transcription of 30 s segments: log-mel frontend, encoder,
    then a batched greedy decode loop (a single segment is a batch of one),
    or beam search over one segment."""

    SAMPLE_RATE = 16_000
    N_SAMPLES = 30 * 16_000  # 30-second segments

    def __init__(self, model: Whisper, tokenizer=None) -> None:
        self.model = model
        self.tokenizer = tokenizer
        self.preprocessor = WhisperPreprocessor("large-v3" if model.cfg.n_mels == 128 else "tiny",
                                                device=model.device)

    def _stage_batch(self, audios) -> torch.Tensor:
        return stage_segments(audios, self.N_SAMPLES, self.model.device)

    @torch.inference_mode()
    def _transcribe_batch(self, wav: torch.Tensor, initial_tokens: list[int], eot_id: int, max_tokens: int):
        if max_tokens > DEC_MAX_LEN:
            raise ValueError(f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN})")
        if not 0 < len(initial_tokens) <= max_tokens:
            raise ValueError(f"transcription needs 1 to max_tokens={max_tokens} initial tokens")
        m = self.model
        memory = whisper_encode(m.params, m.cfg, self.preprocessor(wav))
        init = torch.tensor(initial_tokens, dtype=torch.int64, device=m.device)
        return _generate_batch(m.params, m.cfg, memory, init, max_tokens, eot_id)

    def transcribe_tokens(self, audio, initial_tokens: list[int], eot_id: int,
                          max_tokens: int = DEC_MAX_LEN) -> list[int]:
        """Waveform (n,) -> transcribed token ids (greedy, one 30 s segment)."""
        buf, lengths = self._transcribe_batch(self._stage_batch([audio]), initial_tokens, eot_id, max_tokens)
        return buf[0, : lengths[0]].tolist()

    def transcribe_tokens_batch(self, audios, initial_tokens: list[int], eot_id: int,
                                max_tokens: int = DEC_MAX_LEN) -> list[list[int]]:
        """Batched greedy transcription of several 30 s segments."""
        if len(audios) == 0:
            raise ValueError("transcription needs at least one segment")
        buf, lengths = self._transcribe_batch(self._stage_batch(audios), initial_tokens, eot_id, max_tokens)
        return [buf[i, : lengths[i]].tolist() for i in range(len(audios))]

    def transcribe(self, audio, initial_tokens: list[int] | None = None, eot_id: int | None = None,
                   max_tokens: int = DEC_MAX_LEN, language: str = "en", task: str = "transcribe") -> str:
        """Waveform -> text; needs a tokenizer (``sot_sequence``, ``eot``,
        ``decode``). Without one use :meth:`transcribe_tokens`."""
        if self.tokenizer is None:
            raise ValueError("transcribe() returns text and needs a tokenizer; "
                             "use transcribe_tokens(...) for raw token ids")
        if initial_tokens is None or eot_id is None:
            initial_tokens = self.tokenizer.sot_sequence(language, task)
            eot_id = self.tokenizer.eot
        return self.tokenizer.decode(self.transcribe_tokens(audio, initial_tokens, eot_id, max_tokens))

    def transcribe_beam_tokens(self, audio, initial_tokens: list[int], eot_id: int, max_tokens: int = DEC_MAX_LEN,
                               beam_width: int = 4, length_penalty: float = 0.0, return_all: bool = False):
        """Beam-search transcription of one 30 s segment (a batch of one).
        Returns the best token sequence (prompt + generated + EOT, like
        :meth:`transcribe_tokens`), or ``(sequences, scores)`` for all
        ``beam_width`` beams with ``return_all`` (best first; scores are
        length-penalized log-probs: models/text/beam.py)."""
        from ..text.beam import _check_beam

        if max_tokens > DEC_MAX_LEN:
            raise ValueError(f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN})")
        _check_beam(beam_width, length_penalty)
        if not 0 < len(initial_tokens) < max_tokens:
            raise ValueError(f"beam transcription needs 1 to max_tokens - 1 = {max_tokens - 1} initial tokens")
        m = self.model
        with torch.inference_mode():
            memory = whisper_encode(m.params, m.cfg, self.preprocessor(self._stage_batch([audio])))
        init = torch.tensor(initial_tokens, dtype=torch.int64, device=m.device)
        seqs, scores, lens = (t.cpu().numpy() for t in _beam(m.params, m.cfg, memory, init, max_tokens, eot_id,
                                                                 beam_width, float(length_penalty)))
        outs = [seqs[i, : lens[i]].tolist() for i in range(beam_width)]
        return (outs, scores.tolist()) if return_all else outs[0]

    def transcribe_beam(self, audio, language: str = "en", task: str = "transcribe", beam_width: int = 4,
                        length_penalty: float = 0.0, max_tokens: int = DEC_MAX_LEN) -> str:
        """Waveform -> text via beam search (needs a tokenizer)."""
        if self.tokenizer is None:
            raise ValueError("transcribe_beam() returns text and needs a tokenizer; "
                             "use transcribe_beam_tokens(...) for raw ids")
        out = self.transcribe_beam_tokens(audio, self.tokenizer.sot_sequence(language, task), self.tokenizer.eot,
                                          max_tokens, beam_width, length_penalty)
        return self.tokenizer.decode(out)

    # ---------------------------------------------------------------- long-form

    def transcribe_long_tokens(self, audio, initial_tokens: list[int], eot_id: int,
                               sot_prev_id: int | None = None, ctx_tokens: int = 64,
                               max_tokens: int = DEC_MAX_LEN, batch_size: int = 8) -> list[list[int]]:
        """Long-form (> 30 s) greedy transcription over fixed 30 s windows;
        returns per-window GENERATED token ids (prompt and EOT stripped).

        - ``sot_prev_id=None``: windows are independent and decode in
          batches of ``batch_size`` (a short tail batch is padded by
          repeating its last window when there is more than one batch).
        - ``sot_prev_id`` given: windows decode in order, each conditioned on
          ``[sot_prev_id] + last ctx_tokens generated + initial_tokens`` once
          ``ctx_tokens`` tokens have accumulated.
        """
        windows = split_windows(audio, self.N_SAMPLES)
        if sot_prev_id is None:
            outs: list[list[int]] = []
            for i in range(0, len(windows), batch_size):
                sl = windows[i: i + batch_size]
                n_real = len(sl)
                if n_real < batch_size and len(windows) > batch_size:
                    sl = np.concatenate([sl, np.repeat(sl[-1:], batch_size - n_real, 0)])
                outs += self.transcribe_tokens_batch(sl, initial_tokens, eot_id, max_tokens)[:n_real]
            return [_strip_generated(o, len(initial_tokens), eot_id) for o in outs]

        results: list[list[int]] = []
        text_accum: list[int] = []
        for w in windows:
            if len(text_accum) >= ctx_tokens:
                prompt = [sot_prev_id] + text_accum[-ctx_tokens:] + list(initial_tokens)
            else:
                prompt = list(initial_tokens)
            gen = _strip_generated(self.transcribe_tokens(w, prompt, eot_id, max_tokens), len(prompt), eot_id)
            results.append(gen)
            text_accum += gen
        return results

    def transcribe_long(self, audio, language: str = "en", task: str = "transcribe",
                        condition_on_previous_text: bool = True, ctx_tokens: int = 64,
                        max_tokens: int = DEC_MAX_LEN, batch_size: int = 8) -> str:
        """Long-form waveform -> text via fixed 30 s windows (needs a tokenizer)."""
        if self.tokenizer is None:
            raise ValueError("transcribe_long() returns text and needs a tokenizer; "
                             "use transcribe_long_tokens(...) for raw ids")
        initial_tokens = self.tokenizer.sot_sequence(language, task)
        sot_prev = self.tokenizer.special_tokens["<|startofprev|>"] if condition_on_previous_text else None
        outs = self.transcribe_long_tokens(audio, initial_tokens, self.tokenizer.eot, sot_prev, ctx_tokens,
                                           max_tokens, batch_size)
        return "".join(self.tokenizer.decode(o) for o in outs)


class SpeculativeWhisperGenerator:
    """``WhisperGenerator`` accelerated by a draft Whisper (e.g. tiny
    drafting for base): greedy and EXACT, token-identical to
    :meth:`WhisperGenerator.transcribe_tokens` for any draft
    (models/text/speculative.py). Both encoders run on each segment, each
    behind its own log-mel frontend. Within k positions of the 448-slot
    position table the loop stops instead of drafting past it: a
    transcription with no EOT before position ``448 - k`` can return up to
    k - 1 fewer tokens than the plain generator (pass ``max_tokens <= 448 -
    k`` for identity). After a one-segment call, ``last_iters`` holds its
    iteration count (verify chunks run) and ``last_accept_rate`` its
    measured acceptance (None without an iteration); both are None before
    the first."""

    SAMPLE_RATE = WhisperGenerator.SAMPLE_RATE
    N_SAMPLES = WhisperGenerator.N_SAMPLES

    def __init__(self, model: Whisper, draft_model: Whisper, tokenizer=None, k: int = 4) -> None:
        if model.cfg.vocab_size != draft_model.cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.model = model
        self.draft_model = draft_model
        self.tokenizer = tokenizer
        self.k = k
        self.preprocessor = WhisperPreprocessor("large-v3" if model.cfg.n_mels == 128 else "tiny",
                                                device=model.device)
        self.draft_preprocessor = WhisperPreprocessor("large-v3" if draft_model.cfg.n_mels == 128 else "tiny",
                                                      device=model.device)
        self.last_iters: int | None = None
        self.last_accept_rate: float | None = None

    @classmethod
    def with_truncated_draft(cls, model: Whisper, tokenizer=None, n_layers: int = 2,
                             k: int = 4) -> SpeculativeWhisperGenerator:
        """The draft is the target's own first ``n_layers`` of both stacks
        (shared conv stem, embeddings and final norms): no extra weights;
        the depth only moves the speed and the acceptance."""
        from ..text.speculative import TruncatedDraft

        return cls(model, TruncatedDraft(model, n_layers, ("encoder", "decoder")), tokenizer, k)

    @torch.inference_mode()
    def _transcribe(self, wav: torch.Tensor, initial_tokens: list[int], eot_id: int, max_tokens: int,
                    one_row: bool) -> list[list[int]]:
        from ..text.speculative import acceptance, cut_at_eos

        if max_tokens > DEC_MAX_LEN:
            raise ValueError(f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN})")
        if not 0 < len(initial_tokens) <= max_tokens:
            raise ValueError(f"transcription needs 1 to max_tokens={max_tokens} initial tokens")
        m, d = self.model, self.draft_model
        mel = self.preprocessor(wav)
        d_mel = mel if d.cfg.n_mels == m.cfg.n_mels else self.draft_preprocessor(wav)
        memory = whisper_encode(m.params, m.cfg, mel)
        d_memory = whisper_encode(d.params, d.cfg, d_mel)
        init = torch.tensor(initial_tokens, dtype=torch.int64, device=m.device)
        out, lengths, iters = _speculative_generate(m.params, m.cfg, d.params, d.cfg, memory, d_memory, init,
                                                    max_tokens, eot_id, self.k, one_row)
        n = len(initial_tokens)
        if one_row:
            self.last_iters, self.last_accept_rate = iters, acceptance(int(lengths[0]) - (n + 1), iters, self.k)
        return [cut_at_eos(out[i, : lengths[i]], n, eot_id) for i in range(out.shape[0])]

    def transcribe_tokens(self, audio, initial_tokens: list[int], eot_id: int,
                          max_tokens: int = DEC_MAX_LEN) -> list[int]:
        """Waveform (n,) -> transcribed token ids (greedy, one 30 s segment;
        token-identical to the plain generator)."""
        wav = stage_segments([audio], self.N_SAMPLES, self.model.device)
        return self._transcribe(wav, initial_tokens, eot_id, max_tokens, True)[0]

    def transcribe_tokens_batch(self, audios, initial_tokens: list[int], eot_id: int,
                                max_tokens: int = DEC_MAX_LEN) -> list[list[int]]:
        """Batched speculative transcription of several 30 s segments: both
        encoders on the batch, then every row drafts and verifies together
        with per-row acceptance and EOT, one batched per-op pass a step.
        Token-identical per row to :meth:`transcribe_tokens`."""
        if len(audios) == 0:
            raise ValueError("transcription needs at least one segment")
        wav = stage_segments(audios, self.N_SAMPLES, self.model.device)
        return self._transcribe(wav, initial_tokens, eot_id, max_tokens, False)

    def transcribe(self, audio, initial_tokens: list[int] | None = None, eot_id: int | None = None,
                   max_tokens: int = DEC_MAX_LEN, language: str = "en", task: str = "transcribe") -> str:
        """Waveform -> text; needs a tokenizer (``sot_sequence``, ``eot``,
        ``decode``), as ``WhisperGenerator.transcribe`` does."""
        if self.tokenizer is None:
            raise ValueError("transcribe() returns text and needs a tokenizer; "
                             "use transcribe_tokens(...) for raw token ids")
        if initial_tokens is None or eot_id is None:
            initial_tokens = self.tokenizer.sot_sequence(language, task)
            eot_id = self.tokenizer.eot
        return self.tokenizer.decode(self.transcribe_tokens(audio, initial_tokens, eot_id, max_tokens))
