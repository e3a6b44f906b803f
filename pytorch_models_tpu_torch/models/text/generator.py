"""Greedy generation and scoring with a KV-cached decode loop (PyTorch port
of ``pytorch_models_tpu/models/text/generator.py``).

Prompts are LEFT-padded to a ``PROMPT_BUCKET`` multiple so every row ends at
the same cache slot; one prefill fills the caches, then a Python loop runs
fixed-shape single-token steps. The step follows the JAX package's
``_generate_batch_body`` / ``_decode_rows``: per-row position ids clipped at
0, the pad mask threaded to attention, finished rows parked on EOS, and each
row's length cut at its first generated EOS. The caches are layer-stacked
buffers with per-layer views. When the fused step serves the model and
batch (``ops/attention.py`` ``USE_FUSED_STEP``, auto on CUDA tensors), the
weights are packed once per call and each greedy step is ONE kernel launch
(layer stack + final norm + argmax) after the two embedding gathers (or
with them, ``USE_FUSED_EMBED``). int8 serving: ``model.quantize_int8()``
(w8a16 weights; ``USE_A8_DECODE`` for w8a8 and the int8 head) and
``USE_INT8_KV`` (the prefilled cache quantized once, as in the JAX package:
on the fused route only). Sampling, beam search, parallel samples and
speculative decoding are not ported yet; a CUDA graph for the step is later
work.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import attention as _attn
from ...ops.greedy_head import greedy_argmax_tied
from ...ops.int8_kv import quantize_kv_caches
from ._decoder_lm import (
    decoder_lm_apply,
    decoder_lm_forward_cached_batch,
    decoder_lm_fused_ok,
    decoder_lm_fused_tok_batch,
    decoder_lm_hidden_cached_batch,
    decoder_lm_make_cache,
    decoder_lm_pack,
)

PROMPT_BUCKET = 64  # prompts are padded to a multiple of this (the JAX package's bucket)
DONE_CHECK_EVERY = 8  # decode steps between host reads of the all-rows-done flag


def _eos_id(tokenizer) -> int:
    eos = getattr(tokenizer, "eos_token_id", None)
    return -1 if eos is None else eos  # -1 never matches


@torch.inference_mode()
def _generate_batch(params, cfg, prompt_buf: torch.Tensor, pad_lens: torch.Tensor, limit: int, eos_id: int):
    """Batched greedy generation over LEFT-padded prompts.

    ``prompt_buf``: (B, P) with each row's tokens right-aligned; ``pad_lens``:
    (B,) int32 left-pad count per row. Returns ``(tokens (B, max_seq_len),
    lengths (B,))`` on the host; row i's output occupies ``[pad_i, len_i)``.
    """
    b, p_len = prompt_buf.shape
    dev = prompt_buf.device
    pos_ids = (torch.arange(p_len, device=dev)[None, :] - pad_lens[:, None].long()).clamp_min(0)

    cache_dtype = params["token_embs"].dtype
    fused = decoder_lm_fused_ok(params, cfg, b)
    # the per-op prefill writes through per-layer views of the stacked buffers the fused step reads
    caches, stacked = decoder_lm_make_cache(cfg, (b,), dtype=cache_dtype, device=dev)
    if fused:
        packed, head = decoder_lm_pack(params, cfg)
    logits, caches = decoder_lm_forward_cached_batch(params, cfg, prompt_buf, pos_ids, caches, 0, pad_lens)
    if fused and _attn.use_int8_kv(b):
        # int8 self-KV (ops/attention.py USE_INT8_KV): the prefilled cache is quantized once; each fused step
        # writes its K/V quantized
        stacked = quantize_kv_caches(stacked)

    buf = torch.zeros((b, cfg.max_seq_len), dtype=torch.int64, device=dev)
    buf[:, :p_len] = prompt_buf
    nxt = torch.argmax(logits[:, -1], dim=-1)  # rows are right-aligned: slot P-1 is each row's last token
    buf[:, p_len] = nxt
    done = nxt == eos_id
    eos = torch.full_like(nxt, eos_id)
    greedy_head = _attn.use_greedy_head(b, params["token_embs"])

    pos = p_len + 1
    while pos < limit:
        # rows done early keep stepping (parked on EOS) until the next check:
        # the output is the same, and the host reads the flag less often
        if (pos - p_len - 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        tok = buf[:, pos - 1:pos]
        p_ids = (pos - 1 - pad_lens.long())[:, None]
        if fused:  # layer stack + final norm + argmax in ONE kernel
            nxt = decoder_lm_fused_tok_batch(params, packed, head, cfg, tok, p_ids, stacked, pos - 1, pad_lens)
        elif greedy_head:
            hidden, caches = decoder_lm_hidden_cached_batch(params, cfg, tok, p_ids, caches, pos - 1, pad_lens)
            nxt = greedy_argmax_tied(hidden[:, 0], params["token_embs"].to(hidden.dtype))
        else:
            logits, caches = decoder_lm_forward_cached_batch(params, cfg, tok, p_ids, caches, pos - 1, pad_lens)
            nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt = torch.where(done, eos, nxt)  # finished rows stay parked on EOS
        buf[:, pos] = nxt
        done = done | (nxt == eos_id)
        pos += 1

    # per-row length: first EOS among actually generated slots, else `pos`
    out = buf.cpu().numpy()
    gen = out[:, p_len:pos]
    is_eos = gen == eos_id
    has_eos = is_eos.any(axis=1)
    lengths = np.where(has_eos, p_len + is_eos.argmax(axis=1) + 1, pos)
    return out, lengths


@torch.inference_mode()
def _score_tokens(params, cfg, buf: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    """Teacher-forced per-token log-probs: (B, P) right-padded rows with (B,)
    valid lengths -> (B, P-1) fp32 ``log p(x_t | x_<t)``, zeroed past each
    row's length (causal masking makes the right-pad harmless)."""
    logits = decoder_lm_apply(params, cfg, buf)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = torch.gather(logp, -1, buf[:, 1:, None]).squeeze(-1)
    keep = torch.arange(1, buf.shape[1], device=buf.device)[None, :] < n_rows[:, None]
    return ll * keep


class DecoderGenerator:
    """Greedy generation and scoring over a decoder-only LM (``model.params``,
    ``model.cfg``, ``model.device``) and a tokenizer (``eos_token_id``, and
    ``encode`` for :meth:`perplexity`). Sampling (``topk``/``top_p``/
    ``temperature``) and the string-level ``generate`` are not ported yet."""

    def __init__(self, model, tokenizer) -> None:
        self.model = model
        self.tokenizer = tokenizer

    def generate_tokens(self, tokens: list[int], max_tokens: int = 100) -> list[int]:
        """Greedy generation of one prompt, as in the JAX package: when the
        fused step serves the model it runs as a batch of one through
        :meth:`generate_tokens_batch` (``PROMPT_BUCKET`` padding: the budget
        is ``min(pad + max_tokens, max_seq_len)`` and a prompt whose padded
        length reaches the context generates nothing); otherwise with no
        bucket padding, so the budget is ``min(n + max_tokens,
        max_seq_len)``."""
        if max_tokens <= 0 or len(tokens) >= self.model.cfg.max_seq_len:
            return list(tokens)
        if decoder_lm_fused_ok(self.model.params, self.model.cfg, 1):
            return self.generate_tokens_batch([tokens], max_tokens)[0]
        return self._generate_left_padded([tokens], max_tokens, bucket=1)[0]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100) -> list[list[int]]:
        """Greedy generation of several prompts in one left-padded batch."""
        return self._generate_left_padded(token_lists, max_tokens, PROMPT_BUCKET)

    def _generate_left_padded(self, token_lists: list[list[int]], max_tokens: int, bucket: int) -> list[list[int]]:
        if not token_lists:
            raise ValueError("generation needs at least one prompt")
        cfg = self.model.cfg
        if max_tokens <= 0:
            return [list(ts) for ts in token_lists]
        max_n = max(len(ts) for ts in token_lists)
        pad = min(-(-max_n // bucket) * bucket, cfg.max_seq_len)
        if max_n > pad:
            raise ValueError(f"prompt too long for context {cfg.max_seq_len}")
        if pad >= cfg.max_seq_len:  # no room left to generate
            return [list(ts) for ts in token_lists]
        b = len(token_lists)
        buf = np.zeros((b, pad), np.int64)
        pad_lens = np.zeros((b,), np.int32)
        for i, ts in enumerate(token_lists):  # LEFT-pad: right-align each row
            pad_lens[i] = pad - len(ts)
            buf[i, pad_lens[i]:] = ts

        limit = min(pad + max_tokens, cfg.max_seq_len)
        dev = self.model.device
        out, lengths = _generate_batch(self.model.params, cfg, torch.from_numpy(buf).to(dev),
                                       torch.from_numpy(pad_lens).to(dev), limit, _eos_id(self.tokenizer))
        return [out[i, pad_lens[i]: lengths[i]].tolist() for i in range(b)]

    def score_tokens(self, tokens: list[int]) -> list[float]:
        """Per-token log-probs ``log p(x_t | x_<t)`` for t >= 1. Length: len(tokens) - 1."""
        return self.score_tokens_batch([tokens])[0]

    def score_tokens_batch(self, token_lists: list[list[int]]) -> list[list[float]]:
        """Batched :meth:`score_tokens` over right-padded rows."""
        if not token_lists:
            raise ValueError("score_tokens_batch needs at least one sequence")
        cfg = self.model.cfg
        if any(len(ts) < 2 for ts in token_lists):
            raise ValueError("scoring needs >= 2 tokens")
        max_n = max(len(ts) for ts in token_lists)
        if max_n > cfg.max_seq_len:
            raise ValueError(f"sequence too long for context {cfg.max_seq_len}")
        pad = min(-(-max_n // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        b = len(token_lists)
        buf = np.zeros((b, pad), np.int64)
        ns = np.zeros((b,), np.int64)
        for i, ts in enumerate(token_lists):
            buf[i, : len(ts)] = ts
            ns[i] = len(ts)
        dev = self.model.device
        ll = _score_tokens(self.model.params, cfg, torch.from_numpy(buf).to(dev), torch.from_numpy(ns).to(dev))
        ll = ll.cpu().numpy()
        return [ll[i, : ns[i] - 1].tolist() for i in range(b)]

    def perplexity(self, text: str) -> float:
        """exp(-mean per-token log-prob) of the tokenized text."""
        lls = self.score_tokens(self.tokenizer.encode(text))
        return float(np.exp(-np.mean(lls)))
