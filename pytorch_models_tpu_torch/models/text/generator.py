"""Generation and scoring with a KV-cached decode loop (PyTorch port of
``pytorch_models_tpu/models/text/generator.py``).

Prompts are LEFT-padded to a ``PROMPT_BUCKET`` multiple so every row ends at
the same cache slot; one prefill fills the caches, then a Python loop runs
fixed-shape single-token steps. The step follows the JAX package's
``_generate_batch_body`` / ``_decode_rows``: per-row position ids clipped at
0, the pad mask threaded to attention, finished rows parked on EOS, and each
row's length cut at its first generated EOS. The caches are layer-stacked
buffers with per-layer views. When the fused step serves the model and
batch (``ops/attention.py`` ``USE_FUSED_STEP``, auto on CUDA tensors), the
weights are packed once per call and each step is ONE kernel launch after
the step embedding: greedy, the layer stack + final norm + argmax; sampled,
the layer stack alone (the headless step), then the head matmul and the
sampler. int8 serving: ``model.quantize_int8()`` (w8a16 weights;
``USE_A8_DECODE`` for w8a8 and the int8 head) and ``USE_INT8_KV`` (the
prefilled cache quantized once, as in the JAX package: on the fused route
of ``generate_tokens_batch`` only).

Sampling (greedy, top-k, top-p/nucleus, temperature) draws ONE uniform per
row per step from a ``torch.Generator`` seeded with ``seed`` and picks the
token by inverse CDF over the renormalised fp32 probabilities of the
candidates, sorted by a stable descending sort (equal logits keep the lower
index first, as ``lax.top_k`` does). Every route draws the same uniforms, so
the fused, per-op and plain routes give the same tokens except where a draw
lies on a CDF boundary that their summation orders move. The stream is not
JAX's (its PRNG cannot be matched); beam search is in ``beam.py``.
Speculative decoding is ``speculative.py``; a CUDA graph of the step is
later work.
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
    decoder_lm_hidden_fused_batch,
    decoder_lm_make_cache,
    decoder_lm_pack,
    tied_logits,
)

PROMPT_BUCKET = 64  # prompts are padded to a multiple of this (the JAX package's bucket)
DONE_CHECK_EVERY = 8  # decode steps between host reads of the all-rows-done flag


def _eos_id(tokenizer) -> int:
    eos = getattr(tokenizer, "eos_token_id", None)
    return -1 if eos is None else eos  # -1 never matches


def _check_sampling(topk: int, top_p, temperature) -> None:
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if not temperature > 0.0:
        raise ValueError(f"temperature must be > 0 (use topk=1 for greedy), got {temperature}")


def _is_greedy(topk: int, top_p) -> bool:
    return topk == 1 and top_p is None


def _parse_sampling_params(n_req: int, topk: int, top_p, temperature):
    """Per-request sampling params for the serving engines: ``temperature``
    and ``top_p`` may be lists (length ``n_req``); ``topk`` and the nucleus
    on/off mode are per call. Returns ``(greedy, has_tp, temps_l, tps_l)``."""
    temps_l = list(temperature) if isinstance(temperature, (list, tuple)) else [temperature] * n_req
    has_tp = top_p is not None
    tps_l = (list(top_p) if isinstance(top_p, (list, tuple)) else [top_p] * n_req) if has_tp else [None] * n_req
    if len(temps_l) != n_req or len(tps_l) != n_req:
        raise ValueError("per-request temperature/top_p lists must have one entry per request")
    for tp_r, tm_r in zip(tps_l, temps_l):
        if has_tp and tp_r is None:
            raise ValueError("mixed top_p on/off is per call")
        _check_sampling(topk, tp_r, tm_r)
    return _is_greedy(topk, 1.0 if has_tp else None), has_tp, temps_l, tps_l


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, descending,
    equal values in index order (a stable sort; ``torch.topk`` leaves the
    order of ties undefined)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _nucleus_mask(vals: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask DESC-sorted logits outside the smallest set with prob mass >= top_p.

    The token that crosses the threshold is kept (standard nucleus rule), so
    at least one token always survives."""
    probs = torch.softmax(vals.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    return torch.where(keep, vals, torch.finfo(vals.dtype).min)


def _inverse_cdf(vals: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index into DESC-sorted logits ``vals`` (..., k) drawn by the uniforms
    ``u`` (...): the first entry whose fp32 CDF exceeds ``u`` times the total.
    Masked entries (probability 0) are never drawn: the choice is held to the
    last entry of positive probability."""
    p = torch.softmax(vals.float(), dim=-1)
    cdf = torch.cumsum(p, dim=-1)
    choice = (cdf <= u[..., None] * cdf[..., -1:]).sum(-1)
    return torch.minimum(choice, (p > 0).sum(-1) - 1)


def _sample(logits: torch.Tensor, gen: torch.Generator | None, topk: int, top_p=None,
            temperature: float = 1.0) -> torch.Tensor:
    """Greedy / top-k / top-p / combined sampling over (..., V) logits:
    int64 ids (...). ``topk == 1`` with ``top_p`` set is nucleus sampling
    over the whole vocabulary. Greedy takes the first argmax and draws
    nothing; otherwise ONE uniform per row from ``gen`` (a generator on the
    logits' device), whatever the settings."""
    if _is_greedy(topk, top_p):
        return torch.argmax(logits, dim=-1)
    k = topk if topk > 1 else logits.shape[-1]
    vals, idx = _top_k(logits / temperature, k)
    if top_p is not None:
        vals = _nucleus_mask(vals, top_p)
    u = torch.rand(logits.shape[:-1], generator=gen, device=logits.device)
    return torch.gather(idx, -1, _inverse_cdf(vals, u)[..., None])[..., 0]


@torch.inference_mode()
def _generate_batch(params, cfg, prompt_buf: torch.Tensor, pad_lens: torch.Tensor, limit: int, eos_id: int,
                    topk: int = 1, seed: int = 0, top_p=None, temperature: float = 1.0):
    """Batched generation over LEFT-padded prompts.

    ``prompt_buf``: (B, P) with each row's tokens right-aligned; ``pad_lens``:
    (B,) int32 left-pad count per row. Returns ``(tokens (B, max_seq_len),
    lengths (B,))`` on the host; row i's output occupies ``[pad_i, len_i)``.
    """
    b, p_len = prompt_buf.shape
    dev = prompt_buf.device
    pos_ids = (torch.arange(p_len, device=dev)[None, :] - pad_lens[:, None].long()).clamp_min(0)

    fused = decoder_lm_fused_ok(params, cfg, b)
    # the per-op prefill writes through per-layer views of the stacked buffers the fused step reads
    caches, stacked = decoder_lm_make_cache(cfg, (b,), dtype=params["token_embs"].dtype, device=dev)
    logits, caches = decoder_lm_forward_cached_batch(params, cfg, prompt_buf, pos_ids, caches, 0, pad_lens)
    if fused and _attn.use_int8_kv(b):
        # int8 self-KV (ops/attention.py USE_INT8_KV): the prefilled cache is quantized once; each fused step
        # writes its K/V quantized
        stacked = quantize_kv_caches(stacked)

    buf = torch.zeros((b, cfg.max_seq_len), dtype=torch.int64, device=dev)
    buf[:, :p_len] = prompt_buf
    # rows are right-aligned: slot P-1 is each row's last prompt token
    return _decode_rows(params, cfg, fused, buf, p_len, logits[:, -1], caches, stacked, pad_lens, limit, eos_id,
                        topk, seed, top_p, temperature)


def _decode_rows(params, cfg, fused: bool, buf, p_len: int, last, caches, stacked, pad_lens, limit: int,
                 eos_id: int, topk: int, seed: int, top_p, temperature: float):
    """Shared decode loop over B prefilled rows: sample each row's first
    token from ``last`` (B, V), then single-token steps until every row hit
    EOS or ``limit``: the fused step when ``fused`` (with the greedy head,
    or headless when sampling), else per-op (with the greedy head kernel
    when greedy and its gate allows). Returns ``(buf (B, max_seq_len),
    lengths (B,))`` on the host."""
    greedy = _is_greedy(topk, top_p)
    b = buf.shape[0]
    gen = None if greedy else torch.Generator(device=buf.device).manual_seed(seed)
    if fused:
        packed, head = decoder_lm_pack(params, cfg)
    nxt = _sample(last, gen, topk, top_p, temperature)
    buf[:, p_len] = nxt
    done = nxt == eos_id
    eos = torch.full_like(nxt, eos_id)
    greedy_head = greedy and not fused and _attn.use_greedy_head(b, params["token_embs"], tied=True)

    pos = p_len + 1
    while pos < limit:
        # rows done early keep stepping (parked on EOS) until the next check:
        # the output is the same, and the host reads the flag less often
        if (pos - p_len - 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        tok = buf[:, pos - 1:pos]
        p_ids = (pos - 1 - pad_lens.long())[:, None]
        if fused and greedy:  # layer stack + final norm + argmax in ONE kernel
            nxt = decoder_lm_fused_tok_batch(params, packed, head, cfg, tok, p_ids, stacked, pos - 1, pad_lens)
        elif fused:  # the headless step, then the head matmul and the sampler
            hidden = decoder_lm_hidden_fused_batch(params, packed, cfg, tok, p_ids, stacked, pos - 1, pad_lens)
            nxt = _sample(tied_logits(params, hidden[:, 0]), gen, topk, top_p, temperature)
        elif greedy_head:
            hidden, caches = decoder_lm_hidden_cached_batch(params, cfg, tok, p_ids, caches, pos - 1, pad_lens)
            nxt = greedy_argmax_tied(hidden[:, 0], params["token_embs"].to(hidden.dtype))
        else:
            logits, caches = decoder_lm_forward_cached_batch(params, cfg, tok, p_ids, caches, pos - 1, pad_lens)
            nxt = _sample(logits[:, 0], gen, topk, top_p, temperature)
        nxt = torch.where(done, eos, nxt)  # finished rows stay parked on EOS
        buf[:, pos] = nxt
        done = done | (nxt == eos_id)
        pos += 1

    # per-row length: first EOS among actually generated slots, else `pos`
    out = buf.cpu().numpy()
    is_eos = out[:, p_len:pos] == eos_id
    lengths = np.where(is_eos.any(axis=1), p_len + is_eos.argmax(axis=1) + 1, pos)
    return out, lengths


@torch.inference_mode()
def _generate_samples(params, cfg, prompt_buf: torch.Tensor, pad_len: int, limit: int, eos_id: int, n: int,
                      topk: int, seed: int, top_p, temperature: float):
    """N independent samples of ONE prompt with a SHARED prefill: the prompt
    (P,), LEFT-padded by ``pad_len``, is forwarded once, its cache prefix
    copied to ``n`` rows, and the rows decode through :func:`_decode_rows`:
    token-identical to generating ``n`` copies of the prompt, minus n - 1
    prefills. Returns ``(tokens (n, max_seq_len), lengths (n,))``."""
    p_len = prompt_buf.shape[0]
    dev = prompt_buf.device
    pad1 = torch.full((1,), pad_len, dtype=torch.int32, device=dev)
    pos_ids = (torch.arange(p_len, device=dev)[None, :] - pad_len).clamp_min(0)
    dtype = params["token_embs"].dtype
    one, _ = decoder_lm_make_cache(cfg, (1,), dtype=dtype, device=dev)
    logits, one = decoder_lm_forward_cached_batch(params, cfg, prompt_buf[None], pos_ids, one, 0, pad1)

    caches, stacked = decoder_lm_make_cache(cfg, (n,), dtype=dtype, device=dev)
    for view, src in zip(caches, one):  # the prefilled prefix, broadcast to the n rows
        for k in ("k", "v"):
            view[k][:, :p_len] = src[k][:, :p_len]
    buf = torch.zeros((n, cfg.max_seq_len), dtype=torch.int64, device=dev)
    buf[:, :p_len] = prompt_buf
    return _decode_rows(params, cfg, decoder_lm_fused_ok(params, cfg, n), buf, p_len, logits[:, -1].expand(n, -1),
                        caches, stacked, pad1.expand(n).contiguous(), limit, eos_id, topk, seed, top_p, temperature)


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
    """Generation, beam search and scoring over a decoder-only LM
    (``model.params``, ``model.cfg``, ``model.device``) and a tokenizer
    (``eos_token_id``; ``encode``/``decode`` for the string methods)."""

    def __init__(self, model, tokenizer) -> None:
        self.model = model
        self.tokenizer = tokenizer

    def generate(self, prompt: str, max_tokens: int = 100, topk: int = 1, seed: int = 0,
                 top_p: float | None = None, temperature: float = 1.0) -> str:
        out = self.generate_tokens(self.tokenizer.encode(prompt), max_tokens=max_tokens, topk=topk, seed=seed,
                                   top_p=top_p, temperature=temperature)
        return self.tokenizer.decode(out)

    def generate_tokens(self, tokens: list[int], max_tokens: int = 100, topk: int = 1, seed: int = 0,
                        top_p: float | None = None, temperature: float = 1.0) -> list[int]:
        """Greedy (default), top-k, top-p/nucleus or combined sampling of one
        prompt; ``temperature`` rescales logits when sampling. As in the JAX
        package: greedy with the fused step runs as a batch of one through
        :meth:`generate_tokens_batch` (``PROMPT_BUCKET`` padding: the budget
        is ``min(pad + max_tokens, max_seq_len)`` and a prompt whose padded
        length reaches the context generates nothing); otherwise with no
        bucket padding, so the budget is ``min(n + max_tokens,
        max_seq_len)``."""
        _check_sampling(topk, top_p, temperature)
        if max_tokens <= 0 or len(tokens) >= self.model.cfg.max_seq_len:
            return list(tokens)
        sampling = dict(topk=topk, seed=seed, top_p=top_p, temperature=temperature)
        if _is_greedy(topk, top_p) and decoder_lm_fused_ok(self.model.params, self.model.cfg, 1):
            return self.generate_tokens_batch([tokens], max_tokens)[0]
        return self._generate_left_padded([tokens], max_tokens, 1, sampling)[0]

    def generate_batch(self, prompts: list[str], max_tokens: int = 100, topk: int = 1, seed: int = 0,
                       top_p: float | None = None, temperature: float = 1.0) -> list[str]:
        """Batched generation over several prompts."""
        outs = self.generate_tokens_batch([self.tokenizer.encode(p) for p in prompts], max_tokens=max_tokens,
                                          topk=topk, seed=seed, top_p=top_p, temperature=temperature)
        return [self.tokenizer.decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100, topk: int = 1,
                              seed: int = 0, top_p: float | None = None,
                              temperature: float = 1.0) -> list[list[int]]:
        """Generation of several prompts in one left-padded batch."""
        _check_sampling(topk, top_p, temperature)
        return self._generate_left_padded(token_lists, max_tokens, PROMPT_BUCKET,
                                          dict(topk=topk, seed=seed, top_p=top_p, temperature=temperature))

    def _generate_left_padded(self, token_lists: list[list[int]], max_tokens: int, bucket: int,
                              sampling: dict) -> list[list[int]]:
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
                                       torch.from_numpy(pad_lens).to(dev), limit, _eos_id(self.tokenizer),
                                       **sampling)
        return [out[i, pad_lens[i]: lengths[i]].tolist() for i in range(b)]

    def generate_samples(self, prompt: str, n: int, max_tokens: int = 100, topk: int = 40, seed: int = 0,
                         top_p: float | None = None, temperature: float = 1.0) -> list[str]:
        """N independent samples of one prompt with a SHARED prefill (the
        prompt is forwarded once and its KV cache fans out to the n rows):
        best-of-n / self-consistency serving. Token-identical to
        :meth:`generate_batch` over n copies of the prompt."""
        outs = self.generate_tokens_samples(self.tokenizer.encode(prompt), n, max_tokens=max_tokens, topk=topk,
                                            seed=seed, top_p=top_p, temperature=temperature)
        return [self.tokenizer.decode(o) for o in outs]

    def generate_tokens_samples(self, tokens: list[int], n: int, max_tokens: int = 100, topk: int = 40,
                                seed: int = 0, top_p: float | None = None,
                                temperature: float = 1.0) -> list[list[int]]:
        """Token-level :meth:`generate_samples`. With greedy settings
        (``topk=1``, no ``top_p``) all n rows are identical by construction."""
        _check_sampling(topk, top_p, temperature)
        if n < 1:
            raise ValueError(f"generate_tokens_samples needs n >= 1, got {n}")
        cfg = self.model.cfg
        if max_tokens <= 0:
            return [list(tokens) for _ in range(n)]
        pad = min(-(-max(len(tokens), 1) // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        if len(tokens) > pad:
            raise ValueError(f"prompt too long for context {cfg.max_seq_len}")
        if pad >= cfg.max_seq_len:
            return [list(tokens) for _ in range(n)]
        buf = np.zeros((pad,), np.int64)
        pad_len = pad - len(tokens)
        buf[pad_len:] = tokens
        limit = min(pad + max_tokens, cfg.max_seq_len)
        out, lengths = _generate_samples(self.model.params, cfg, torch.from_numpy(buf).to(self.model.device),
                                         pad_len, limit, _eos_id(self.tokenizer), n, topk, seed, top_p, temperature)
        return [out[i, pad_len: lengths[i]].tolist() for i in range(n)]

    def beam_search(self, prompt: str, max_tokens: int = 100, beam_width: int = 4,
                    length_penalty: float = 0.0) -> str:
        out = self.beam_search_tokens(self.tokenizer.encode(prompt), max_tokens, beam_width, length_penalty)
        return self.tokenizer.decode(out)

    def beam_search_tokens(self, tokens: list[int], max_tokens: int = 100, beam_width: int = 4,
                           length_penalty: float = 0.0, return_all: bool = False):
        """Beam-search decoding. Returns the best sequence, or ``(sequences,
        scores)`` with ``return_all``: see models/text/beam.py."""
        from .beam import beam_search_tokens

        return beam_search_tokens(self.model, tokens, max_tokens, beam_width, _eos_id(self.tokenizer),
                                  length_penalty, return_all)

    def beam_search_batch(self, prompts: list[str], max_tokens: int = 100, beam_width: int = 4,
                          length_penalty: float = 0.0) -> list[str]:
        """Beam search over several prompts in one batched decode."""
        outs = self.beam_search_tokens_batch([self.tokenizer.encode(p) for p in prompts], max_tokens, beam_width,
                                             length_penalty)
        return [self.tokenizer.decode(o) for o in outs]

    def beam_search_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100, beam_width: int = 4,
                                 length_penalty: float = 0.0, return_all: bool = False):
        """Batched :meth:`beam_search_tokens`: all G*W beam rows of the G
        prompts step together through the batched decode path. Returns the
        best sequence per prompt, or ``(sequences, scores)`` lists with
        ``return_all``: see models/text/beam.py."""
        from .beam import beam_search_tokens_batch

        return beam_search_tokens_batch(self.model, token_lists, max_tokens, beam_width, _eos_id(self.tokenizer),
                                        length_penalty, return_all)

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
