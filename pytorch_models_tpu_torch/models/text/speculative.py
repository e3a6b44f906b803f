"""Speculative decoding: a small draft model proposes k tokens, the target
verifies them in ONE chunked KV-cached forward (PyTorch port of
``pytorch_models_tpu/models/text/speculative.py``).

Greedy speculative decoding is EXACT: the emitted sequence is
token-identical to the target's own greedy decode for ANY draft (accepted
drafts equal the target argmax by construction; the first mismatch is
replaced by the target argmax). The draft only changes the speed.

Loop mechanics, as in the JAX package:
- buffer slots at or after ``pos`` are scratch: drafts are written there
  and not advanced over when rejected; rejected cache slots are masked by
  position and rewritten by the next iteration;
- the verify chunk re-feeds the last accepted token at ``pos - 1`` (its
  logits verify draft 0);
- the loop stops once ``pos + k > l_max`` (up to k tokens before the
  context ends); the length is clamped to ``limit`` and the output cut at
  the first EOS;
- the correction write at the buffer edge (all k accepted at ``pos = l_max
  - k``) is a no-op;
- both models prefill the whole right-padded ``PROMPT_BUCKET`` bucket, and
  when all k drafts are accepted the draft never refills slot ``pos+k-1``:
  the next iteration reads what that slot held (a pad token's K/V from the
  prefill, or an earlier iteration's). This is the JAX package's cache, kept
  as it is: it sets the acceptance rate.

Routes. One loop serves one row and many: positions, budgets, acceptance
and the stop are per row on the device, finished rows park (they compute at
in-bounds slots and their results are discarded), and each iteration makes
one host read. One row reads its position with it and runs at host-integer
positions: each draft step is ONE launch of the fused decode step
(``ops/decode_step.py``, K7 at B=1, which takes its position as a host
integer) where its gate serves the draft (greedy with the in-kernel head;
sampled headless, then the tied head), else per-op. Batched calls read
whether any row is live and run at per-row positions
(``transformer.mha_apply``'s per-row ``cache_pos``): each draft step is ONE
batched per-op pass over every row (K7 takes one position for all rows, as
the JAX package's batched path also leaves its fused step). The verify
chunk is the per-op S = k+1 cached forward.

Sampling (top-k / top-p / temperature) is rejection sampling (Leviathan et
al. 2023, Chen et al. 2023): draft token x_j ~ q_j is accepted with
probability min(1, p_j(x_j) / q_j(x_j)); the first rejection is replaced by
a draw from the normalised residual max(0, p_j - q_j), and when all k are
accepted a bonus token is drawn from p_k. The emitted tokens are then
distributed exactly as step-by-step sampling from the target's filtered
distribution, for any draft. JAX's PRNG stream cannot be matched: every
draw takes ONE counter-based uniform (``continuous._uniforms``) keyed by the
seed, the row and the ABSOLUTE buffer position, from one of three streams
(draft and bonus, accept, residual), as ``fold_in(key, pos)`` keys the JAX
package's draws; a token is drawn by inverse CDF over the full-vocabulary
probabilities. So a draft equal to the target reduces to a positional plain
sampler on the draft stream, and batched row r reproduces the one-row
sampler run as row r.
"""

from __future__ import annotations

from dataclasses import replace
import numpy as np
import torch

from ._decoder_lm import (
    chunk_positions,
    decoder_lm_forward_cached_batch,
    decoder_lm_fused_ok,
    decoder_lm_fused_tok_batch,
    decoder_lm_hidden_cached_batch,
    decoder_lm_hidden_fused_batch,
    decoder_lm_make_cache,
    decoder_lm_pack,
    tied_logits,
)
from .continuous import _uniforms
from .generator import PROMPT_BUCKET, _check_sampling, _eos_id, _is_greedy, _nucleus_mask, _top_k

DRAFT, ACCEPT, RESIDUAL = range(3)  # the sampler's uniform streams: draft and bonus draws, accept tests, residuals


def _stream_uniforms(seed: int, stream: int, rows: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """(B, m) uniforms of ``stream`` for row ``rows[b]`` (B,) at absolute
    buffer positions ``positions`` (B, m)."""
    req = (rows.long() * 3 + stream)[:, None].expand_as(positions)
    return _uniforms(seed, req, positions)


def _filtered_probs(logits: torch.Tensor, topk: int, top_p, temperature: float) -> torch.Tensor:
    """Full-vocabulary fp32 probabilities (..., V) of the distribution the
    port's ``generator._sample`` draws from: the top k of the
    temperature-scaled logits (ties to the lower id), then the nucleus; zero
    outside the kept set. ``topk == 1`` here means nucleus only."""
    v = logits.shape[-1]
    vals, idx = _top_k(logits / temperature, topk if topk > 1 else v)
    if top_p is not None:
        vals = _nucleus_mask(vals, top_p)
    pk = torch.softmax(vals.float(), dim=-1)
    return torch.zeros(logits.shape, dtype=torch.float32, device=logits.device).scatter_(-1, idx, pk)


def _sample_probs(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw from (..., V) probabilities by the uniforms ``u``
    (...): the first id whose cumulative probability exceeds ``u`` times the
    total. An id of probability 0 is never drawn (the choice is held to the
    last id of positive probability)."""
    cdf = torch.cumsum(probs, dim=-1)
    choice = (cdf <= u[..., None] * cdf[..., -1:]).sum(-1)
    ids = torch.arange(probs.shape[-1], device=probs.device)
    return torch.minimum(choice, torch.where(probs > 0, ids, 0).amax(-1))


def _accept_and_correct(q_probs, p_probs, drafts, pos, seed: int, rows):
    """The rejection-sampling core, per row: accept the leading run of
    drafts with probability min(1, p/q) each, then draw the correction,
    from the normalised residual max(0, p_{n_acc} - q_{n_acc}) after a
    rejection, or from p_k on the draft stream when all k are accepted (so
    that a draft equal to the target stays a positional plain sampler).

    ``q_probs`` (B, k, V) draft rows; ``p_probs`` (B, k+1, V) target rows;
    ``drafts`` (B, k), living at buffer positions ``pos + j`` (``pos`` an
    int or (B,)); ``rows`` (B,) the rows' counters. Returns ``(n_acc (B,),
    correction (B,))``."""
    b, k, v = q_probs.shape
    at = chunk_positions(pos, k + 1, b, drafts.device)  # absolute positions pos .. pos+k
    qd = q_probs.gather(2, drafts[..., None])[..., 0]
    pd = p_probs[:, :k].gather(2, drafts[..., None])[..., 0]
    us = _stream_uniforms(seed, ACCEPT, rows, at[:, :k])
    n_acc = torch.cumprod((us * qd < pd).long(), dim=1).sum(1)  # u < p/q without dividing by q
    sel = n_acc[:, None, None].expand(b, 1, v)
    p_na = p_probs.gather(1, sel)[:, 0]
    q_na = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1).gather(1, sel)[:, 0]
    residual = (p_na - q_na).clamp_min(0.0)
    rsum = residual.sum(-1, keepdim=True)
    residual = torch.where(rsum > 0, residual / rsum, p_na)  # p == q: the residual is p itself
    res_tok = _sample_probs(residual, _stream_uniforms(seed, RESIDUAL, rows, (at[:, 0] + n_acc)[:, None])[:, 0])
    bonus = _sample_probs(p_probs[:, k], _stream_uniforms(seed, DRAFT, rows, at[:, k:])[:, 0])
    return n_acc, torch.where(n_acc == k, bonus, res_tok)


def _greedy_accept(drafts, _aux, t_toks, _pos):
    """The leading run of drafts equal to the target's argmaxes (B, k+1),
    and the target's token after it."""
    k = drafts.shape[1]
    n_acc = torch.cumprod((drafts == t_toks[:, :k]).long(), dim=1).sum(1)
    return n_acc, t_toks.gather(1, n_acc[:, None])[:, 0]


def _put(buf: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor | None) -> None:
    """``buf[b, cols[b]] = vals[b]`` where ``mask[b]`` (every row when
    ``mask`` is None), in place."""
    idx, vals = cols[:, None], vals[:, None].to(buf.dtype)
    buf.scatter_(1, idx, vals if mask is None else torch.where(mask[:, None], vals, buf.gather(1, idx)))


def _run(draft, verify, accept, t_state, d_state, buf, pos0, done0, limit, k: int, eos_id: int, l_max: int):
    """The speculative loop over B rows (``buf`` (B, l_max)) at per-row
    positions on the device. Finished rows park: they compute at in-bounds
    slots and their writes are discarded. One host read per iteration: any
    row live, and for one row (``pos0`` an int) its position too, which the
    steps then take as a host integer (K7 takes its position so). Returns
    ``(tokens (B, l_max), lengths (B,), iterations)`` on the host."""
    b, dev = buf.shape[0], buf.device
    one_row = isinstance(pos0, int)
    pos = torch.full((b,), pos0, device=dev) if one_row else pos0
    limits = torch.full((b,), limit, device=dev) if one_row else limit
    done = done0
    ar = torch.arange(k, device=dev)
    iters = 0
    while True:  # slots [p, p+k) for drafts, [p-1, p+k) to verify
        live = ~done & (pos < limits) & (pos + k <= l_max)
        p = pos.clamp(max=l_max - k)  # a parked row computes at in-bounds slots; its results are discarded
        if one_row:
            any_live, p = torch.stack([live.any().long(), p[0]]).tolist()  # the iteration's one host read
        else:
            any_live = bool(live.any())  # the iteration's one host read
        if not any_live:
            break
        cols = chunk_positions(p - 1, k + 1, b, dev)
        aux = []
        for j in range(k):  # draft phase: k single-token steps into buf[p + j]
            nxt, a, d_state = draft(buf.gather(1, cols[:, j:j + 1]), d_state, p - 1 + j)
            _put(buf, cols[:, j + 1], nxt, None if one_row else live)
            aux.append(a)
        out, t_state = verify(buf.gather(1, cols), t_state, p - 1)  # verify phase: one (k+1)-token chunk
        drafts = buf.gather(1, cols[:, 1:])
        n_acc, corr = accept(drafts, aux, out, p)
        at = cols[:, 1] + n_acc
        _put(buf, at.clamp(max=l_max - 1), corr, live & (at < l_max))  # the buffer-edge write is a no-op
        # emitted this iteration: the accepted drafts and the correction (or bonus) token
        hit = ((ar < n_acc[:, None]) & (drafts == eos_id)).any(1) | (corr == eos_id)
        pos = torch.where(live, at + 1, pos)
        done = torch.where(live, hit, done)
        iters += 1
    return buf.cpu().numpy(), torch.minimum(pos, limits).cpu().numpy(), iters


def acceptance(emitted: int, iters: int, k: int) -> float | None:
    """The measured acceptance of a run that emitted ``emitted`` tokens in
    ``iters`` iterations (1 + accepted drafts an iteration), None without an
    iteration."""
    return (emitted / iters - 1) / k if iters else None


def spec_greedy_decode_loop(draft_step, verify_chunk, t_state, d_state, buf, pos0, done0, limit, k: int, eos_id: int,
                            l_max: int):
    """Model-agnostic greedy speculative loop (the T5 and Whisper generators
    reuse it with their own cached forwards).

    ``draft_step(tok (B, 1), d_state, pos) -> (next_tok (B,), d_state)``:
    one greedy draft step given the tokens at position ``pos``.
    ``verify_chunk(chunk (B, k+1), t_state, pos) -> (argmaxes (B, k+1),
    t_state)``: the target's argmaxes for a chunk at positions ``[pos,
    pos+k]``. ``buf`` (B, l_max) int64 on the device, everything below
    ``pos0`` decoded (the prompt and the first target token); ``done0`` (B,)
    bool. One row: ``pos0`` and ``limit`` ints (B = 1; host positions,
    which K7 takes); per-row: (B,) tensors. Returns ``(tokens (B, l_max),
    lengths (B,), iterations)`` on the host: the lengths clamped to
    ``limit``, the iterations the verify chunks run, from which
    :func:`acceptance` follows with ``emitted = length - pos0``."""
    def draft(tok, state, pos):
        nxt, state = draft_step(tok, state, pos)
        return nxt, None, state

    return _run(draft, verify_chunk, _greedy_accept, t_state, d_state, buf, pos0, done0, limit, k, eos_id, l_max)


def spec_sample_decode_loop(draft_probs, verify_probs, t_state, d_state, buf, pos0, done0, limit, k: int, eos_id: int,
                            seed: int, rows: torch.Tensor, l_max: int):
    """Model-agnostic speculative-sampling loop (the rejection-sampling core
    of the module docstring). ``draft_probs(tok (B, 1), d_state, pos) -> (q
    (B, V), d_state)``: the draft's filtered probabilities for position
    ``pos + 1``; the loop draws the draft token on the draft stream at that
    position. ``verify_probs(chunk (B, k+1), t_state, pos) -> (p (B, k+1,
    V), t_state)``: the target's filtered probabilities for the chunk at
    ``[pos, pos+k]``. ``rows`` (B,): each row's counter index. Buffers,
    positions, the stop and the result as :func:`spec_greedy_decode_loop`."""
    def draft(tok, state, pos):
        q, state = draft_probs(tok, state, pos)
        u = _stream_uniforms(seed, DRAFT, rows, chunk_positions(pos + 1, 1, rows.shape[0], q.device))[:, 0]
        return _sample_probs(q, u), q, state

    def accept(drafts, qs, p_probs, pos):
        return _accept_and_correct(torch.stack(qs, dim=1), p_probs, drafts, pos, seed, rows)

    return _run(draft, verify_probs, accept, t_state, d_state, buf, pos0, done0, limit, k, eos_id, l_max)


@torch.inference_mode()
def _spec_generate(params, cfg, draft_params, draft_cfg, prompt_buf: torch.Tensor, n_prompt, limit, k: int,
                   eos_id: int, sampler: tuple | None = None, row: int = 0, fused_draft: bool = True):
    """Prefill both models, then the speculative loop. ``prompt_buf`` (B, P)
    right-padded rows on the device. One row: ``n_prompt`` and ``limit``
    (prompt + budget) ints, the draft's steps through K7 at B=1 where its
    gate allows; per-row: (B,) int64 tensors, every step per-op.
    ``sampler``: None (greedy) or ``(topk, top_p, temperature, seed)``;
    the rows draw the sampler's counters of rows ``row, row + 1, ...``.
    ``fused_draft=False`` keeps the draft per-op (the JAX package's
    tensor-parallel loop, ``parallel/spec_serving.py``). Returns
    ``(tokens (B, max_seq_len) on the host, lengths, iterations)``."""
    one_row = isinstance(n_prompt, int)
    b = prompt_buf.shape[0]
    dev = prompt_buf.device
    l_max = cfg.max_seq_len
    if k >= l_max:
        raise ValueError(f"k={k} leaves no room to verify in a context of {l_max}")
    t_caches, _ = decoder_lm_make_cache(cfg, (b,), params["token_embs"].dtype, dev)
    d_caches, d_stacked = decoder_lm_make_cache(draft_cfg, (b,), draft_params["token_embs"].dtype, dev)
    # both models prefill the whole right-padded bucket, as in the JAX package (its pad slots are what the draft
    # reads where it does not refill a slot)
    at0 = chunk_positions(0, prompt_buf.shape[1], b, dev)
    hidden, _ = decoder_lm_hidden_cached_batch(params, cfg, prompt_buf, at0, t_caches, 0, None)
    decoder_lm_hidden_cached_batch(draft_params, draft_cfg, prompt_buf, at0, d_caches, 0, None)
    ids = torch.arange(b, device=dev)
    rows = ids + row  # the sampler's counters
    last = tied_logits(params, hidden[ids, n_prompt - 1])  # (B, V)
    buf = torch.zeros((b, l_max), dtype=torch.int64, device=dev)
    buf[:, :prompt_buf.shape[1]] = prompt_buf

    fused = fused_draft and one_row and decoder_lm_fused_ok(draft_params, draft_cfg, 1)
    if fused:
        d_packed, d_head = decoder_lm_pack(draft_params, draft_cfg)

    def draft_hidden(tok, caches, pos):  # (B, d) final normed hidden state of one draft step
        if fused:
            hidden = decoder_lm_hidden_fused_batch(draft_params, d_packed, draft_cfg, tok,
                                                   chunk_positions(pos, 1, b, dev), d_stacked, pos, None)
            return hidden[:, 0], caches
        hidden, caches = decoder_lm_hidden_cached_batch(draft_params, draft_cfg, tok, chunk_positions(pos, 1, b, dev),
                                                        caches, pos, None)
        return hidden[:, 0], caches

    def target_logits(chunk, caches, pos):  # (B, k+1, V) logits of the verify chunk at slots [pos, pos+k]
        return decoder_lm_forward_cached_batch(params, cfg, chunk, chunk_positions(pos, k + 1, b, dev), caches, pos,
                                               None)

    if sampler is None:
        first = torch.argmax(last, dim=-1)

        def draft_step(tok, caches, pos):
            if fused:  # layer stack + final norm + argmax in ONE kernel
                return decoder_lm_fused_tok_batch(draft_params, d_packed, d_head, draft_cfg, tok,
                                                  chunk_positions(pos, 1, b, dev), d_stacked, pos, None), caches
            hidden, caches = draft_hidden(tok, caches, pos)
            return torch.argmax(tied_logits(draft_params, hidden), dim=-1), caches

        def verify_chunk(chunk, caches, pos):
            logits, caches = target_logits(chunk, caches, pos)
            return torch.argmax(logits, dim=-1), caches
    else:
        topk, top_p, temperature, seed = sampler
        first = _sample_probs(_filtered_probs(last, topk, top_p, temperature),
                              _stream_uniforms(seed, DRAFT, rows, chunk_positions(n_prompt, 1, b, dev))[:, 0])

        def draft_probs(tok, caches, pos):  # the headless step, then the tied head
            hidden, caches = draft_hidden(tok, caches, pos)
            return _filtered_probs(tied_logits(draft_params, hidden), topk, top_p, temperature), caches

        def verify_probs(chunk, caches, pos):
            logits, caches = target_logits(chunk, caches, pos)
            return _filtered_probs(logits, topk, top_p, temperature), caches

    buf[ids, n_prompt] = first
    args = (t_caches, d_caches, buf, n_prompt + 1, first == eos_id, limit, k, eos_id)
    if sampler is None:
        return spec_greedy_decode_loop(draft_step, verify_chunk, *args, l_max)
    return spec_sample_decode_loop(draft_probs, verify_probs, *args, seed, rows, l_max)


def cut_at_eos(row: np.ndarray, start: int, eos_id: int) -> list[int]:
    """A result row cut after the first ``eos_id`` at or after ``start``."""
    hits = np.nonzero(row[start:] == eos_id)[0]
    return (row[: start + hits[0] + 1] if hits.size else row).tolist()


def truncate_decoder_lm(params: dict, cfg, n_layers: int, stacks=("decoder",)):
    """A draft from the target's own weights: the first ``n_layers`` of each
    of its ``stacks`` (T5 and Whisper cut both, encoder and decoder) with
    the shared embeddings, tables and final norms (no training). The prefix
    of a stack is a real, if crude, predictor of the whole stack's argmax.
    Returns ``(draft_params, draft_cfg)`` sharing tensors with the target.
    Each stack's dict is copied with its ``layers`` cut, not replaced by
    ``{"layers": ...}`` as in the JAX package, so its other entries carry
    over."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(f"a draft of {n_layers} layers from stacks of {cfg.n_layers}")
    draft = dict(params)
    for stack in stacks:
        draft[stack] = dict(params[stack], layers=params[stack]["layers"][:n_layers])
    return draft, replace(cfg, n_layers=n_layers)


class TruncatedDraft:
    """A draft model of ``model``'s first ``n_layers`` of ``stacks``
    (:func:`truncate_decoder_lm`): ``params``, ``cfg``, ``device``. Its
    ``params`` cut the target's CURRENT ``params`` at every read, so a cast
    or a quantization of the target after the draft was made (``to_bf16``,
    ``quantize_int8``) is the draft's too."""

    def __init__(self, model, n_layers: int, stacks=("decoder",)) -> None:
        self.model, self.stacks = model, stacks
        self.cfg = truncate_decoder_lm(model.params, model.cfg, n_layers, stacks)[1]

    @property
    def params(self) -> dict:
        return truncate_decoder_lm(self.model.params, self.model.cfg, self.cfg.n_layers, self.stacks)[0]

    @property
    def device(self):
        return self.model.device


class SpeculativeDecoderGenerator:
    """``DecoderGenerator`` accelerated by a draft model. Greedy (default)
    is token-identical to ``DecoderGenerator(model, tok).generate_tokens``
    for any draft; sampling (``topk``/``top_p``/``temperature``) is
    distribution-exact with respect to the target (module docstring). Draft
    and target share the tokenizer and the vocabulary, and lie on one device
    (``model.device``). After a greedy :meth:`generate_tokens` call,
    ``last_iters`` holds its iteration count (verify chunks run) and
    ``last_accept_rate`` its measured acceptance, ``(emitted / iters - 1) /
    k`` (None without an iteration); both are None before the first."""

    def __init__(self, model, draft_model, tokenizer, k: int = 4) -> None:
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
    def with_truncated_draft(cls, model, tokenizer, n_draft_layers: int, k: int = 4) -> SpeculativeDecoderGenerator:
        """The draft is the first ``n_draft_layers`` of the target's own
        stack (:func:`truncate_decoder_lm`): no extra weights. The output
        stays token-identical to plain greedy; the depth only moves the
        speed and the acceptance."""
        return cls(model, TruncatedDraft(model, n_draft_layers), tokenizer, k)

    def generate(self, prompt: str, max_tokens: int = 100, topk: int = 1, seed: int = 0,
                 top_p: float | None = None, temperature: float = 1.0) -> str:
        return self.tokenizer.decode(self.generate_tokens(self.tokenizer.encode(prompt), max_tokens, topk=topk,
                                                          seed=seed, top_p=top_p, temperature=temperature))

    def _bucket(self, ns: list[int]) -> int:
        cfg = self.model.cfg
        if not ns or min(ns) < 1:
            raise ValueError("speculative generation needs at least one non-empty prompt")
        pad = min(-(-max(ns) // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        if max(ns) > pad:
            raise ValueError(f"prompt too long for context {cfg.max_seq_len}")
        return pad

    def generate_tokens(self, tokens: list[int], max_tokens: int = 100, topk: int = 1, seed: int = 0,
                        top_p: float | None = None, temperature: float = 1.0) -> list[int]:
        """Greedy (default) or sampled speculative generation of one prompt
        (row 0 of the sampler's counters). The budget is ``min(n +
        max_tokens, max_seq_len)``; a prompt whose ``PROMPT_BUCKET`` padding
        reaches the context generates nothing, as in the JAX package."""
        _check_sampling(topk, top_p, temperature)
        n = len(tokens)
        pad = self._bucket([n])
        cfg = self.model.cfg
        if max_tokens <= 0 or pad >= cfg.max_seq_len:
            return list(tokens)
        buf = np.zeros((1, pad), np.int64)
        buf[0, :n] = tokens
        eos = _eos_id(self.tokenizer)
        greedy = _is_greedy(topk, top_p)
        out, lengths, iters = _spec_generate(
            self.model.params, cfg, self.draft_model.params, self.draft_model.cfg,
            torch.from_numpy(buf).to(self.model.device), n, min(n + max_tokens, cfg.max_seq_len), self.k, eos,
            None if greedy else (topk, top_p, temperature, seed))
        length = int(lengths[0])
        if greedy:
            self.last_iters, self.last_accept_rate = iters, acceptance(length - (n + 1), iters, self.k)
        return cut_at_eos(out[0, :length], n, eos)

    def generate_batch(self, prompts: list[str], max_tokens: int = 100, topk: int = 1, seed: int = 0,
                       top_p: float | None = None, temperature: float = 1.0) -> list[str]:
        """Batched speculative generation over several prompts."""
        outs = self.generate_tokens_batch([self.tokenizer.encode(p) for p in prompts], max_tokens, topk=topk,
                                          seed=seed, top_p=top_p, temperature=temperature)
        return [self.tokenizer.decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100, topk: int = 1,
                              seed: int = 0, top_p: float | None = None,
                              temperature: float = 1.0) -> list[list[int]]:
        """Batched :meth:`generate_tokens`: B right-padded rows draft and
        verify together with per-row acceptance, one batched per-op pass a
        step. Greedy rows are token-identical to the one-row path; sampled
        row r draws row r's counters."""
        _check_sampling(topk, top_p, temperature)
        ns = [len(t) for t in token_lists]
        pad = self._bucket(ns)
        cfg = self.model.cfg
        if max_tokens <= 0 or pad >= cfg.max_seq_len:
            return [list(t) for t in token_lists]
        buf = np.zeros((len(ns), pad), np.int64)  # RIGHT-padded rows
        for i, t in enumerate(token_lists):
            buf[i, :ns[i]] = t
        eos = _eos_id(self.tokenizer)
        dev = self.model.device
        n_t = torch.tensor(ns, dtype=torch.int64, device=dev)
        out, lengths, _ = _spec_generate(
            self.model.params, cfg, self.draft_model.params, self.draft_model.cfg, torch.from_numpy(buf).to(dev),
            n_t, (n_t + max_tokens).clamp(max=cfg.max_seq_len), self.k, eos,
            None if _is_greedy(topk, top_p) else (topk, top_p, temperature, seed))
        return [cut_at_eos(out[i, : lengths[i]], ns[i], eos) for i in range(len(ns))]
