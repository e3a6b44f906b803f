"""Fixed-shape batched beam search (PyTorch port of
``pytorch_models_tpu/models/text/beam.py``).

The W alive beams of each of G prompts ARE a batch: each step forwards all
G*W rows through the same KV-cached decode path the batched greedy loop
uses (the fused step headless, ``ops/decode_step.py``, where it serves the
batch: beam needs full logits, not the in-kernel argmax; else per-op),
expands to the top 2W candidates over each group's (W, V) scores, routes
EOS candidates into a W-slot finished pool, keeps the top W non-EOS as the
new alive set and reorders the self-attention caches by parent beam. The
loop core (:func:`beam_decode_loop_batched`) is model-agnostic: it takes
the per-step forward and a cache-reorder callback, so Whisper and T5 reuse
it.

Scoring: sum of token log-probs; ``length_penalty`` alpha divides by
``len_generated ** alpha`` (alpha=0: pure log-prob). 2W candidates give at
least W non-EOS continuations (each parent contributes at most one EOS
candidate).

As in the JAX package: every top-k is ``lax.top_k``'s (a stable descending
sort, equal scores in index order), so ties between ``NEG_INF`` slots fall
the same way. Unlike it: the cache reorder gathers only the written prefix
``[0, pos)`` into a second buffer that then swaps with the first
(:func:`reorder_caches`), and the host reads the loop's stop flag every
``DONE_CHECK_EVERY`` steps; the steps between the stop and that read
change nothing (the state is frozen by an on-device flag).
"""

from __future__ import annotations

import numpy as np
import torch

from ._decoder_lm import (
    decoder_lm_forward_cached_batch,
    decoder_lm_fused_ok,
    decoder_lm_hidden_fused_batch,
    decoder_lm_make_cache,
    decoder_lm_pack,
    tied_logits,
)
from .generator import DONE_CHECK_EVERY, PROMPT_BUCKET, _top_k

# finite: -inf would NaN through masked softmax rows
NEG_INF = -1e30


def _length_penalty(n_gen, alpha: float) -> torch.Tensor:
    """``max(n_gen, 1) ** alpha`` in fp32 (``n_gen`` an int or a tensor)."""
    return torch.as_tensor(n_gen).clamp_min(1).float().pow(alpha)


def _views(stacked: dict) -> list:
    return [{"k": stacked["k"][i], "v": stacked["v"][i]} for i in range(stacked["k"].shape[0])]


def beam_caches(stacked: dict) -> tuple:
    """Self caches for the beam loop, from layer-stacked ``{"k", "v"}: (L,
    R, Lp, H*D)`` buffers over the R beam rows: ``(views, stacked,
    spare)``, the per-layer views the per-op step writes through, the
    buffers the fused step reads, and a second pair of buffers that
    :func:`reorder_caches` fills (zeros, as the slots of a fresh cache: the
    plain attention reads every slot, masked)."""
    return _views(stacked), stacked, {k: torch.zeros_like(v) for k, v in stacked.items()}


def _gather_prefix(src: dict, idx: torch.Tensor, pos: int, dst: dict) -> None:
    for k in ("k", "v"):
        torch.index_select(src[k][:, :, :pos], 1, idx, out=dst[k][:, :, :pos])


def fan_out_caches(stacked: dict, idx: torch.Tensor, pos: int) -> tuple:
    """Beam caches of ``len(idx)`` rows whose written prefix ``[0, pos)`` is
    row ``idx[r]`` of ``stacked``'s (L, B, Lp, H*D) buffers."""
    shape = (stacked["k"].shape[0], idx.shape[0], *stacked["k"].shape[2:])
    out = {k: torch.zeros(shape, dtype=v.dtype, device=v.device) for k, v in stacked.items()}
    _gather_prefix(stacked, idx, pos, out)
    return beam_caches(out)


def reorder_caches(caches: tuple, idx: torch.Tensor, pos: int) -> tuple:
    """Beam row ``r`` takes row ``idx[r]``'s cache: the written prefix ``[0,
    pos)`` is gathered into the spare buffers, which become the caches (the
    slots from ``pos`` on are written before they are read)."""
    _, stacked, spare = caches
    _gather_prefix(stacked, idx, pos, spare)
    return _views(spare), spare, stacked


def beam_cross_caches(one: dict, w: int) -> tuple[list, dict]:
    """One prompt's cross caches (``precompute_cross_caches``' stacked
    ``{"k", "v": (L, 1, Lx, H*D), "len": (1,)}``) copied to the W beam rows:
    ``(per-layer caches, stacked)``, as ``precompute_cross_caches`` returns
    them. They stay as they are while the self caches reorder."""
    stacked = {k: one[k].expand(-1, w, -1, -1).contiguous() for k in ("k", "v")}
    stacked["len"] = one["len"].expand(w).contiguous()
    return [{"k": k, "v": v, "len": stacked["len"]} for k, v in zip(stacked["k"], stacked["v"])], stacked


def beam_decode_loop_batched(forward, gather_caches, caches, last_logits: torch.Tensor, buf: torch.Tensor,
                             p_len: int, limit: int, w: int, eos_id: int, alpha: float):
    """Model-agnostic beam loop over G independent prompt groups of W beams.

    ``forward(tok (G*W, 1), caches, pos) -> (logits (G*W, V), caches)`` runs
    all groups' beams as one flat batch (``tok`` is the token at ``pos -
    1``); ``gather_caches(caches, idx (G*W,), pos) -> caches`` reorders the
    flat per-beam state (global row numbers; the cache slots ``[0, pos)``
    are written). ``last_logits``: (G, V) logits of each group's last prompt
    token; ``buf``: (G, W, L) int64 holding each group's prompt in ``[:,
    :, :p_len)`` (``p_len``, the common padded prompt length). Returns
    ``(seqs (G, W, L), scores (G, W), lengths (G, W))`` on the device,
    best-first per group, with still-alive beams merged in at the limit.
    Groups whose early-exit bound closes keep stepping until ALL close (a
    closed group's pool can only be offered worse candidates)."""
    g, v = last_logits.shape
    dev = buf.device

    # first expansion: all of a group's rows are the same beam: the top W
    # distinct first tokens (an EOS here finishes at once)
    scores, toks = _top_k(torch.log_softmax(last_logits.float(), dim=-1), w)  # (G, W)
    buf[:, :, p_len] = toks
    is_eos0 = toks == eos_id
    fin_buf = torch.where(is_eos0[..., None], buf, 0)
    fin_scores = torch.where(is_eos0, scores / _length_penalty(1, alpha), NEG_INF)
    fin_lens = torch.where(is_eos0, p_len + 1, 0)
    scores = torch.where(is_eos0, NEG_INF, scores)

    # optimistic alive bound: log-probs only decrease; the best final penalty
    # an alive beam can reach is at the longest generated length
    best_penalty = _length_penalty(limit - p_len, alpha).to(dev)
    running = torch.ones((), dtype=torch.bool, device=dev)
    end = torch.full((), p_len + 1, device=dev)  # the position at which the JAX loop stops
    rows = torch.arange(g, device=dev)[:, None] * w
    pos = p_len + 1
    while pos < limit:
        running = running & (scores.amax(1) / best_penalty > fin_scores.amin(1)).any()
        if (pos - p_len - 1) % DONE_CHECK_EVERY == 0 and not bool(running):
            break
        logits, caches = forward(buf.reshape(g * w, -1)[:, pos - 1:pos], caches, pos)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(g, w, v)
        top_scores, top_idx = _top_k((scores[:, :, None] + logp).reshape(g, w * v), 2 * w)  # (G, 2W)
        parents, toks = top_idx // v, top_idx % v
        is_eos = toks == eos_id
        cand_buf = torch.gather(buf, 1, parents[:, :, None].expand(-1, -1, buf.shape[2]))
        cand_buf[:, :, pos] = toks

        # finished pool: merge the EOS candidates, keep the best W per group
        cand_fin = torch.where(is_eos, top_scores / _length_penalty(pos + 1 - p_len, alpha), NEG_INF)
        new_fin_scores, keep = _top_k(torch.cat([fin_scores, cand_fin], 1), w)
        new_fin_buf = torch.gather(torch.cat([fin_buf, cand_buf], 1), 1, keep[:, :, None].expand(-1, -1, buf.shape[2]))
        new_fin_lens = torch.gather(torch.cat([fin_lens, torch.full_like(cand_fin, pos + 1, dtype=fin_lens.dtype)], 1),
                                    1, keep)

        # alive set: the best W non-EOS candidates; the caches follow their parents
        new_scores, sel = _top_k(torch.where(is_eos, NEG_INF, top_scores), w)
        new_buf = torch.gather(cand_buf, 1, sel[:, :, None].expand(-1, -1, buf.shape[2]))
        caches = gather_caches(caches, (rows + torch.gather(parents, 1, sel)).reshape(g * w), pos)

        # a stopped loop changes nothing (its later steps only run until the host reads the flag)
        buf = torch.where(running, new_buf, buf)
        scores = torch.where(running, new_scores, scores)
        fin_buf = torch.where(running, new_fin_buf, fin_buf)
        fin_scores = torch.where(running, new_fin_scores, fin_scores)
        fin_lens = torch.where(running, new_fin_lens, fin_lens)
        end = end + running
        pos += 1

    # merge the still-alive beams as length-limit finishes
    all_scores = torch.cat([fin_scores, scores / _length_penalty(end - p_len, alpha)], 1)
    out_scores, keep = _top_k(all_scores, w)
    seqs = torch.gather(torch.cat([fin_buf, buf], 1), 1, keep[:, :, None].expand(-1, -1, buf.shape[2]))
    lens = torch.gather(torch.cat([fin_lens, end.expand(g, w)], 1), 1, keep)
    return seqs, out_scores, lens


def beam_decode_loop(forward, gather_caches, caches, last_logits: torch.Tensor, buf: torch.Tensor, p_len: int,
                     limit: int, w: int, eos_id: int, alpha: float):
    """Single-prompt beam loop: the G=1 case of
    :func:`beam_decode_loop_batched`. ``forward(tok (W, 1), caches, pos) ->
    (logits (W, V), caches)``; ``last_logits``: (V,); ``buf``: (W, L) holding
    the prompt in ``[:, :p_len)``. Returns ``(seqs (W, L), scores (W,),
    lengths (W,))`` best-first."""
    seqs, scores, lens = beam_decode_loop_batched(forward, gather_caches, caches, last_logits[None], buf[None],
                                                  p_len, limit, w, eos_id, alpha)
    return seqs[0], scores[0], lens[0]


@torch.inference_mode()
def _beam_search_batch(params, cfg, prompt_bufs: torch.Tensor, pad_lens_g: torch.Tensor, limit: int, w: int,
                       eos_id: int, alpha: float):
    """Decoder-LM beam search over G prompts at once. ``prompt_bufs``: (G,
    P) int64, each row LEFT-padded to the shared bucket length;
    ``pad_lens_g``: (G,) int32 pad counts. The prefill runs once per prompt
    (G rows); the caches' prefix then fans out to the G*W beam rows. Returns
    ``(seqs (G, W, max_seq_len), scores (G, W), lengths (G, W))`` on the
    device, best-first per group."""
    g, p_len = prompt_bufs.shape
    dev = prompt_bufs.device
    pos_ids = (torch.arange(p_len, device=dev)[None, :] - pad_lens_g[:, None].long()).clamp_min(0)
    prefill, prefill_stacked = decoder_lm_make_cache(cfg, (g,), dtype=params["token_embs"].dtype, device=dev)
    logits, _ = decoder_lm_forward_cached_batch(params, cfg, prompt_bufs, pos_ids, prefill, 0, pad_lens_g)
    caches = fan_out_caches(prefill_stacked, torch.arange(g, device=dev).repeat_interleave(w), p_len)
    del prefill, prefill_stacked
    pad_lens = pad_lens_g.repeat_interleave(w)
    fused = decoder_lm_fused_ok(params, cfg, g * w)
    packed = decoder_lm_pack(params, cfg)[0] if fused else None

    buf = torch.zeros((g, w, cfg.max_seq_len), dtype=torch.int64, device=dev)
    buf[:, :, :p_len] = prompt_bufs[:, None]

    def forward(tok, caches, pos):
        p_ids = (pos - 1 - pad_lens.long())[:, None]
        if fused:
            hidden = decoder_lm_hidden_fused_batch(params, packed, cfg, tok, p_ids, caches[1], pos - 1, pad_lens)
            return tied_logits(params, hidden[:, 0]), caches
        lg, _ = decoder_lm_forward_cached_batch(params, cfg, tok, p_ids, caches[0], pos - 1, pad_lens)
        return lg[:, 0], caches

    return beam_decode_loop_batched(forward, reorder_caches, caches, logits[:, -1], buf, p_len, limit, w, eos_id,
                                    alpha)


def _check_beam(beam_width: int, length_penalty: float) -> None:
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    if length_penalty < 0.0:
        raise ValueError("a negative length_penalty breaks the early-stop bound")


def beam_search_tokens_batch(model, token_lists, max_tokens: int = 100, beam_width: int = 4, eos_id: int = -1,
                             length_penalty: float = 0.0, return_all: bool = False):
    """Beam-search continuations of G prompts in one batched decode (all G*W
    beam rows step together). Returns a list of best sequences, or
    ``(sequences (G lists of W), scores (G lists of W))`` with
    ``return_all`` (best first per prompt; scores are length-penalized
    log-probs)."""
    _check_beam(beam_width, length_penalty)
    cfg = model.cfg
    g = len(token_lists)
    ns = [len(t) for t in token_lists]
    if g < 1 or min(ns) < 1:
        raise ValueError("beam search needs at least one non-empty prompt")
    n_max = max(ns)
    p_len = min(-(-n_max // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
    if max_tokens <= 0 or n_max >= cfg.max_seq_len or p_len >= cfg.max_seq_len:
        outs = [list(t) for t in token_lists]
        return ([[o] for o in outs], [[0.0]] * g) if return_all else outs
    prompt_bufs = np.zeros((g, p_len), np.int64)
    pad_lens = np.zeros((g,), np.int32)
    for i, t in enumerate(token_lists):  # left-pad: the beams ride the batched path
        pad_lens[i] = p_len - ns[i]
        prompt_bufs[i, pad_lens[i]:] = t
    limit = min(p_len + max_tokens, cfg.max_seq_len)
    dev = model.device
    seqs, scores, lens = _beam_search_batch(model.params, cfg, torch.from_numpy(prompt_bufs).to(dev),
                                            torch.from_numpy(pad_lens).to(dev), limit, beam_width, eos_id,
                                            float(length_penalty))
    seqs, scores, lens = seqs.cpu().numpy(), scores.cpu().numpy(), lens.cpu().numpy()
    outs = [[seqs[i, j, pad_lens[i]: lens[i, j]].tolist() for j in range(beam_width)] for i in range(g)]
    if return_all:
        return outs, [scores[i].tolist() for i in range(g)]
    return [o[0] for o in outs]


def beam_search_tokens(model, tokens: list[int], max_tokens: int = 100, beam_width: int = 4, eos_id: int = -1,
                       length_penalty: float = 0.0, return_all: bool = False):
    """Beam-search continuation of ``tokens``: the G=1 case of
    :func:`beam_search_tokens_batch`. Returns the best sequence, or
    ``(sequences, scores)`` for all ``beam_width`` beams with ``return_all``
    (best first; scores are length-penalized log-probs)."""
    out = beam_search_tokens_batch(model, [tokens], max_tokens, beam_width, eos_id, length_penalty, return_all)
    if return_all:
        return out[0][0], out[1][0]
    return out[0]
