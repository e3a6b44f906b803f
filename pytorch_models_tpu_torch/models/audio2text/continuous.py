"""Continuous batching for Whisper transcription (PyTorch port of
``pytorch_models_tpu/models/audio2text/continuous.py``): a fixed pool of
decoder slots serves 30 s segments with mid-flight admission, on the host
scheduler of the decoder-LM engine (``models/text/continuous.py``).

A pool of B slots runs one shared decode loop; the moment a slot's
transcript finishes the next segment is admitted, its log-mel frontend,
encoder and cross-attention K/V computed once at admission while the other
rows keep their state.

- All rows share one monotonic cache position ``pos``. A segment admitted at
  ``pos`` puts its I initial tokens at buffer and cache slots ``[pos-I,
  pos)`` and sets ``pad_lens[row] = pos-I``: the left-pad mask hides every
  earlier slot, the previous transcript's stale self-KV included, so no
  cache is cleared.
- Admission writes the segment's cross-attention K/V over the slot's cross
  cache (each row attends to its own memory through the per-row ``len``)
  and prefills the row's self-KV over the chunk ``[pos-1-I, pos-1)`` (its
  first slot is pad-masked); the next decode step takes the last initial
  token like any other row's.
- Every row reads the position-table row ``pos - 1 - pad_lens[row]``, its
  own position: each slot's math is that of a fresh batch row, so outputs
  are token-identical to ``WhisperGenerator.transcribe_tokens`` per segment.
  The pool context (default 2 x 448) may exceed the position table; only a
  transcript (``max_tokens`` <= 448) is bounded by it.
- All admissions of one scheduling point encode as ONE batched call (log-mel
  kernel K5, then the encoder with K1), in power-of-2 buckets whose tail
  repeats the last segment.

Decode: the fused step (K7's cross variant, per-row pads and positions)
when ``_whisper_fused_ok`` serves the pool's batch, else the per-op step
(K2 for self and cross attention, K4 where ``use_greedy_head`` takes the
pool). Sampled pools run K7 headless (or the per-op stack), the tied head
matmul and the port's per-row sampler: transcript token g of segment r
draws ``_uniforms(seed, r, g)``, whatever the pool or the schedule.

int8 pools, on the fused route only as in the JAX package: ``USE_INT8_KV``
keeps the self caches per-key int8 (each admission prefills a one-row
full-precision scratch and commits it quantized once, the plain
generator's order), ``USE_INT8_KV_CROSS`` quantizes each segment's cross
K/V once at admission. The sharding hooks ``_params_cfg``, ``_init_pool``
and ``_int8_modes`` let ``parallel/cb_serving.py`` run the same code on a
rank's head shard (per-op, int8 pools through the int8 decode kernel).
"""

from __future__ import annotations

import torch

from ... import transformer as tfm
from ...ops import attention as _attn
from ...ops.greedy_head import greedy_argmax_tied
from ..text.continuous import (
    ServingStats,
    _bucket_pow2,
    _commit_rows,
    _CrossPool,
    _layer_views,
    _serve,
    _to_device,
)
from ..text.generator import _parse_sampling_params
from .whisper import (
    DEC_MAX_LEN,
    ENC_MAX_LEN,
    _decoder_hidden_chunk,
    _fused_whisper_step,
    _head,
    _strip_generated,
    _whisper_fused_ok,
    WhisperPreprocessor,
    split_windows,
    stage_segments,
    whisper_encode,
)


class _WhisperPool(_CrossPool):
    """The Whisper pool: the encoder-decoder pool state (cross caches for
    the 1,500 encoder frames, int8 where ``i8_self`` / ``i8_cross``) and the
    fused step's packed weights and tied head (``fused``)."""

    def __init__(self, params: dict, cfg, b: int, l_max: int, fused: bool, i8_self: bool, i8_cross: bool) -> None:
        p = params["decoder"]
        dtype = p["token_embs"].dtype
        super().__init__(b, l_max, tfm.padded_cache_len(ENC_MAX_LEN // 2), cfg.n_layers, cfg.dec_layer, dtype,
                         p["token_embs"].device, fused, i8_self, i8_cross)
        if fused:
            from ...ops.decode_step import pack_decode_weights, pack_greedy_head

            self.packed = pack_decode_weights(p["layers"], dtype, cross=True)
            self.head = pack_greedy_head(p["token_embs"], p["norm"], dtype,
                                         a8=_attn.use_a8_decode(self.packed["wqkv"].dtype))


class WhisperContinuousBatchingGenerator:
    """Transcription serving over a fixed pool of ``batch_size`` decoder
    slots with mid-flight segment admission. Greedy per-segment outputs are
    token-identical to ``WhisperGenerator.transcribe_tokens``.

    ``pool_ctx`` is the pool's shared position budget (it may exceed the
    decoder position table: positions are per row; a larger pool context
    means fewer epoch resets); ``check_every`` is decode steps between host
    scheduling points. The pool decodes through the fused step when
    ``_whisper_fused_ok`` holds at ``batch_size`` (on the card: any pool,
    over row slices of up to ``ops.decode_step.MAX_LAUNCH_ROWS`` rows),
    else per-op; a launch that fails raises. The text methods take a ``WhisperTokenizer`` passed in."""

    SAMPLE_RATE = 16_000
    N_SAMPLES = 30 * 16_000

    def __init__(self, model, tokenizer=None, batch_size: int = 4, check_every: int = 16,
                 pool_ctx: int = 2 * DEC_MAX_LEN) -> None:
        if batch_size < 1 or check_every < 1:
            raise ValueError("batch_size and check_every must be >= 1")
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.check_every = check_every
        self.pool_ctx = pool_ctx
        self.preprocessor = WhisperPreprocessor("large-v3" if model.cfg.n_mels == 128 else "tiny",
                                                device=model.device)
        self.last_stats: ServingStats | None = None

    # ---- sharding hooks (overridden by parallel/cb_serving.py) ----
    def _params_cfg(self):
        return self.model.params, self.model.cfg

    def _init_pool(self, params, cfg, b: int, l_max: int) -> _WhisperPool:
        fused = _whisper_fused_ok(params["decoder"], cfg, b)
        return _WhisperPool(params, cfg, b, l_max, fused, *self._int8_modes(cfg, b, fused))

    def _int8_modes(self, cfg, b: int, fused: bool) -> tuple[bool, bool]:
        """``(i8_self, i8_cross)``: on the fused route only, as in the JAX
        package (only the fused step reads scale planes on one device)."""
        if not fused or cfg.dec_layer.tp_axis is not None:
            return False, False
        return _attn.use_int8_kv(b), _attn.use_int8_kv_cross(b)

    def _tok(self):
        if self.tokenizer is None:
            raise ValueError("the text methods need a tokenizer: construct with "
                             "WhisperContinuousBatchingGenerator(model, WhisperTokenizer(...)), or call the *_tokens_many "
                             "methods for raw token ids")
        return self.tokenizer

    def transcribe_many(self, audios, language: str = "en", task: str = "transcribe",
                        max_tokens: int = DEC_MAX_LEN, on_tokens=None, topk: int = 1, top_p=None,
                        temperature=1.0, seed: int = 0) -> list[str]:
        """Waveforms -> transcribed texts."""
        tok = self._tok()
        outs = self.transcribe_tokens_many(audios, tok.sot_sequence(language, task), tok.eot, max_tokens,
                                           on_tokens=on_tokens, topk=topk, top_p=top_p, temperature=temperature,
                                           seed=seed)
        return [tok.decode(o) for o in outs]

    def transcribe_long_many(self, audios, language: str = "en", task: str = "transcribe",
                             max_tokens: int = DEC_MAX_LEN, topk: int = 1, top_p=None, temperature=1.0,
                             seed: int = 0) -> list[str]:
        """Long-form (> 30 s) waveforms -> texts through the pool, every 30 s
        window its own segment (``transcribe_long_tokens_many``)."""
        tok = self._tok()
        outs = self.transcribe_long_tokens_many(audios, tok.sot_sequence(language, task), tok.eot, max_tokens,
                                                topk=topk, top_p=top_p, temperature=temperature, seed=seed)
        return ["".join(tok.decode(w) for w in wins) for wins in outs]

    def transcribe_long_tokens_many(self, audios, initial_tokens: list[int], eot_id: int,
                                    max_tokens: int = DEC_MAX_LEN, topk: int = 1, top_p=None, temperature=1.0,
                                    seed: int = 0) -> list[list[list[int]]]:
        """Split each waveform into fixed 30 s windows and schedule every
        window of every audio through the pool as its own segment; returns
        per audio the per-window GENERATED token ids (prompt and EOT
        stripped), window-identical to ``WhisperGenerator.
        transcribe_long_tokens(audio, ..., sot_prev_id=None)``. Sampling:
        window w, in admission order over all audios, is segment w."""
        windows, owners = [], []
        for i, a in enumerate(audios):
            w = split_windows(a, self.N_SAMPLES)
            windows.extend(w)
            owners.extend([i] * len(w))
        outs = self.transcribe_tokens_many(windows, initial_tokens, eot_id, max_tokens, topk=topk, top_p=top_p,
                                           temperature=temperature, seed=seed)
        per: list[list[list[int]]] = [[] for _ in audios]
        for owner, o in zip(owners, outs):
            per[owner].append(_strip_generated(o, len(initial_tokens), eot_id))
        return per

    def _encode(self, audios: list) -> torch.Tensor:
        """Segments -> (mb, T, d) encoder memory in ONE batched call, ``mb``
        the power-of-2 bucket of ``len(audios)`` (the tail repeats the last
        segment)."""
        params, cfg = self._params_cfg()
        mb = _bucket_pow2(len(audios))
        wav = stage_segments(list(audios) + [audios[-1]] * (mb - len(audios)), self.N_SAMPLES,
                             params["decoder"]["token_embs"].device)
        return whisper_encode(params, cfg, self.preprocessor(wav))

    def _admit_row(self, pool: _WhisperPool, row: int, pos: int, memory: torch.Tensor, init: torch.Tensor) -> None:
        """Fill slot ``row`` at ``pos`` with one segment (``memory`` (1, T,
        d)): project its cross K/V into the slot's cross cache (quantized
        once into an int8 pool), write the initial tokens at ``[pos-I,
        pos)`` and prefill the row's self-KV over ``[pos-1-I, pos-1)`` with
        the full-precision cross K/V (an int8 pool on a one-row scratch,
        committed quantized once)."""
        params, cfg = self._params_cfg()
        p, lc = params["decoder"], cfg.dec_layer
        i = init.shape[0]
        pad_len = pos - i
        row_cross, row_stacked = tfm.precompute_cross_caches(p, lc, memory)
        _commit_rows(pool.cross, row, row_stacked["k"][:, 0], row_stacked["v"][:, 0], pool.i8_cross, lc.tp_axis)
        pool.cross["len"][row] = row_stacked["len"][0]
        pool.buf[row, pad_len:pos] = init
        c0 = pos - 1 - i
        p_ids = (torch.arange(i, device=init.device) + (c0 - pad_len)).clamp_min(0)[None]
        pads = torch.full((1,), pad_len, dtype=torch.int32, device=init.device)
        if pool.i8_self:
            _, target = tfm.make_kv_cache(cfg.n_layers, (1,), lc.n_heads, self.pool_ctx, lc.head_dim, pool.dtype,
                                          init.device)
            views = _layer_views(target)
        else:
            views = _layer_views(pool.stacked, row)
        _decoder_hidden_chunk(p, lc, row_cross, pool.buf[row:row + 1, c0:c0 + i], views, c0, pads, p_ids)
        if pool.i8_self:
            _commit_rows(pool.stacked, row, target["k"][:, 0], target["v"][:, 0], True, lc.tp_axis)

    def _steps(self, pool: _WhisperPool, pos: int, n_steps: int, eot_id: int, greedy: bool, topk: int,
               has_tp: bool, seed: int) -> int:
        """Up to ``n_steps`` decode steps over the whole pool: each row at its
        own position-table row ``pos - 1 - pad_len``."""
        params, cfg = self._params_cfg()
        p = params["decoder"]
        b = pool.buf.shape[0]
        greedy_head = greedy and not pool.fused and _attn.use_greedy_head(b, p["token_embs"], tied=True)

        def hidden(tok, pos, p_ids, head):
            if pool.fused:
                return _fused_whisper_step(p, pool.packed, head, cfg, tok, pool.stacked, pool.cross_ops,
                                           pool.cross["len"], pos - 1, pool.pad_lens, p_ids)
            hn, _ = _decoder_hidden_chunk(p, cfg.dec_layer, pool.cross_views, tok, pool.caches, pos - 1,
                                          pool.pad_lens, p_ids[:, None])
            return hn[:, 0]

        def next_tokens(pos):
            tok = pool.buf[:, pos - 1:pos]
            p_ids = pos - 1 - pool.pad_lens.long()
            if not greedy:  # the headless step (or the per-op stack), the tied head matmul, the sampler
                return pool.draw(_head(p, hidden(tok, pos, p_ids, None)), pos, seed, topk, has_tp)
            if pool.fused:  # layer stack + final LN + argmax in ONE kernel
                return hidden(tok, pos, p_ids, pool.head)
            hn = hidden(tok, pos, p_ids, None)
            if greedy_head:
                return greedy_argmax_tied(hn, p["token_embs"].to(hn.dtype))
            return torch.argmax(_head(p, hn), dim=-1)

        return pool.run_steps(pos, n_steps, eot_id, next_tokens)

    @torch.inference_mode()
    def transcribe_tokens_many(self, audios, initial_tokens: list[int], eot_id: int, max_tokens: int = DEC_MAX_LEN,
                               on_tokens=None, topk: int = 1, top_p=None, temperature=1.0,
                               seed: int = 0) -> list[list[int]]:
        """Schedule all segments (admitted in order as slots free up) and
        return each one's initial + transcript token list, in order: greedy,
        identical per segment to ``WhisperGenerator.transcribe_tokens(audio,
        initial_tokens, eot_id, max_tokens)``.

        ``on_tokens(segment_index, new_tokens)``: streaming callback, called
        at every scheduling point with the tokens each live segment
        transcribed since the previous one: every transcript token once, in
        order. ``topk``/``top_p``/``temperature``/``seed``: sampling (greedy
        by default; ``temperature`` and ``top_p`` also take per-segment
        lists); transcript token g of segment r draws ``_uniforms(seed, r,
        g)``, whatever the pool size or the schedule."""
        if max_tokens > DEC_MAX_LEN:
            raise ValueError(f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN})")
        n_req = len(audios)
        if n_req == 0:
            return []
        sampling = _parse_sampling_params(n_req, topk, top_p, temperature)
        greedy, has_tp = sampling[:2]
        n_init = len(initial_tokens)
        if not 1 <= n_init < max_tokens:
            raise ValueError(f"transcription needs 1 to max_tokens - 1 = {max_tokens - 1} initial tokens")
        max_new = max_tokens - n_init  # the plain generator's buffer holds max_tokens in all
        l_max = self.pool_ctx
        base = n_init + 1  # the admission prefill's chunk [pos-1-I, pos-1) needs pos >= I + 1
        if base + max_new > l_max:
            raise ValueError(f"max_tokens={max_tokens} cannot fit the pool context ({l_max}); raise pool_ctx")
        params, cfg = self._params_cfg()
        pool = self._init_pool(params, cfg, self.batch_size, l_max)
        init = _to_device(list(initial_tokens), params["decoder"]["token_embs"].device)

        def admit(pos, admissions):
            memory = self._encode([audios[r] for _, r in admissions])
            for i, (row, _) in enumerate(admissions):
                self._admit_row(pool, row, pos, memory[i:i + 1], init)

        outputs, self.last_stats = _serve(
            pool, n_req, base, self.check_every,
            fits=lambda pos, r: pos + max_new <= l_max, n_prompt=lambda r: n_init, budget=lambda r: max_new,
            admit=admit, steps=lambda pos, n: self._steps(pool, pos, n, eot_id, greedy, topk, has_tp, seed),
            sampling=sampling, on_tokens=on_tokens)
        return outputs  # type: ignore[return-value]

