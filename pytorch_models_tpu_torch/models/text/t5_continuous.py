"""Continuous batching for T5 generation (PyTorch port of
``pytorch_models_tpu/models/text/t5_continuous.py``): a fixed pool of
decoder slots serves encoder-decoder requests with mid-flight admission, on
the host scheduler of the decoder-LM engine (``models/text/continuous.py``).

- All rows share one monotonic cache position ``pos``. A request admitted at
  ``pos`` puts its leading pad token at buffer slot ``pos-1`` and sets
  ``pad_lens[row] = pos-1``: the left-pad mask hides every earlier slot, the
  previous occupant's stale self-KV included, so no cache is cleared. There
  is no self-KV prefill: the first decode step computes the pad token's K/V.
- T5's relative-position bias depends only on ``q_pos - k_pos``, which the
  per-row shift leaves as it is: ONE pool-wide (H, pool_ctx, Lp) decode bias
  table serves every row exactly (key-major ``(pool_ctx, Lp, H)`` for the
  fused step, row ``pos - 1`` each step; never tiled per row group).
- Admission writes the prompt's cross-attention K/V over the slot's cross
  cache (each row attends to its own prompt through the per-row ``len``).
  All admissions of one scheduling point encode as ONE batched call in
  power-of-2 buckets over one encoder bucket shared by the whole call (the
  per-row ``len`` masks the tail, so a wider bucket changes nothing).
- Per-request outputs are token-identical to ``T5Generator.generate_tokens``
  (pad + generated + EOS). T5 has no decoder position table, so
  ``pool_ctx`` (default 4 x ``max_tokens``: fewer epoch resets) is free.

Decode: the fused step (K7's T5 variant with per-row pads) when
``_t5_fused_ok`` serves the pool's batch, else the per-op step (K2 with the
key-major bias and per-row pads, K2 over the cross caches, K4-untied where
``use_greedy_head`` takes the pool). Sampled pools run K7 headless (or the
per-op stack), the classifier and the port's per-row sampler: generated
token g of request r draws ``_uniforms(seed, r, g)``.

int8 pools, on the fused route only as in the JAX package: ``USE_INT8_KV``
(the self caches start as quantized zeros and every step writes quantized;
at most 128 (row, head) pairs per group of 8 rows, the JAX package's rule)
and ``USE_INT8_KV_CROSS`` (each prompt's cross K/V quantized once at
admission). The sharding hooks ``_params_cfg``, ``_encode``,
``_init_pool`` and ``_int8_modes`` let ``parallel/cb_serving.py`` run the
same code on a rank's head shard (per-op; int8 cross pools through the int8
decode kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import transformer as tfm
from ...ops import attention as _attn
from ...ops import linear
from ...ops.gather import embed_rows
from ...ops.greedy_head import greedy_argmax
from .continuous import ServingStats, _bucket_pow2, _commit_rows, _CrossPool, _serve
from .generator import _parse_sampling_params
from .t5 import (
    ENC_BUCKET,
    _fused_t5_step,
    _pad_bias,
    _t5_decode_layers,
    _t5_fused_ok,
    _t5_key_major_bias,
    relative_position_bias,
    rms_norm,
    t5_encode,
)


class _T5Pool(_CrossPool):
    """The T5 pool: the encoder-decoder pool state (cross caches for the
    call's encoder bucket, int8 where ``i8_self`` / ``i8_cross``), the
    pool-wide decode bias table (of the rank's heads under tensor
    parallelism), and the fused step's packed weights, untied head and
    key-major bias (``fused``)."""

    def __init__(self, params: dict, cfg, b: int, l_max: int, t_pad: int, fused: bool, i8_self: bool,
                 i8_cross: bool) -> None:
        dec = params["decoder"]
        lc = cfg.layer
        dtype = params["token_embs"].dtype
        dev = params["token_embs"].device
        super().__init__(b, l_max, t_pad, cfg.n_layers, lc, dtype, dev, fused, i8_self, i8_cross)
        # ONE decode bias table: a function of q_pos - k_pos only, so every shifted row reads it exactly
        self.bias_table = relative_position_bias(dec["attn_bias"], torch.arange(l_max, device=dev),
                                                 torch.arange(tfm.padded_cache_len(l_max), device=dev), False, cfg)
        if fused:
            from ...ops.decode_step import pack_decode_weights, pack_greedy_head

            self.packed = pack_decode_weights(dec["layers"], dtype, cross=True, gated=True)
            self.head = pack_greedy_head(params["classifier"]["w"], dec["norm"], dtype, tied=False,
                                         a8=_attn.use_a8_decode(self.packed["wqkv"].dtype))
            self.bias_km = _t5_key_major_bias(self.bias_table)


class T5ContinuousBatchingGenerator:
    """T5 generation serving over a fixed pool of ``batch_size`` decoder
    slots with mid-flight request admission. Greedy per-request outputs are
    token-identical to ``T5Generator.generate_tokens``.

    ``pool_ctx`` is the pool's shared position budget (default 4x the call's
    ``max_tokens``; a larger one means fewer epoch resets); ``check_every``
    is decode steps between host scheduling points. The pool decodes through
    the fused step when ``_t5_fused_ok`` holds at ``batch_size`` (on the
    card: any pool, over row slices of up to ``ops.decode_step.MAX_LAUNCH_ROWS``
    rows), else per-op; a launch that fails raises. The string methods take a sentencepiece-style
    tokenizer passed in (``Encode(text, add_eos=True)``, ``Decode(ids)``,
    ``pad_id()``, ``eos_id()``)."""

    def __init__(self, model, tokenizer=None, batch_size: int = 4, check_every: int = 16,
                 pool_ctx: int | None = None) -> None:
        if batch_size < 1 or check_every < 1:
            raise ValueError("batch_size and check_every must be >= 1")
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.check_every = check_every
        self.pool_ctx = pool_ctx
        self.last_stats: ServingStats | None = None

    # ---- sharding hooks (overridden by parallel/cb_serving.py) ----
    def _params_cfg(self):
        return self.model.params, self.model.cfg

    def _encode(self, params, cfg, enc_tokens, n_enc):
        return t5_encode(params, cfg, enc_tokens, _pad_bias(n_enc, enc_tokens.shape[1]))

    def _init_pool(self, params, cfg, b: int, l_max: int, t_pad: int) -> _T5Pool:
        return _T5Pool(params, cfg, b, l_max, t_pad, _t5_fused_ok(params, cfg, b),
                       *self._int8_modes(params, cfg, b, l_max))

    def _int8_modes(self, params, cfg, b: int, l_max: int) -> tuple[bool, bool]:
        """``(i8_self, i8_cross)``: on the fused route only, as in the JAX
        package; int8 self-KV at most 128 (row, head) pairs per group of 8
        rows (t5.py's rule)."""
        if cfg.layer.tp_axis is not None or not _t5_fused_ok(params, cfg, b):
            return False, False
        return (_attn.use_int8_kv(b) and min(b, 8) * cfg.layer.n_heads <= 128, _attn.use_int8_kv_cross(b))

    def generate_many(self, prompts: list[str], max_tokens: int = 100, on_tokens=None, topk: int = 1, top_p=None,
                      temperature=1.0, seed: int = 0) -> list[str]:
        """Prompts -> generated texts."""
        tok = self.tokenizer
        if tok is None:
            raise ValueError("generate_many() returns text and needs a tokenizer: construct with "
                             "T5ContinuousBatchingGenerator(model, tokenizer), or call generate_tokens_many(...) "
                             "for raw token ids")
        outs = self.generate_tokens_many([tok.Encode(p, add_eos=True) for p in prompts], max_tokens, tok.pad_id(),
                                         tok.eos_id(), on_tokens=on_tokens, topk=topk, top_p=top_p,
                                         temperature=temperature, seed=seed)
        return [tok.Decode(o) for o in outs]

    def _admit(self, pool: _T5Pool, pos: int, admissions: list, token_lists: list, p_pad: int, pad_id: int) -> None:
        """Encode the admitted prompts in ONE call (right-padded to the
        call's bucket ``p_pad``, a power-of-2 batch whose tail repeats the
        last prompt), project their cross K/V (quantized once into an int8
        pool) into the slots' cross caches, and write each leading pad token
        at ``pos - 1``."""
        params, cfg = self._params_cfg()
        dev = params["token_embs"].device
        rows = [token_lists[r] for _, r in admissions]
        rows += [rows[-1]] * (_bucket_pow2(len(rows)) - len(rows))
        enc = np.zeros((len(rows), p_pad), np.int64)
        for i, ts in enumerate(rows):
            enc[i, :len(ts)] = ts
        n_enc = torch.tensor([len(ts) for ts in rows], device=dev)
        memory = self._encode(params, cfg, torch.from_numpy(enc).to(dev), n_enc)
        _, stacked = tfm.precompute_cross_caches(params["decoder"], cfg.layer, memory, valid_lens=n_enc)
        for i, (row, _) in enumerate(admissions):
            _commit_rows(pool.cross, row, stacked["k"][:, i], stacked["v"][:, i], pool.i8_cross, cfg.layer.tp_axis)
            pool.cross["len"][row] = stacked["len"][i]
            pool.buf[row, pos - 1] = pad_id

    def _steps(self, pool: _T5Pool, pos: int, n_steps: int, eos_id: int, greedy: bool, topk: int, has_tp: bool,
               seed: int) -> int:
        """Up to ``n_steps`` decode steps over the whole pool, the self bias
        of cache position ``pos - 1`` for every row."""
        params, cfg = self._params_cfg()
        dec = params["decoder"]
        b = pool.buf.shape[0]
        w_cls = params["classifier"]["w"]
        greedy_head = (greedy and not pool.fused and not isinstance(w_cls, dict)
                       and _attn.use_greedy_head(b, w_cls, tied=False))

        def hidden(tok, pos, head):
            if pool.fused:
                return _fused_t5_step(params, pool.packed, head, cfg, tok, pool.stacked, pool.cross_ops,
                                      pool.cross["len"], pool.bias_km, pos - 1, pool.pad_lens)
            h = _t5_decode_layers(dec, cfg, embed_rows(params["token_embs"], tok[:, None]), pool.caches,
                                  pool.cross_views, pool.bias_table[:, pos - 1:pos], pos - 1, pool.pad_lens)
            return rms_norm(dec["norm"], h)[:, 0]

        def next_tokens(pos):
            tok = pool.buf[:, pos - 1]
            if not greedy:  # the headless step (or the per-op stack), the classifier, the sampler
                return pool.draw(linear(params["classifier"], hidden(tok, pos, None)), pos, seed, topk, has_tp)
            if pool.fused:  # layer stack + final RMSNorm + untied argmax in ONE kernel
                return hidden(tok, pos, pool.head)
            h = hidden(tok, pos, None)
            if greedy_head:
                return greedy_argmax(h, w_cls.to(h.dtype))
            return torch.argmax(linear(params["classifier"], h), dim=-1)

        return pool.run_steps(pos, n_steps, eos_id, next_tokens)

    @torch.inference_mode()
    def generate_tokens_many(self, token_lists: list[list[int]], max_tokens: int, pad_id: int, eos_id: int,
                             on_tokens=None, topk: int = 1, top_p=None, temperature=1.0,
                             seed: int = 0) -> list[list[int]]:
        """Schedule all requests (admitted in order as slots free up) and
        return each one's pad + generated token list, in order: greedy,
        identical per request to ``T5Generator.generate_tokens(token_ids,
        max_tokens, pad_id, eos_id)``.

        ``on_tokens(request_index, new_tokens)``: streaming callback, called
        at every scheduling point with the tokens each live request
        generated since the previous one: every generated token once, in
        order (the output minus its leading pad token).
        ``topk``/``top_p``/``temperature``/``seed``: sampling (greedy by
        default; ``temperature`` and ``top_p`` also take per-request lists);
        generated token g of request r draws ``_uniforms(seed, r, g)``,
        whatever the pool size or the schedule."""
        n_req = len(token_lists)
        if n_req == 0:
            return []
        sampling = _parse_sampling_params(n_req, topk, top_p, temperature)
        greedy, has_tp = sampling[:2]
        if max_tokens < 2:
            raise ValueError(f"max_tokens must fit the pad token and one more, got {max_tokens}")
        if not all(token_lists):
            raise ValueError("empty prompt")
        max_new = max_tokens - 1  # the plain generator's buffer holds max_tokens in all, the pad token first
        l_max = self.pool_ctx if self.pool_ctx is not None else 4 * max_tokens
        base = 1  # admission writes the pad token at slot pos - 1
        if base + max_new > l_max:
            raise ValueError(f"max_tokens={max_tokens} cannot fit the pool context ({l_max}); raise pool_ctx")
        # one encoder bucket for the call: the per-row cross len masks the tail
        p_pad = -(-max(len(ts) for ts in token_lists) // ENC_BUCKET) * ENC_BUCKET
        params, cfg = self._params_cfg()
        pool = self._init_pool(params, cfg, self.batch_size, l_max, tfm.padded_cache_len(p_pad))
        outputs, self.last_stats = _serve(
            pool, n_req, base, self.check_every,
            fits=lambda pos, r: pos + max_new <= l_max, n_prompt=lambda r: 1, budget=lambda r: max_new,
            admit=lambda pos, adm: self._admit(pool, pos, adm, token_lists, p_pad, pad_id),
            steps=lambda pos, n: self._steps(pool, pos, n, eos_id, greedy, topk, has_tp, seed),
            sampling=sampling, on_tokens=on_tokens)
        return outputs  # type: ignore[return-value]
