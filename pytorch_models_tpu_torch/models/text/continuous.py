"""Continuous batching over a decoder-only LM (PyTorch port of
``pytorch_models_tpu/models/text/continuous.py``): dynamic request admission
into a running batched decode.

A fixed pool of B cache slots runs one shared decode loop; whenever a slot
finishes its request a new one is admitted mid-flight and the other rows
never stop. Decode stays on the batched fast path: the fused one-kernel
decode step (``ops/decode_step.py``; a pool above ``MAX_LAUNCH_ROWS`` rows
runs it over row slices, one launch each) when it serves the model, else
the per-op step (with the greedy head
kernel where its gate takes it). Per-row left-pad masking makes each slot's
math that of a fresh left-padded batch row, so outputs are token-identical
to ``DecoderGenerator.generate_tokens`` per request.

Admission on fixed shapes (no paging), as in the JAX package:
- All rows share one cache position ``pos``. A request with n prompt tokens
  admitted at ``pos`` occupies buffer and cache slots ``[pos-n, pos)`` and
  sets ``pad_lens[row] = pos - n``: every earlier slot, the previous
  request's stale K/V included, is masked by the left-pad rule, so no cache
  is cleared.
- The admit prefill forwards one ``prompt_bucket``-wide chunk ``[pos-1-P,
  pos-1)`` of that row through the stack against its cache rows (views of
  the pool's layer-stacked buffers, written in place); the next decode step
  then takes the last prompt token like any other row's.
- ``pos`` never rewinds mid-epoch. When the head-of-queue request no longer
  fits (``pos + max_tokens > max_seq_len``) the pool drains and ``pos``
  resets to the epoch base (an "epoch reset"); stale buffers stay, masked.

Prefix caching (``shared_prefix``): the common prefix is forwarded once per
call and its K/V pasted into a slot at admission (K/V depend only on
row-relative positions); only the suffix is prefilled. Chunked prefill:
prompts longer than the bucket are forwarded in bucket-wide chunks left to
right, then the ordinary admit runs the tail.

The scheduler runs on the host (``_serve`` over a pool's ``_Slots``; the
Whisper and T5 engines, ``models/audio2text/continuous.py`` and
``t5_continuous.py``, run on it too). Between scheduling points it enqueues
up to ``check_every`` decode steps with no device-to-host sync (finished
rows park writing EOS; the host stops the chunk early only where every live
row has reached its budget, which it knows), then copies ``(buf, ends,
done)`` back in one transfer. The JAX package's device loop also stops when every row
has emitted EOS; here such a chunk runs on, parked, to its end.

Sampling with per-request ``temperature`` / ``top_p`` lists: generated
token g of request r draws the uniform ``_uniforms(seed, r, g)``, a
counter-based hash computed on the device, then picks by inverse CDF as the
port's ``_sample`` does. So a request's stream does not depend on the pool
size, the admission order, ``check_every`` or epoch resets. The stream is
not JAX's ``fold_in`` chain (its PRNG cannot be matched).

int8 self-KV pool (``ops.attention.USE_INT8_KV``, fused pools only): the
pool's caches are per-key int8 with fp32 scale planes for the whole call,
and each admission prefills in full precision on a one-row scratch cache,
quantized once when it is committed to the pool: the plain int8
generator's prefill-then-quantize order.

Sharding hooks, as in the JAX package: ``_params_cfg`` (the parameters and
config the pool runs), ``_init_pool`` and ``_use_int8_pool`` (the int8
gate). ``parallel/cb_serving.py`` overrides them to run the same admission
and decode code on one rank's head shard: the per-op step (the fused step
is never a tensor-parallel path), an int8 pool through the per-op int8
decode kernel, its scales all-reduced to the full row's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ... import transformer as tfm
from ...ops import attention as _attn
from ...ops.greedy_head import greedy_argmax_tied
from ...ops.int8_kv import quantize_kv_caches, quantize_rows
from ._decoder_lm import (
    cross_operands,
    decoder_lm_forward_cached_batch,
    decoder_lm_fused_ok,
    decoder_lm_fused_tok_batch,
    decoder_lm_hidden_cached_batch,
    decoder_lm_hidden_fused_batch,
    decoder_lm_make_cache,
    decoder_lm_pack,
    tied_logits,
)
from .generator import PROMPT_BUCKET, _eos_id, _inverse_cdf, _nucleus_mask, _parse_sampling_params, _top_k


def _to_device(tokens: list, device) -> torch.Tensor:
    """Host token ids -> an int64 tensor on ``device`` without stalling the
    host: from pinned memory, asynchronously (a copy from pageable memory
    waits for the work queued before it, which would serialize every
    admission with the device)."""
    t = torch.tensor(tokens, dtype=torch.int64, pin_memory=device.type == "cuda")
    return t.to(device, non_blocking=True)


def _layer_views(stacked: dict, row: int | None = None) -> list:
    """Per-layer cache dicts viewing layer-stacked ``(L, B, Lp, W)`` buffers
    (one pool row ``row:row+1`` of them, or all rows), scale planes
    included."""
    sl = slice(None) if row is None else slice(row, row + 1)
    return [{k: t[i, sl] for k, t in stacked.items()} for i in range(stacked["k"].shape[0])]


def _commit_rows(pool_caches: dict, row: int, src_k: torch.Tensor, src_v: torch.Tensor, int8: bool,
                 group=None) -> None:
    """Write one row's layer-stacked ``(L, Lp, W)`` K/V into pool row ``row``:
    quantized per key, with its scale planes, into an int8 pool (``group``:
    the tp process group whose ranks hold width shards; the scales are the
    full rows')."""
    for kv, src in (("k", src_k), ("v", src_v)):
        if int8:
            q, sc = quantize_rows(src, group=group)
            pool_caches[kv][:, row] = q
            pool_caches[kv + "s"][:, row] = sc[..., 0]
        else:
            pool_caches[kv][:, row] = src.to(pool_caches[kv].dtype)


def _row_prefill(params, cfg, buf, row: int, stacked, cache_row: int, c0: int, pad_len: int, p: int) -> None:
    """Prefill cache row ``cache_row`` of ``stacked`` (the pool's row, or a
    one-row scratch) over pool row ``row``'s buffer chunk ``[c0, c0+P)``, in
    place. Slots below ``pad_len`` hold garbage the pad mask hides; cached
    K/V below ``c0`` (a pasted prefix, earlier chunks) is attended to, not
    recomputed."""
    dev = buf.device
    chunk = buf[row:row + 1, c0:c0 + p]
    p_ids = (torch.arange(p, device=dev)[None, :] + (c0 - pad_len)).clamp_min(0)
    pads = torch.full((1,), pad_len, dtype=torch.int32, device=dev)
    decoder_lm_hidden_cached_batch(params, cfg, chunk, p_ids, _layer_views(stacked, cache_row), c0, pads)


def _paste(buf, row: int, stacked, cache_row: int, pad_len: int, prefix: list, prefix_caches: dict) -> None:
    """The shared prefix's tokens into pool row ``row`` and its K/V into
    cache row ``cache_row`` of ``stacked``, at ``[pad_len, pad_len+k)``: no
    forward pass."""
    k = len(prefix)
    buf[row, pad_len:pad_len + k] = _to_device(prefix, buf.device)
    for kv in ("k", "v"):
        stacked[kv][:, cache_row, pad_len:pad_len + k] = prefix_caches[kv][:, 0, :k].to(stacked[kv].dtype)


def _prefix_caches(params, cfg, prefix_chunk: torch.Tensor) -> dict:
    """Layer-stacked ``(L, 1, Lp, W)`` caches whose slots ``[0, k)`` hold the
    shared prefix's K/V at relative positions ``0..k-1``, from one forward
    of the (Kp,) left-aligned prefix chunk."""
    kp = prefix_chunk.shape[0]
    dev = prefix_chunk.device
    caches, stacked = decoder_lm_make_cache(cfg, (1,), dtype=params["token_embs"].dtype, device=dev)
    decoder_lm_hidden_cached_batch(params, cfg, prefix_chunk[None], torch.arange(kp, device=dev)[None], caches, 0,
                                   torch.zeros((1,), dtype=torch.int32, device=dev))
    return stacked


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift / multiply rounds) of int64 values
    in ``[0, 2**32)``; every product stays below 2**63."""
    m = 0xFFFFFFFF
    for c in (0x7FEB352D, 0x2C1B3C6D, 0x297A2D39):
        x = ((x ^ (x >> 16)) * c) & m
    return x ^ (x >> 16)


def _uniforms(seed: int, req: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The counter-based uniform in [0, 1) of generated token ``g`` of
    request ``req`` under ``seed``: (B,) int64 counters -> (B,) fp32, 24
    random bits each, on the counters' device."""
    h = _mix32(torch.full_like(req, seed & 0xFFFFFFFF) ^ 0x5BD1E995)
    h = _mix32(h ^ (req & 0xFFFFFFFF))
    h = _mix32(h ^ (g & 0xFFFFFFFF))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _sample_rows(logits: torch.Tensor, u: torch.Tensor, topk: int, temps: torch.Tensor, tps) -> torch.Tensor:
    """The port's ``_sample`` with per-row ``temps`` (B,) and nucleus
    thresholds ``tps`` (B,) (None: nucleus off), drawing by the given
    uniforms ``u`` (B,)."""
    k = topk if topk > 1 else logits.shape[-1]
    vals, idx = _top_k((logits.float() / temps[:, None]).to(logits.dtype), k)
    if tps is not None:
        vals = _nucleus_mask(vals, tps[:, None])
    return torch.gather(idx, -1, _inverse_cdf(vals, u)[..., None])[..., 0]


def _bucket_pow2(m: int) -> int:
    """Smallest power of two >= m: the batch buckets of the encoder engines'
    batched admission encodes."""
    return 1 << max(m - 1, 0).bit_length()


@dataclass
class ServingStats:
    """Scheduler-side counters for one ``*_many`` call of a serving engine
    (set as ``gen.last_stats``). ``decode_steps`` counts the steps run (a
    chunk stopped early counts what ran), ``live_slot_steps`` integrates the
    pool's occupancy over them (at chunk granularity), ``tokens_generated``
    counts the returned generated tokens (EOS included)."""

    requests: int = 0
    admissions: int = 0
    epoch_resets: int = 0
    scheduling_points: int = 0
    decode_steps: int = 0
    slot_steps: int = 0        # decode_steps x pool size (capacity)
    live_slot_steps: int = 0   # occupied-slot steps (parked finished slots excluded)
    tokens_generated: int = 0
    wall_time_s: float = 0.0

    @property
    def occupancy(self) -> float:
        """Fraction of slot-step capacity spent on live requests."""
        return self.live_slot_steps / self.slot_steps if self.slot_steps else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_time_s if self.wall_time_s else 0.0


class _Slots:
    """The per-row device state the host scheduler drives, shared by the
    serving engines: the token buffer, left-pad lengths, limits, ends and
    done flags, and the sampling state (request index, admission position,
    temperature, top-p), all updated in place."""

    def __init__(self, b: int, l_max: int, dev) -> None:
        self.buf = torch.zeros((b, l_max), dtype=torch.int64, device=dev)
        self.pad_lens = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.limits = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.ends = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.done = torch.ones((b,), dtype=torch.bool, device=dev)
        self.req = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.t0 = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.temps = torch.ones((b,), dtype=torch.float32, device=dev)
        self.tps = torch.ones((b,), dtype=torch.float32, device=dev)

    def arm(self, row: int, pad_len: int, pos: int, max_new: int) -> None:
        self.pad_lens[row] = pad_len
        self.limits[row] = pos + max_new
        self.done[row] = False

    def draw(self, logits: torch.Tensor, pos: int, seed: int, topk: int, has_tp: bool) -> torch.Tensor:
        """Each row's sampled next token at ``pos``: generated token ``pos -
        t0`` of its request, by the counter-based uniform."""
        u = _uniforms(seed, self.req, pos - self.t0)
        return _sample_rows(logits, u, topk, self.temps, self.tps if has_tp else None)

    def run_steps(self, pos: int, n_steps: int, eos: int, next_tokens) -> int:
        """``n_steps`` decode steps over the whole pool with no
        device-to-host sync, ``next_tokens(pos)`` giving each row's (B,)
        token at ``pos`` from the token at ``pos - 1``. Finished rows park
        writing EOS; a row's ``ends`` latches to pos+1 the step it finishes
        (EOS emitted or its limit reached). Returns the new ``pos``."""
        eos_t = torch.full_like(self.ends, eos)
        for _ in range(n_steps):
            nxt = torch.where(self.done, eos_t, next_tokens(pos))
            new_done = self.done | (nxt == eos) | (pos + 1 >= self.limits)
            self.ends = torch.where(new_done & ~self.done, pos + 1, self.ends)
            self.buf[:, pos] = nxt
            self.done = new_done
            pos += 1
        return pos


def _serve(slots: _Slots, n_req: int, base: int, check_every: int, fits, n_prompt, budget, admit, steps,
           sampling: tuple, on_tokens=None) -> tuple[list, ServingStats]:
    """The host scheduler of every serving engine. Harvests finished slots,
    admits queued requests in order into free slots while ``fits(pos, r)``
    (all of one scheduling point in ONE ``admit(pos, [(row, r), ...])``
    call, which fills each row's buffer and caches; the scheduler then arms
    the rows: request r's prompt is the ``n_prompt(r)`` buffer slots before
    ``pos``, its budget ``budget(r)`` new tokens), resets the epoch when the
    pool drained and the head of the queue does not fit, then runs a chunk
    of up to ``check_every`` decode steps (``steps(pos, n) -> pos``, no
    further than every live row's limit) and copies ``(buf, ends, done)``
    back in one transfer. ``sampling``: ``_parse_sampling_params``' tuple.
    Returns each request's buffer span ``[pad, end)``, in order, and the
    call's stats."""
    b, l_max = slots.buf.shape
    greedy, has_tp, temps_l, tps_l = sampling
    pos = base
    next_req = 0
    slot_req: list[int | None] = [None] * b  # request index occupying each slot
    slot_pad = [0] * b
    slot_n = [0] * b
    slot_lim = [0] * b
    slot_seen = [0] * b  # next unstreamed buffer slot (on_tokens)
    outputs: list[list[int] | None] = [None] * n_req
    done_h = np.ones((b,), bool)
    ends_h = np.zeros((b,), np.int64)
    buf_h = None
    stats = ServingStats(requests=n_req)
    t_start = time.perf_counter()

    while next_req < n_req or any(r is not None for r in slot_req):
        # harvest finished slots, then admit queued requests in order
        for row in range(b):
            if slot_req[row] is not None and done_h[row]:
                end = int(ends_h[row])
                outputs[slot_req[row]] = buf_h[row, slot_pad[row]:end].tolist()
                stats.tokens_generated += end - slot_pad[row] - slot_n[row]
                slot_req[row] = None
        admissions = []
        for row in range(b):
            if slot_req[row] is None and next_req < n_req and fits(pos, next_req):
                admissions.append((row, next_req))
                slot_req[row] = next_req
                next_req += 1
        if admissions:
            admit(pos, admissions)
            for row, r in admissions:
                n, m = n_prompt(r), budget(r)
                slots.arm(row, pos - n, pos, m)
                if not greedy:  # the request's own counter and admission position
                    slots.req[row] = r
                    slots.t0[row] = pos
                    slots.temps[row] = temps_l[r]
                    if has_tp:
                        slots.tps[row] = tps_l[r]
                done_h[row] = False
                slot_pad[row] = pos - n
                slot_n[row] = n
                slot_lim[row] = pos + m
                slot_seen[row] = pos  # generated tokens start at slot pos
                stats.admissions += 1

        if all(r is None for r in slot_req):
            if next_req < n_req:
                # epoch reset: the pool drained and the head of the queue did not fit; parked rows must not
                # take negative positions against the rewound pos (their stale state stays, masked)
                pos = base
                slots.pad_lens.zero_()
                slots.limits.zero_()
                stats.epoch_resets += 1
                continue
            break

        # a chunk of decode steps (no further than every live row's limit), then the scheduler's one copy
        live = [row for row in range(b) if slot_req[row] is not None and not done_h[row]]
        n_steps = min(check_every, l_max - pos, max(slot_lim[row] for row in live) - pos)
        pos_before = pos
        pos = steps(pos, n_steps)
        snap = torch.cat([slots.buf, slots.ends[:, None], slots.done[:, None].long()], dim=1).cpu().numpy()
        buf_h, ends_h, done_h = snap[:, :l_max], snap[:, l_max], snap[:, l_max + 1].astype(bool)
        d_steps = pos - pos_before
        stats.scheduling_points += 1
        stats.decode_steps += d_steps
        stats.slot_steps += d_steps * b
        stats.live_slot_steps += d_steps * len(live)

        if on_tokens is not None:
            for row in range(b):
                r = slot_req[row]
                if r is None:
                    continue
                upto = int(ends_h[row]) if done_h[row] else pos  # finished rows park past their end
                if upto > slot_seen[row]:
                    on_tokens(r, buf_h[row, slot_seen[row]:upto].tolist())
                    slot_seen[row] = upto

    stats.wall_time_s = time.perf_counter() - t_start
    return outputs, stats


class _Pool(_Slots):
    """The decoder-LM pool: the shared slot state, the caches (layer-stacked,
    and per-layer views for the per-op step; per-key int8 with scale planes
    where ``int8``) and the fused step's packed weights (``fused``)."""

    def __init__(self, params, cfg, b: int, fused: bool, int8: bool) -> None:
        dev = params["token_embs"].device
        super().__init__(b, cfg.max_seq_len, dev)
        self.fused = fused
        self.packed, self.head = decoder_lm_pack(params, cfg) if self.fused else (None, None)
        _, stacked = decoder_lm_make_cache(cfg, (b,), dtype=params["token_embs"].dtype, device=dev)
        self.int8 = int8
        # the int8 pool: per-key int8 caches + scale planes for the whole call (zeros quantize harmlessly)
        self.stacked = quantize_kv_caches(stacked) if self.int8 else stacked
        self.caches = _layer_views(self.stacked)


class _CrossPool(_Slots):
    """An encoder-decoder pool (Whisper, T5): the slot state, self caches
    ``(L, B, Lp, W)`` and cross caches ``(L, B, Lx, W)`` with per-row lengths
    (per-key int8 with scale planes where ``i8_self`` / ``i8_cross``), their
    per-layer views for the per-op step, and the fused step's cross
    operands (``fused``)."""

    def __init__(self, b: int, l_max: int, lx: int, n_layers: int, lc, dtype, dev, fused: bool, i8_self: bool,
                 i8_cross: bool) -> None:
        super().__init__(b, l_max, dev)
        self.dtype, self.fused, self.i8_self, self.i8_cross = dtype, fused, i8_self, i8_cross
        _, stacked = tfm.make_kv_cache(n_layers, (b,), lc.n_heads, l_max, lc.head_dim, dtype, dev)
        self.stacked = quantize_kv_caches(stacked) if i8_self else stacked
        self.caches = _layer_views(self.stacked)
        shape = (n_layers, b, lx, lc.n_heads * lc.head_dim)
        cross = {"k": torch.zeros(shape, dtype=dtype, device=dev), "v": torch.zeros(shape, dtype=dtype, device=dev),
                 "len": torch.zeros((b,), dtype=torch.int32, device=dev)}
        self.cross = quantize_kv_caches(cross) if i8_cross else cross
        self.cross_views = [{**{k: t[i] for k, t in self.cross.items() if k != "len"}, "len": self.cross["len"]}
                            for i in range(n_layers)]
        if fused:
            self.cross_ops = cross_operands(self.cross, dtype)


class ContinuousBatchingGenerator:
    """Serving over a fixed pool of ``batch_size`` KV-cache slots with
    mid-flight request admission; greedy per-request outputs are
    token-identical to ``DecoderGenerator(model, tok).generate_tokens(prompt,
    max_tokens)``.

    ``prompt_bucket`` is the admit chunk's width; longer prompts admit by
    chunked prefill, capped only by ``max_seq_len``. ``check_every`` is the
    number of decode steps between host scheduling points: larger amortizes
    the device-to-host copy, smaller admits waiting requests sooner (a
    finished slot parks up to ``check_every - 1`` steps). The pool decodes
    through the fused step when ``decoder_lm_fused_ok(params, cfg,
    batch_size)`` holds (on the card: any ``batch_size``, one launch per
    step up to ``ops.decode_step.MAX_LAUNCH_ROWS`` rows, else one per row
    slice); a launch that fails raises."""

    def __init__(self, model, tokenizer, batch_size: int = 8, prompt_bucket: int = PROMPT_BUCKET,
                 check_every: int = 16) -> None:
        if batch_size < 1 or prompt_bucket < 1 or check_every < 1:
            raise ValueError("batch_size, prompt_bucket and check_every must be >= 1")
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.prompt_bucket = prompt_bucket
        self.check_every = check_every
        self.last_stats: ServingStats | None = None

    # ---- sharding hooks (overridden by parallel/cb_serving.py) ----
    def _params_cfg(self):
        return self.model.params, self.model.cfg

    def _init_pool(self, params, cfg, b: int) -> _Pool:
        fused = decoder_lm_fused_ok(params, cfg, b)
        return _Pool(params, cfg, b, fused, self._use_int8_pool(cfg, b, fused))

    def _use_int8_pool(self, cfg, b: int, fused: bool) -> bool:
        """The int8 pool's gate: the fused step carries it (only it reads
        scale planes on a single device), as in the JAX package."""
        return fused and cfg.tp_axis is None and _attn.use_int8_kv(b)

    def generate_many(self, prompts: list[str], max_tokens: int | list[int] = 100, shared_prefix: str | None = None,
                      topk: int = 1, top_p=None, temperature=1.0, seed: int = 0) -> list[str]:
        outs = self.generate_tokens_many(
            [self.tokenizer.encode(p) for p in prompts], max_tokens,
            shared_prefix=None if shared_prefix is None else self.tokenizer.encode(shared_prefix),
            topk=topk, top_p=top_p, temperature=temperature, seed=seed)
        return [self.tokenizer.decode(o) for o in outs]

    def _steps(self, pool: _Pool, pos: int, n_steps: int, eos: int, greedy: bool, topk: int, has_tp: bool,
               seed: int) -> int:
        """Up to ``n_steps`` decode steps over the whole pool (``_Slots.run_steps``)."""
        params, cfg = self._params_cfg()
        b = pool.buf.shape[0]
        greedy_head = (greedy and not pool.fused
                       and _attn.use_greedy_head(b, params["token_embs"], tied=True))

        def next_tokens(pos):
            tok = pool.buf[:, pos - 1:pos]
            p_ids = (pos - 1 - pool.pad_lens.long())[:, None]
            step = (params, cfg, tok, p_ids)
            if not greedy:
                if pool.fused:  # the headless step, then the head matmul
                    hidden = decoder_lm_hidden_fused_batch(params, pool.packed, cfg, tok, p_ids, pool.stacked, pos - 1,
                                                           pool.pad_lens)
                    logits = tied_logits(params, hidden[:, 0])
                else:
                    logits = decoder_lm_forward_cached_batch(*step, pool.caches, pos - 1, pool.pad_lens)[0][:, 0]
                return pool.draw(logits, pos, seed, topk, has_tp)
            if pool.fused:  # layer stack + final norm + argmax in ONE kernel
                return decoder_lm_fused_tok_batch(params, pool.packed, pool.head, cfg, tok, p_ids, pool.stacked,
                                                  pos - 1, pool.pad_lens)
            if greedy_head:
                hidden, _ = decoder_lm_hidden_cached_batch(*step, pool.caches, pos - 1, pool.pad_lens)
                return greedy_argmax_tied(hidden[:, 0], params["token_embs"].to(hidden.dtype))
            logits, _ = decoder_lm_forward_cached_batch(*step, pool.caches, pos - 1, pool.pad_lens)
            return torch.argmax(logits[:, 0], dim=-1)

        return pool.run_steps(pos, n_steps, eos, next_tokens)

    def _admit(self, pool: _Pool, row: int, pos: int, toks: list, prefix, prefix_caches) -> None:
        """Fill slot ``row`` with ``toks`` (after the shared ``prefix``) at
        ``pos``: paste the prefix, forward whole bucket chunks left to right
        while the prompt is longer than the bucket, forward the tail chunk
        ``[pos-1-P, pos-1)`` (the scheduler then arms the row). The int8
        pool runs it all on a one-row full-precision scratch cache and
        commits the row quantized once."""
        params, cfg = self._params_cfg()
        p = self.prompt_bucket
        k = len(prefix) if prefix else 0
        s = len(toks)
        pad_len = pos - k - s
        buf = pool.buf
        if pool.int8:
            _, target = decoder_lm_make_cache(cfg, (1,), dtype=params["token_embs"].dtype, device=buf.device)
            cache_row = 0
        else:
            target, cache_row = pool.stacked, row
        if k:
            _paste(buf, row, target, cache_row, pad_len, prefix, prefix_caches)
        c0 = pad_len + k
        while c0 + p < pos:  # chunks cover buffer slots up to pos-P (the tail's prefill reads from pos-1-P)
            off = c0 - pad_len - k
            buf[row, c0:c0 + p] = _to_device(toks[off:off + p], buf.device)
            _row_prefill(params, cfg, buf, row, target, cache_row, c0, pad_len, p)
            c0 += p
        n_tok = min(s, p)  # the tail's tokens land at [pos-n_tok, pos); earlier slots keep theirs
        buf[row, pos - n_tok:pos] = _to_device(toks[s - n_tok:], buf.device)
        _row_prefill(params, cfg, buf, row, target, cache_row, max(pos - 1 - p, 0), pad_len, p)
        if pool.int8:
            _commit_rows(pool.stacked, row, target["k"][:, 0], target["v"][:, 0], True, cfg.tp_axis)

    @torch.inference_mode()
    def generate_tokens_many(self, requests: list[list[int]], max_tokens: int | list[int] = 100,
                             shared_prefix: list[int] | None = None, topk: int = 1, top_p=None, temperature=1.0,
                             seed: int = 0, on_tokens=None) -> list[list[int]]:
        """Schedule all ``requests`` (admitted in order as slots free up) and
        return each one's full prompt + generated token list, in order.

        ``shared_prefix``: a common prompt prefix (a system prompt); each
        request's prompt is ``shared_prefix + request``, the prefix is
        forwarded once per call and pasted at admission; outputs include it.
        ``topk``/``top_p``/``temperature``/``seed``: sampling (greedy by
        default); ``temperature`` and ``top_p`` also take per-request lists,
        ``topk`` and the nucleus on/off mode are per call. Token g of request
        r draws ``_uniforms(seed, r, g)``: independent of the pool size, the
        admission order and the scheduling.

        ``on_tokens(request_index, new_tokens)``: streaming callback, called
        at every scheduling point with the tokens each live request generated
        since the previous one: every generated token once, in order."""
        params, cfg = self._params_cfg()
        n_req = len(requests)
        if n_req == 0:
            return []
        sampling = _parse_sampling_params(n_req, topk, top_p, temperature)
        greedy, has_tp = sampling[:2]
        budgets = [max_tokens] * n_req if isinstance(max_tokens, int) else list(max_tokens)
        if len(budgets) != n_req:
            raise ValueError("per-request max_tokens must have one entry per request")
        p_bucket = self.prompt_bucket
        l_max = cfg.max_seq_len
        eos = _eos_id(self.tokenizer)
        dev = params["token_embs"].device

        k = len(shared_prefix) if shared_prefix else 0
        kp = -(-k // p_bucket) * p_bucket if k else 0
        # epoch start: admissions need pos >= n = k + s, so the base covers the longest request (long prompts
        # chunk-prefill at admission); not bucket-rounded, which would reject feasible prompts near max_seq_len
        base = kp + max(p_bucket, max(len(t) for t in requests))

        def fits_n(pos, n, m_eff):
            if pos + m_eff > l_max or pos + 1 > l_max:
                return False
            return not k or pos - n + kp <= l_max  # the JAX package's prefix paste window stays in bounds

        plans = []  # (tokens, effective max_new) with the plain generator's clamp
        for toks, m in zip(requests, budgets):
            if len(toks) < 1:
                raise ValueError("empty request")
            n = k + len(toks)
            m_eff = min(m, l_max - n)  # plain generator: limit = min(n + max_tokens, L)
            if m_eff < 1 or not fits_n(base, n, m_eff):
                raise ValueError(f"request (n={n}, max_tokens={m}) cannot fit a fresh epoch "
                                 f"(epoch base {base} + {m_eff} > max_seq_len {l_max})")
            plans.append((toks, m_eff))

        prefix_caches = None
        if k:
            chunk = torch.zeros((kp,), dtype=torch.int64, device=dev)
            chunk[:k] = torch.as_tensor(shared_prefix)
            prefix_caches = _prefix_caches(params, cfg, chunk)

        pool = self._init_pool(params, cfg, self.batch_size)

        def admit(pos, admissions):
            for row, r in admissions:
                self._admit(pool, row, pos, plans[r][0], shared_prefix, prefix_caches)

        outputs, self.last_stats = _serve(
            pool, n_req, base, self.check_every,
            fits=lambda pos, r: fits_n(pos, k + len(plans[r][0]), plans[r][1]),
            n_prompt=lambda r: k + len(plans[r][0]), budget=lambda r: plans[r][1], admit=admit,
            steps=lambda pos, n: self._steps(pool, pos, n, eos, greedy, topk, has_tp, seed),
            sampling=sampling, on_tokens=on_tokens)
        return outputs  # type: ignore[return-value]
