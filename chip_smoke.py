#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                   # what the checks need
    python3 chip_smoke.py --profile DIR     # and torch.profiler summaries in DIR

Builds the port's CUDA kernels from ``pytorch_models_tpu_torch/csrc/`` (one
``nvcc`` per source, in parallel), holds each kernel against its plain
PyTorch version at the GPT-2, Whisper and T5 serving shapes (the fused
decode step K7 at full GPT-2-small, Whisper-base and T5-base width, fp32 and
bf16; the biased decode attention and the untied greedy head at T5-base's;
the greedy heads at B=8 to 200 beside the head matmul + argmax, with the
side ``use_greedy_head`` takes at each;
the encoder attention K1 also at ViT-B/16's B=128 x 197 tokens and at head
widths 32, 80 and 128, with its tensor-core instructions per instantiation
counted by ``cuobjdump -sass``), then drives the port's three main paths and
checks that each went through its kernels:

- GPT-2 small at full width (12 layers, d_model 768, vocab 50257, context
  1024, random weights from a seed) through ``score_tokens_batch``, then,
  rescaled so that greedy streams move, ``generate_tokens_batch`` (and at
  B=16, above the fused step's 8 rows, per-op against plain in fp32: the
  tied greedy head K4 once per decode step);
- Whisper-base at full width (8 + 8 layers, d_model 512, vocab 51865, 80
  mels, random weights from a seed) transcribing eight 5-30 s waveforms
  through ``WhisperGenerator.transcribe_tokens_batch`` and
  ``transcribe_tokens`` (log-mel kernel, conv stem, encoder, cross-attention
  decoder);
- T5-base at full width (Flan-T5 shapes: 12 + 12 layers, d_model 768, 12
  heads, GEGLU mlp 2048, vocab 32128; random weights from a seed, layer
  matrices at 2x the init's scale, rel-pos tables seeded at scale 2) greedily
  continuing eight prompts of 5-64 tokens through
  ``T5Generator.generate_tokens_batch`` (64 tokens at most);
- ViT-B/16 at full width (12 layers, d_model 768, 12 heads, patch 16, 224 x
  224, AugReg's cls pooling; random weights from a seed) through
  ``ViT.__call__`` (phase "vit"): fp32 at B=32 (TF32 off), the encoder
  attention K1 route (flags auto) against the SDPA route, K1 once per layer;
  bf16 at B=128, ``bench.py``'s batch: both routes' img/s and MFU in turns,
  and K1's share of the forward.

The generation API at full width (``beam_sample_paths``): beam search
through ``DecoderGenerator.beam_search_tokens_batch`` (GPT-2 small, G=2 and
4 prompts x W=4: 8 rows, the fused step headless, and 16, per-op),
``WhisperGenerator.transcribe_beam_tokens`` (Whisper-base, one 30 s
segment, W=4) and ``T5Generator.generate_beam_tokens`` (T5-base, one
prompt, W=4), at most BEAM_NEW new tokens; sampling through
``generate_tokens_batch`` (B=8) and ``generate_tokens_samples`` (n=16) at
top-k 40, top-p 0.9, temperature 0.8, seed 0. fp32 beams must be identical
on the fused, per-op and plain routes (a group may part only where the
plain run had a selection within the near-tie tolerance GAP_TOL at the
model's top logit, printed) with scores within it, fp32 sampled streams identical on the fused and plain routes (a
row may part only where its draw lies on a boundary of the plain route's
CDF that the routes' logits can move, printed), and the headless K7 launched once per
beam or sampled step (T5: and once for the pad token). bf16: GPT-2 beam and
sampled row tokens/s and Whisper beam segments/s, fused against per-op in
turns; the beam cache reorder's time a step. The headless K7 (no final
norm, no head) is also held against its plain twin at those rows (GPT-2 8,
Whisper and T5 4) on ``decode_step_phases``' inputs and timed beside the
head matmul that follows it.

The decoders' embedding is K3's one-launch ``embed_add`` (token rows + cast
position rows), held bit for bit against its plain version at the GPT-2,
Whisper and T5 shapes and timed beside the launch floor, an empty kernel
timed the same way (phase "kernel embed_add").

Each main path runs three decode routes: fused (every flag auto: one K7
launch per greedy step), per-op kernels (``USE_FUSED_STEP = False``; for T5
the decode kernel with its rel-pos bias and the untied greedy head must
launch) and plain (every flag False). fp32 tokens must be identical across the three,
up to the first step where the plain top-2 logits are closer than
``GAP_TOL`` (a near-tie that summation order may decide; such a step is
printed with its gap), and K7 must launch once per decode step.

int8 serving: K6 (the int8 decode attention) against its plain version at
the GPT-2, Whisper-cross and T5 (rel-pos bias) shapes; K7's int8 variants
(w8a16 + int8 self-KV, w8a8 + the int8 head, Whisper's int8 self + cross
KV, T5's w8a8 + int8 self + cross KV with its self bias, the embed phase)
against the plain twin per step at full width, layer by layer from the
kernel's own input (each differing int8 K/V level traced to a rounding
boundary) and with the token held against the plain head on the kernel's
x_out (the a8 head exactly); the per-op int8 step (12 GPT-2-small layers
through ``transformer.decoder_apply``, one K6 launch each) against K7 on a
copy of the same caches; and the three models in int8 serving through their
generators: fp32 every step's token held against the plain head on the
kernel route's own x_out, K7 once per decode step, where the rows part from
the generator driving K7's plain twin (a reading), bf16 agreement with the
unquantized bf16 route and the routes' times.

K7's time per phase (``decode_step_breakdown``): each block stamps
%globaltimer at four points of every phase (``stamps=`` of the wrappers),
and a line per variant (GPT-2 bf16 / fp32 / fp32 w8a16 + int8 KV, Whisper
and T5 bf16, B=8) splits the step into barrier wait and skew, input load,
matvec or attention and epilogue, in µs per phase of each kind.

K1 in bf16: an output row beyond TOL passes only where p values that lie
at a bf16 rounding boundary, moved to their other rounding, explain every
column of the row, and within 2^-8 * (P @ |V|) / l + 2^-7 * |o| + 1e-6
(``_check_k1``): the kernel and its twin sum the scores in other orders.

Prints one line per phase; the line before the last is a JSON summary of
the kernels (``max_abs_err`` is the largest |kernel - plain| output over
every shape and dtype checked, for K7's int8 variants on x after each layer
from the kernel's own input; for the greedy head, whose outputs are ids,
it is the largest score regret ``s[plain id] - s[kernel id]``; for the
log-mel kernel it is taken where the plain value is at least its global
max - 8, the part the Whisper frontend keeps; ``ms``, ``plain_ms`` and
``library_ms`` are device times per call (see ``_time_ms``); ``launches`` counts the main
paths' runs, with every count set to 0 just before each path; a variant
counts its own launches: ``decode_attention`` those without a bias,
``decode_attention_bias`` those with one, ``fused_cross_decode_step``
Whisper's, ``fused_cross_decode_step_t5`` T5's, ``int8_kv`` K6's on the
per-op int8 step, ``fused_decode_step_int8`` / ``_a8`` / ``_embed`` and
``fused_cross_decode_step_int8`` / ``_t5_a8`` K7's int8 serving launches
(int8 KV without w8a8, w8a8, the embed phase; Whisper's int8 KV, T5's
w8a8) on the int8 serving paths; ``limit`` is ``max_abs_err``'s bound;
``bound_ms``
is the larger of the bytes the call must move over 3.35 TB/s and its
operations over the card's peak for their type; ``library_ms`` is one
PyTorch call computing the same function, where there is one), the line
before it the card's name and power limit, and the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the exit code is non-zero and no result is printed. Without a
CUDA device it exits with code 2.

fp32 phases run with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` False), so fp32 means fp32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_NEW = 64
B16_NEW = 16  # new tokens of the per-op GPT-2 generation at B=16
PROMPT_LENS = (5, 12, 23, 31, 40, 47, 55, 60)
# kernel vs plain version on the same inputs, elementwise |got - ref| <=
# atol + rtol * |ref|. fp32 differs by summation order only (readings on an
# H100: 2.98e-7 decode attention; the encoder attention, whose products run
# as 3xTF32 and exp as ex2, 9.24e-6). Both bf16 paths keep fp32 inside and
# round once at the end, so an output may land one bf16 step of its own value
# (at most 2^-7 relative) apart (readings: 3.91e-3 encoder, 3.8e-6 decode
# attention); the encoder attention also rounds p, see _check_k1.
TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
SCORE_TOL = 1e-3  # fp32 log-probs after 12 layers: attention sums differ in order
# log10 mel power, log-mel kernel vs plain where the plain value is at least
# its global max - 8 (what the Whisper frontend keeps): both fp32, summed in
# other orders. At this input (B=8 x 30 s of noise, a tone and silence) the
# plain version itself departs from a float64 reference by up to 2.1e-4
# (a CPU reading); the kernel is allowed ten times that.
MEL_TOL = 2e-3

# K7 (fused decode step) vs its plain version over 12 (GPT-2) or 8 (Whisper)
# layers, elementwise atol + rtol * |ref| on x_out and the K/V written at pos.
# fp32: both sum in fp32, in other orders; the error grows with depth, so
# each layer's 1e-7-relative noise is given room to compound (readings on an
# H100: at most 2.4e-6). bf16: both round at the same points, but an fp32 sum
# that straddles a rounding boundary lands one bf16 step (2^-8 relative)
# apart and carries through the later layers; residual values reach |x| ~ 16,
# where one step is 0.0625 (readings: at most 0.078, at |x| > 16). The phase
# prints the largest |kernel - plain| / (atol + rtol * |plain|). The first
# layer's K/V at pos are one projection of the step's own input, with no
# earlier layer to carry a difference: they are held to TOL, one bf16 step.
DS_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -3, 2.0 ** -5)}
# fp32 routes (fused, per-op kernels, plain) may part only at a step whose
# plain top-2 logits lie closer than this: fp32 summation order moves a logit
# by ~1e-5 of its size through 12 layers.
GAP_TOL = (1e-3, 1e-4)  # atol, rtol * |top logit|
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# CUDA-core fp32; tensor-core bf16 and int8 (dense): the bound of fp32, bf16 and int8 arithmetic
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
PEAK_TF32 = 495e12  # tensor-core TF32 (dense); 3xTF32 runs each fp32 product as three of these

# Whisper-base main path: <|startoftranscript|><|en|><|transcribe|><|notimestamps|>
W_INIT = [50258, 50259, 50359, 50363]
W_EOT = 50257
W_SECONDS = (5.0, 8.5, 12.0, 15.5, 19.0, 22.5, 26.0, 30.0)
W_SAMPLES = 30 * 16_000

# T5-base main path: right-padded prompts, decoding from the pad token; Flan-T5's pad and EOS ids
T5_PROMPT_LENS = (5, 12, 23, 31, 40, 47, 55, 64)
T5_PAD, T5_EOS = 0, 1
T5_MAX = 64  # tokens per output row, the pad token included
T5_WEIGHT_SCALE = 2.0  # layer matrices, x the init's scale
T5_BIAS_SCALE = 2.0  # rel-pos tables, seeded N(0, 1) x this (the init's are zeros)

# beam search and sampling: W beams a prompt, G prompts (G x W = 8 rows: the fused step headless; 16: per-op),
# at most BEAM_NEW new tokens; the sampled phases' settings (topk, top_p, temperature, seed)
BEAM_W, BEAM_G, BEAM_NEW = 4, (2, 4), 32
# fp32 routes' beams: scores within the model's beam tolerance, and sequences parted only where a selection of
# the plain route's run (the 2W candidates, the W survivors, the finished pool) had its k-th and (k+1)-th
# scores within it. The tolerance is the main paths' near-tie tolerance at the model's top logit on the first
# prompt, GAP_TOL[0] + GAP_TOL[1] * |top logit|: fp32 summation order moves a logit by ~1e-5 of its size, and
# a score sums up to BEAM_NEW + 1 log-probs whose errors mostly cancel (H100 readings: GPT-2 2.2e-4, Whisper
# 1.1e-3 between the fused and plain routes).
SAMPLE = dict(topk=40, top_p=0.9, temperature=0.8, seed=0)
SAMPLE_B, SAMPLE_N = 8, 16
# fp32 routes' sampled streams may part only where the draw lies on a CDF boundary that the routes' logits
# can move: within 2 * (GAP_TOL[0] + GAP_TOL[1] * |top logit|) / temperature of one of the plain route's
# cumulative probabilities (every logit moved by at most the main paths' near-tie tolerance moves a
# log-probability by at most twice that, over the temperature)

# ViT-B/16 (AugReg's cls pooling): fp32 routes compared at VIT_B32 images, bf16 timed at bench.py's batch
VIT_B32, VIT_B = 32, 128
VIT_FORWARDS = 10  # forwards per timed turn
# the features of the K1 route against the SDPA route after 12 layers: fp32 as DS_TOL (K7's 12-layer bound:
# the two sum in other orders, K1's products in 3xTF32); bf16 by relative L2 norm: each route rounds p and
# every layer's output to bf16 (2^-8 relative), and 12 layers of such steps add at most linearly
VIT_BF16_REL = 12 * 2.0 ** -8


def vit_flops_per_image(n_layers=12, d=768, patch=16, img=224, mlp_ratio=4) -> float:
    """Forward FLOPs (2 x MACs) of a ViT with a cls token: bench.py's formula
    (35.13 GFLOP for ViT-B/16 at 224)."""
    n_tok = (img // patch) ** 2 + 1
    patch_macs = (img // patch) ** 2 * (patch * patch * 3) * d
    per_layer = 4 * n_tok * d * d + 2 * n_tok * n_tok * d + 2 * n_tok * d * (d * mlp_ratio)
    return 2.0 * (patch_macs + n_layers * per_layer)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fns, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls cycling through ``fns``
    (several input copies keep a cache-sized working set out of L2), after
    warm-up, timed with CUDA events. The calls are queued behind a device-side
    spin (``torch.cuda._sleep``) of twice the host's time to queue them, so
    the wrappers' host overhead does not throttle the loop and the events time
    what the device did (a call that waits for the device would still count
    the host's time)."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fns[i % len(fns)]()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * queue_s * _spin_cycles_per_s()) + 100_000)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_SPIN_RATE: list[float] = []


def _spin_cycles_per_s() -> float:
    """Cycles per second of ``torch.cuda._sleep``, measured once."""
    import torch

    if not _SPIN_RATE:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)  # warm
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN_RATE.append(10_000_000 / (start.elapsed_time(end) / 1e3))
    return _SPIN_RATE[0]


def _ab_ms(kernel_fns, plain_fns, iters: int) -> tuple[float, float]:
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1 = _time_ms(plain_fns, iters)
    k1 = _time_ms(kernel_fns, iters)
    k2 = _time_ms(kernel_fns, iters)
    p2 = _time_ms(plain_fns, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _rec(err: float, ms: float, plain_ms: float, nbytes: float, flops: float, dn: str,
         library_ms: float | None = None, tf32x3: bool = False) -> dict:
    """A kernel's numbers at one shape: its bound is the larger of the bytes
    it must move over the HBM rate and its operations over the peak for the
    dtype (inputs read once, outputs written once, data-dependent work as
    these inputs need it). ``tf32x3``: an fp32 kernel whose products run as
    3xTF32 on the tensor cores may take the smaller of the CUDA-core fp32 time
    and three times the TF32 time for its operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dn] * 1e3
    if tf32x3 and dn == "float32":
        t_ops = min(t_ops, 3 * flops / PEAK_TF32 * 1e3)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def _check_close(name: str, got, ref, tol: tuple[float, float]) -> float:
    """Max |got - ref|; raises unless finite and every element is within
    ``atol + rtol * |ref|``."""
    import torch

    atol, rtol = tol
    diff = (got.float() - ref.float()).abs()
    bad = diff > atol + rtol * ref.float().abs()
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max |kernel - plain| = "
                             f"{diff.max().item()} (atol {atol}, rtol {rtol})")
    return diff.max().item()


def _check_greedy(name: str, x, emb, tie: int, untied: bool = False) -> tuple[float, int]:
    """Greedy head kernel vs plain on ``x`` (B, d), ``emb`` (V, d) whose rows
    ``tie`` and a later one hold the same best score for batch row 0 (with
    ``untied``: the (d, V) classifier and its columns, K4-untied).

    Measured error: the score regret ``s[b, plain id] - s[b, kernel id]``
    over all rows, held to the fp32 summation-order noise of a score (fp32)
    or one bf16 step of the top score (bf16). Ids must be equal where the
    top-2 gap exceeds that, and the tie must go to the lowest index.
    Returns (max |regret|, rows with a decided top-2)."""
    import torch

    from pytorch_models_tpu_torch.ops import greedy_head as gh

    if untied:
        got, ref, s = gh.greedy_argmax(x, emb), gh.greedy_argmax_plain(x, emb), torch.matmul(x.float(), emb.float())
    else:
        got, ref = gh.greedy_argmax_tied(x, emb), gh.greedy_argmax_tied_plain(x, emb)
        s = torch.matmul(x.float(), emb.float().t())
    if x.dtype == torch.bfloat16:
        s = s.to(x.dtype).float()
    top2 = s.topk(2, dim=-1).values
    gap_tol = torch.full_like(top2[:, 0], 1e-3) if x.dtype == torch.float32 else top2[:, 0].abs() * 2 ** -7
    decided = top2[:, 0] - top2[:, 1] > gap_tol
    rows = torch.arange(x.shape[0], device=x.device)
    regret = s[rows, ref] - s[rows, got]
    if got[0].item() != tie:
        raise AssertionError(f"{name}: forced tie gave {got[0].item()}, not the lowest index {tie}")
    if not torch.equal(got[decided], ref[decided]) or bool((regret.abs() > gap_tol).any()):
        raise AssertionError(f"{name}: {got.tolist()} != plain {ref.tolist()}, score regret {regret.tolist()}")
    return regret.abs().max().item(), int(decided.sum())


K1_NEAR = 4e-6  # a p within this (relative) of a bf16 rounding boundary may round either way in kernel and twin
K1_MAX_NEAR = 10  # at most this many such p in a row whose output differs beyond TOL (3^10 sets searched)


def _k1_flips(q, k, v, n_heads: int, causal: bool, b: int, r: int, h: int, d_got, d_ref) -> tuple[bool, float, int]:
    """Whether the bf16 output row (b, query r, head h) of K1 differs from
    its twin only by p values that lie at a bf16 rounding boundary: replay
    the twin's tile walk for the row in fp32, take each p within ``K1_NEAR``
    of a boundary (the replay's own scores are summed in another order, so
    either side may be the twin's), and find one move of each such p by the
    step between its two roundings, up, down or none (times the row's later
    rescales, over l), that brings every column of the row within TOL: one
    set of moves for all columns. Also holds the row to the per-element bound
    2^-8 * (P @ |V|) / l + 2^-7 * |o| + 1e-6 (P from the fp32 scores).
    Returns (explained, max excess over that bound, p near a boundary)."""
    import math

    import torch

    from pytorch_models_tpu_torch.ops.encoder_attention import K_TILE, NEG_INF

    d = q.shape[-1] // n_heads
    cols = slice(h * d, (h + 1) * d)
    qv, kk, vv = q[b, r, cols].float(), k[b, :, cols].float(), v[b, :, cols].float()
    n = min(k.shape[1], r + 1) if causal else k.shape[1]
    s = (kk[:n] @ qv) * (1.0 / math.sqrt(d))
    m, m_tile = NEG_INF, torch.empty_like(s)
    for kt in range(0, n, K_TILE[torch.bfloat16]):  # the running max each tile's p was taken against
        m = max(m, s[kt:kt + K_TILE[torch.bfloat16]].max().item())
        m_tile[kt:kt + K_TILE[torch.bfloat16]] = m
    p = torch.exp(s - m_tile)
    later = torch.exp(m_tile - m)  # the rescales after each key's tile
    l = (p * later).sum()
    bits = p.to(torch.bfloat16).view(torch.int16)  # p >= 0: the neighbours are one bit pattern up and down
    pr = bits.view(torch.bfloat16).float()
    up, down = ((bits + step).view(torch.bfloat16).float() for step in (1, -1))
    other = torch.where(p >= pr, up, down)  # the neighbour on p's side of its rounding
    near = ((p - (pr + other) / 2).abs() <= K1_NEAR * p).nonzero().flatten().tolist()
    atol, rtol = TOL["bfloat16"]
    diff, allow = d_got.float() - d_ref.float(), atol + rtol * d_ref.float().abs()
    p_final = torch.exp(s - m)
    bound = 2.0 ** -8 * (p_final @ vv[:n].abs()) / p_final.sum() + 2.0 ** -7 * d_ref.float().abs() + 1e-6
    excess = (diff.abs() - bound).max().item()
    if len(near) > K1_MAX_NEAR:
        return False, excess, len(near)
    if not near:
        return False, excess, 0
    steps = torch.stack([(other[j] - pr[j]).abs() * later[j] * vv[j] / l for j in near])  # (near, D)
    signs = torch.tensor([-1.0, 0.0, 1.0], device=steps.device)
    moves = torch.cartesian_prod(*[signs] * len(near)).reshape(-1, len(near))  # every up / none / down choice
    explained = bool(((diff[None] - moves @ steps).abs() <= allow[None]).all(-1).any())
    return explained and excess <= 0, excess, len(near)


def _check_k1(name: str, q, k, v, n_heads: int, causal: bool) -> tuple[float, int]:
    """K1 against its twin: every element within TOL, or, in bf16, every row
    beyond TOL explained by p values at a rounding boundary (``_k1_flips``).
    Returns (max |kernel - plain|, rows so explained)."""
    import torch

    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention, encoder_attention_plain

    got, ref = encoder_attention(q, k, v, n_heads, causal), encoder_attention_plain(q, k, v, n_heads, causal)
    dn = str(q.dtype).removeprefix("torch.")
    atol, rtol = TOL[dn]
    diff = (got.float() - ref.float()).abs()
    bad = diff > atol + rtol * ref.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    if not bad.any():
        return diff.max().item(), 0
    if q.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max |kernel - plain| = {diff.max().item()} "
                             f"(atol {atol}, rtol {rtol})")
    d = q.shape[-1] // n_heads
    rows = sorted({(bi, r, c // d) for bi, r, c in bad.nonzero().tolist()})
    for bi, r, h in rows:
        ok, excess, n_near = _k1_flips(q, k, v, n_heads, causal, bi, r, h, got[bi, r, h * d:(h + 1) * d],
                                       ref[bi, r, h * d:(h + 1) * d])
        if not ok:
            raise AssertionError(f"{name}: row (b={bi}, q={r}, head={h}) differs beyond TOL and not by p at a "
                                 f"rounding boundary ({n_near} p near one; excess over the per-element bound "
                                 f"{excess:.3g}); max |kernel - plain| = {diff.max().item()}")
    return diff.max().item(), len(rows)


def _k1_case(name: str, q, k, v, n_heads: int, causal: bool, iters: int) -> dict:
    """K1 at one shape: the kernel against its plain twin (``_check_k1``), then
    the device times of the kernel, the twin and SDPA on the split-head view
    (a yardstick the port never calls), and the bound: q, k, v read and the
    output written once; 2 x 2 multiply-adds per (query, key, channel) pair
    that the mask keeps; fp32 as 3xTF32."""
    import torch.nn.functional as F

    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention, encoder_attention_plain

    def heads(t):  # (B, L, H*D) -> the split-head (B, H, L, D) view SDPA takes
        return t.unflatten(-1, (n_heads, -1)).transpose(1, 2)

    dn = str(q.dtype).removeprefix("torch.")
    err, flipped = _check_k1(name, q, k, v, n_heads, causal)
    ms, plain_ms = _ab_ms([lambda: encoder_attention(q, k, v, n_heads, causal)],
                          [lambda: encoder_attention_plain(q, k, v, n_heads, causal)], iters)
    lib = _time_ms([lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), is_causal=causal)], iters)
    b, lq, hd = q.shape
    lk = k.shape[1]
    pairs = sum(min(i + 1, lk) for i in range(lq)) if causal else lq * lk
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return {**_rec(err, ms, plain_ms, nbytes, 4 * b * pairs * hd, dn, lib, tf32x3=True), "flipped": flipped}


def _k1_times(rec: dict) -> str:
    return (f"{rec['flipped']} rows beyond TOL by p at a rounding boundary | kernel {rec['ms'] * 1e3:.1f} us, "
            f"plain {rec['plain_ms'] * 1e3:.1f} us, SDPA {rec['library_ms'] * 1e3:.1f} us, "
            f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']})")


def _sass_tensor_core_counts(lib_path) -> dict | None:
    """Tensor-core instructions (``HMMA`` / ``HGMMA``) in each K1
    instantiation of the built library, from ``cuobjdump -sass``; None where
    the toolkit has no cuobjdump."""
    import re
    import shutil
    from pathlib import Path

    from pytorch_models_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._find_nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"encoder_attention_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", line)
            cur = None if m is None else f"{'fp32' if m.group(1) == 'f' else 'bf16'} D={m.group(2)} MT={m.group(3)}"
            if cur is not None:
                counts[cur] = 0
        elif cur is not None and re.search(r"\bHG?MMA\.", line):
            counts[cur] += 1
    return counts


def kernel_phases(dev, card: str) -> dict:
    """Each kernel vs its plain version at the slice's shapes, fp32 and bf16."""
    import torch

    from pytorch_models_tpu_torch.ops import _build
    from pytorch_models_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_cluster,
        decode_attention_plain,
    )
    from pytorch_models_tpu_torch.ops.encoder_attention import K_TILE
    from pytorch_models_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from pytorch_models_tpu_torch.ops.attention import use_greedy_head
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax_tied, greedy_argmax_tied_plain

    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def heads(t):  # (B, L, H*D) -> the split-head (B, H, L, D) view SDPA takes
        return t.unflatten(-1, (12, 64)).transpose(1, 2)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        tol = TOL[dn]

        # K1: the twin walks the kernel's key tiles; B=2, L in {7, 197, 1024}, dense and causal, H*D = 768
        k_tile = _build.load_library().pmt_encoder_attention_k_tile(_build.dtype_code(torch.zeros(1, dtype=dtype)))
        if k_tile != K_TILE[dtype]:
            raise AssertionError(f"encoder_attention {dn}: the kernel's key tile {k_tile} != K_TILE {K_TILE[dtype]}")
        err, flipped = 0.0, 0
        for L in (7, 197, 1024):
            q, k, v = (rnd(2, L, 768, dtype=dtype) for _ in range(3))
            for causal in (False, True):
                e, f = _check_k1(f"encoder_attention L={L} causal={causal} {dn}", q, k, v, 12, causal)
                err, flipped = max(err, e), flipped + f
        rec = res[("encoder_attention", dn)] = _k1_case(f"encoder_attention GPT-2 causal {dn}", q, k, v, 12, True, 20)
        rec["err"] = err = max(err, rec["err"])
        print(f"phase kernel encoder_attention {dn}: B=2 L=7,197,1024 dense+causal max_abs_err={err:.3g} "
              f"(atol, rtol)={tol}, {flipped} rows beyond it by p at a rounding boundary, key tile {k_tile} | "
              f"GPT-2 causal B=2 H=12 L=1024 {_k1_times(rec)} [{card}]")
        # the other head widths the kernel is built for: DETR's 32, ViT-H's 80, 128
        errs, flipped = {}, 0
        for d, h in ((32, 8), (80, 16), (128, 4)):
            for L in (7, 65, 300):
                qd, kd, vd = (rnd(2, L, h * d, dtype=dtype) for _ in range(3))
                for causal in (False, True):
                    e, f = _check_k1(f"encoder_attention D={d} L={L} causal={causal} {dn}", qd, kd, vd, h, causal)
                    errs[d], flipped = max(errs.get(d, 0.0), e), flipped + f
        rec["err"] = max(rec["err"], *errs.values())
        print(f"phase kernel encoder_attention {dn} (head widths): B=2 L=7,65,300 dense+causal, max_abs_err "
              + ", ".join(f"D={d} (H={h}) {errs[d]:.3g}" for d, h in ((32, 8), (80, 16), (128, 4)))
              + f" (atol, rtol)={tol}, {flipped} rows beyond it by p at a rounding boundary [{card}]")
        # ViT-B/16: the JAX kernel's design shape, B=128 images of 197 tokens, 12 heads of 64
        qv, kv_, vv = (rnd(128, 197, 768, dtype=dtype) for _ in range(3))
        vit = _k1_case(f"encoder_attention ViT-B/16 {dn}", qv, kv_, vv, 12, False, 10)
        rec["err"] = max(rec["err"], vit["err"])
        print(f"phase kernel encoder_attention {dn} (ViT-B/16): B=128 L=197 H=12 D=64 dense max_abs_err="
              f"{vit['err']:.3g} (atol, rtol)={tol} | {_k1_times(vit)} [{card}]")
        del qv, kv_, vv

        # K2: B=8, L=1024, mixed pads/ends, one empty row
        ends = torch.tensor([1024, 700, 5, 64, 1, 300, 1000, 512], dtype=torch.int32, device=dev)
        pads = torch.tensor([0, 10, 5, 0, 0, 299, 3, 100], dtype=torch.int32, device=dev)  # row 2 empty
        copies = [(rnd(8, 1, 768, dtype=dtype), rnd(8, 1024, 768, dtype=dtype), rnd(8, 1024, 768, dtype=dtype))
                  for _ in range(4 if dtype == torch.bfloat16 else 2)]
        q1, kc, vc = copies[0]
        out = decode_attention(q1, kc, vc, ends, 12, pads)
        err = _check_close(f"decode_attention {dn}", out, decode_attention_plain(q1, kc, vc, ends, 12, pads), tol)
        if out[2].abs().max().item() != 0.0:
            raise AssertionError("decode_attention: an empty [pad, end) row must give zeros")
        k2_ms, k2_plain = _ab_ms([lambda c=c: decode_attention(*c, ends, 12, pads) for c in copies],
                                 [lambda c=c: decode_attention_plain(*c, ends, 12, pads) for c in copies], 50)
        col = torch.arange(1024, device=dev)
        mask = ((col >= pads[:, None]) & (col < ends[:, None]))[:, None, None, :]
        k2_lib = _time_ms([lambda c=c: F.scaled_dot_product_attention(heads(c[0]), heads(c[1]), heads(c[2]),
                                                                     attn_mask=mask) for c in copies], 50)
        keys = int((ends - pads).clamp_min(0).sum())  # the valid [pad, end) ranges only
        rec = res[("decode_attention", dn)] = _rec(err, k2_ms, k2_plain, (2 * keys + 2 * 8) * 768 * q1.element_size(),
                                                   4 * keys * 768, dn, k2_lib)
        # the running max jumps: row 0's last key scores far above the rest (the row's last CTA)
        kj = kc.clone()
        kj[0, 1023] = 8.0 * q1[0, 0]
        jump = decode_attention(q1, kj, vc, ends, 12, pads)
        rec["err"] = max(err, _check_close(f"decode_attention max jump {dn}", jump,
                                           decode_attention_plain(q1, kj, vc, ends, 12, pads), tol))
        print(f"phase kernel decode_attention {dn}: B=8 L=1024 H=12 mixed pads/ends + empty row + a max jump, "
              f"cluster {decode_attention_cluster(8, 1024, 12)}: max_abs_err={rec['err']:.3g} (atol, rtol)={tol} | "
              f"kernel {k2_ms * 1e3:.1f} us, plain {k2_plain * 1e3:.1f} us, masked SDPA {k2_lib * 1e3:.1f} us, bound "
              f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}) [{card}]")
        # B=32: the per-op route above the fused step's 8 rows; mixed ranges with a full and an empty row
        r32 = torch.Generator(device=dev).manual_seed(SEED + 32)
        e32 = torch.randint(1, 1025, (32,), generator=r32, device=dev, dtype=torch.int32)
        p32 = (torch.rand(32, generator=r32, device=dev) * e32).to(torch.int32)
        e32[:2], p32[:2] = torch.tensor([1024, 300], dtype=torch.int32), torch.tensor([0, 300], dtype=torch.int32)
        c32 = [(rnd(32, 1, 768, dtype=dtype), rnd(32, 1024, 768, dtype=dtype), rnd(32, 1024, 768, dtype=dtype))
               for _ in range(2)]
        out = decode_attention(*c32[0], e32, 12, p32)
        e = _check_close(f"decode_attention B=32 {dn}", out, decode_attention_plain(*c32[0], e32, 12, p32), tol)
        if out[1].abs().max().item() != 0.0:
            raise AssertionError("decode_attention B=32: an empty [pad, end) row must give zeros")
        rec["err"] = max(rec["err"], e)
        t32 = _ab_ms([lambda c=c: decode_attention(*c, e32, 12, p32) for c in c32],
                     [lambda c=c: decode_attention_plain(*c, e32, 12, p32) for c in c32], 50)
        m32 = ((col >= p32[:, None]) & (col < e32[:, None]))[:, None, None, :]
        lib32 = _time_ms([lambda c=c: F.scaled_dot_product_attention(heads(c[0]), heads(c[1]), heads(c[2]),
                                                                     attn_mask=m32) for c in c32], 50)
        k32 = int((e32 - p32).clamp_min(0).sum())
        b32 = _rec(e, *t32, (2 * k32 + 2 * 32) * 768 * q1.element_size(), 4 * k32 * 768, dn, lib32)
        print(f"phase kernel decode_attention {dn} (B=32): L=1024 H=12 mixed pads/ends ({k32} keys), cluster "
              f"{decode_attention_cluster(32, 1024, 12)}: max_abs_err={e:.3g} (atol, rtol)={tol} | kernel "
              f"{t32[0] * 1e3:.1f} us, plain {t32[1] * 1e3:.1f} us, masked SDPA {lib32 * 1e3:.1f} us, bound "
              f"{b32['bound_ms'] * 1e3:.2f} us ({b32['bound_by']}) [{card}]")
        del c32

        # K3: V = 50257 and 1024, out-of-range ids, exact
        err = 0.0
        for V in (1024, 50257):
            table = rnd(V, 768, dtype=dtype)
            idx = torch.tensor([0, V - 1, -5, V + 17, 3, 3, 1000, 42], device=dev)
            err = max(err, _check_close(f"gather_rows V={V} {dn}", gather_rows(table, idx),
                                        gather_rows_plain(table, idx), (0.0, 0.0)))
        k3_ms, k3_plain = _ab_ms([lambda: gather_rows(table, idx)], [lambda: gather_rows_plain(table, idx)], 200)
        idx_c = idx.clamp(0, table.shape[0] - 1)  # the same lookups, ids in range (embedding does not clamp)
        k3_lib = _time_ms([lambda: F.embedding(idx_c, table)], 200)
        res[("gather_rows", dn)] = _rec(err, k3_ms, k3_plain, 2 * 8 * 768 * table.element_size() + 8 * 8, 0, dn,
                                        k3_lib)
        print(f"phase kernel gather_rows {dn}: V=1024,50257 N=8 ids incl. out-of-range: max_abs_err={err} (exact) | "
              f"kernel {k3_ms * 1e3:.1f} us, plain {k3_plain * 1e3:.1f} us [{card}]")

        # K4: V=50257, forced tie at rows 7 and 50000 for batch row 0; B=8 is the main path's batch, 16 to 200
        # the per-op route's (batches above the fused step's 8 rows; 64 and 200 above what the two-pass head
        # held in shared memory at fp32), each against what the batch gate (ops/attention.py use_greedy_head)
        # chooses between: the kernel, or the model's own head matmul in its dtype + argmax
        emb = rnd(50257, 768, dtype=dtype)
        parts, head1 = [], None
        for nb in (8, 16, 17, 32, 33, 64, 200):  # both sides of each of use_greedy_head's crossovers
            x = rnd(nb, 768, dtype=dtype)
            emb[7] = emb[50000] = x[0] * 4
            e, decided = _check_greedy(f"greedy_argmax_tied B={nb} {dn}", x, emb, 7)
            k4 = _ab_ms([lambda x=x: greedy_argmax_tied(x, emb)], [lambda x=x: greedy_argmax_tied_plain(x, emb)], 50)
            head = _time_ms([lambda x=x: torch.argmax(torch.matmul(x, emb.t()), dim=-1)], 50)
            r = _rec(e, *k4, (emb.numel() + x.numel()) * x.element_size(), 2 * nb * emb.numel(), dn,
                     tf32x3=True)  # no single call
            if nb == 8:
                rec = res[("greedy_argmax_tied", dn)] = r
                x1 = x[:1].contiguous()
                head1 = _ab_ms([lambda: greedy_argmax_tied(x1, emb)],
                               [lambda: torch.argmax(torch.matmul(x1, emb.t()), dim=-1)], 50)
            else:
                rec["err"] = max(rec["err"], e)
            parts.append(f"B={nb}: {decided}/{nb} decided rows equal, max score regret {e:.3g}, kernel "
                         f"{k4[0] * 1e3:.1f} us, plain {k4[1] * 1e3:.1f} us, head matmul + argmax {head * 1e3:.1f} us, "
                         f"bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), the gate takes the "
                         f"{'kernel' if use_greedy_head(nb, emb, tied=True) else 'matmul'}")
        print(f"phase kernel greedy_argmax_tied {dn}: V=50257 d=768, tie->lowest ok (score regret tol per row: "
              f"{'1e-3' if dtype == torch.float32 else 'one bf16 step of the top score'}) | " + "; ".join(parts)
              + f"; B=1 kernel {head1[0] * 1e3:.1f} us, head {head1[1] * 1e3:.1f} us [{card}]")
    torch.cuda.synchronize()
    return res


def embed_kernel_phase(dev, card: str) -> dict:
    """K3's one-launch decoder embedding (``embed_add``) vs its plain version,
    bit for bit, at the decoders' shapes: GPT-2 small's tables with ids per
    row (a decode step's B=8, int32 and int64, out-of-range ids; a B=8 x 60
    prefill chunk), Whisper-base's with a start position (a step, period 1;
    a 4-token prefill chunk, period 4), T5-base's gather without a position
    table. Times at GPT-2's decode step beside the plain version, the two K3
    gathers + cast + add it replaces, ``embedding`` + cast + add, and the
    launch floor: an empty kernel of the same grid timed the same way."""
    import torch
    import torch.nn.functional as F

    from pytorch_models_tpu_torch.ops import _build
    from pytorch_models_tpu_torch.ops.gather import embed_add, embed_add_plain, gather_rows

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    lib = _build.load_library()
    res = {}

    def ids(n, v):
        return torch.randint(0, v, (n,), generator=g, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        gpt_tok, gpt_pos = (torch.randn(v, 768, generator=g, device=dev).to(dtype) for v in (50257, 1024))
        w_tok, w_pos = (torch.randn(v, 512, generator=g, device=dev).to(dtype) for v in (51865, 448))
        t5_tok = torch.randn(32128, 768, generator=g, device=dev).to(dtype)
        step_ids = torch.tensor([0, 50256, -5, 50300, 7, 7, 1000, 42], device=dev)
        step_pos = torch.tensor([127, 127, 5, -1, 1030, 99, 99, 512], device=dev)
        cases = {
            "GPT-2 step int64": ((gpt_tok, step_ids, gpt_pos, step_pos), {}),
            "GPT-2 step int32": ((gpt_tok, step_ids.int(), gpt_pos, step_pos.int()), {}),
            "GPT-2 prefill 8 x 60": ((gpt_tok, ids(480, 50257), gpt_pos, ids(480, 1024)), {}),
            "Whisper step at 40": ((w_tok, ids(8, 51865).int(), w_pos), {"start": 40, "period": 1}),
            "Whisper prefill 8 x 4 at 0": ((w_tok, ids(32, 51865), w_pos), {"start": 0, "period": 4}),
            "T5 step, no position table": ((t5_tok, ids(8, 32128).int()), {}),
        }
        before = embed_add.launches
        for name, (args, kw) in cases.items():
            got, ref = embed_add(*args, **kw), embed_add_plain(*args, **kw)
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                raise AssertionError(f"embed_add {name} {dn}: not bit-equal to its plain version "
                                     f"(max |diff| {(got.float() - ref.float()).abs().max().item()})")
        torch.cuda.synchronize()
        if embed_add.launches - before != len(cases):
            raise AssertionError(f"embed_add {dn}: {embed_add.launches - before} launches for {len(cases)} calls")
        sid, spos = step_ids.int(), step_pos.int()
        k_ms, plain_ms = _ab_ms([lambda: embed_add(gpt_tok, sid, gpt_pos, spos)],
                                [lambda: embed_add_plain(gpt_tok, sid, gpt_pos, spos)], 200)
        gathers_ms = _time_ms([lambda: gather_rows(gpt_tok, sid) + gather_rows(gpt_pos, spos).to(dtype)], 200)
        cid, cpos = step_ids.clamp(0, 50256), step_pos.clamp(0, 1023)  # in range: embedding does not clamp
        pair_ms = _time_ms([lambda: F.embedding(cid, gpt_tok) + F.embedding(cpos, gpt_pos).to(dtype)], 200)
        stream = _build.stream_ptr(gpt_tok)
        floor_ms = _time_ms([lambda: _build.check("pmt_launch_floor", lib.pmt_launch_floor(8, 192, stream))], 200)
        nbytes = 8 * 768 * 3 * gpt_tok.element_size() + 2 * 8 * 4  # token and position rows, out, two id vectors
        rec = res[("embed_add", dn)] = _rec(0.0, k_ms, plain_ms, nbytes, 8 * 768, dn)  # no single library call
        rec.update(two_gathers_ms=gathers_ms, embedding_add_ms=pair_ms, launch_floor_ms=floor_ms)
        print(f"phase kernel embed_add {dn}: " + ", ".join(cases) + " bit-equal to plain (max_abs_err 0, exact) | "
              f"GPT-2 step B=8: kernel {k_ms * 1e3:.2f} us, launch floor (empty kernel, 8 x 192) {floor_ms * 1e3:.2f} "
              f"us, plain {plain_ms * 1e3:.2f} us, the two K3 gathers + cast + add it replaces "
              f"{gathers_ms * 1e3:.2f} us, embedding + cast + add {pair_ms * 1e3:.2f} us, bound {rec['bound_ms'] * 1e3:.4f} us "
              f"({rec['bound_by']}) [{card}]")
    torch.cuda.synchronize()
    return res


def _waveforms(b: int, seconds, seed: int):
    """``b`` seeded waveforms (noise with a slow envelope and a tone), each
    with a stretch of exact silence, zero-padded to 30 s: (b, W_SAMPLES) fp32."""
    r = np.random.default_rng(seed)
    out = np.zeros((b, W_SAMPLES), np.float32)
    for i, sec in enumerate(seconds):
        n = int(sec * 16_000)
        t = np.arange(n) / 16_000
        x = 0.3 * r.standard_normal(n) * (1 + np.sin(2 * np.pi * (i + 1) * t))
        x += 0.2 * np.sin(2 * np.pi * 150 * (i + 2) * t)
        x[n // 3: n // 3 + 16_000] = 0.0  # 1 s of exact silence: -inf log-mel frames
        out[i, :n] = x
    return out


def whisper_kernel_phases(dev, card: str) -> dict:
    """The kernels at Whisper-base's shapes: K5 (fp32 only, as the frontend
    runs it), K1 dense L=1500 and cross Lq=448/Lk=1500, K2 over the
    1536-slot cross cache with per-row ends, K4 at V=51865, d=512."""
    import torch

    import torch.nn.functional as F

    from pytorch_models_tpu_torch.audio2text import WhisperPreprocessor
    from pytorch_models_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_cluster,
        decode_attention_plain,
    )
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax_tied, greedy_argmax_tied_plain
    from pytorch_models_tpu_torch.ops.mel import _dft_constants, _mel_bands, log_mel_spectrogram, log_mel_spectrogram_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    res = {}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # K5: B=8 x 30 s, n_mels 80 and 128
    wav = torch.from_numpy(_waveforms(8, [30.0] * 8, SEED + 2)).to(dev)
    err, n_inf = 0.0, {}
    for n_mels in (80, 128):
        got, ref = log_mel_spectrogram(wav, n_mels=n_mels), log_mel_spectrogram_plain(wav, n_mels=n_mels)
        if got.shape != (8, n_mels, 3001) or bool(torch.isnan(got).any()):
            raise AssertionError(f"log_mel_spectrogram n_mels={n_mels}: shape {tuple(got.shape)} or NaN")
        if not torch.equal(torch.isinf(got), torch.isneginf(ref)) or bool(torch.isposinf(got).any()):
            raise AssertionError(f"log_mel_spectrogram n_mels={n_mels}: -inf pattern differs from plain")
        n_inf[n_mels] = int(torch.isneginf(ref).sum())
        fin = torch.isfinite(ref)
        keep = fin & (ref >= ref[fin].max() - 8)
        e = (got - ref).abs()[keep].max().item()
        if not n_inf[n_mels] or e > MEL_TOL:
            raise AssertionError(f"log_mel_spectrogram n_mels={n_mels}: max |kernel - plain| {e} > {MEL_TOL} "
                                 f"or no silent frame ({n_inf[n_mels]} -inf)")
        err = max(err, e)
    # the Whisper frontend: kernel vs the same clip + scale on the plain log-mel
    pre = WhisperPreprocessor(fused=True)(wav)
    ref = log_mel_spectrogram_plain(wav)[..., :-1]
    ref = (torch.maximum(ref, ref.amax((-2, -1), keepdim=True) - 8) + 4) / 4
    pre_err = _check_close("WhisperPreprocessor(fused=True)", pre, ref, (MEL_TOL / 4, 0.0))
    k5_ms, k5_plain = _ab_ms([lambda: log_mel_spectrogram(wav)], [lambda: log_mel_spectrogram_plain(wav)], 20)
    # waveform in, (8, 80, 3001) out; the DFT as the kernel computes it (3001 frames x 400 samples x 402 real
    # outputs per row) plus the mel product over each filter's band (its nonzero weights); no single PyTorch
    # call. The kernel runs the DFT as 3xTF32 on the tensor cores, so the kernels line takes the operations at
    # three TF32 passes (as K1's fp32 rows do); the phase also prints the fp32 CUDA-core time of the same work
    band = int(np.diff(_mel_bands(_dft_constants(400, 80, 16_000)[2]), axis=1).sum())
    k5_flops = 2 * 8 * 3001 * (400 * 402 + band)
    k5_bytes = (wav.numel() + 8 * 80 * 3001) * 4
    rec = res[("log_mel_spectrogram", "float32")] = _rec(max(err, pre_err), k5_ms, k5_plain, k5_bytes, k5_flops,
                                                         "float32", tf32x3=True)
    print(f"phase kernel log_mel_spectrogram float32: B=8 x 30 s (3001 frames), n_mels 80/128, -inf frames equal "
          f"({n_inf[80]}/{n_inf[128]} values), max |kernel - plain| where plain >= max-8: {err:.3g}, preprocessor "
          f"{pre_err:.3g} (tol {MEL_TOL}, {MEL_TOL / 4}) | n_mels 80 kernel {k5_ms * 1e3:.1f} us, plain "
          f"{k5_plain * 1e3:.1f} us, bound {rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']}: 3xTF32 tensor-core "
          f"ops, the mel product over {band} band weights), {k5_flops / PEAK_FLOPS['float32'] * 1e6:.1f} us (fp32 "
          f"CUDA-core ops), {k5_bytes / HBM_BYTES_PER_S * 1e6:.1f} us (bytes) [{card}]")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        tol = TOL[dn]
        # K1: the encoder's dense L=1500, and teacher-forced cross Lq=448, Lk=1500
        q, k, v = (rnd(8, 1500, 512, dtype=dtype) for _ in range(3))
        qx = rnd(8, 448, 512, dtype=dtype)
        rec = res[("encoder_attention", dn)] = _k1_case(f"encoder_attention dense L=1500 {dn}", q, k, v, 8, False, 10)
        cross = _k1_case(f"encoder_attention cross 448x1500 {dn}", qx, k, v, 8, False, 10)
        e1, e2 = rec["err"], cross["err"]
        rec["err"] = max(e1, e2)
        print(f"phase kernel encoder_attention {dn} (Whisper): B=8 H=8 dense L=1500 max_abs_err={e1:.3g}, cross "
              f"Lq=448 Lk=1500 {e2:.3g} (atol, rtol)={tol} | dense {_k1_times(rec)}; cross {_k1_times(cross)} [{card}]")

        # K2: one query per row over the write-once cross cache, ends = len
        ends = torch.full((8,), 1500, dtype=torch.int32, device=dev)
        copies = [(rnd(8, 1, 512, dtype=dtype), rnd(8, 1536, 512, dtype=dtype), rnd(8, 1536, 512, dtype=dtype))
                  for _ in range(4)]
        e = _check_close(f"decode_attention cross {dn}", decode_attention(*copies[0], ends, 8),
                         decode_attention_plain(*copies[0], ends, 8), tol)
        k2 = _ab_ms([lambda c=c: decode_attention(*c, ends, 8) for c in copies],
                    [lambda c=c: decode_attention_plain(*c, ends, 8) for c in copies], 50)
        xmask = (torch.arange(1536, device=dev) < 1500)[None, None, None, :]
        k2_lib = _time_ms([lambda c=c: F.scaled_dot_product_attention(*(t.unflatten(-1, (8, 64)).transpose(1, 2)
                                                                        for t in c), attn_mask=xmask)
                           for c in copies], 50)
        rec = res[("decode_attention", dn)] = _rec(e, *k2, (2 * 8 * 1500 + 2 * 8) * 512 * copies[0][0].element_size(),
                                                   4 * 8 * 1500 * 512, dn, k2_lib)
        print(f"phase kernel decode_attention {dn} (Whisper cross): B=8 L=1536 H=8 ends=1500, cluster "
              f"{decode_attention_cluster(8, 1536, 8)}: max_abs_err={e:.3g} (atol, rtol)={tol} | kernel "
              f"{k2[0] * 1e3:.1f} us, plain {k2[1] * 1e3:.1f} us, masked SDPA {k2_lib * 1e3:.1f} us, bound "
              f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}) [{card}]")

        # K4: the tied head at V=51865, d=512
        x, emb = rnd(8, 512, dtype=dtype), rnd(51865, 512, dtype=dtype)
        emb[11] = emb[51000] = x[0] * 4
        e, decided = _check_greedy(f"greedy_argmax_tied (Whisper) {dn}", x, emb, 11)
        k4 = _ab_ms([lambda: greedy_argmax_tied(x, emb)], [lambda: greedy_argmax_tied_plain(x, emb)], 50)
        res[("greedy_argmax_tied", dn)] = _rec(e, *k4, (emb.numel() + x.numel()) * x.element_size(),
                                               2 * 8 * emb.numel(), dn, tf32x3=True)
        print(f"phase kernel greedy_argmax_tied {dn} (Whisper): B=8 V=51865 d=512 tie->lowest ok, ids equal on "
              f"{decided}/8 decided rows, max score regret {e:.3g} | kernel {k4[0] * 1e3:.1f} us, plain "
              f"{k4[1] * 1e3:.1f} us [{card}]")
    torch.cuda.synchronize()
    return res


def t5_kernel_phases(dev, card: str) -> dict:
    """The T5-only kernel variants at T5-base's decode shapes: K2 with a
    key-major rel-pos bias (B=8, H=12, caches of 128 and 1024; a shared
    (1, L, H) bias, and a per-row (B, L, H) one with left pads), and K4 over
    the untied (d, V) classifier (B=8, 16 and 32, V=32128, d=768)."""
    import torch
    import torch.nn.functional as F

    from pytorch_models_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_cluster,
        decode_attention_plain,
    )
    from pytorch_models_tpu_torch.ops.attention import use_greedy_head
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax, greedy_argmax_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    res = {}

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def heads(t):  # (B, L, H*D) -> the split-head (B, H, L, D) view SDPA takes
        return t.unflatten(-1, (12, 64)).transpose(1, 2)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        tol = TOL[dn]
        err, moved, times, no_bias, recs = 0.0, [], {}, {}, {}
        for L, end in ((128, 41), (1024, 1000)):
            ends = torch.tensor([end, end // 2, 1, end, 7, end - 3, 64, 2], dtype=torch.int32, device=dev)
            pads = torch.tensor([0, 3, 0, end // 4, 6, 0, 63, 1], dtype=torch.int32, device=dev)
            copies = [(rnd(8, 1, 768, dtype=dtype), rnd(8, L, 768, dtype=dtype), rnd(8, L, 768, dtype=dtype))
                      for _ in range(4)]
            shared, per_row = T5_BIAS_SCALE * rnd(1, L, 12), T5_BIAS_SCALE * rnd(8, L, 12)
            for what, e, p, bias in (("shared", end, None, shared), ("per-row + pads", ends, pads, per_row)):
                got = decode_attention(*copies[0], e, 12, p, bias)
                err = max(err, _check_close(f"decode_attention bias L={L} {what} {dn}", got,
                                            decode_attention_plain(*copies[0], e, 12, p, bias), tol))
                moved.append((got.float() - decode_attention(*copies[0], e, 12, p).float()).abs().max().item())
            # the T5 decode step's call: every row at the same position, one shared bias
            times[L] = _ab_ms([lambda c=c: decode_attention(*c, end, 12, None, shared) for c in copies],
                              [lambda c=c: decode_attention_plain(*c, end, 12, None, shared) for c in copies], 50)
            no_bias[L] = _time_ms([lambda c=c: decode_attention(*c, end, 12) for c in copies], 50)
            col = torch.arange(L, device=dev)
            mask = (shared.transpose(1, 2)[:, :, None, :] + torch.where(col < end, 0.0, float("-inf"))).to(dtype)
            lib = _time_ms([lambda c=c: F.scaled_dot_product_attention(heads(c[0]), heads(c[1]), heads(c[2]),
                                                                       attn_mask=mask)
                            for c in copies], 50)
            # q and out once, the valid K/V prefix and its bias rows once
            recs[L] = _rec(err, *times[L], (2 * 8 * end + 2 * 8) * 768 * copies[0][0].element_size() + end * 12 * 4,
                           4 * 8 * end * 768, dn, lib)
        rec = recs[128]
        if dtype == torch.float32 and min(moved) <= 100 * tol[0]:
            raise AssertionError(f"decode_attention bias: the bias moved the output only {min(moved)}")
        rec["err"] = err
        res[("decode_attention_bias", dn)] = rec
        print(f"phase kernel decode_attention_bias {dn}: B=8 H=12 L=128 (ends 41) and 1024 (ends 1000), shared "
              f"(1, L, H) and per-row (B, L, H) + pads, bias N(0, 1) x {T5_BIAS_SCALE}: max_abs_err={err:.3g} "
              f"(atol, rtol)={tol}; the bias moves the output by >= {min(moved):.3g} | clusters L=128 "
              f"{decode_attention_cluster(8, 128, 12)}, L=1024 {decode_attention_cluster(8, 1024, 12)}; shared L=128 kernel "
              f"{times[128][0] * 1e3:.1f} us, plain {times[128][1] * 1e3:.1f} us, SDPA with the bias as a float mask "
              f"{rec['library_ms'] * 1e3:.1f} us, bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}), the "
              f"kernel without the bias {no_bias[128] * 1e3:.1f} us; L=1024 kernel {times[1024][0] * 1e3:.1f} us, "
              f"plain {times[1024][1] * 1e3:.1f} us, SDPA with the bias as a float mask "
              f"{recs[1024]['library_ms'] * 1e3:.1f} us, bound {recs[1024]['bound_ms'] * 1e3:.2f} us "
              f"({recs[1024]['bound_by']}), without the bias {no_bias[1024] * 1e3:.1f} us [{card}]")

        # K4-untied: the (d, V) classifier read as it lies, forced tie at columns 7 and 32000 for row 0; B=8 is
        # the T5 main path's batch, 16 to 200 the per-op route's (batches above the fused step's 8 rows)
        w = rnd(768, 32128, dtype=dtype)
        parts = []
        for nb in (8, 16, 17, 32, 33, 64, 200):  # both sides of each of use_greedy_head's crossovers
            x = rnd(nb, 768, dtype=dtype)
            w[:, 7] = w[:, 32000] = x[0] * 4
            e, decided = _check_greedy(f"greedy_argmax (untied) B={nb} {dn}", x, w, 7, untied=True)
            k4 = _ab_ms([lambda x=x: greedy_argmax(x, w)], [lambda x=x: greedy_argmax_plain(x, w)], 50)
            head = _time_ms([lambda x=x: torch.argmax(torch.matmul(x, w), dim=-1)], 50)
            r = _rec(e, *k4, (w.numel() + x.numel()) * x.element_size(), 2 * nb * w.numel(), dn,
                     tf32x3=True)  # no single call
            if nb == 8:
                rec = res[("greedy_argmax", dn)] = r
            else:
                rec["err"] = max(rec["err"], e)
            parts.append(f"B={nb}: {decided}/{nb} decided rows equal, max score regret {e:.3g}, kernel "
                         f"{k4[0] * 1e3:.1f} us, plain {k4[1] * 1e3:.1f} us, head matmul + argmax {head * 1e3:.1f} us, "
                         f"bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}), the gate takes the "
                         f"{'kernel' if use_greedy_head(nb, w, tied=False) else 'matmul'}")
        print(f"phase kernel greedy_argmax {dn} (untied, T5): V=32128 d=768, tie->lowest ok | " + "; ".join(parts)
              + f" [{card}]")
    torch.cuda.synchronize()
    return res


def _k7_model(dev, kind: str):
    """Full-width random layers for the K7 phase (init scale, from a seed):
    GPT-2 small (12 layers, d 768, tanh GELU, tied vocab 50257), the
    Whisper-base decoder (8 layers, d 512, cross-attention, exact GELU, tied
    vocab 51865) or the T5-base decoder (12 layers, d 768, RMSNorm, GEGLU
    mlp 2048, cross-attention, untied (d, V) classifier, vocab 32128). Norms
    are drawn off their identity init, so the check covers their parameters.
    Returns ``(layer config, layers, head table, final norm)``."""
    import torch

    from pytorch_models_tpu_torch import transformer as tfm
    from pytorch_models_tpu_torch.models.text.t5 import T5Config, t5_block_init
    from pytorch_models_tpu_torch.utils import tree_map

    gen = torch.Generator().manual_seed(SEED + 5)
    if kind == "t5":
        t5 = T5Config(32128, 768, 12, 12, 2048)
        cfg = tfm.LayerConfig(768, 12, 64, bias=False, act="approximate_gelu")
        layers = [t5_block_init(gen, t5, True) for _ in range(t5.n_layers)]
        vocab = t5.vocab_size
    else:
        n_layers, d, vocab, cross = (12, 768, 50257, False) if kind == "gpt2" else (8, 512, 51865, True)
        cfg = tfm.LayerConfig.make(d, cross_attn=cross, act="approximate_gelu" if kind == "gpt2" else "gelu")
        layers = [tfm.layer_init(gen, cfg) for _ in range(n_layers)]
    layers = tree_map(lambda t: t.to(dev), layers)
    d = cfg.d_model
    g = torch.Generator(device=dev).manual_seed(SEED + 8)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def norm():  # T5's norms have no bias
        return {"scale": 1 + 0.1 * rnd(d)} | ({} if kind == "t5" else {"bias": 0.1 * rnd(d)})

    for lp in layers:
        for name in [k for k in lp if k.endswith("norm")]:
            lp[name] = norm()
    return cfg, layers, rnd(d, vocab) if kind == "t5" else rnd(vocab, d), norm()


def decode_step_phases(dev, card: str) -> dict:
    """K7 against its plain version at the full GPT-2-small, Whisper-base and
    T5-base shapes, B=8, fp32 and bf16: mixed left pads with one row whose
    cached range is empty until pos (GPT-2, Whisper; T5 decodes without
    pads), per-row cross lengths with a short row, T5's seeded rel-pos self
    bias (which must move fp32 x_out by far more than its tolerance); x_out
    and the K/V written at pos elementwise, tok as the greedy head is
    checked. Times: the kernel, its plain version, and the per-op step it
    replaces (kernels on; layer stack + final norm + greedy head), in turns."""
    import torch

    from pytorch_models_tpu_torch import transformer as tfm
    from pytorch_models_tpu_torch.models.text.t5 import T5Config, _t5_decode_layers, relative_position_bias, rms_norm
    from pytorch_models_tpu_torch.ops import layer_norm
    from pytorch_models_tpu_torch.ops.decode_step import (
        fused_cross_decode_step,
        fused_decode_step,
        fused_decode_step_plain,
        pack_decode_weights,
        pack_greedy_head,
    )
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax, greedy_argmax_tied
    from pytorch_models_tpu_torch.utils import cast_tree

    res = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    b = 8
    for kind in ("gpt2", "whisper", "t5"):
        cfg32, layers32, emb32, final32 = _k7_model(dev, kind)
        cross, t5 = kind != "gpt2", kind == "t5"
        name = {"gpt2": "fused_decode_step", "whisper": "fused_cross_decode_step",
                "t5": "fused_cross_decode_step_t5"}[kind]
        n_layers, d, hd = len(layers32), cfg32.d_model, cfg32.n_heads * cfg32.head_dim
        l_max, pos = (1024, 127) if kind == "gpt2" else (128, 40)
        if t5:  # T5 decodes without left pads; its cross rows are prompts of 7-64 tokens in a 128-slot cache
            pads, lx = None, 128
            lens = torch.tensor([64, 64, 7, 64, 50, 64, 12, 64], dtype=torch.int32, device=dev)
            table = T5_BIAS_SCALE * torch.randn(12, 32, generator=g, device=dev)  # a seeded rel-pos table
            t5cfg = T5Config(32128, 768, 12, 12, 2048)
            bias_hl = relative_position_bias(table, torch.arange(l_max, device=dev), torch.arange(l_max, device=dev),
                                             False, t5cfg)[:, pos]  # (H, Lp): query pos, every key
            variant = dict(norm="rms", gated=True, sbias=bias_hl.t().contiguous())
        else:
            pads = torch.tensor([0, 5, pos, 3, 0, pos // 2, 1, 17], dtype=torch.int32, device=dev)
            lx, variant = 1536, {}
            lens = torch.tensor([1500, 1500, 7, 1500, 1200, 1500, 300, 1500], dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).removeprefix("torch.")
            layers = cast_tree(layers32, dtype)
            packed = pack_decode_weights(layers, dtype, cross=cross, gated=t5)
            head = pack_greedy_head(emb32, final32, dtype, tied=not t5)
            x = torch.randn(b, d, generator=g, device=dev).to(dtype)
            kc, vc = (torch.randn(n_layers, b, l_max, hd, generator=g, device=dev).to(dtype) for _ in range(2))
            xk, xv = ((torch.randn(n_layers, b, lx, hd, generator=g, device=dev).to(dtype) for _ in range(2))
                      if cross else (None, None))

            def kernel(kc=kc, vc=vc, variant=variant):
                if cross:
                    return fused_cross_decode_step(x, packed, kc, vc, xk, xv, lens, pos, pads, cfg32.n_heads,
                                                   cfg32.act, cfg32.norm_eps, head=head, **variant)
                return fused_decode_step(x, packed, kc, vc, pos, pads, cfg32.n_heads, cfg32.act, cfg32.norm_eps,
                                         head=head)

            def plain(kc=kc, vc=vc):
                ck = dict(cross_k=xk, cross_v=xv, cross_lens=lens) if cross else {}
                return fused_decode_step_plain(x, packed, kc, vc, pos, pads, cfg32.n_heads, cfg32.act,
                                               cfg32.norm_eps, head, **ck, **variant)

            kc_p, vc_p = kc.clone(), vc.clone()
            ref_x, ref_tok = plain(kc_p, vc_p)
            got_x, got_tok = kernel()
            torch.cuda.synchronize()
            tol = DS_TOL[dn]
            err = _check_close(f"{name} x_out {dn}", got_x, ref_x, tol)
            use = ((got_x.float() - ref_x.float()).abs() / (tol[0] + tol[1] * ref_x.float().abs())).max().item()
            kv0 = 0.0  # layer 0's K/V at pos, to one bf16 step; the deeper layers' to DS_TOL
            for c, c_ref, what in ((kc, kc_p, "k"), (vc, vc_p, "v")):
                kv0 = max(kv0, _check_close(f"{name} layer 0 {what} at pos {dn}", c[0, :, pos], c_ref[0, :, pos],
                                            TOL[dn]))
                err = max(err, _check_close(f"{name} {what} at pos {dn}", c[1:, :, pos], c_ref[1:, :, pos], tol))
                if not torch.equal(c[:, :, :pos], c_ref[:, :, :pos]):
                    raise AssertionError(f"{name} {dn}: the cache changed outside pos")
            err = max(err, kv0)
            moved = ""
            if t5:  # the self bias must matter: without it fp32 x_out leaves its tolerance far behind
                no_bias_x, _ = kernel(kc.clone(), vc.clone(), dict(variant, sbias=None))
                shift = (no_bias_x.float() - got_x.float()).abs().max().item()
                if dtype == torch.float32 and shift <= 100 * tol[0]:
                    raise AssertionError(f"{name}: the rel-pos self bias moved x_out only {shift}")
                moved = f"; without the self bias x_out moves by {shift:.3g}"
            # tok as the greedy head is checked: the plain scores, ids equal where the top-2 gap exceeds the
            # tolerance, the score regret within it on every row
            final_x = rms_norm(final32, ref_x) if t5 else layer_norm(final32, ref_x)
            s = torch.matmul(final_x.float(), head["emb"].float().t())
            if dtype == torch.bfloat16:
                s = s.to(dtype).float()
            top2 = s.topk(2, dim=-1).values
            gap_tol = GAP_TOL[0] + GAP_TOL[1] * top2[:, 0].abs() if dtype == torch.float32 else \
                2.0 ** -5 * top2[:, 0].abs()
            decided = top2[:, 0] - top2[:, 1] > gap_tol
            rows = torch.arange(b, device=dev)
            regret = s[rows, ref_tok] - s[rows, got_tok]
            if not torch.equal(got_tok[decided], ref_tok[decided]) or bool((regret.abs() > gap_tol).any()):
                raise AssertionError(f"{name} {dn}: tok {got_tok.tolist()} != plain {ref_tok.tolist()}, "
                                     f"regret {regret.tolist()}")

            # the per-op step K7 replaces, on the same buffers (views of the stacked caches)
            p = {"layers": layers}
            views = [{"k": kc[i], "v": vc[i]} for i in range(n_layers)]
            cross_views = ([{"k": xk[i], "v": xv[i], "len": lens} for i in range(n_layers)] if cross else None)
            final = cast_tree(final32, dtype)
            emb = cast_tree(emb32, dtype)

            def per_op():
                if t5:
                    h = _t5_decode_layers(p, t5cfg, x[:, None], views, cross_views, bias_hl[:, None], pos)
                    return greedy_argmax(rms_norm(final, h[:, 0]), emb)
                h, _ = tfm.decoder_apply(p, cfg32, x[:, None], self_caches=views, cross_caches=cross_views,
                                         pos=pos, pad_lens=pads)
                return greedy_argmax_tied(layer_norm(final, h[:, 0], cfg32.norm_eps), head["emb"])

            with torch.inference_mode():
                ms, plain_ms = _ab_ms([kernel], [plain], 10)
                ms2, op_ms = _ab_ms([kernel], [per_op], 20)
            item = x.element_size()
            w_el = sum(t.numel() for k, t in packed.items() if k.startswith("w"))
            small = sum(t.numel() for k, t in packed.items() if not k.startswith("w")) + 2 * d
            small += variant["sbias"].numel() if t5 else 0
            # cached keys read, per layer
            self_keys = b * pos if pads is None else int((pos - pads.clamp(max=pos)).sum())
            cross_keys = int(lens.sum()) if cross else 0
            nbytes = ((w_el + head["emb"].numel()) * item + small * 4 + 2 * b * d * item
                      + 2 * n_layers * (self_keys + cross_keys) * hd * item + 2 * n_layers * b * hd * item + 8 * b)
            flops = 2 * b * (w_el + head["emb"].numel()) + 4 * n_layers * hd * (self_keys + b + cross_keys)
            res[(name, dn)] = _rec(err, ms, plain_ms, nbytes, flops, dn)
            res[(name, dn)]["per_op_ms"] = op_ms
            r = res[(name, dn)]
            print(f"phase kernel {name} {dn}: {kind} {n_layers} layers d={d} B=8 pos={pos} "
                  + (f"pads {pads.tolist()}" if pads is not None else "no pads")
                  + (f" cross lens {lens.tolist()} of {lx}" if cross else "")
                  + (f", rel-pos table N(0, 1) x {T5_BIAS_SCALE}, untied head" if t5 else "")
                  + f" | max |kernel - plain| (x_out, K/V at pos) {err:.3g} (atol, rtol)={tol}, x_out at {use:.2f} of its "
                  f"tolerance, layer 0 K/V at pos {kv0:.3g} (atol, rtol)={TOL[dn]}{moved}; tok {got_tok.tolist()}"
                  f" ({int(decided.sum())}/8 decided, equal), max regret {regret.abs().max().item():.3g} | kernel "
                  f"{ms * 1e3:.1f} us ({ms2 * 1e3:.1f} us in the second pair), plain {plain_ms * 1e3:.1f} us, "
                  f"per-op step {op_ms * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}, "
                  f"{nbytes / 1e6:.1f} MB) [{card}]")
            res.update(_headless_check(kind, name, dn, card, x, packed, kc, vc, xk, xv, lens, pos, pads, cfg32,
                                       variant, final32, head))
    torch.cuda.synchronize()
    return res


def _headless_check(kind: str, name: str, dn: str, card: str, x, packed, kc, vc, xk, xv, lens, pos: int, pads, cfg,
                    variant: dict, final32, head) -> dict:
    """K7 headless (no final norm, no head: the sampled and beam loops) at
    the rows the new paths give it (GPT-2: 8, the sampled batch and G=2 x
    W=4 beams; Whisper and T5: W=4 beams), on ``decode_step_phases``'s
    inputs: x_out and the K/V written at pos against the plain twin (DS_TOL;
    layer 0's K/V to TOL), no token; the kernel and its twin in turns, the
    head matmul that follows it in torch, and the bound without a head."""
    import torch

    from pytorch_models_tpu_torch.models.text.t5 import rms_norm
    from pytorch_models_tpu_torch.ops import layer_norm
    from pytorch_models_tpu_torch.ops.decode_step import (
        fused_cross_decode_step,
        fused_decode_step,
        fused_decode_step_plain,
    )

    cross, t5 = kind != "gpt2", kind == "t5"
    b = 8 if kind == "gpt2" else BEAM_W
    n_layers, hd = kc.shape[0], kc.shape[3]
    hx = x[:b].contiguous()
    hk, hv = kc[:, :b].contiguous(), vc[:, :b].contiguous()
    hxk, hxv = (xk[:, :b].contiguous(), xv[:, :b].contiguous()) if cross else (None, None)
    hl, hp = lens[:b].contiguous(), None if pads is None else pads[:b].contiguous()
    args = (cfg.n_heads, cfg.act, cfg.norm_eps)

    def kernel(kc=hk, vc=hv):
        if cross:
            return fused_cross_decode_step(hx, packed, kc, vc, hxk, hxv, hl, pos, hp, *args, **variant)
        return fused_decode_step(hx, packed, kc, vc, pos, hp, *args)

    def plain(kc, vc):
        ck = dict(cross_k=hxk, cross_v=hxv, cross_lens=hl) if cross else {}
        return fused_decode_step_plain(hx, packed, kc, vc, pos, hp, *args, None, **ck, **variant)

    kp, vp = hk.clone(), hv.clone()
    ref_x, ref_tok = plain(kp, vp)
    got_x, got_tok = kernel()
    torch.cuda.synchronize()
    if got_tok is not None or ref_tok is not None:
        raise AssertionError(f"{name} headless: a token came back")
    tol = DS_TOL[dn]
    err = _check_close(f"{name} headless x_out {dn}", got_x, ref_x, tol)
    for c, c_ref, what in ((hk, kp, "k"), (hv, vp, "v")):
        err = max(err, _check_close(f"{name} headless layer 0 {what} at pos {dn}", c[0, :, pos], c_ref[0, :, pos],
                                    TOL[dn]),
                   _check_close(f"{name} headless {what} at pos {dn}", c[1:, :, pos], c_ref[1:, :, pos], tol))
    final = {k: v.to(hx.dtype) for k, v in final32.items()}
    emb = head["emb"].to(hx.dtype)
    xn = rms_norm(final, got_x) if t5 else layer_norm(final, got_x, cfg.norm_eps)
    with torch.inference_mode():
        ms, plain_ms = _ab_ms([kernel], [lambda: plain(hk, hv)], 10)
        head_ms = _time_ms([lambda: torch.matmul(xn, emb.t())], 50)
    item = hx.element_size()
    w_el = sum(t.numel() for k, t in packed.items() if k.startswith("w"))
    small = sum(t.numel() for k, t in packed.items() if not k.startswith("w")) + (variant["sbias"].numel() if t5 else 0)
    self_keys = b * pos if hp is None else int((pos - hp.clamp(max=pos)).sum())
    cross_keys = int(hl.sum()) if cross else 0
    nbytes = (w_el * item + small * 4 + 2 * b * hx.shape[1] * item + 2 * n_layers * (self_keys + cross_keys) * hd * item
              + 2 * n_layers * b * hd * item)
    flops = 2 * b * w_el + 4 * n_layers * hd * (self_keys + b + cross_keys)
    rec = _rec(err, ms, plain_ms, nbytes, flops, dn)
    rec["head_matmul_ms"] = head_ms
    print(f"phase kernel {name} headless {dn}: {kind} {n_layers} layers B={b} pos={pos} | max |kernel - plain| (x_out, "
          f"K/V at pos) {err:.3g} (atol, rtol)={tol} | kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
          f"{rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']}, {nbytes / 1e6:.1f} MB, no head); the head matmul that "
          f"follows it ({b} x {emb.shape[1]} x {emb.shape[0]}) {head_ms * 1e3:.1f} us [{card}]")
    return {(f"{name}_headless", dn): rec}


# K7's per-phase breakdown: (kind, dtype, int8 serving options of _k7_step) at B=8, each launched this many
# times with stamps
BREAKDOWN = (("gpt2", "bfloat16", {}), ("gpt2", "float32", {}), ("whisper", "bfloat16", {}), ("t5", "bfloat16", {}),
             ("gpt2", "float32", {"q8": True, "kv": True}))
BREAKDOWN_RUNS = 5


def _k7_step(dev, kind: str, dtype, g, model=None, a8=False, kv=False, kvx=False, q8=False, embed=False):
    """One K7 step at ``decode_step_phases``'s B=8 shapes on fresh random
    inputs: GPT-2 (pos 127 of 1024, mixed left pads), Whisper (pos 40, cross
    lengths 7-1500 of 1536) or T5 (pos 40, cross lengths 7-64 of 128, a
    seeded rel-pos self bias), optionally in an int8 serving variant as
    I8_VARIANTS names them (``int8_decode_step_phases``'s shapes). Returns
    ``(call(**kw), n_layers, cross)``, ``call`` launching the kernel on the
    same buffers each time."""
    import torch

    from pytorch_models_tpu_torch.models.text.t5 import T5Config, relative_position_bias
    from pytorch_models_tpu_torch.ops.decode_step import (
        fused_cross_decode_step,
        fused_decode_step,
        pack_decode_weights,
        pack_embed_tables,
        pack_greedy_head,
    )
    from pytorch_models_tpu_torch.ops.int8_kv import quantize_kv_caches
    from pytorch_models_tpu_torch.utils import cast_tree, quantize_tree_int8

    cfg, layers32, emb32, final32 = model or _k7_model(dev, kind)
    cross, t5, b = kind != "gpt2", kind == "t5", 8
    n_layers, d, hd = len(layers32), cfg.d_model, cfg.n_heads * cfg.head_dim
    l_max, pos = (1024, 127) if kind == "gpt2" else (128, 40)
    variant = {}
    if t5:
        pads, lx = None, 128
        lens = torch.tensor([64, 64, 7, 64, 50, 64, 12, 64], dtype=torch.int32, device=dev)
        table = T5_BIAS_SCALE * torch.randn(12, 32, generator=g, device=dev)
        bias_hl = relative_position_bias(table, torch.arange(l_max, device=dev), torch.arange(l_max, device=dev),
                                         False, T5Config(32128, 768, 12, 12, 2048))[:, pos]
        variant = dict(norm="rms", gated=True, sbias=bias_hl.t().contiguous())
    else:
        pads = torch.tensor([0, 5, pos, 3, 0, pos // 2, 1, 17], dtype=torch.int32, device=dev)
        lx = 1536
        lens = torch.tensor([1500, 1500, 7, 1500, 1200, 1500, 300, 1500], dtype=torch.int32, device=dev)
    layers = cast_tree(layers32, dtype)
    packed = pack_decode_weights(quantize_tree_int8(layers) if q8 else layers, dtype, cross=cross, gated=t5)
    head = pack_greedy_head(emb32, final32, dtype, tied=not t5, a8=a8)
    x = torch.randn(b, d, generator=g, device=dev).to(dtype)

    def caches(n, int8):
        raw = {k: torch.randn(n_layers, b, n, hd, generator=g, device=dev) for k in ("k", "v")}
        return quantize_kv_caches(raw) if int8 else {k: t.to(dtype) for k, t in raw.items()}

    sc = caches(l_max, kv)
    variant.update(a8=a8, kv_scales={"ks": sc["ks"], "vs": sc["vs"]} if kv else None)
    if cross:
        xc = caches(lx, kvx)
        variant["kv_scales_x"] = {"ks": xc["ks"], "vs": xc["vs"]} if kvx else None
    if embed:  # ids incl. one out of range
        tabs = pack_embed_tables(torch.randn(50257, d, generator=g, device=dev),
                                 3.0 * torch.randn(1024, d, generator=g, device=dev), dtype)
        ids = torch.tensor([5, 50256, 0, 17, 99999, 1234, 42, 7], device=dev)
        prow = (pos - torch.where(pads > pos, pos, pads)).to(torch.int64)
        variant.update(emb=tabs, tok_ids=ids, pos_rows=prow)
        x = None

    def call(**kw):
        if cross:
            return fused_cross_decode_step(x, packed, sc["k"], sc["v"], xc["k"], xc["v"], lens, pos, pads,
                                           cfg.n_heads, cfg.act, cfg.norm_eps, head=head, **variant, **kw)
        return fused_decode_step(x, packed, sc["k"], sc["v"], pos, pads, cfg.n_heads, cfg.act, cfg.norm_eps,
                                 head=head, **variant, **kw)

    return call, n_layers, cross


def decode_step_breakdown(dev, card: str) -> dict:
    """K7's time per phase, split in four parts from each block's
    %globaltimer stamps (``stamps=`` of the wrappers; never on the
    generators' path): barrier wait and skew, input load (norm, merge,
    gate), matvec or attention, epilogue, the barrier's own latency and the
    busiest block's time (``ops.decode_step.phase_breakdown``); µs, the
    median over the phases of one kind, over BREAKDOWN_RUNS launches after a
    warm-up, for each of BREAKDOWN. Prints one line per variant, with the
    sum over one step's phases of barrier and busy."""
    import torch

    from pytorch_models_tpu_torch.ops.decode_step import phase_breakdown, step_phase_kinds

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    models, res = {}, {}
    for kind, dn, opts in BREAKDOWN:
        if kind not in models:
            models[kind] = _k7_model(dev, kind)
        call, n_layers, cross = _k7_step(dev, kind, getattr(torch, dn), g, models[kind], **opts)
        kinds = step_phase_kinds(n_layers, cross, True)
        call()
        stamps: list = []
        for _ in range(BREAKDOWN_RUNS):
            call(stamps=stamps)
        torch.cuda.synchronize()
        st = torch.stack(stamps).cpu()
        if not bool((st > 0).all()):
            raise AssertionError(f"K7 breakdown {kind} {dn}: a block left a phase unstamped")
        kind = kind + "".join(f" {k}" for k in opts)  # q8: w8a16 weights, kv: int8 self-KV
        bd = res[(kind, dn)] = phase_breakdown(st, kinds)
        parts = ("wait", "load", "compute", "epilogue", "barrier", "busy")
        sums = {p: sum(bd[k][p] * bd[k]["n"] for k in dict.fromkeys(kinds)) for p in parts[-2:]}
        print(f"phase breakdown K7 {kind} {dn}: B=8, {len(kinds)} phases, step {bd['step']:.1f} us (stamped); "
              "per phase, us (median over the kind's phases; max over blocks but barrier: min) "
              "wait/load/compute/epilogue/barrier/busy: "
              + "; ".join(f"{k} x{bd[k]['n']} " + "/".join(f"{bd[k][p]:.2f}" for p in parts)
                          for k in dict.fromkeys(kinds))
              + " | summed over the step: " + ", ".join(f"{p} {sums[p]:.1f}" for p in sums) + f" [{card}]")
    torch.cuda.synchronize()
    return res


class _Tok:
    eos_token_id = None


# decode routes: (every dispatch flag, USE_FUSED_STEP)
ROUTES = {"fused": (None, None), "per-op": (None, False), "plain": (False, False)}


def _set_flags(on: bool | None, fused: bool | None = None) -> None:
    """Every dispatch flag to ``on``, ``USE_FUSED_STEP`` to ``fused``."""
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.ops import gather, mel

    attn.USE_DECODE_KERNEL = attn.USE_ENCODER_KERNEL = attn.USE_GREEDY_HEAD = gather.USE_GATHER_KERNEL = on
    mel.USE_MEL_KERNEL = on
    attn.USE_FUSED_STEP = fused


def _route(name: str) -> None:
    """fused: every flag auto (one K7 launch per greedy step); per-op: the
    kernels with USE_FUSED_STEP False; plain: every flag False."""
    _set_flags(*ROUTES[name])


def _kernels() -> dict:
    """Every kernel wrapper of the port, by name (each carries a launch count)."""
    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention
    from pytorch_models_tpu_torch.ops.decode_step import fused_cross_decode_step, fused_decode_step
    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention
    from pytorch_models_tpu_torch.ops.gather import embed_add, gather_rows
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax, greedy_argmax_tied
    from pytorch_models_tpu_torch.ops.int8_kv import int8_decode_attention
    from pytorch_models_tpu_torch.ops.mel import log_mel_spectrogram

    return {"encoder_attention": encoder_attention, "decode_attention": decode_attention,
            "gather_rows": gather_rows, "embed_add": embed_add, "greedy_argmax_tied": greedy_argmax_tied,
            "greedy_argmax": greedy_argmax,
            "log_mel_spectrogram": log_mel_spectrogram, "fused_decode_step": fused_decode_step,
            "fused_cross_decode_step": fused_cross_decode_step, "int8_kv": int8_decode_attention}


def _reset_launches() -> None:
    kernels = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    kernels["decode_attention"].bias_launches = 0
    for name in ("fused_decode_step", "fused_cross_decode_step"):
        kernels[name].variant_launches = dict.fromkeys(kernels[name].variant_launches, 0)


def _launches(required: set) -> dict:
    """Every wrapper's launches since :func:`_reset_launches`, K2's with a
    bias also on their own, and K7's with int8 KV, with w8a8 and with the
    embed phase (``fused_decode_step_kv_int8``, ...); raises unless each
    ``required`` one launched."""
    kernels = _kernels()
    counts = {name: fn.launches for name, fn in kernels.items()}
    counts["decode_attention_bias"] = kernels["decode_attention"].bias_launches
    for name in ("fused_decode_step", "fused_cross_decode_step"):
        counts.update({f"{name}_{k}": v for k, v in kernels[name].variant_launches.items()})
    missing = sorted(k for k in required if counts[k] <= 0)
    if missing:
        raise AssertionError(f"a main path never launched: {missing}")
    return counts


def _make_streams_move(dev, seed: int, embeddings: dict, stacks: list) -> None:
    """Random weights at the init's scale make the tied greedy head repeat its
    input token forever (the residual stays the token's own embedding), so
    token identity across routes would compare a constant stream. Seeded
    position embeddings at scale 3 (``embeddings["pos_embs"]``) and every
    layer matrix of ``stacks`` at 4x the init's scale make the streams move.
    At 6x Whisper amplifies fp32 rounding so much that kernel and plain part
    at near-ties (top-2 logits 0.0136 apart at 88.2, measured on an H100),
    which says nothing about the kernels."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    pos = embeddings["pos_embs"]
    embeddings["pos_embs"] = 3.0 * torch.randn(pos.shape, generator=g, device=dev)
    for layers in stacks:
        _scale_matrices(layers, 4.0)


def _scale_matrices(layers: list, factor: float) -> None:
    """Every linear weight ``{"w": ...}`` of the layers' blocks, times ``factor``."""
    for lp in layers:
        for block in lp.values():
            for lin in block.values():
                if isinstance(lin, dict):
                    lin["w"] *= factor


def _check_moving(what: str, rows, n_init) -> list[int]:
    """Distinct new tokens per row; raises unless every row has at least 3."""
    distinct = [len(set(r[n:])) for r, n in zip(rows, n_init)]
    if min(distinct) < 3:
        raise AssertionError(f"{what}: a greedy stream barely moves (distinct new tokens per row {distinct})")
    return distinct


def _event_ms(fn) -> tuple[float, object]:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _decode_steps(n_generated: list[int], total: int, all_stopped: bool) -> int:
    """Decode steps the generators' loops ran for rows that generated
    ``n_generated`` tokens each (the prefill's first included): ``total``
    unless every row stopped at EOS; then up to the first all-done check
    (every DONE_CHECK_EVERY steps) after the last row stopped."""
    from pytorch_models_tpu_torch.models.text.generator import DONE_CHECK_EVERY

    if not all_stopped:
        return total
    last = max(n_generated) - 1
    return min(-(-last // DONE_CHECK_EVERY) * DONE_CHECK_EVERY, total)


def _check_routes(what: str, outs: dict, gap_fn) -> str:
    """fp32 token rows of every route against the plain route's, row by row.
    A row may part only at a step whose plain top-2 logits lie within
    GAP_TOL (``gap_fn(row, prefix)`` gives the plain (top logit, top-2 gap)
    after ``prefix``); the parting is printed. Returns the partings."""
    notes = []
    for route, rows in outs.items():
        for i, (row, ref) in enumerate(zip(rows, outs["plain"])):
            if row == ref:
                continue
            n = min(len(row), len(ref))
            j = next((k for k in range(n) if row[k] != ref[k]), n)
            top, gap = gap_fn(i, ref[:j])
            note = f"{route} row {i} parts from plain at token {j}: plain top-2 logits {gap:.4g} apart at {top:.6g}"
            print(f"phase {what}: {note}")
            if gap >= GAP_TOL[0] + GAP_TOL[1] * abs(top):
                raise AssertionError(f"{what}: {note}, above the near-tie tolerance {GAP_TOL}")
            notes.append(note)
    return "; ".join(notes) or "none"


def _top2(logits) -> tuple[float, float]:
    t = logits.float().topk(2).values
    return t[0].item(), (t[0] - t[1]).item()


def main_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """GPT-2 small at full width through the port's entry points: fp32
    generation by the three routes (token identity, K7 once per step),
    scoring, bf16 agreement and the bf16 time phase; with ``profile_dir``,
    profiled bf16 generations (fused and per-op)."""
    import torch

    from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator

    kernels = _kernels()
    r = np.random.default_rng(SEED)
    prompts = [r.integers(0, 50257, n).tolist() for n in PROMPT_LENS]
    seqs = [r.integers(0, 50257, 1024).tolist() for _ in range(2)]

    t0 = time.perf_counter()
    model = GPT2.from_hf("gpt2", rng=SEED, device=dev)
    gen = DecoderGenerator(model, _Tok())
    c = model.cfg
    print(f"phase main: GPT2({c.n_layers}, {c.d_model}) vocab {c.vocab_size} ctx {c.max_seq_len} "
          f"built from seed {SEED} on {dev} in {time.perf_counter() - t0:.1f} s")

    def generate():
        return gen.generate_tokens_batch(prompts, max_tokens=N_NEW)

    def gap_fn(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(torch.tensor(prefix))[-1])

    # plain reference first (every flag False: no kernel launches)
    _route("plain")
    plain_scores = gen.score_tokens_batch(seqs)

    # the main path, counts from 0: scoring at the init's scale (SCORE_TOL was set there: the rescaled model
    # below amplifies fp32 summation order to 1.43e-3 in a log-prob, an H100 reading); then the streams made to
    # move, and generation by the plain (no launches), fused and per-op routes, fp32 and bf16
    _reset_launches()
    _route("fused")
    scores = gen.score_tokens_batch(seqs)
    _make_streams_move(dev, SEED + 7, model.params, [model.params["decoder"]["layers"]])
    _route("plain")
    outs32 = {"plain": generate()}
    _route("fused")
    outs32["fused"] = generate()
    k7_launches = kernels["fused_decode_step"].launches
    _route("per-op")
    outs32["per-op"] = generate()
    torch.cuda.synchronize()
    for route, rows in outs32.items():
        for row, p in zip(rows, prompts):
            if row[:len(p)] != p or len(row) != len(p) + N_NEW or not all(0 <= t < 50257 for t in row):
                raise AssertionError(f"fp32 generation ({route}): malformed row")
    steps = _decode_steps([N_NEW] * len(prompts), N_NEW - 1, False)  # no EOS: every step to the limit
    if k7_launches != steps:
        raise AssertionError(f"fused route: K7 launched {k7_launches} times for {steps} decode steps")
    distinct = _check_moving("main fp32 generate_tokens_batch", outs32["fused"], PROMPT_LENS)
    partings = _check_routes("main fp32", outs32, gap_fn)
    print(f"phase main fp32 generate_tokens_batch (position embeddings at scale 3, layer matrices at 4x the "
          f"init's): {len(prompts)} prompts of {min(PROMPT_LENS)}-{max(PROMPT_LENS)} "
          f"tokens, {N_NEW} new each: fused, per-op kernels and plain (every flag False) token-identical "
          f"(partings at near-ties: {partings}); K7 launched {k7_launches} times = {steps} decode steps; distinct "
          f"new tokens per row {distinct}")
    # above the fused step's 8 rows: B=16 decodes per-op, the tied greedy head (K4) once per decode step
    r16 = np.random.default_rng(SEED + 16)
    prompts16 = [r16.integers(0, 50257, n).tolist() for n in PROMPT_LENS * 2]
    outs16 = {}
    for route in ("plain", "per-op"):
        _route(route)
        before = kernels["greedy_argmax_tied"].launches
        outs16[route] = gen.generate_tokens_batch(prompts16, max_tokens=B16_NEW)
        k4_16 = kernels["greedy_argmax_tied"].launches - before
    torch.cuda.synchronize()
    for route, rows in outs16.items():
        if any(row[:len(p)] != p or len(row) != len(p) + B16_NEW for row, p in zip(rows, prompts16)):
            raise AssertionError(f"fp32 B=16 generation ({route}): malformed row")
    if k4_16 != B16_NEW - 1:
        raise AssertionError(f"per-op route at B=16: K4 launched {k4_16} times for {B16_NEW - 1} decode steps")
    partings16 = _check_routes("main fp32 B=16", outs16, gap_fn)
    print(f"phase main fp32 generate_tokens_batch B=16 (above the fused step's 8 rows): {B16_NEW} new tokens each, "
          f"per-op kernels and plain token-identical (partings at near-ties: {partings16}); K4 (tied) launched "
          f"{k4_16} times = {B16_NEW - 1} decode steps")
    _route("fused")
    model.to_bf16()
    out16 = {"fused": generate()}
    _route("per-op")
    out16["per-op"] = generate()
    torch.cuda.synchronize()
    launches = _launches({"encoder_attention", "decode_attention", "embed_add", "greedy_argmax_tied",
                          "fused_decode_step"})

    err = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) for a, b in zip(scores, plain_scores))
    if not all(np.isfinite(s).all() and len(s) == 1023 for s in scores) or err > SCORE_TOL:
        raise AssertionError(f"score_tokens_batch: max |kernel - plain| = {err} > {SCORE_TOL}")
    print(f"phase main fp32 score_tokens_batch (init-scale weights): 2 x 1024 tokens, max |kernel - plain| "
          f"log-prob = {err:.3g} (tol {SCORE_TOL})")

    _route("plain")
    out16["plain"] = generate()
    _route("fused")
    agree = {}
    for route in ("fused", "per-op"):
        agree[route] = np.mean([x == y for a, b, p in zip(out16[route], out16["plain"], prompts)
                                for x, y in zip(a[len(p):], b[len(p):])])
        if not all(len(a) - len(p) == N_NEW and all(0 <= t < 50257 for t in a) for a, p in zip(out16[route], prompts)):
            raise AssertionError(f"bf16 generation ({route}): malformed row")
    print(f"phase main bf16 generate_tokens_batch: new tokens agreeing with the plain bf16 path: fused "
          f"{agree['fused']:.4f}, per-op kernels {agree['per-op']:.4f}")
    print("phase main launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))

    # bf16 end-to-end rate of the three routes, in turns
    n_tok = len(prompts) * N_NEW
    times = {}
    for route in ("plain", "per-op", "fused", "fused", "per-op", "plain"):
        _route(route)
        ms, _ = _event_ms(generate)
        times.setdefault(route, []).append(ms)
    _route("fused")
    tps = {k: n_tok / (np.mean(v) / 1e3) for k, v in times.items()}
    print(f"phase time bf16 generate_tokens_batch B={len(prompts)} x {N_NEW} new (prefill included, CUDA events): "
          + ", ".join(f"{k} {tps[k]:.1f} tok/s ({np.mean(times[k]):.1f} ms)" for k in ROUTES) + f" [{card}]")
    if profile_dir is not None:
        for route in ("fused", "per-op"):
            _route(route)
            profile_phase(generate, f"bf16 generate_tokens_batch B={len(prompts)} x {N_NEW} new, {route} route",
                          f"profile_bf16_generate_{route}.json", profile_dir, card, lambda out: N_NEW - 1)
        _route("fused")
    return launches


def whisper_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """Whisper-base at full width through the port's entry points: fp32
    batched and single transcription by the three routes (token identity,
    K7 once per step), bf16 agreement, then the bf16 time phase; with
    ``profile_dir``, profiled bf16 batches. Returns the launches."""
    import torch

    from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
    from pytorch_models_tpu_torch.models.audio2text.whisper import whisper_encode

    kernels = _kernels()
    t0 = time.perf_counter()
    model = Whisper.from_openai("base", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 3, model.params["decoder"],
                       [model.params["encoder"]["layers"], model.params["decoder"]["layers"]])
    gen = WhisperGenerator(model)
    c = model.cfg
    audio = _waveforms(8, W_SECONDS, SEED + 4)
    wav = torch.from_numpy(audio).to(dev)
    max_tokens = len(W_INIT) + N_NEW
    n_init = len(W_INIT)
    print(f"phase whisper: Whisper({c.n_layers}+{c.n_layers} layers, {c.d_model}) vocab {c.vocab_size} "
          f"n_mels {c.n_mels} built from seed {SEED} on {dev} in {time.perf_counter() - t0:.1f} s; 8 waveforms of "
          f"{min(W_SECONDS)}-{max(W_SECONDS)} s, {n_init} initial tokens, {N_NEW} new at most")

    def transcribe():
        return gen.transcribe_tokens_batch(wav, W_INIT, W_EOT, max_tokens)

    def gap_fn(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(gen.preprocessor(wav[i:i + 1]), torch.tensor([prefix], device=dev))[0, -1])

    _route("plain")
    outs32 = {"plain": transcribe()}
    _reset_launches()
    _route("fused")
    outs32["fused"] = transcribe()
    k7_launches = kernels["fused_cross_decode_step"].launches
    single = gen.transcribe_tokens(audio[0][: int(W_SECONDS[0] * 16_000)], W_INIT, W_EOT, max_tokens)
    _route("per-op")
    outs32["per-op"] = transcribe()
    torch.cuda.synchronize()
    for rows in outs32.values():
        for row in rows:
            if (row[:n_init] != W_INIT or not n_init < len(row) <= max_tokens
                    or not all(0 <= t < c.vocab_size for t in row)):
                raise AssertionError(f"whisper transcription: malformed row {row}")
    fused = outs32["fused"]
    steps = _decode_steps([len(r) - n_init for r in fused], max_tokens - n_init - 1,
                          all(W_EOT in r[n_init:] for r in fused))
    if k7_launches != steps:
        raise AssertionError(f"whisper fused route: K7 launched {k7_launches} times for {steps} decode steps")
    distinct = _check_moving("whisper fp32 transcribe_tokens_batch", fused, [n_init] * len(fused))
    partings = _check_routes("whisper fp32", {**outs32, "single (fused)": [single]}, gap_fn)
    print(f"phase whisper fp32 transcribe_tokens_batch: fused, per-op kernels and plain (every flag False) "
          f"token-identical, and transcribe_tokens(row 0) equals its batch row (partings at near-ties: "
          f"{partings}); K7 launched {k7_launches} times = {steps} decode steps; generated lengths "
          f"{[len(r) - n_init for r in fused]}, distinct tokens per row {distinct}")

    _route("fused")
    model.to_bf16()
    out16 = {"fused": transcribe()}
    _route("per-op")
    out16["per-op"] = transcribe()
    torch.cuda.synchronize()
    launches = _launches({"encoder_attention", "decode_attention", "embed_add", "greedy_argmax_tied",
                          "log_mel_spectrogram", "fused_cross_decode_step"})
    for row in out16["fused"] + out16["per-op"]:
        if row[:n_init] != W_INIT or not n_init < len(row) <= max_tokens:
            raise AssertionError(f"whisper bf16 transcription: malformed row {row}")

    _route("plain")
    out16["plain"] = transcribe()
    _route("fused")
    agree = {k: np.mean([x == y for a, b in zip(out16[k], out16["plain"]) for x, y in zip(a[n_init:], b[n_init:])])
             for k in ("fused", "per-op")}
    print(f"phase whisper bf16 transcribe_tokens_batch: generated tokens agreeing with the plain bf16 path: fused "
          f"{agree['fused']:.4f}, per-op kernels {agree['per-op']:.4f}")
    print("phase whisper launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))

    # bf16 end-to-end rate of the three routes in turns; then the fused
    # route's stages (frontend, + encoder; the rest is the decode loop)
    times, n_gen = {}, {}
    for route in ("plain", "per-op", "fused", "fused", "per-op", "plain"):
        _route(route)
        ms, out = _event_ms(transcribe)
        times.setdefault(route, []).append(ms)
        n_gen[route] = sum(len(r) - n_init for r in out)
    _route("fused")
    with torch.inference_mode():
        mel_ms, _ = _event_ms(lambda: gen.preprocessor(wav))
        enc_ms, _ = _event_ms(lambda: whisper_encode(model.params, c, gen.preprocessor(wav)))
    parts = []
    for k in ROUTES:
        sec = np.mean(times[k]) / 1e3
        parts.append(f"{k} {8 / sec:.2f} segments/s, {sum(W_SECONDS) / sec:.1f} audio-s/s, {n_gen[k] / sec:.1f} "
                     f"generated tok/s ({sec * 1e3:.1f} ms, {n_gen[k]} tokens)")
    print(f"phase time bf16 transcribe_tokens_batch B=8 (30 s segments holding {sum(W_SECONDS)} s of audio), CUDA "
          f"events: " + "; ".join(parts) + f"; fused route stages: log-mel {mel_ms:.2f} ms, log-mel + encoder "
          f"{enc_ms:.2f} ms [{card}]")
    if profile_dir is not None:
        for route in ROUTES:
            _route(route)
            profile_phase(transcribe, f"bf16 transcribe_tokens_batch B=8, {route} route",
                          f"profile_bf16_whisper_{route}.json", profile_dir, card,
                          lambda out: _decode_steps([len(r) - n_init for r in out], max_tokens - n_init - 1,
                                                    all(W_EOT in r[n_init:] for r in out)))
        _route("fused")
    return launches


def _make_t5_streams_move(dev, seed: int, params: dict) -> None:
    """T5's rel-pos tables start at zero, which would leave every bias path
    unexercised: seed both stacks' tables at N(0, 1) x T5_BIAS_SCALE, and
    scale every layer matrix by T5_WEIGHT_SCALE, as the GPT-2 and Whisper
    smoke models are scaled. (At the init's scale T5's untied head already
    moves; a CPU run of the port at d 256 and full depth gave 33-58 distinct
    tokens of 63 per row at these scales, fp32 and float64 token-identical.)"""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    for side in ("encoder", "decoder"):
        stack = params[side]
        stack["attn_bias"] = T5_BIAS_SCALE * torch.randn(stack["attn_bias"].shape, generator=g, device=dev)
        _scale_matrices(stack["layers"], T5_WEIGHT_SCALE)


def t5_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """T5-base at full width through ``T5Generator.generate_tokens_batch``:
    fp32 generation by the three routes (token identity, K7 once per step;
    the per-op route launches K2 with the rel-pos bias and the untied head),
    bf16 agreement and the bf16 time phase; with ``profile_dir``, profiled
    bf16 generations. Returns the launches."""
    import torch

    from pytorch_models_tpu_torch.text import T5Generator, T5Model

    kernels = _kernels()
    t0 = time.perf_counter()
    model = T5Model.from_t5x("flan_t5-base", rng=SEED, device=dev)
    _make_t5_streams_move(dev, SEED + 9, model.params)
    gen = T5Generator(model=model)
    c = model.cfg
    r = np.random.default_rng(SEED + 10)
    prompts = [r.integers(2, c.vocab_size, n).tolist() for n in T5_PROMPT_LENS]  # no pad, no EOS
    print(f"phase t5: T5Model({c.n_layers}+{c.n_layers} layers, d {c.dim}, {c.n_heads} heads, mlp {c.mlp_dim}) vocab "
          f"{c.vocab_size} built from seed {SEED} on {dev} in {time.perf_counter() - t0:.1f} s (layer matrices at "
          f"{T5_WEIGHT_SCALE}x the init's, rel-pos tables N(0, 1) x {T5_BIAS_SCALE}); {len(prompts)} prompts of "
          f"{min(T5_PROMPT_LENS)}-{max(T5_PROMPT_LENS)} tokens, rows of {T5_MAX} tokens at most, EOS {T5_EOS}")

    def generate():
        return gen.generate_tokens_batch(prompts, T5_MAX, T5_PAD, T5_EOS)

    def gap_fn(i, prefix):
        _route("plain")
        return _top2(model(torch.tensor([prompts[i]], device=dev), torch.tensor([prefix], device=dev))[0, -1])

    def steps_of(rows):
        return _decode_steps([len(row) for row in rows], T5_MAX - 1, all(T5_EOS in row[1:] for row in rows))

    _route("plain")
    outs32 = {"plain": generate()}
    _reset_launches()
    _route("fused")
    outs32["fused"] = generate()
    k7_launches = kernels["fused_cross_decode_step"].launches
    single = gen.generate_tokens(prompts[0], T5_MAX, T5_PAD, T5_EOS)
    k7_single = kernels["fused_cross_decode_step"].launches - k7_launches
    _route("per-op")
    before = (kernels["decode_attention"].bias_launches, kernels["greedy_argmax"].launches)
    outs32["per-op"] = generate()
    torch.cuda.synchronize()
    per_op = (kernels["decode_attention"].bias_launches - before[0], kernels["greedy_argmax"].launches - before[1])
    for route, rows in outs32.items():
        for row in rows:
            if row[0] != T5_PAD or not 1 < len(row) <= T5_MAX or not all(0 <= t < c.vocab_size for t in row):
                raise AssertionError(f"t5 fp32 generation ({route}): malformed row {row}")
    fused = outs32["fused"]
    steps = steps_of(fused)
    if k7_launches != steps or k7_single != steps_of([single]):
        raise AssertionError(f"t5 fused route: K7 launched {k7_launches} times for {steps} decode steps "
                             f"({k7_single} for {steps_of([single])} of the single prompt)")
    if min(per_op) <= 0:
        raise AssertionError(f"t5 per-op route: K2 with a bias launched {per_op[0]}, K4-untied {per_op[1]} times")
    distinct = _check_moving("t5 fp32 generate_tokens_batch", fused, [1] * len(fused))
    if len({tuple(row) for row in fused}) < len(fused):
        raise AssertionError("t5 fp32: two prompts gave the same row: the encoder barely reaches the decoder")
    partings = _check_routes("t5 fp32", {**outs32, "single (fused)": [single]}, gap_fn)
    print(f"phase t5 fp32 generate_tokens_batch: fused, per-op kernels and plain (every flag False) "
          f"token-identical, and generate_tokens(prompt 0) equals its batch row (partings at near-ties: "
          f"{partings}); K7 launched {k7_launches} times = {steps} decode steps; per-op route: K2 with the rel-pos "
          f"bias {per_op[0]} launches, K4-untied {per_op[1]}; row lengths {[len(row) for row in fused]}, distinct "
          f"new tokens per row {distinct}")

    _route("fused")
    model.to_bf16()
    out16 = {"fused": generate()}
    _route("per-op")
    out16["per-op"] = generate()
    torch.cuda.synchronize()
    launches = _launches({"decode_attention", "decode_attention_bias", "gather_rows", "embed_add", "greedy_argmax",
                          "fused_cross_decode_step"})
    _route("plain")
    out16["plain"] = generate()
    _route("fused")
    for row in out16["fused"] + out16["per-op"] + out16["plain"]:
        if row[0] != T5_PAD or not 1 < len(row) <= T5_MAX:
            raise AssertionError(f"t5 bf16 generation: malformed row {row}")
    agree = {k: np.mean([x == y for a, b in zip(out16[k], out16["plain"]) for x, y in zip(a[1:], b[1:])])
             for k in ("fused", "per-op")}
    print(f"phase t5 bf16 generate_tokens_batch: new tokens agreeing with the plain bf16 path: fused "
          f"{agree['fused']:.4f}, per-op kernels {agree['per-op']:.4f}")
    print("phase t5 launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))

    # bf16 end-to-end rate of the three routes, in turns (encoder included)
    times, n_gen = {}, {}
    for route in ("plain", "per-op", "fused", "fused", "per-op", "plain"):
        _route(route)
        ms, out = _event_ms(generate)
        times.setdefault(route, []).append(ms)
        n_gen[route] = sum(len(row) - 1 for row in out)
    _route("fused")
    print(f"phase time bf16 t5 generate_tokens_batch B={len(prompts)}, rows of {T5_MAX} at most (encoder included, "
          f"CUDA events): " + ", ".join(f"{k} {n_gen[k] / (np.mean(times[k]) / 1e3):.1f} generated tok/s "
                                        f"({np.mean(times[k]):.1f} ms, {n_gen[k]} tokens)" for k in ROUTES)
          + f" [{card}]")
    if profile_dir is not None:
        for route in ("fused", "per-op"):
            _route(route)
            profile_phase(generate, f"bf16 t5 generate_tokens_batch B={len(prompts)}, {route} route",
                          f"profile_bf16_t5_{route}.json", profile_dir, card, steps_of)
        _route("fused")
    return launches


# ---------------------------------------------------------------------------
# int8 serving: K6 and K7's int8 variants, then the three models in int8 serving
# ---------------------------------------------------------------------------

# The per-op int8 stack vs K7 with int8 self-KV (both fp32 weights): both quantize the same values, but a
# projection summed in another order can move a value across an int8 rounding boundary, and one q or
# probability level then moves a head's context by about 1/127 of its scale, through the later layers. x_out
# is held to I8_DS_TOL (atol, rtol) (reading: 2.9e-3); the K/V written at pos: layer 0's int8 levels exactly,
# the later layers' one level apart at most, on at least I8_LEVELS_EQUAL of the values (reading: 0.9984).
I8_DS_TOL = (5e-2, 2e-2)
I8_LEVELS_EQUAL = 0.99
# K7's int8 variants vs the plain twin, layer by layer (_trace_layers): every layer runs once as the kernel
# and once as the twin from the kernel's own input, so no difference is carried from an earlier layer (whole
# stack, w8a8 fp32: 4.7e-2, every later layer's K/V moved). Each int8 K/V level the two write at pos that
# differs must be one level apart and lie within I8_MARGIN of a rounding boundary (in levels; bf16: or one
# bf16 step of the value, the two rounding their fp32 sums to bf16 apart), either as the twin computes it or
# with one w8a8 input level of the QKV phase that lies that close to its own boundary moved to its other side
# (readings: 3 levels in 12 layers of w8a16, all at a boundary, none needing a moved input; 0 elsewhere). x
# after the layer is held to I8_LAYER_TOL (atol, rtol): most layers sit at fp32 noise (2.4e-7 to 9.5e-7),
# and a layer where a phase input, q or probability level moved reads up to 6.5e-3 (GPT-2 w8a8, one layer
# of 12; T5 w8a8 3.3e-3); bf16 layers read 0 or one bf16 step of x (up to 0.016).
I8_LAYER_TOL = {"float32": (2e-2, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
I8_MARGIN = 1e-3
# the a8 head, held exactly on the kernel's own x_out: its final norm, summed in another order than the plain
# one, is taken as uncertain by this share of the row's absmax; an 8-bit hidden level within it of a rounding
# boundary may be either level, and the kernel's id must be the plain argmax for one such choice
A8_NORM_NOISE = 1e-6
A8_MAX_UNCERTAIN = 8


def _int8_levels(name: str, got, ref) -> float:
    """int8 caches written by two routes at one position: at most one level
    apart and equal on at least I8_LEVELS_EQUAL of the values. Returns the
    share of equal levels."""
    d = (got.int() - ref.int()).abs()
    equal = (d == 0).float().mean().item()
    if d.max().item() > 1 or equal < I8_LEVELS_EQUAL:
        raise AssertionError(f"{name}: int8 levels {d.max().item()} apart, {equal:.4f} equal "
                             f"(limit 1 level, {I8_LEVELS_EQUAL} equal)")
    return equal


def int8_kernel_phases(dev, card: str) -> dict:
    """K6 (int8 decode attention) vs its plain version, fp32 and bf16: at
    GPT-2's shape (B=8, H=12, cache 1024, K2's mixed ranges with an empty row,
    without and with the current position), Whisper-base's cross shape (B=8,
    H=8, 1500 frames in a 1536 cache, per-row lengths 0-1500) and T5-base's
    (B=8, H=12, cache 128 at pos 41 and 1024 at pos 1000, the current position
    and the key-major rel-pos bias). Library call: masked SDPA over the
    dequantized cache in the serving dtype (a yardstick: it reads twice the
    bytes and quantizes nothing)."""
    import torch
    import torch.nn.functional as F

    from pytorch_models_tpu_torch.ops.int8_kv import (
        int8_decode_attention,
        int8_decode_attention_cluster,
        int8_decode_attention_plain,
        quantize_kv_caches,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    res = {}

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def caches(b, lk, hd, n):
        return [quantize_kv_caches({"k": rnd(b, lk, hd), "v": rnd(b, lk, hd)}) for _ in range(n)]

    def kv(c):
        return c["k"], c["v"], c["ks"], c["vs"]

    def deq(c, key, dtype, n_heads):  # the split-head (B, H, L, D) view of a dequantized cache
        return (c[key].float() * c[key + "s"][..., None]).to(dtype).unflatten(-1, (n_heads, 64)).transpose(1, 2)

    def bound(keys, b, hd, item, cur=False, bias_rows=0):
        # int8 K/V and their fp32 scales for the keys read, q and out (and the current K/V) once
        nbytes = keys * (2 * hd + 8) + (4 if cur else 2) * b * hd * item + bias_rows * 4
        return nbytes, 4 * (keys + (b if cur else 0)) * hd  # int8 multiply-adds: scores and P @ V

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        tol = TOL[dn]
        item = torch.finfo(dtype).bits // 8

        # GPT-2: K2's mixed ranges (3,189 keys), without and with the current position
        ends = torch.tensor([1024, 700, 5, 64, 1, 300, 1000, 512], dtype=torch.int32, device=dev)
        pads = torch.tensor([0, 10, 5, 0, 0, 299, 3, 100], dtype=torch.int32, device=dev)  # row 2 empty
        cs = caches(8, 1024, 768, 4)
        qs = [(rnd(8, 1, 768).to(dtype), rnd(8, 768).to(dtype), rnd(8, 768).to(dtype)) for _ in cs]
        err = 0.0
        for cur in (False, True):
            kw = dict(cur_k=qs[0][1], cur_v=qs[0][2]) if cur else {}
            got = int8_decode_attention(qs[0][0], *kv(cs[0]), ends, 12, pads, **kw)
            err = max(err, _check_close(f"int8_decode_attention cur={cur} {dn}", got,
                                        int8_decode_attention_plain(qs[0][0], *kv(cs[0]), ends, 12, pads, **kw), tol))
            if not cur and got[2].abs().max().item() != 0.0:
                raise AssertionError("int8_decode_attention: an empty [pad, end) row must give zeros")
        # the running max jumps: row 0's last key, in the last block of the row's last CTA, scores far above
        # every earlier one, so each block's levels depend on the prefix max the cluster hands it
        kj = rnd(8, 1024, 768)
        kj[0, 1023] = 40.0 * qs[0][0][0, 0].float()
        cj = quantize_kv_caches({"k": kj, "v": rnd(8, 1024, 768)})
        err = max(err, _check_close(f"int8_decode_attention max jump {dn}",
                                    int8_decode_attention(qs[0][0], *kv(cj), ends, 12, pads),
                                    int8_decode_attention_plain(qs[0][0], *kv(cj), ends, 12, pads), tol))
        del kj, cj
        times = _ab_ms([lambda c=c, q=q: int8_decode_attention(q[0], *kv(c), ends, 12, pads) for c, q in zip(cs, qs)],
                       [lambda c=c, q=q: int8_decode_attention_plain(q[0], *kv(c), ends, 12, pads)
                        for c, q in zip(cs, qs)], 50)
        cur_ms = _time_ms([lambda c=c, q=q: int8_decode_attention(q[0], *kv(c), ends, 12, pads, q[1], q[2])
                           for c, q in zip(cs, qs)], 50)
        col = torch.arange(1024, device=dev)
        mask = ((col >= pads[:, None]) & (col < ends[:, None]))[:, None, None, :]
        dq = [(q[0].unflatten(-1, (12, 64)).transpose(1, 2), deq(c, "k", dtype, 12), deq(c, "v", dtype, 12))
              for c, q in zip(cs, qs)]
        lib = _time_ms([lambda t=t: F.scaled_dot_product_attention(*t, attn_mask=mask) for t in dq], 50)
        keys = int((ends - pads).clamp_min(0).sum())
        nbytes, ops = bound(keys, 8, 768, item)
        rec = res[("int8_kv", dn)] = _rec(err, *times, nbytes, ops, "int8", lib)
        print(f"phase kernel int8_kv {dn}: B=8 Lk=1024 H=12 K2's pads/ends ({keys} keys) + empty row, without and "
              f"with the current position, and a max jump, cluster {int8_decode_attention_cluster(8, 1024, 12)}: "
              f"max_abs_err={err:.3g} (atol, rtol)={tol} | kernel {times[0] * 1e3:.1f} us "
              f"({cur_ms * 1e3:.1f} us with the current position), plain {times[1] * 1e3:.1f} us, masked SDPA over "
              f"the dequantized cache {lib * 1e3:.1f} us, bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}, "
              f"{nbytes / 1e6:.2f} MB) [{card}]")

        # Whisper-base cross: 1500 frames in a 1536 cache, per-row lengths with a short and an empty row
        lens = torch.tensor([1500, 1500, 7, 1500, 1200, 0, 300, 1500], dtype=torch.int32, device=dev)
        cs = caches(8, 1536, 512, 4)
        qx = [rnd(8, 1, 512).to(dtype) for _ in cs]
        got = int8_decode_attention(qx[0], *kv(cs[0]), lens, 8)
        e = _check_close(f"int8_decode_attention cross {dn}", got,
                         int8_decode_attention_plain(qx[0], *kv(cs[0]), lens, 8), tol)
        if got[5].abs().max().item() != 0.0:
            raise AssertionError("int8_decode_attention cross: an empty row must give zeros")
        rec["err"] = max(rec["err"], e)
        tx = _ab_ms([lambda c=c, q=q: int8_decode_attention(q, *kv(c), lens, 8) for c, q in zip(cs, qx)],
                    [lambda c=c, q=q: int8_decode_attention_plain(q, *kv(c), lens, 8) for c, q in zip(cs, qx)], 50)
        xmask = (torch.arange(1536, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        dqx = [(q.unflatten(-1, (8, 64)).transpose(1, 2), deq(c, "k", dtype, 8), deq(c, "v", dtype, 8))
               for c, q in zip(cs, qx)]
        libx = _time_ms([lambda t=t: F.scaled_dot_product_attention(*t, attn_mask=xmask) for t in dqx], 50)
        xkeys = int(lens.sum())
        xb, xo = bound(xkeys, 8, 512, item)
        rx = _rec(e, *tx, xb, xo, "int8", libx)
        print(f"phase kernel int8_kv {dn} (Whisper cross): B=8 Lk=1536 H=8 lens {lens.tolist()} ({xkeys} keys), "
              f"cluster {int8_decode_attention_cluster(8, 1536, 8)}: "
              f"max_abs_err={e:.3g} (atol, rtol)={tol} | kernel {tx[0] * 1e3:.1f} us, plain {tx[1] * 1e3:.1f} us, "
              f"masked SDPA over the dequantized cache {libx * 1e3:.1f} us, bound {rx['bound_ms'] * 1e3:.2f} us "
              f"({rx['bound_by']}, {xb / 1e6:.2f} MB) [{card}]")

        # T5-base: the self-attention step at pos with the current position and the rel-pos bias
        parts = []
        for lk, pos in ((128, 41), (1024, 1000)):
            cs = caches(8, lk, 768, 4)
            qt = [(rnd(8, 1, 768).to(dtype), rnd(8, 768).to(dtype), rnd(8, 768).to(dtype)) for _ in cs]
            sb = T5_BIAS_SCALE * rnd(lk, 12)
            got = int8_decode_attention(qt[0][0], *kv(cs[0]), pos, 12, None, qt[0][1], qt[0][2], sb)
            e = _check_close(f"int8_decode_attention bias Lk={lk} {dn}", got,
                             int8_decode_attention_plain(qt[0][0], *kv(cs[0]), pos, 12, None, qt[0][1], qt[0][2], sb),
                             tol)
            moved = (got.float() - int8_decode_attention(qt[0][0], *kv(cs[0]), pos, 12, None, qt[0][1],
                                                         qt[0][2]).float()).abs().max().item()
            if dtype == torch.float32 and moved <= 100 * tol[0]:
                raise AssertionError(f"int8_decode_attention: the bias moved the output only {moved}")
            rec["err"] = max(rec["err"], e)
            tt = _ab_ms([lambda c=c, q=q: int8_decode_attention(q[0], *kv(c), pos, 12, None, q[1], q[2], sb)
                         for c, q in zip(cs, qt)],
                        [lambda c=c, q=q: int8_decode_attention_plain(q[0], *kv(c), pos, 12, None, q[1], q[2], sb)
                         for c, q in zip(cs, qt)], 50)
            tb, to = bound(8 * pos, 8, 768, item, cur=True, bias_rows=(pos + 1) * 12)

            def dequantized(c, q):  # (q, K, V) split-head: the dequantized cache [0, pos), the current K/V at pos
                kd, vd = (deq(c, key, dtype, 12)[:, :, :pos + 1].clone() for key in ("k", "v"))
                kd[:, :, pos], vd[:, :, pos] = q[1].unflatten(-1, (12, 64)), q[2].unflatten(-1, (12, 64))
                return q[0].unflatten(-1, (12, 64)).transpose(1, 2), kd, vd

            tmask = sb[:pos + 1].t()[None, :, None, :].to(dtype)  # the key-major bias as a float mask
            dqt = [dequantized(c, q) for c, q in zip(cs, qt)]
            libt = _time_ms([lambda t=t: F.scaled_dot_product_attention(*t, attn_mask=tmask) for t in dqt], 50)
            rt = _rec(e, *tt, tb, to, "int8", libt)
            parts.append(f"Lk={lk} pos={pos} cluster {int8_decode_attention_cluster(8, lk, 12)}: max_abs_err={e:.3g}, "
                         f"the bias moves the output by {moved:.3g}, kernel "
                         f"{tt[0] * 1e3:.1f} us, plain {tt[1] * 1e3:.1f} us, SDPA over the dequantized cache with "
                         f"the bias as a float mask {libt * 1e3:.1f} us, bound {rt['bound_ms'] * 1e3:.2f} us "
                         f"({rt['bound_by']})")
        print(f"phase kernel int8_kv {dn} (T5 self + current + rel-pos bias N(0, 1) x {T5_BIAS_SCALE}), B=8 H=12: "
              + "; ".join(parts) + f" (atol, rtol)={tol} [{card}]")
    torch.cuda.synchronize()
    return res


def int8_stack_path(dev, card: str) -> dict:
    """The per-op int8 decode route: one GPT-2-small decode step (12 layers,
    d 768, B=8, pos 127 in a 1024 cache, left pads) through
    ``transformer.decoder_apply`` over per-layer int8 caches, where each
    layer's self-attention is one K6 launch, held against K7 with int8
    self-KV (``kv_scales``) on a copy of the same caches: one layer stack run
    twice, two kernels against each other. Counts from 0 before the per-op
    run; returns K6's launches there."""
    import torch

    from pytorch_models_tpu_torch import transformer as tfm
    from pytorch_models_tpu_torch.ops.decode_step import fused_decode_step, pack_decode_weights
    from pytorch_models_tpu_torch.ops.int8_kv import int8_decode_attention, quantize_kv_caches

    cfg, layers, _, _ = _k7_model(dev, "gpt2")
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    pos = 127
    pads = torch.tensor([0, 5, pos, 3, 0, pos // 2, 1, 17], dtype=torch.int32, device=dev)
    x = torch.randn(8, 768, generator=g, device=dev)
    c = quantize_kv_caches({k: torch.randn(12, 8, 1024, 768, generator=g, device=dev) for k in ("k", "v")})
    c2 = {k: t.clone() for k, t in c.items()}
    views = [{k: t[i] for k, t in c.items()} for i in range(12)]
    _reset_launches()
    with torch.inference_mode():
        h, _ = tfm.decoder_apply({"layers": layers}, cfg, x[:, None], self_caches=views, pos=pos, pad_lens=pads)
    torch.cuda.synchronize()
    k6 = int8_decode_attention.launches
    if k6 != 12:
        raise AssertionError(f"per-op int8 step: K6 launched {k6} times for 12 layers")
    x_out, _ = fused_decode_step(x, pack_decode_weights(layers, torch.float32), c2["k"], c2["v"], pos, pads,
                                 cfg.n_heads, cfg.act, cfg.norm_eps, kv_scales={"ks": c2["ks"], "vs": c2["vs"]})
    torch.cuda.synchronize()
    err = _check_close("per-op int8 step vs K7 int8-KV x_out", x_out, h[:, 0], I8_DS_TOL)
    equal = min(_int8_levels(f"per-op int8 step vs K7 {key} at pos", c2[key][1:, :, pos], c[key][1:, :, pos])
                for key in ("k", "v"))
    for key in ("k", "v"):
        if not torch.equal(c2[key][0, :, pos], c[key][0, :, pos]):
            raise AssertionError(f"per-op int8 step vs K7: layer 0's {key} at pos differs")
        if not torch.equal(c2[key][:, :, :pos], c[key][:, :, :pos]):
            raise AssertionError("per-op int8 step vs K7: a cache changed outside pos")
    print(f"phase int8 per-op step: GPT-2 small fp32, 12 layers, B=8 pos={pos} pads {pads.tolist()}, int8 caches of "
          f"1024: transformer.decoder_apply (K6 launched {k6} times, once per layer) vs K7 with int8 self-KV on a "
          f"copy: "
          f"x_out max |diff| {err:.3g} (atol, rtol)={I8_DS_TOL}, int8 K/V at pos equal on layer 0 and on "
          f">= {equal:.4f} of the later layers' values (one level at most) [{card}]")
    return {"int8_kv": k6}


def _head_check(name: str, head: dict, x, tok, eps: float, norm: str) -> tuple[int, float]:
    """The step's token ``tok`` (B,) against the plain head run on the
    kernel's own ``x`` (B, d). The a8 head exactly: the int8 hidden levels
    (their row scale unapplied) times the int8 table, summed exactly in
    float64, times ``emb_s`` in fp32, argmax with ties to the lowest index;
    a level within ``A8_NORM_NOISE`` of a rounding boundary may be either
    (see the constant). A float head as the K7 phase checks it: ids equal
    where the top-2 gap exceeds GAP_TOL (fp32) or 2^-5 of the top score
    (bf16), the score regret within it. Returns (hidden levels taken as
    uncertain, max score regret)."""
    import itertools

    import torch

    from pytorch_models_tpu_torch.ops.decode_step import _norm

    rows = torch.arange(x.shape[0], device=x.device)
    if "emb_s" not in head:
        s = torch.matmul(_norm(head["fn_s"], head["fn_b"], x, eps, norm).float(), head["emb"].float().t())
        if x.dtype == torch.bfloat16:
            s = s.to(x.dtype).float()
        top2 = s.topk(2, dim=-1).values
        gap_tol = GAP_TOL[0] + GAP_TOL[1] * top2[:, 0].abs() if x.dtype == torch.float32 else \
            2.0 ** -5 * top2[:, 0].abs()
        plain = s.argmax(dim=-1)
        regret = s[rows, plain] - s[rows, tok]
        decided = top2[:, 0] - top2[:, 1] > gap_tol
        if not torch.equal(tok[decided], plain[decided]) or bool((regret.abs() > gap_tol).any()):
            raise AssertionError(f"{name}: tok {tok.tolist()} != plain head {plain.tolist()} on the kernel's x_out, "
                                 f"regret {regret.tolist()}")
        return 0, regret.abs().max().item()
    # the a8 head: the plain norm in fp32 before its rounding to x's dtype, the kernel's within the noise of it
    y = _norm(head["fn_s"], head["fn_b"], x.float(), eps, norm)
    noise = A8_NORM_NOISE * y.abs().amax(dim=-1, keepdim=True)
    absmax = y.to(x.dtype).float().abs().amax(dim=-1, keepdim=True)
    r = torch.where(absmax == 0, torch.ones_like(absmax), absmax) * (1.0 / 127.0)
    lo = torch.round((y - noise).to(x.dtype).float() / (r * (1 + A8_NORM_NOISE))).clamp(-127, 127)
    hi = torch.round((y + noise).to(x.dtype).float() / (r * (1 - A8_NORM_NOISE))).clamp(-127, 127)
    lo, hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
    table = head["emb"].double().t()
    n_uncertain = 0
    for i in range(x.shape[0]):
        mid = torch.round(y[i].to(x.dtype).float() / r[i]).clamp(-127, 127)
        open_ = (lo[i] != hi[i]).nonzero().flatten()
        n_uncertain += len(open_)
        if len(open_) > A8_MAX_UNCERTAIN:
            raise AssertionError(f"{name}: row {i} has {len(open_)} hidden levels within the norm's noise")
        ids = []
        for pick in itertools.product((0, 1), repeat=len(open_)):
            q = mid.clone()
            if len(open_):
                q[open_] = torch.where(torch.tensor(pick, device=x.device) == 1, hi[i, open_], lo[i, open_])
            ids.append((torch.matmul(q.double(), table).float() * head["emb_s"]).argmax().item())
            if ids[-1] == tok[i].item():
                break
        else:
            raise AssertionError(f"{name}: row {i} id {tok[i].item()} is not the a8 head's argmax {ids} on the "
                                 f"kernel's x_out ({len(open_)} hidden levels within the norm's noise)")
    return n_uncertain, 0.0


def _qkv_replica(packed: dict, i: int, x, eps: float, norm: str, a8: bool, h_q=None):
    """Layer ``i``'s QKV phase as the plain twin computes it, from the
    layer's input ``x``: ``(q|k|v (B, 3*H*D) in x's dtype, its w8a8 input
    levels and row scales or None)``; ``h_q`` replaces the input levels."""
    import torch

    from pytorch_models_tpu_torch.ops.decode_step import _norm
    from pytorch_models_tpu_torch.ops.int8_kv import quantize_rows

    h = _norm(packed["ln1_s"][i], packed["ln1_b"][i], x, eps, norm)
    w = packed["wqkv"][i]
    levels = None
    if w.dtype == torch.int8 and a8:
        hq, r = quantize_rows(h)
        levels = (hq if h_q is None else h_q, r, h)
        acc = torch.matmul(levels[0].double(), w.double()).float() * r
    else:
        acc = torch.matmul(h.float(), w.float())
    if w.dtype == torch.int8:
        acc = acc * packed["s_qkv"][i]
    return (acc + packed["bqkv"][i].float()).to(x.dtype), levels


def _near(t, dt):
    """Which quantizer inputs ``t`` (in levels) lie within I8_MARGIN of a
    rounding boundary (bf16: or within one bf16 step of the value)."""
    import torch

    margin = (t - t.floor() - 0.5).abs()
    window = I8_MARGIN if dt == torch.float32 else torch.clamp(t.abs() * 2.0 ** -7, min=I8_MARGIN)
    return margin < window


def _explain_kv(name: str, packed: dict, i: int, x, eps: float, norm: str, a8: bool, kern: dict, twin: dict,
                hd: int) -> dict:
    """Layer ``i``'s int8 K/V at pos, the kernel's (``kern``: ``{"k", "v",
    "ks", "vs"}`` rows) against the twin's (``twin``), both from the same
    input ``x``: every differing level must be one apart and within
    I8_MARGIN of a rounding boundary of the twin's value, or of the twin's
    value with one w8a8 QKV input level near its own boundary moved (the
    kernel's norm, summed in another order, rounding it the other way), and
    the scales must agree to 1e-5 of the explaining value's. Returns the
    counts of differing levels and of rows explained by a moved input
    level."""
    import torch

    from pytorch_models_tpu_torch.ops.int8_kv import quantize_rows

    qkv, levels = _qkv_replica(packed, i, x, eps, norm, a8)
    dt = x.dtype

    def kv_of(qkv_rows):
        out = {}
        for j, key in ((1, "k"), (2, "v")):
            new = qkv_rows[..., j * hd:(j + 1) * hd]
            q8, sc = quantize_rows(new)
            out[key], out[key + "s"], out[key + "t"] = q8, sc[..., 0], new.float() / sc
        return out

    mine = kv_of(qkv)
    for key in ("k", "v", "ks", "vs"):
        if not torch.equal(mine[key], twin[key]):
            raise AssertionError(f"{name}: the QKV replica does not reproduce the twin's layer {i} {key}")

    def fits(ref, row) -> bool:
        for key in ("k", "v"):
            off = kern[key][row].int() - ref[key][row].int()
            if off.abs().max().item() > 1 or not bool(_near(ref[key + "t"][row], dt)[off != 0].all()):
                return False
            if abs(kern[key + "s"][row].item() - ref[key + "s"][row].item()) > 1e-5 * ref[key + "s"][row].item():
                return False
        return True

    n_diff, moved = 0, 0
    for row in range(x.shape[0]):
        diff = sum(int((kern[key][row] != mine[key][row]).sum()) for key in ("k", "v"))
        scale_diff = any(kern[key][row].item() != mine[key][row].item() for key in ("ks", "vs"))
        if not diff and not scale_diff:
            continue
        n_diff += diff
        if fits(mine, row):
            continue
        ok = False
        if levels is not None:  # one w8a8 input level of the QKV phase moved across its boundary
            hq, r, h = levels
            t = h[row].float() / r[row]
            for j in _near(t, dt).nonzero().flatten().tolist():
                alt = hq.clone()
                alt[row, j] = int(torch.floor(t[j]).item()) + (0 if alt[row, j].item() > t[j].item() else 1)
                if fits(kv_of(_qkv_replica(packed, i, x, eps, norm, a8, h_q=alt)[0]), row):
                    ok, moved = True, moved + 1
                    break
        if not ok:
            raise AssertionError(f"{name}: layer {i} row {row}: {diff} int8 K/V levels at pos differ from the twin's "
                                 f"away from any rounding boundary")
    return {"levels": n_diff, "moved_inputs": moved}


def _trace_layers(name: str, run, n_layers: int, pre: dict, got: tuple, sc: dict, pos: int, packed: dict,
                  x_in, eps: float, norm: str, a8: bool, kv: bool, hd: int) -> dict:
    """K7 layer by layer from the same caches ``pre`` (as they stood before
    the step): the kernel over layer i's slice from its own layer-i input,
    chained, must equal the whole-stack launch ``got = (x_out, tok)`` and its
    caches ``sc`` bit for bit; the twin over the same slice from the same
    input is then held to I8_LAYER_TOL on x and, with int8 self-KV, by
    :func:`_explain_kv` on the K/V at pos. Returns the readings."""
    import torch

    ck = {k: t.clone() for k, t in pre.items()}
    cp = {k: t.clone() for k, t in pre.items()}
    dn = str(x_in.dtype).removeprefix("torch.")
    xi, err, dx, n_levels, n_moved = x_in, 0.0, [], 0, 0
    for i in range(n_layers):
        last = i == n_layers - 1
        xk, tk = run(ck, False, slice(i, i + 1), xi, last)
        xp, _ = run(cp, True, slice(i, i + 1), xi, False)
        e = _check_close(f"{name} layer {i} x (kernel vs twin from the kernel's input)", xk, xp, I8_LAYER_TOL[dn])
        err = max(err, e)
        dx.append(e)
        if kv:
            rows = {d: {key: c[key][i, :, pos] for key in ("k", "v", "ks", "vs")} for d, c in (("k", ck), ("p", cp))}
            got_kv = _explain_kv(name, packed, i, xi, eps, norm, a8, rows["k"], rows["p"], hd)
            n_levels += got_kv["levels"]
            n_moved += got_kv["moved_inputs"]
        xi = xk
    if not torch.equal(xk, got[0]) or not torch.equal(tk, got[1]):
        raise AssertionError(f"{name}: the kernel layer by layer differs from its whole-stack launch")
    for key in sc:
        if not torch.equal(ck[key], sc[key]):
            raise AssertionError(f"{name}: the kernel layer by layer wrote other {key} caches than its whole stack")
    return {"err": err, "dx": dx, "levels": n_levels, "moved_inputs": n_moved}


# K7's int8 variants: (name in the kernels line, model, w8a8 (+ a8 head), int8 self-KV, int8 cross-KV,
# weight-only int8, embed phase)
I8_VARIANTS = (
    ("fused_decode_step_int8", "gpt2", False, True, False, True, False),
    ("fused_decode_step_a8", "gpt2", True, True, False, True, False),
    ("fused_cross_decode_step_int8", "whisper", False, True, True, False, False),
    ("fused_cross_decode_step_t5_a8", "t5", True, True, True, True, False),
    ("fused_decode_step_embed", "gpt2", False, False, False, False, True),
)


def int8_decode_step_phases(dev, card: str) -> dict:
    """K7's int8 serving variants against the plain twin at full width, B=8,
    fp32 and bf16, one step: GPT-2 small w8a16 + int8 self-KV, and w8a8 with
    the int8 head + int8 self-KV (pos 127 in a 1024 cache, left pads);
    Whisper-base int8 self + cross KV (pos 40, 1500 frames in 1536, per-row
    lengths); T5-base w8a8 + int8 self + cross KV with the rel-pos self bias
    (pos 40, prompts of 7-64 tokens); GPT-2 with the embed phase. The int8
    variants layer by layer (:func:`_trace_layers`), the embed phase's x_out
    and K/V at pos to DS_TOL; the token against the plain head on the
    kernel's x_out (:func:`_head_check`); times kernel and plain."""
    import torch

    from pytorch_models_tpu_torch.models.text.t5 import T5Config, relative_position_bias
    from pytorch_models_tpu_torch.ops.decode_step import (
        fused_cross_decode_step,
        fused_decode_step,
        pack_decode_weights,
        pack_embed_tables,
        pack_greedy_head,
    )
    from pytorch_models_tpu_torch.ops.int8_kv import quantize_kv_caches
    from pytorch_models_tpu_torch.utils import cast_tree, quantize_tree_int8

    res = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    b = 8
    models = {}
    for name, kind, a8, kv, kvx, q8, embed in I8_VARIANTS:
        if kind not in models:
            models[kind] = _k7_model(dev, kind)
        cfg32, layers32, emb32, final32 = models[kind]
        cross, t5 = kind != "gpt2", kind == "t5"
        n_layers, d, hd = len(layers32), cfg32.d_model, cfg32.n_heads * cfg32.head_dim
        l_max, pos = (1024, 127) if kind == "gpt2" else (128, 40)
        variant = {}
        if t5:
            pads, lx = None, 128
            lens = torch.tensor([64, 64, 7, 64, 50, 64, 12, 64], dtype=torch.int32, device=dev)
            table = T5_BIAS_SCALE * torch.randn(12, 32, generator=g, device=dev)
            bias_hl = relative_position_bias(table, torch.arange(l_max, device=dev), torch.arange(l_max, device=dev),
                                             False, T5Config(32128, 768, 12, 12, 2048))[:, pos]
            variant = dict(norm="rms", gated=True, sbias=bias_hl.t().contiguous())
        else:
            pads = torch.tensor([0, 5, pos, 3, 0, pos // 2, 1, 17], dtype=torch.int32, device=dev)
            lx = 1536
            lens = torch.tensor([1500, 1500, 7, 1500, 1200, 1500, 300, 1500], dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).removeprefix("torch.")
            layers = cast_tree(layers32, dtype)
            if q8:  # the JAX package's serving order: to_bf16(), then quantize_int8()
                layers = quantize_tree_int8(layers)
            packed = pack_decode_weights(layers, dtype, cross=cross, gated=t5)
            head = pack_greedy_head(emb32, final32, dtype, tied=not t5, a8=a8)
            x = torch.randn(b, d, generator=g, device=dev).to(dtype)
            raw = {k: torch.randn(n_layers, b, l_max, hd, generator=g, device=dev) for k in ("k", "v")}
            sc = quantize_kv_caches(raw) if kv else {k: t.to(dtype) for k, t in raw.items()}
            kw = dict(a8=a8, kv_scales={"ks": sc["ks"], "vs": sc["vs"]} if kv else None)
            if cross:
                xraw = {k: torch.randn(n_layers, b, lx, hd, generator=g, device=dev) for k in ("k", "v")}
                xc = quantize_kv_caches(xraw) if kvx else {k: t.to(dtype) for k, t in xraw.items()}
                kw["kv_scales_x"] = {"ks": xc["ks"], "vs": xc["vs"]} if kvx else None
            x_in = x
            if embed:  # the embed phase: x is built from the tables (ids clamped, one out of range)
                tabs = pack_embed_tables(torch.randn(50257, d, generator=g, device=dev),
                                         3.0 * torch.randn(1024, d, generator=g, device=dev), dtype)
                ids = torch.tensor([5, 50256, 0, 17, 99999, 1234, 42, 7], device=dev)
                prow = (pos - torch.where(pads > pos, pos, pads)).to(torch.int64)
                kw.update(emb=tabs, tok_ids=ids, pos_rows=prow)
                x_in = None

            def run(c, plain, sl=slice(None), x_in=x_in, with_head=True, kw=kw, variant=variant, packed=packed,
                    head=head, xc=xc if cross else None):
                # the step over the layers ``sl`` of the weights and caches (a layer's slice for the trace)
                cs = {k: t[sl] for k, t in c.items()}
                args = dict(kw, kv_scales={"ks": cs["ks"], "vs": cs["vs"]} if kv else None, plain=plain,
                            head=head if with_head else None)
                pk = {k: t[sl] for k, t in packed.items()}
                if cross:
                    xs = {k: t[sl] for k, t in xc.items()}
                    args["kv_scales_x"] = {"ks": xs["ks"], "vs": xs["vs"]} if kvx else None
                    return fused_cross_decode_step(x_in, pk, cs["k"], cs["v"], xs["k"], xs["v"], lens, pos, pads,
                                                   cfg32.n_heads, cfg32.act, cfg32.norm_eps, **variant, **args)
                return fused_decode_step(x_in, pk, cs["k"], cs["v"], pos, pads, cfg32.n_heads, cfg32.act,
                                         cfg32.norm_eps, **args)

            pre = {k: t.clone() for k, t in sc.items()}
            ref_c = {k: t.clone() for k, t in sc.items()}
            ref_x, ref_tok = run(ref_c, True)
            got_x, got_tok = run(sc, False)
            torch.cuda.synchronize()
            norm = "rms" if t5 else "ln"
            for key in ("k", "v"):
                if not torch.equal(sc[key][:, :, :pos], pre[key][:, :, :pos]):
                    raise AssertionError(f"{name} {dn}: the cache changed outside pos")
            if kv or q8:
                # layer by layer from the kernel's own inputs; the whole stack against the twin's is a reading
                trace = _trace_layers(f"{name} {dn}", run, n_layers, pre, (got_x, got_tok), sc, pos, packed, x,
                                      cfg32.norm_eps, norm, a8, kv, hd)
                err, tol = trace["err"], I8_LAYER_TOL[dn]
                stack = (got_x.float() - ref_x.float()).abs().max().item()
                checked = (f"layer by layer from the kernel's own input: max |kernel - twin| on x {err:.3g} "
                           f"(atol, rtol)={tol} (per layer {', '.join(f'{e:.2g}' for e in trace['dx'])})"
                           + (f", int8 K/V levels at pos differing {trace['levels']} (each one level apart at a "
                              f"rounding boundary; {trace['moved_inputs']} rows by a moved w8a8 input level)"
                              if kv else "")
                           + f"; the whole stack bit-equal to the layers chained; whole stack vs twin (carried "
                             f"through the layers, not held): x_out max |diff| {stack:.3g}")
            else:
                tol = DS_TOL[dn]
                err = _check_close(f"{name} x_out {dn}", got_x, ref_x, tol)
                for key in ("k", "v"):
                    err = max(err, _check_close(f"{name} {key} at pos {dn}", sc[key][:, :, pos],
                                                ref_c[key][:, :, pos], tol))
                checked = f"max |kernel - plain| (x_out, K/V at pos) {err:.3g} (atol, rtol)={tol}"
            # the token: the plain head on the kernel's own x_out (the a8 head exactly)
            uncertain, regret = _head_check(f"{name} {dn}", head, got_x, got_tok, cfg32.norm_eps, norm)
            with torch.inference_mode():
                ms, plain_ms = _ab_ms([lambda: run(sc, False)], [lambda: run(ref_c, True)], 10)
            # bytes: every weight (int8: 1 byte + an fp32 scale per column) and the head table once, the small
            # params, the cached keys' K/V (int8 + 8 bytes of scales per key) and the K/V written
            w_bytes = sum(t.numel() * t.element_size() for k, t in packed.items())
            h_bytes = sum(t.numel() * t.element_size() for t in head.values())
            self_keys = b * pos if pads is None else int((pos - pads.clamp(max=pos)).sum())
            cross_keys = int(lens.sum()) if cross else 0
            kv_item = 1 if kv else dtype.itemsize
            xkv_item = (1 if kvx else dtype.itemsize) if cross else 0
            nbytes = (w_bytes + h_bytes + 2 * b * d * dtype.itemsize
                      + n_layers * self_keys * (2 * hd * kv_item + (8 if kv else 0))
                      + n_layers * cross_keys * (2 * hd * xkv_item + (8 if kvx else 0))
                      + n_layers * b * (2 * hd * kv_item + (8 if kv else 0)) + 8 * b)
            if embed:
                nbytes += 2 * b * d * dtype.itemsize
            w_el = sum(t.numel() for k, t in packed.items() if k.startswith("w")) + head["emb"].numel()
            ops = 2 * b * w_el + 4 * n_layers * hd * (self_keys + b + cross_keys)
            rec = res[(name, dn)] = _rec(err, ms, plain_ms, nbytes, ops, "int8" if a8 else dn)
            features = [f for f, on in (("w8a8 + int8 head", a8), ("w8a16", q8 and not a8), ("int8 self-KV", kv),
                                        ("int8 cross-KV", kvx), ("embed phase (ids incl. one out of range)", embed),
                                        ("rel-pos self bias", t5)) if on]
            print(f"phase kernel {name} {dn}: {kind} {n_layers} layers d={d} B=8 pos={pos}, " + ", ".join(features)
                  + f" | {checked}; tok {got_tok.tolist()} = the plain head on the kernel's x_out ("
                  + (f"exact, {uncertain} hidden levels within the norm's noise" if a8 else
                     f"max score regret {regret:.3g}") + f"; the twin's own {ref_tok.tolist()})"
                  f" | kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
                  f"{rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']}, {nbytes / 1e6:.1f} MB) [{card}]")
    torch.cuda.synchronize()
    return res


class _StepSpy:
    """While active, the fused steps the generators launch (they import the
    wrappers at call time) go through a spy: with ``plain``, the plain twin
    runs in the kernel's place; else each step's token is held against the
    plain head on the kernel route's own x_out (:func:`_head_check`; the a8
    head exactly). Counts the steps and the hidden levels taken as
    uncertain."""

    def __init__(self, plain: bool):
        self.plain, self.steps, self.uncertain, self.regret = plain, 0, 0, 0.0

    def __enter__(self):
        import functools
        import inspect

        from pytorch_models_tpu_torch.ops import decode_step as ds

        self._orig = {n: getattr(ds, n) for n in ("fused_decode_step", "fused_cross_decode_step")}
        for n, fn in self._orig.items():
            if self.plain:
                setattr(ds, n, functools.partial(fn, plain=True))
                continue

            def spy(*args, _fn=fn, _sig=inspect.signature(fn), **kw):
                x, tok = _fn(*args, **kw)
                a = _sig.bind(*args, **kw).arguments
                u, r = _head_check(f"step {self.steps}", a["head"], x, tok, a["eps"], a.get("norm", "ln"))
                self.steps, self.uncertain, self.regret = self.steps + 1, self.uncertain + u, max(self.regret, r)
                return x, tok

            spy.__dict__ = fn.__dict__  # the wrapper counts its launches on its module name: one shared count
            setattr(ds, n, spy)
        return self

    def __exit__(self, *exc):
        from pytorch_models_tpu_torch.ops import decode_step as ds

        for n, fn in self._orig.items():
            setattr(ds, n, fn)


def _parting(got: list, ref: list) -> str:
    """Where each row of the kernel route first parts from the twin's (a
    reading: the int8 state the two routes carry drifts apart a level at a
    time, so their streams need not stay together)."""
    firsts = [next((k for k in range(min(len(a), len(b))) if a[k] != b[k]), min(len(a), len(b))) if a != b
              else None
              for a, b in zip(got, ref)]
    same = sum(f is None for f in firsts)
    return f"{same}/{len(got)} rows identical" + ("" if same == len(got) else ", others part at tokens "
                                                  + ", ".join(str(f) for f in firsts if f is not None))


def _int8_flags(kv: bool = False, kv_cross: bool = False, a8: bool = False, embed: bool | None = None,
                fused=None) -> None:
    from pytorch_models_tpu_torch.ops import attention as attn

    attn.USE_INT8_KV, attn.USE_INT8_KV_CROSS, attn.USE_A8_DECODE, attn.USE_FUSED_EMBED = kv, kv_cross, a8, embed
    attn.USE_FUSED_STEP = fused


def int8_paths(dev, card: str) -> dict:
    """GPT-2 small, Whisper-base and T5-base at full width in int8 serving,
    through the generators: GPT-2 after ``quantize_int8()`` with int8 self-KV,
    w8a8 and the int8 head (and once more in w8a16 with the embed phase);
    Whisper with int8 self- and cross-KV; T5 after ``quantize_int8()`` with
    w8a8, the int8 head over its dequantized classifier and int8 self- and
    cross-KV. fp32: every step's token held against the plain head on the
    kernel route's own x_out (the a8 head exactly), K7 launched once per
    decode step, >= 3 distinct new tokens per row, and where the rows part
    from the same generator driving K7's plain twin (a reading); bf16:
    agreement with the unquantized bf16 fused route and the time of both, and
    of the int8 per-op route. Counts from 0 before each model. Returns each
    model's launches."""
    import torch

    from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
    from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
    from pytorch_models_tpu_torch.ops.decode_step import fused_cross_decode_step, fused_decode_step
    from pytorch_models_tpu_torch.text import T5Generator, T5Model

    out = {}
    r = np.random.default_rng(SEED)
    prompts = [r.integers(0, 50257, n).tolist() for n in PROMPT_LENS]
    r5 = np.random.default_rng(SEED + 10)
    t5_prompts = [r5.integers(2, 32128, n).tolist() for n in T5_PROMPT_LENS]
    audio = _waveforms(8, W_SECONDS, SEED + 4)
    wav = torch.from_numpy(audio).to(dev)
    n_init, w_max = len(W_INIT), len(W_INIT) + N_NEW

    def build(kind, quantize: bool, bf16: bool):
        if kind == "gpt2":
            m = GPT2.from_hf("gpt2", rng=SEED, device=dev)
            _make_streams_move(dev, SEED + 7, m.params, [m.params["decoder"]["layers"]])
            gen = DecoderGenerator(m, _Tok())
            fn = (lambda: gen.generate_tokens_batch(prompts, max_tokens=N_NEW))
            new = lambda rows: [row[len(p):] for row, p in zip(rows, prompts)]  # noqa: E731
            steps = lambda rows: _decode_steps([N_NEW] * len(prompts), N_NEW - 1, False)  # noqa: E731
        elif kind == "whisper":
            m = Whisper.from_openai("base", rng=SEED, device=dev)
            _make_streams_move(dev, SEED + 3, m.params["decoder"],
                               [m.params["encoder"]["layers"], m.params["decoder"]["layers"]])
            gen = WhisperGenerator(m)
            fn = (lambda: gen.transcribe_tokens_batch(wav, W_INIT, W_EOT, w_max))
            new = lambda rows: [row[n_init:] for row in rows]  # noqa: E731
            steps = lambda rows: _decode_steps([len(x) - n_init for x in rows], w_max - n_init - 1,  # noqa: E731
                                               all(W_EOT in x[n_init:] for x in rows))
        else:
            m = T5Model.from_t5x("flan_t5-base", rng=SEED, device=dev)
            _make_t5_streams_move(dev, SEED + 9, m.params)
            gen = T5Generator(model=m)
            fn = (lambda: gen.generate_tokens_batch(t5_prompts, T5_MAX, T5_PAD, T5_EOS))
            new = lambda rows: [row[1:] for row in rows]  # noqa: E731
            steps = lambda rows: _decode_steps([len(x) for x in rows], T5_MAX - 1,  # noqa: E731
                                               all(T5_EOS in x[1:] for x in rows))
        if bf16:
            m.to_bf16()
        if quantize:
            m.quantize_int8()
        return fn, new, steps

    # (model, its int8 serving flags, weight-only int8?, the K7 wrapper it launches, more runs of the GPT-2 path)
    plans = (("gpt2", dict(kv=True, a8=True), True, fused_decode_step),
             ("whisper", dict(kv=True, kv_cross=True), False, fused_cross_decode_step),
             ("t5", dict(kv=True, kv_cross=True, a8=True), True, fused_cross_decode_step))
    for kind, flags, quantize, k7 in plans:
        fn, new, steps_of = build(kind, quantize, bf16=False)
        a8 = flags.get("a8", False)
        runs = [("", flags)] + ([("w8a16 + embed phase", dict(kv=True, embed=True))] if kind == "gpt2" else [])
        _reset_launches()
        notes, distinct, k7_launches, k7_steps = [], None, 0, 0
        for label, fl in runs:
            _int8_flags(**fl)
            with _StepSpy(plain=True):
                ref = fn()
            before = k7.launches
            with _StepSpy(plain=False) as spy:
                got = fn()
            torch.cuda.synchronize()
            k7_launches += k7.launches - before
            k7_steps += steps_of(got)
            if spy.steps != k7.launches - before:
                raise AssertionError(f"int8 {kind}: {spy.steps} steps checked of {k7.launches - before} K7 launches")
            notes.append(f"{label or 'serving'}: every step's token = the plain head on the kernel route's x_out ("
                         + (f"exact, {spy.uncertain} hidden levels within the norm's noise" if fl.get("a8") else
                            f"max score regret {spy.regret:.3g}") + f"); vs the twin driven alone: {_parting(got, ref)}")
            if distinct is None:
                distinct = _check_moving(f"int8 {kind} fp32", new(got), [0] * len(got))
        if k7_launches != k7_steps:
            raise AssertionError(f"int8 {kind}: K7 launched {k7_launches} times for {k7_steps} decode steps")
        # bf16: int8 serving against the unquantized bf16 fused route, and the times of the routes
        fn16, new16, _ = build(kind, quantize, bf16=True)
        base16, _, _ = build(kind, False, bf16=True)
        _int8_flags(**flags)
        rows_i8 = fn16()
        _int8_flags()
        rows_base = base16()
        agree = np.mean([a == b for x, y in zip(new16(rows_i8), new16(rows_base)) for a, b in zip(x, y)])
        times = {}
        for route in ("bf16 fused", "int8 fused", "int8 per-op", "int8 per-op", "int8 fused", "bf16 fused"):
            if route == "bf16 fused":
                _int8_flags()
                ms, rows = _event_ms(base16)
            else:
                _int8_flags(**flags, fused=None if route == "int8 fused" else False)
                ms, rows = _event_ms(fn16)
            times.setdefault(route, []).append((ms, sum(len(x) for x in new16(rows))))
        _int8_flags()
        torch.cuda.synchronize()
        launches = _launches(set())
        out[kind] = launches
        rate = {k: ", ".join(f"{n / (ms / 1e3):.1f} tok/s ({ms:.1f} ms, {n} tokens)" for ms, n in v)
                for k, v in times.items()}
        unit = "segments" if kind == "whisper" else "rows"
        print(f"phase int8 {kind}: {'quantize_int8() + ' if quantize else ''}"
              + ", ".join(k for k, on in (("int8 self-KV", flags.get("kv")), ("int8 cross-KV", flags.get("kv_cross")),
                                          ("w8a8 + int8 head", a8)) if on)
              + f" | fp32 {'; '.join(notes)}; "
              f"K7 launched {k7_launches} times = {k7_steps} decode steps; distinct new tokens per row {distinct} | "
              f"bf16 new tokens agreeing with the unquantized bf16 fused route {agree:.4f} | bf16 8 {unit}, CUDA "
              f"events, generated tokens per second by route: " + "; ".join(f"{k}: {v}" for k, v in rate.items())
              + f" [{card}]")
        print(f"phase int8 {kind} launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    return out


def vit_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """ViT-B/16 at full width (12 layers, d 768, 12 heads, patch 16, 224 x 224,
    cls pooling) with random weights from the seed (PE and cls token seeded
    at a checkpoint's scale, 0.02; the init's are zeros) and images from a
    seed, through ``ViT.__call__``: fp32 (TF32 off) at B=32, the K1 route
    (flags auto) against the SDPA route (``USE_ENCODER_KERNEL = False``: the
    port's plain ``ops.attention.sdpa``, matmul + softmax + matmul, the JAX
    package's XLA route), K1 launched once per layer; bf16 at B=128, both
    routes' img/s and MFU in turns, K1's share of the forward beside one
    torch ``scaled_dot_product_attention`` call's; with ``profile_dir``, a
    profiled bf16 forward of each route."""
    import torch

    from pytorch_models_tpu_torch.image import ViT
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention

    kernels = _kernels()
    t0 = time.perf_counter()
    model = ViT.from_google("B/16_augreg", rng=SEED, device=dev)
    c = model.cfg
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    for key in ("pe", "cls_token"):
        model.params[key] = 0.02 * torch.randn(model.params[key].shape, generator=g, device=dev)
    imgs = torch.randn(VIT_B, 3, c.img_size, c.img_size, generator=g, device=dev)
    gflop = vit_flops_per_image(c.n_layers, c.d_model, c.patch_size, c.img_size) / 1e9
    print(f"phase vit: ViT-B/16 ({c.n_layers} layers, d {c.d_model}, {c.n_heads} heads, patch {c.patch_size}, "
          f"{c.img_size}^2, {c.pool_type} pooling) built from seed {SEED} on {dev} in "
          f"{time.perf_counter() - t0:.1f} s; {gflop:.2f} GFLOP per image")

    def forward(route, x):
        attn.USE_ENCODER_KERNEL = None if route == "K1" else False
        return model(x)

    # fp32: the main path's run, counts from 0
    x32 = imgs[:VIT_B32]
    ref = forward("SDPA", x32)
    _reset_launches()
    got = forward("K1", x32)
    torch.cuda.synchronize()
    launches = _launches({"encoder_attention"})
    if launches["encoder_attention"] != c.n_layers:
        raise AssertionError(f"vit fp32: K1 launched {launches['encoder_attention']} times, not once per layer")
    if got.shape != (VIT_B32, c.d_model):
        raise AssertionError(f"vit fp32: features of shape {tuple(got.shape)}")
    err = _check_close("vit fp32 K1 route vs SDPA route", got, ref, DS_TOL["float32"])
    print(f"phase vit fp32 B={VIT_B32} (TF32 off): pooled features (|x| <= {ref.abs().max().item():.3g}) of the K1 "
          f"route vs the SDPA route max_abs_err={err:.3g} (atol, rtol)={DS_TOL['float32']}; K1 launched "
          f"{launches['encoder_attention']} times = {c.n_layers} layers per forward")

    # bf16 at bench.py's batch: agreement, then the two routes in turns
    model.to_bf16()
    xb = imgs.to(torch.bfloat16)
    before = kernels["encoder_attention"].launches
    outs = {route: forward(route, xb) for route in ("SDPA", "K1")}
    torch.cuda.synchronize()
    k1_per_fwd = kernels["encoder_attention"].launches - before
    if k1_per_fwd != c.n_layers:
        raise AssertionError(f"vit bf16: K1 launched {k1_per_fwd} times in one forward")
    a, b = outs["K1"].float(), outs["SDPA"].float()
    rel = ((a - b).norm() / b.norm()).item()
    if a.shape != (VIT_B, c.d_model) or not bool(torch.isfinite(a).all()) or rel > VIT_BF16_REL:
        raise AssertionError(f"vit bf16: K1 route vs SDPA route relative L2 {rel:.3g} (limit {VIT_BF16_REL:.3g})")
    times: dict[str, list] = {}
    for route in ("SDPA", "K1", "K1", "SDPA"):  # CUDA events around VIT_FORWARDS forwards queued ahead of the device
        forward(route, xb)
        ms_run, _ = _event_ms(lambda: [forward(route, xb) for _ in range(VIT_FORWARDS)])
        times.setdefault(route, []).append(ms_run / VIT_FORWARDS)
    attn.USE_ENCODER_KERNEL = None
    ms = {route: float(np.mean(v)) for route, v in times.items()}
    q, k, v = (torch.randn(VIT_B, 197, c.d_model, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    k1_ms = _time_ms([lambda: encoder_attention(q, k, v, c.n_heads)], 20)
    sdpa_ms = _time_ms([lambda: torch.nn.functional.scaled_dot_product_attention(
        *(t.unflatten(-1, (c.n_heads, -1)).transpose(1, 2) for t in (q, k, v)))], 20)
    parts = []
    for route in ("K1", "SDPA"):
        ips = VIT_B / (ms[route] / 1e3)
        mfu = ips * gflop * 1e9 / PEAK_FLOPS["bfloat16"]
        parts.append(f"{route} route {ips:.1f} img/s ({ms[route]:.3f} ms per forward, turns "
                     f"{', '.join(f'{t:.3f}' for t in times[route])}), MFU {mfu:.4f}")
    print(f"phase vit bf16 B={VIT_B}: K1 route vs SDPA route relative L2 {rel:.3g} (limit {VIT_BF16_REL:.3g}); "
          + "; ".join(parts) + f" (CUDA events over {VIT_FORWARDS} forwards a turn, against "
          f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s); K1 {k1_ms * 1e3:.1f} us a call, {c.n_layers} calls = "
          f"{c.n_layers * k1_ms / ms['K1']:.4f} of the K1 route's forward (one torch scaled_dot_product_attention "
          f"call {sdpa_ms * 1e3:.1f} us, {c.n_layers} = {c.n_layers * sdpa_ms / ms['K1']:.4f} of it) [{card}]")
    if profile_dir is not None:
        for route in ("K1", "SDPA"):
            profile_phase(lambda: forward(route, xb), f"bf16 ViT-B/16 forward B={VIT_B}, {route} route",
                          f"profile_bf16_vit_{route.lower()}.json", profile_dir, card, lambda out: 1, "forward")
        attn.USE_ENCODER_KERNEL = None
    return launches


class _SelectionGaps:
    """Inside the block, each beam group's smallest margin at any selection
    of the beam loop (``beam._top_k``: the W first tokens, the 2W
    candidates, the W survivors, the finished pool): the k-th score minus
    the (k+1)-th, over live scores (slots at NEG_INF tie by design, and
    every route orders those the same way). ``gaps``: (G,) or None."""

    def __enter__(self):
        import torch

        from pytorch_models_tpu_torch.models.text import beam

        self.beam, self.real, self.gaps = beam, beam._top_k, None

        def top_k(x, k):
            vals, idx = self.real(x, k + 1)
            if vals.shape[-1] > k:
                live = vals[..., k] > beam.NEG_INF / 2
                gap = torch.where(live, vals[..., k - 1] - vals[..., k], torch.inf).reshape(x.shape[0], -1).amin(1)
                self.gaps = gap if self.gaps is None else torch.minimum(self.gaps, gap)
            return vals[..., :k], idx[..., :k]

        beam._top_k = top_k
        return self

    def __exit__(self, *exc):
        self.beam._top_k = self.real


class _BeamSteps:
    """Counts the beam loop's steps inside the block (one cache reorder a
    step, ``beam.reorder_caches``)."""

    def __enter__(self):
        from pytorch_models_tpu_torch.models.text import beam

        self.beam, self.real, self.n = beam, beam.reorder_caches, 0

        def reorder(*args):
            self.n += 1
            return self.real(*args)

        beam.reorder_caches = reorder
        return self

    def __exit__(self, *exc):
        self.beam.reorder_caches = self.real


def _beam_tol(logits) -> float:
    """The beam tolerance at a model's first-step logits (see GAP_TOL)."""
    return GAP_TOL[0] + GAP_TOL[1] * logits.float().abs().max().item()


def _beam_routes(what: str, run, check_rows, tol: float) -> tuple[dict, str, int]:
    """fp32 beams of ``run()`` (-> (G lists of W sequences, G lists of W
    scores)) on the plain, fused and per-op routes. Per group: sequences
    identical to plain, or parted where the plain run had a selection
    within ``tol`` (printed); scores of identical groups within ``tol``.
    ``check_rows(seqs, scores)`` raises on a malformed result. Returns the
    outputs, the partings and the fused route's beam steps."""
    _route("plain")
    with _SelectionGaps() as sel:
        outs = {"plain": run()}
    gaps = sel.gaps.tolist()
    for route in ("fused", "per-op"):
        _route(route)
        with _BeamSteps() as steps:
            outs[route] = run()
        if route == "fused":
            fused_steps = steps.n
    _route("fused")
    notes, worst = [], 0.0
    for route, (seqs, scores) in outs.items():
        check_rows(seqs, scores)
        for g, (got, ref) in enumerate(zip(seqs, outs["plain"][0])):
            if got != ref:
                note = f"{route} group {g} parts from plain; the plain run's closest selection: {gaps[g]:.3g} apart"
                print(f"phase {what}: {note}")
                if not gaps[g] <= tol:
                    raise AssertionError(f"{what}: {note}, above the near-tie tolerance {tol:.3g}")
                notes.append(note)
                continue
            err = max(abs(a - b) for a, b in zip(scores[g], outs["plain"][1][g]))
            if err > tol:
                raise AssertionError(f"{what}: {route} group {g} scores {err} from plain (tol {tol:.3g})")
            worst = max(worst, err)
    summary = f"{'; '.join(notes) or 'none'}; scores at most {worst:.3g} from plain, tolerance {tol:.3g}"
    return outs, summary, fused_steps


def _beam_rows_check(what: str, prompts, vocab: int):
    """Each beam is its prompt and 1 to BEAM_NEW tokens of the vocabulary;
    scores finite, best first; the W beams distinct."""
    def check(seqs, scores):
        for p, group, sc in zip(prompts, seqs, scores):
            if (any(s[:len(p)] != p or not len(p) < len(s) <= len(p) + BEAM_NEW or not all(0 <= t < vocab for t in s)
                    for s in group) or not np.isfinite(sc).all() or sc != sorted(sc, reverse=True)
                    or len({tuple(s) for s in group}) < len(group)):
                raise AssertionError(f"{what}: malformed beams {group} {sc}")
    return check


def _draw_margins(model, rows, ref_rows, n_prompt: list, seed: int, b: int) -> list:
    """For rows that part from the plain route's: the draw's distance to the
    nearest boundary of the plain route's CDF at the parting step (the
    uniforms the generator drew, one per row a step; the plain logits of
    the plain row's prefix), and the distance the routes' logits can move a
    boundary (see SAMPLE). Returns ``[(row, new-token index, margin, bound)]``."""
    import torch

    from pytorch_models_tpu_torch.models.text import generator as gen_mod

    out = []
    for r, (row, ref, n) in enumerate(zip(rows, ref_rows, n_prompt)):
        if row == ref:
            continue
        j = next((k for k in range(min(len(row), len(ref))) if row[k] != ref[k]), min(len(row), len(ref)))
        g = torch.Generator(device=model.device).manual_seed(seed)
        u = [torch.rand((b,), generator=g, device=model.device) for _ in range(j - n + 1)][-1][r]
        _route("plain")
        with torch.inference_mode():
            logits = model(torch.tensor(ref[:j], device=model.device))[-1]
        _route("fused")
        k = SAMPLE["topk"] if SAMPLE["topk"] > 1 else logits.shape[-1]
        vals, _ = gen_mod._top_k(logits / SAMPLE["temperature"], k)
        cdf = torch.cumsum(torch.softmax(gen_mod._nucleus_mask(vals, SAMPLE["top_p"]).float(), -1), -1)
        bound = 2 * (GAP_TOL[0] + GAP_TOL[1] * logits.abs().max().item()) / SAMPLE["temperature"]
        out.append((r, j - n, (cdf - u * cdf[-1]).abs().min().item(), bound))
    return out


def beam_sample_paths(dev, card: str) -> dict:
    """The generation API at full width: beam search (GPT-2 small, G=2 and 4
    prompts x W=4; Whisper-base, one 30 s segment at W=4; T5-base, one
    prompt at W=4; at most BEAM_NEW new tokens) and sampling (GPT-2 small,
    B=8 prompts and 16 samples of one, SAMPLE's settings), fp32 on the
    plain, fused and per-op routes (the fused step headless at <= 8 rows,
    once per step), then bf16 rates of the fused and per-op routes and the
    beam cache reorder's time a step. Models and seeds as the greedy paths'.
    Returns each path's launches (counts from 0 just before it)."""
    import torch

    from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
    from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator, beam
    from pytorch_models_tpu_torch.text import T5Generator, T5Model

    kernels = _kernels()
    launches, rates = {}, {}
    r = np.random.default_rng(SEED)
    prompts = [r.integers(0, 50257, n).tolist() for n in PROMPT_LENS]
    model = GPT2.from_hf("gpt2", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 7, model.params, [model.params["decoder"]["layers"]])
    gen = DecoderGenerator(model, _Tok())
    c = model.cfg

    # ---- beam gpt2 fp32: G x W = 8 rows (the fused step headless) and 16 (per-op)
    _route("plain")
    with torch.inference_mode():
        tol = _beam_tol(model(torch.tensor(prompts[0], device=dev))[-1])
    _reset_launches()
    for g in BEAM_G:
        def run(g=g):
            return gen.beam_search_tokens_batch(prompts[:g], max_tokens=BEAM_NEW, beam_width=BEAM_W, return_all=True)

        before = kernels["fused_decode_step"].variant_launches["headless"]
        outs, partings, steps = _beam_routes(f"beam gpt2 fp32 G={g}", run, _beam_rows_check(
            "beam gpt2", prompts[:g], c.vocab_size), tol)
        headless = kernels["fused_decode_step"].variant_launches["headless"] - before
        want = steps if g * BEAM_W <= 8 else 0
        if headless != want:
            raise AssertionError(f"beam gpt2 G={g}: K7 headless launched {headless} times for {want} fused beam steps")
        print(f"phase beam gpt2 fp32 G={g} x W={BEAM_W} ({g * BEAM_W} rows): fused, per-op and plain beams identical "
              f"(partings at near-ties: {partings}); {steps} beam steps, K7 headless launched {headless} times; best "
              f"scores {[round(s[0], 4) for s in outs['fused'][1]]}")
    launches["beam gpt2"] = _launches({"fused_decode_step", "decode_attention", "embed_add"})

    # ---- sample gpt2 fp32: B=8 prompts (the fused step headless), 16 samples of one (per-op)
    _reset_launches()
    cases = {f"B={SAMPLE_B}": (lambda: gen.generate_tokens_batch(prompts[:SAMPLE_B], max_tokens=BEAM_NEW, **SAMPLE),
                               prompts[:SAMPLE_B]),
             f"n={SAMPLE_N}": (lambda: gen.generate_tokens_samples(prompts[0], SAMPLE_N, max_tokens=BEAM_NEW, **SAMPLE),
                               [prompts[0]] * SAMPLE_N)}
    for name, (run, rows_p) in cases.items():
        _route("plain")
        ref = run()
        _route("fused")
        before = kernels["fused_decode_step"].variant_launches["headless"]
        got = run()
        headless = kernels["fused_decode_step"].variant_launches["headless"] - before
        for row, p in zip(got + ref, rows_p * 2):
            if row[:len(p)] != p or len(row) != len(p) + BEAM_NEW or not all(0 <= t < c.vocab_size for t in row):
                raise AssertionError(f"sample gpt2 {name}: malformed row {row}")
        if len(rows_p) <= 8 and headless != BEAM_NEW - 1 or len(rows_p) > 8 and headless:
            raise AssertionError(f"sample gpt2 {name}: K7 headless launched {headless} times")
        margins = _draw_margins(model, got, ref, [len(p) for p in rows_p], SAMPLE["seed"], len(rows_p))
        for row, j, m, bound in margins:
            print(f"phase sample gpt2 fp32 {name}: row {row} parts from plain at new token {j}: the draw {m:.3g} "
                  f"from a CDF boundary (the routes' logits can move one by {bound:.3g})")
            if m > bound:
                raise AssertionError(f"sample gpt2 {name}: row {row} parts {m} from a CDF boundary (bound {bound})")
        print(f"phase sample gpt2 fp32 {name} ({SAMPLE}): fused and plain streams identical but {len(margins)} rows "
              f"parted at a CDF boundary; K7 headless launched {headless} times; distinct rows "
              f"{len({tuple(row) for row in got})}/{len(got)}")
    launches["sample gpt2"] = _launches({"fused_decode_step", "decode_attention", "embed_add"})

    # ---- bf16 rates: GPT-2 beams G=2 x W=4 and sampled B=8, fused against per-op, in turns; the cache reorder
    model.to_bf16()
    timed = {"beam": lambda: gen.beam_search_tokens_batch(prompts[:BEAM_G[0]], max_tokens=BEAM_NEW,
                                                           beam_width=BEAM_W, return_all=True),
             "sample": lambda: gen.generate_tokens_batch(prompts[:SAMPLE_B], max_tokens=BEAM_NEW, **SAMPLE)}
    for what, fn in timed.items():
        times, steps = {}, 0
        for route in ("per-op", "fused", "fused", "per-op"):
            _route(route)
            with _BeamSteps() as st:
                ms, _ = _event_ms(fn)
            times.setdefault(route, []).append(ms)
            steps = max(steps, st.n)
        _route("fused")
        rows = BEAM_G[0] * BEAM_W if what == "beam" else SAMPLE_B
        n_tok = rows * ((steps + 1) if what == "beam" else BEAM_NEW)
        rates[f"gpt2 {what}"] = {k: n_tok / (np.mean(v) / 1e3) for k, v in times.items()}
        print(f"phase time bf16 gpt2 {what} ({rows} rows, {n_tok} row tokens, prefill included, CUDA events): "
              + ", ".join(f"{k} {rates[f'gpt2 {what}'][k]:.1f} tok/s ({np.mean(v):.1f} ms)" for k, v in times.items())
              + f" [{card}]")
    _, stacked = beam.decoder_lm_make_cache(c, (8,), torch.bfloat16, dev)
    caches = beam.beam_caches(stacked)
    idx = torch.tensor([1, 0, 3, 2, 5, 4, 7, 6], device=dev)
    pos_mean = 64 + BEAM_NEW // 2
    reorder = {pos: _time_ms([lambda pos=pos: beam.reorder_caches(caches, idx, pos)], 50)
               for pos in (pos_mean, c.max_seq_len)}
    rates["reorder_us"] = reorder[pos_mean] * 1e3
    print(f"phase time bf16 beam cache reorder (GPT-2 small, 8 rows, K and V of 12 layers): the written prefix at "
          f"pos {pos_mean} {reorder[pos_mean] * 1e3:.1f} us a step; the whole {c.max_seq_len}-slot cache (the JAX "
          f"package's gather) {reorder[c.max_seq_len] * 1e3:.1f} us [{card}]")
    del model, gen, stacked, caches

    # ---- beam whisper fp32: one 30 s segment at W=4
    _reset_launches()
    wmodel = Whisper.from_openai("base", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 3, wmodel.params["decoder"],
                       [wmodel.params["encoder"]["layers"], wmodel.params["decoder"]["layers"]])
    wgen = WhisperGenerator(wmodel)
    wav = torch.from_numpy(_waveforms(1, W_SECONDS[-1:], SEED + 4)).to(dev)
    w_max = len(W_INIT) + BEAM_NEW

    def w_run():
        seqs, scores = wgen.transcribe_beam_tokens(wav[0], W_INIT, W_EOT, w_max, beam_width=BEAM_W, return_all=True)
        return [seqs], [scores]

    _route("plain")
    with torch.inference_mode():
        tol = _beam_tol(wmodel(wgen.preprocessor(wav), torch.tensor([W_INIT], device=dev))[0, -1])
    before = kernels["fused_cross_decode_step"].variant_launches["headless"]
    outs, partings, steps = _beam_routes("beam whisper fp32", w_run, _beam_rows_check(
        "beam whisper", [W_INIT], wmodel.cfg.vocab_size), tol)
    headless = kernels["fused_cross_decode_step"].variant_launches["headless"] - before
    if headless != steps:
        raise AssertionError(f"beam whisper: K7 headless launched {headless} times for {steps} fused beam steps")
    print(f"phase beam whisper fp32 W={BEAM_W} (one {W_SECONDS[-1]} s segment): fused, per-op and plain beams "
          f"identical (partings at near-ties: {partings}); {steps} beam steps, K7 headless launched {headless} times; "
          f"scores {[round(s, 4) for s in outs['fused'][1][0]]}")
    launches["beam whisper"] = _launches({"fused_cross_decode_step", "encoder_attention", "log_mel_spectrogram",
                                          "decode_attention", "embed_add"})
    wmodel.to_bf16()
    times = {}
    for route in ("per-op", "fused", "fused", "per-op"):
        _route(route)
        ms, _ = _event_ms(w_run)
        times.setdefault(route, []).append(ms)
    _route("fused")
    rates["whisper beam"] = {k: 1e3 / np.mean(v) for k, v in times.items()}
    print("phase time bf16 beam whisper W=4 (one 30 s segment, frontend and encoder included, CUDA events): "
          + ", ".join(f"{k} {rates['whisper beam'][k]:.2f} segments/s ({np.mean(v):.1f} ms)" for k, v in times.items())
          + f" [{card}]")
    del wmodel, wgen

    # ---- beam t5 fp32: one prompt at W=4
    _reset_launches()
    tmodel = T5Model.from_t5x("flan_t5-base", rng=SEED, device=dev)
    _make_t5_streams_move(dev, SEED + 9, tmodel.params)
    tgen = T5Generator(model=tmodel)
    t_prompt = np.random.default_rng(SEED + 10).integers(2, tmodel.cfg.vocab_size, T5_PROMPT_LENS[3]).tolist()
    t_max = 1 + BEAM_NEW

    def t_run():
        seqs, scores = tgen.generate_beam_tokens(t_prompt, t_max, T5_PAD, T5_EOS, BEAM_W, return_all=True)
        return [seqs], [scores]

    _route("plain")
    tol = _beam_tol(tmodel(torch.tensor([t_prompt], device=dev), torch.tensor([[T5_PAD]], device=dev))[0, -1])
    before = kernels["fused_cross_decode_step"].variant_launches["headless"]
    outs, partings, steps = _beam_routes("beam t5 fp32", t_run, _beam_rows_check("beam t5", [[T5_PAD]],
                                                                                tmodel.cfg.vocab_size), tol)
    headless = kernels["fused_cross_decode_step"].variant_launches["headless"] - before
    if headless != steps + 1:  # and the pad token's step before the loop
        raise AssertionError(f"beam t5: K7 headless launched {headless} times for {steps} fused beam steps + 1")
    print(f"phase beam t5 fp32 W={BEAM_W} (one prompt of {len(t_prompt)} tokens): fused, per-op and plain beams "
          f"identical (partings at near-ties: {partings}); {steps} beam steps + the pad token's, K7 headless "
          f"launched {headless} times; scores {[round(s, 4) for s in outs['fused'][1][0]]}")
    launches["beam t5"] = _launches({"fused_cross_decode_step", "decode_attention_bias", "gather_rows", "embed_add"})
    del tmodel, tgen
    torch.cuda.synchronize()
    for name, counts in launches.items():
        print(f"phase {name} launches: " + " ".join(f"{k}={v}" for k, v in counts.items() if v))
    return launches


def profile_phase(fn, what: str, fname: str, out_dir: str, card: str, steps_fn, unit: str = "decode step") -> None:
    """One call of ``fn`` (after a warm-up call) under torch.profiler.

    Reads the Chrome trace: device busy time is the union of the kernel,
    memcpy and memset intervals, the span runs from the first to the last
    event of the trace, and the idle share is 1 - busy / span (profiler
    overhead included); device events per ``unit`` (a decode step, or a
    forward) divide by ``steps_fn(output)``. Writes the summary, with device time per kernel
    name, to ``out_dir/fname``; the trace itself is deleted.
    """
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = steps_fn(out)
    trace = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    os.remove(trace)

    dev_events = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev_events:
        raise AssertionError("profile: the trace holds no device events")
    busy, cur_s, cur_e = 0.0, None, None
    for e in sorted(dev_events, key=lambda e: e["ts"]):
        s0, e0 = e["ts"], e["ts"] + e["dur"]
        if cur_e is None or s0 > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    per_name: dict[str, list] = {}
    for e in dev_events:
        acc = per_name.setdefault(e["name"], [0, 0.0])
        acc[0] += 1
        acc[1] += e["dur"]
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    summary = {"card": card, "what": what, "wall_ms": wall_ms, "span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
               "idle_share": 1 - busy / span, "device_events": len(dev_events), unit.replace(" ", "_") + "s": steps,
               "by_name": [{"name": n, "calls": c, "ms": d / 1e3} for n, (c, d) in top]}
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"phase profile {what}: wall {wall_ms:.2f} ms profiled, trace span "
          f"{span / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle share {1 - busy / span:.4f}, "
          f"{len(dev_events)} device events ({len(dev_events) / max(steps, 1):.1f} per {unit}, {steps} {unit}s"
          f"{', prefill included' if unit == 'decode step' else ''}); top: "
          + "; ".join(f"{n[:60]} {c}x {d / 1e3:.2f} ms" for n, (c, d) in top[:6]) + f" [{card}]")


def main() -> int:
    import argparse

    import torch

    import pytorch_models_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from pytorch_models_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one bf16 generation and one bf16 transcription; write summaries under DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"phase device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'}) -> {lib_path.name}")

    from pytorch_models_tpu_torch.ops.encoder_attention import SUPPORTED_HEAD_DIMS

    sass = _sass_tensor_core_counts(lib_path)
    served = {f"{dn} D={d}" for dn in ("fp32", "bf16") for d in SUPPORTED_HEAD_DIMS}
    if sass is not None and ({key.rsplit(" ", 1)[0] for key in sass} != served or min(sass.values()) == 0):
        raise AssertionError(f"encoder_attention: every (dtype, head width) must run on the tensor cores: {sass}")
    print("phase sass encoder_attention: tensor-core instructions (HMMA/HGMMA) per instantiation "
          + ("not measured (no cuobjdump)" if sass is None else json.dumps(sass)))
    res = kernel_phases(dev, card)
    res_e = embed_kernel_phase(dev, card)
    res_w = whisper_kernel_phases(dev, card)
    res_t5 = t5_kernel_phases(dev, card)
    res_k7 = decode_step_phases(dev, card)
    decode_step_breakdown(dev, card)
    res_i8 = int8_kernel_phases(dev, card)
    res_i8k7 = int8_decode_step_phases(dev, card)
    paths = {"gpt2": main_path(dev, card, args.profile), "whisper": whisper_path(dev, card, args.profile),
             "t5": t5_path(dev, card, args.profile), "vit": vit_path(dev, card, args.profile)}
    paths.update(beam_sample_paths(dev, card))
    k6_path = int8_stack_path(dev, card)
    i8 = int8_paths(dev, card)

    # name: (source, TPU kernel it replaces, the dtype whose times are reported, its launches over the main paths;
    # the shapes are GPT-2's for K1-K4 and the fused decode step, Whisper's for K5 and the fused cross step,
    # T5-base's for the biased K2, the untied K4 and the T5 variant of the fused cross step)
    def total(name):
        return sum(counts[name] for counts in paths.values())

    meta = {
        "encoder_attention": ("encoder_attention.cu", "pytorch_models_tpu/ops/encoder_attention.py:166", "bfloat16",
                              total("encoder_attention")),
        "decode_attention": ("decode_attention.cu", "pytorch_models_tpu/ops/decode_attention.py:193", "bfloat16",
                             total("decode_attention") - total("decode_attention_bias")),
        "decode_attention_bias": ("decode_attention.cu", "pytorch_models_tpu/ops/decode_attention.py:193", "bfloat16",
                                  total("decode_attention_bias")),
        "gather_rows": ("gather.cu", "pytorch_models_tpu/ops/gather.py:87", "bfloat16", total("gather_rows")),
        "embed_add": ("gather.cu", "pytorch_models_tpu/ops/gather.py:87", "bfloat16", total("embed_add")),
        "greedy_argmax_tied": ("greedy_head.cu", "pytorch_models_tpu/ops/greedy_head.py:85", "bfloat16",
                               total("greedy_argmax_tied")),
        "greedy_argmax": ("greedy_head.cu", "pytorch_models_tpu/ops/greedy_head.py:91", "bfloat16",
                          total("greedy_argmax")),
        "log_mel_spectrogram": ("mel.cu", "pytorch_models_tpu/ops/mel.py:66", "float32", total("log_mel_spectrogram")),
        "fused_decode_step": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                              total("fused_decode_step") - total("fused_decode_step_headless")),
        "fused_cross_decode_step": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                    paths["whisper"]["fused_cross_decode_step"]),
        "fused_cross_decode_step_t5": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                       paths["t5"]["fused_cross_decode_step"]),
        # int8 serving: K6 on the per-op int8 step's path, K7's variants on the int8 serving paths
        "int8_kv": ("int8_kv.cu", "pytorch_models_tpu/ops/int8_kv.py:353", "bfloat16", k6_path["int8_kv"]),
        "fused_decode_step_int8": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                   i8["gpt2"]["fused_decode_step_kv_int8"] - i8["gpt2"]["fused_decode_step_a8"]),
        "fused_decode_step_a8": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                 i8["gpt2"]["fused_decode_step_a8"]),
        "fused_cross_decode_step_int8": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                         i8["whisper"]["fused_cross_decode_step_kv_int8"]),
        "fused_cross_decode_step_t5_a8": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                          i8["t5"]["fused_cross_decode_step_a8"]),
        "fused_decode_step_embed": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                    i8["gpt2"]["fused_decode_step_embed"]),
        # the headless step (no final norm, no head) on the sampled and beam paths
        "fused_decode_step_headless": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                       paths["beam gpt2"]["fused_decode_step_headless"]
                                       + paths["sample gpt2"]["fused_decode_step_headless"]),
        "fused_cross_decode_step_headless": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1397",
                                             "bfloat16", paths["beam whisper"]["fused_cross_decode_step_headless"]),
        "fused_cross_decode_step_t5_headless": ("decode_step.cu", "pytorch_models_tpu/ops/decode_step.py:1397",
                                                "bfloat16", paths["beam t5"]["fused_cross_decode_step_headless"]),
    }
    # each kernel's limit on max_abs_err: elementwise (atol, rtol) by dtype; for the greedy heads, whose outputs
    # are ids, the score regret is held to the top-2 gap tolerance instead
    limits = {name: {dn: list(TOL[dn]) for dn in TOL} for name in meta}
    limits["log_mel_spectrogram"] = {"float32": [MEL_TOL, 0.0]}
    limits["embed_add"] = {dn: [0.0, 0.0] for dn in TOL}  # bit for bit
    for name in ("greedy_argmax_tied", "greedy_argmax"):
        limits[name] = {"float32": "score regret <= 1e-3", "bfloat16": "score regret <= one bf16 step of the top"}
    for name in ("fused_decode_step", "fused_cross_decode_step", "fused_cross_decode_step_t5",
                 "fused_decode_step_embed", "fused_decode_step_headless", "fused_cross_decode_step_headless",
                 "fused_cross_decode_step_t5_headless"):
        limits[name] = {dn: list(DS_TOL[dn]) for dn in DS_TOL}
    for name in ("fused_decode_step_int8", "fused_decode_step_a8", "fused_cross_decode_step_int8",
                 "fused_cross_decode_step_t5_a8"):  # on x after each layer, from the kernel's own input
        limits[name] = {dn: list(I8_LAYER_TOL[dn]) for dn in I8_LAYER_TOL}
    results = (res, res_e, res_w, res_t5, res_k7, res_i8, res_i8k7)
    entries = []
    for name, (src, replaces, timed, launches) in meta.items():
        if launches <= 0:
            raise AssertionError(f"{name}: no launch on its main path")
        err = max(v["err"] for r in results for (k, _), v in r.items() if k == name)
        rec = next(r[(name, timed)] for r in results if (name, timed) in r)
        entries.append({"name": name, "route": "cuda", "source": f"pytorch_models_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": launches, "max_abs_err": err, "limit": limits[name],
                        **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                        **{k: rec[k] for k in ("two_gathers_ms", "embedding_add_ms", "launch_floor_ms",
                                               "head_matmul_ms") if k in rec}})
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
