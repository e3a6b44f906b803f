#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                   # what the checks need
    python3 chip_smoke.py --profile DIR     # and torch.profiler summaries in DIR

Builds the port's CUDA kernels from ``pytorch_models_tpu_torch/csrc/`` (one
``nvcc`` per source, in parallel), holds each kernel against its plain
PyTorch version at the GPT-2, Whisper and T5 serving shapes (the fused
decode step K7 at full GPT-2-small, Whisper-base and T5-base width, fp32 and
bf16, at B=8, 16 and 32 in every variant; the biased decode attention and the untied greedy head at T5-base's;
the greedy heads at B=8 to 200 beside the head matmul + argmax, with the
side ``use_greedy_head`` takes at each;
the encoder attention K1 also at ViT-B/16's B=128 x 197 tokens and at head
widths 32, 80 and 128, with its tensor-core instructions per instantiation
counted by ``cuobjdump -sass`` (HGMMA in every bf16 instantiation of its
TMA + wgmma kernel), as are K7's: its bf16 instantiation above one
row group runs on the tensor cores, the others on the CUDA cores), then
drives the port's three main paths and
checks that each went through its kernels:

- GPT-2 small at full width (12 layers, d_model 768, vocab 50257, context
  1024, random weights from a seed) through ``score_tokens_batch``, then,
  rescaled so that greedy streams move, ``generate_tokens_batch`` (and at
  B=33, one row above the fused step's 32, flags auto against plain in
  fp32: per-op, the tied greedy head K4 once per decode step where its gate
  takes 33 rows);
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

The other families at full published width, random weights from the
seed (``families_path``, phase "families"): GPT-1 greedy through
``generate_tokens_batch`` (post-norm, so per-op: the decode attention K2,
K3's ``embed_add`` and the tied greedy head K4 at V=40478), fp32 against
the plain route; BERT-base on B=8 x 512 tokens and DETR-R50 on two images
padded to 800 x 1066 by ``DETRPipeline``, fp32 the K1 route against the
SDPA route with K1 12 and 18 times a forward; MLP-Mixer-B/16,
ConvNeXt-tiny and MaxViT-tiny at 224 and MobileViT-s at 256, the card's
fp32 output on 2 images against the port's own CPU output; bf16 rates of
all. K1 is also held against its twin at BERT's and DETR's shapes, and K4
at GPT-1's vocab, in the kernel phase.

The audio families at full published width, random weights from the seed
(``audio_path``, phase "audio"): wav2vec2-base, wav2vec2-large-lv60,
data2vec-audio-base and SEW-tiny through ``from_hf(tag, config=...)`` on
B=8 clips of 10 s at 16 kHz, fp32 the K1 route against the SDPA route with
K1 12, 24, 12 and 12 times a forward, bf16 audio-seconds/s of both routes;
EnCodec 24 kHz (mono, 32 quantizers) and 48 kHz (stereo, 16) on B=4 clips
of 10 s, the card's fp32 codes against the port's own CPU codes (identical
up to printed near-ties) and its decode against the CPU's, audio-seconds/s
of encode + decode; w8a8 (``quantize_int8()`` + ``ops.layers.USE_A8_LINEAR``):
``linear`` on the card bit for bit against the CPU, ViT-B/16 (B=128) and
wav2vec2-base (B=8) against their bf16 routes within the JAX package's
bounds, and their rates. K1 is held against its twin at the wav2vec2,
wav2vec2-large and SEW shapes in the kernel phase.

bench.py's batched greedy decode shapes (``batch_paths``): GPT-2 small at
B=32 (32-token prompts), T5-base at B=32 (64-token inputs), Whisper-base at
B=16, fp32 fused, per-op and plain token-identical with K7 once per decode
step at that batch, then bf16 generated tok/s per route in turns at the
bench shapes (GPT-2 512 new tokens). The continuous-batching engine
(``cb_path``): ``ContinuousBatchingGenerator`` on GPT-2 small with a pool
of 32 (K7 at B=32), 96 requests of 5-200 tokens with budgets of 16-128, with
and without a 48-token shared prefix: fp32 every request token-identical to
the plain route's generation, K7 once per decode step; its int8 self-KV
pool held step by step against the plain head; bf16 generated tok/s of the
fused pool against the per-op pool, with the pool's occupancy. The Whisper
and T5 engines (``cb_whisper_path``, ``cb_t5_path``):
``WhisperContinuousBatchingGenerator`` on Whisper-base (pools of 16 and 32,
40 segments of 5-30 s, at most 64 new tokens) and
``T5ContinuousBatchingGenerator`` on T5-base (pool 32, 96 prompts of 5-200
tokens), with a stop id picked so that rows end at spread lengths: fp32
every request identical to the plain route's generator up to near-ties,
K7 (cross, or T5 with per-row pads) once per decode step at the pool's
batch, admissions mid-flight (positions printed); their int8 pools step
by step; bf16 rates of the fused and per-op pools in turns.

The generation API at full width (``beam_sample_paths``): beam search
through ``DecoderGenerator.beam_search_tokens_batch`` (GPT-2 small, G=2 and
4 prompts x W=4: 8 and 16 rows, the fused step headless),
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

Pretrained loading (``pretrained_path``, phase "pretrained"):
``PYTORCH_MODELS_TPU_CACHE`` points at a fresh temporary directory
(restored and removed at the end), into which GPT-2 small (HF ``gpt2.bin``),
Whisper-base (OpenAI ``base.pt``) and ViT-B/16 (the AugReg ``.npz``) are
written from the models and scales of the phases above; each is loaded by
``from_*(tag, pretrained=True)`` on the card and on the CPU (both trees
equal to the written one bit for bit) and served in fp32: GPT-2 B=8 x 32
new and Whisper's 8 segments token-identical on the three routes, K7 once
per decode step, ``embed_add``, K5 and K1 launched; ViT-B/16 (B=8) on the
K1 route within (1e-4, 1e-4) of the CPU forward, K1 once per layer; then
GPT-2 in bf16 through ``save`` / ``load``: the same bits and fused tokens.

Tensor- and data-parallel serving (``tp_path``, phase "tp"): two ranks
spawned on the one card (``torch.multiprocessing``, start method spawn),
a gloo group (NCCL refuses two ranks on one device) whose all-reduces are
staged through host memory while every kernel and matmul stays on the card,
each rank driving ``parallel/`` at full width from the seeds above:
``TPDecoderGenerator`` on GPT-2 small (B=8, 64 new tokens) at tp=2 and at
dp=2 x tp=1, ``TPT5Generator`` on T5-base and ``TPWhisperGenerator`` on
Whisper-base (4 segments) at tp=2, ``TPContinuousBatchingGenerator`` on
GPT-2 at tp=2 with a pool of 16 (full precision and int8 self-KV) and
``TPSpeculativeGenerator`` (k=4, a 2-layer draft, one row). fp32 tokens
equal on every rank and equal the single-device per-op route's up to
printed near-ties; K7 launched 0 times, K1-K5 and K6 with the full-width
scale (``cur_ks``) more than 0 on every rank; the int8 pool's rows against
the single-device per-op int8 pool are a reading; bf16 GPT-2 tok/s at tp=2
and on one rank alone, in turns (a reading of the mechanism, not a
deployment's rate). K6 with ``cur_ks`` (``int8_decode_attention_tp_scale``)
is held against its plain version at GPT-2-small's tp=2 shard in the
kernel phase.

Pipeline- and expert-parallel serving and the train step
(``pp_ep_train_path``, phase "pp ep train"): four ranks on the one card
over gloo, as phase "tp": ``PPDecoderGenerator`` on GPT-2 small at pp=4
and ``TPPPDecoderGenerator`` at (pp, tp) = (2, 2) (B=8, 64 new), the
stages moved to the card from a host copy (each rank's memory printed
beside one rank holding the whole model); ``EPMoEGenerator`` at ep=4 on
the MoE decoder at GPT-2 small's widths (12 layers, 8 experts x 3072,
weights from the seed); fp32 tokens equal on every rank and the single
device's (per-op route; ``MoEDecoderGenerator``) up to printed near-ties,
K7 launched 0 times, K2 and ``embed_add`` more than 0 on every rank,
all_to_all twice per layer and forward; ``make_train_step`` on the MoE LM
at the same widths (2 stages x 6 layers, B=8 x 256, n_micro 2) on (dp,
pp, tp) = (1, 2, 2): two SGD steps with finite, falling losses, every
gradient leaf finite and non-zero, K1 launched 0 times; two at capacity
factor n_experts within 1e-4 relative of the same step on a one-rank mesh;
bf16 GPT-2 tok/s at pp=4 and on one rank in turns, tokens/s of a step.

K7's MLP activations beyond GELU (``act_kernel_phases``, ``act_path``,
phase "act"): K7 with relu, silu and identity against its plain twin at
GPT-2 small's shape (base) and T5-base's (gated), B=8 and 32, fp32 and bf16,
within DS_TOL; then GPT-2 small at full width whose config takes each
activation (``dataclasses.replace(model.cfg, act=...)``) through
``generate_tokens_batch`` (B=8, 64 new): fp32 tokens identical on the fused,
per-op and plain routes up to printed near-ties, K7 once per decode step
with that activation's code; bf16 tok/s of silu fused against per-op in
turns. The ``kernels`` line has one entry per activation
(``fused_decode_step_relu`` / ``_silu`` / ``_identity``, its other shapes
as ``rows``).

The port's five examples (``examples_path``, phase "examples"):
``examples/torch_*.py`` through their ``main`` in this process on the card
with random weights (serve_sharded's 8 ranks sharing the card over gloo),
each script's launches per kernel from 0 and its seconds: text_generate K7
and ``embed_add``, transcribe K5, K1 and K7 (cross), image_classify K1 12
times a forward, serve_sharded K2 and ``embed_add`` on every rank and K7
never; then the four single-card scripts with ``--pretrained`` at full
width from a temporary cache written from the seed (GPT-2 small, Whisper-tiny,
ViT-B/16 AugReg, EnCodec 24 kHz, and synthetic BPE rank tables of both
tokenizers), with the same checks.

K7's time per phase (``decode_step_breakdown``): each block stamps
%globaltimer at four points of every phase (``stamps=`` of the wrappers),
and a line per variant (GPT-2 bf16 / fp32 / fp32 w8a16 + int8 KV, Whisper
and T5 bf16, B=8; GPT-2 bf16 at B=32) splits the step into barrier wait and skew, input load,
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

import gc
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_NEW = 64
B33_NEW = 16  # new tokens of the per-op GPT-2 generation at B=33, one row above what K7 serves
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

# beam search and sampling: W beams a prompt, G prompts (G x W = 8 and 16 rows: the fused step headless),
# at most BEAM_NEW new tokens; the sampled phases' settings (topk, top_p, temperature, seed)
BEAM_W, BEAM_G, BEAM_NEW = 4, (2, 4, 9), 32  # G=9: 36 rows, K7 headless over row slices of 32 and 4
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


def _ab_ms(kernel_fns, plain_fns, iters: int, plain_iters: int | None = None) -> tuple[float, float]:
    """Kernel and plain times in turns (plain, kernel, kernel, plain), the
    plain version over ``plain_iters`` calls a turn (default ``iters``)."""
    p1 = _time_ms(plain_fns, plain_iters or iters)
    k1 = _time_ms(kernel_fns, iters)
    k2 = _time_ms(kernel_fns, iters)
    p2 = _time_ms(plain_fns, plain_iters or iters)
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


def _check_close(name: str, got, ref, tol: tuple[float, float], of_larger: bool = False, extra=0.0) -> float:
    """Max |got - ref|; raises unless finite and every element is within
    ``atol + rtol * |ref|`` (``of_larger``: ``rtol * max(|got|, |ref|)``, one
    bf16 step of either value at rtol 2^-7, also where the two round to the
    two sides of a power of two), plus ``extra`` (per element)."""
    import torch

    atol, rtol = tol
    diff = (got.float() - ref.float()).abs()
    scale = torch.maximum(got.float().abs(), ref.float().abs()) if of_larger else ref.float().abs()
    bad = diff > atol + rtol * scale + extra
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        idx = bad.nonzero()[:4].tolist()
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max |kernel - plain| = "
                             f"{diff.max().item()} (atol {atol}, rtol {rtol}); first at "
                             + ", ".join(f"{i}: {got[tuple(i)].item()} vs {ref[tuple(i)].item()}" for i in idx))
    return diff.max().item()


def _ln_flip_bound(packed: dict, x, eps: float, norm: str, hd: int):
    """bf16: how far layer 0's K/V at pos may move when the kernel's first
    norm rounds an input element to the other bf16 neighbour than the twin's
    (the two sum the norm's statistics in other orders): per (row, K|V
    column), the sum over the row's norm outputs lying within A8_NORM_NOISE
    of the row's absmax of a bf16 rounding midpoint of one bf16 step times
    |W_kv|. (B, 2 H*D) fp32."""
    import torch

    from pytorch_models_tpu_torch.ops.decode_step import _norm

    y = _norm(packed["ln1_s"][0], packed["ln1_b"][0], x.float(), eps, norm)  # fp32, not rounded
    yb = y.to(torch.bfloat16).float()
    _, e = torch.frexp(yb)
    ulp = torch.where(yb == 0, torch.zeros_like(yb), torch.ldexp(torch.ones_like(yb), e - 8))
    noise = A8_NORM_NOISE * y.abs().amax(-1, keepdim=True)
    open_ = (y - yb).abs() >= 0.5 * ulp - noise
    w = packed["wqkv"][0, :, hd:].float().abs()
    return torch.matmul(torch.where(open_, ulp, 0.0), w)


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


# K1 at the families and audio phases' shapes: (name, B, Lq, Lk, heads, head width)
K1_FAMILY_SHAPES = (("BERT-base", 8, 512, 512, 12, 64), ("DETR-R50 encoder", 2, 850, 850, 8, 32),
                    ("DETR-R50 decoder", 2, 100, 100, 8, 32), ("DETR-R50 cross", 2, 100, 850, 8, 32),
                    # the audio phase's: 10 s clips at 16 kHz, 499 frames (SEW's encoder at half rate, 249)
                    ("wav2vec2-base / data2vec-audio-base", 8, 499, 499, 12, 64),
                    ("wav2vec2-large", 8, 499, 499, 16, 64), ("SEW-tiny", 8, 249, 249, 4, 64))

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
    (a yardstick the port never calls), and the bound (``_k1_work``; fp32 as
    3xTF32)."""
    import torch.nn.functional as F

    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention, encoder_attention_plain

    def heads(t):  # (B, L, H*D) -> the split-head (B, H, L, D) view SDPA takes
        return t.unflatten(-1, (n_heads, -1)).transpose(1, 2)

    dn = str(q.dtype).removeprefix("torch.")
    err, flipped = _check_k1(name, q, k, v, n_heads, causal)
    ms, plain_ms = _ab_ms([lambda: encoder_attention(q, k, v, n_heads, causal)],
                          [lambda: encoder_attention_plain(q, k, v, n_heads, causal)], iters,
                          plain_iters=min(iters, 5))  # the twin is host-bound: ms a call
    lib = _time_ms([lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), is_causal=causal)], iters)
    return {**_rec(err, ms, plain_ms, *_k1_work(q, k, causal), dn, lib, tf32x3=True), "flipped": flipped}


def _k1_work(q, k, causal: bool) -> tuple[int, int]:
    """K1's bytes and operations at one shape: q, k, v read and the output
    written once; 2 x 2 multiply-adds per (query, key, channel) pair that the
    mask keeps."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    pairs = sum(min(i + 1, lk) for i in range(lq)) if causal else lq * lk
    return (2 * q.numel() + 2 * k.numel()) * q.element_size(), 4 * b * pairs * hd


def _k1_times(rec: dict) -> str:
    return (f"{rec['flipped']} rows beyond TOL by p at a rounding boundary | kernel {rec['ms'] * 1e3:.1f} us, "
            f"plain {rec['plain_ms'] * 1e3:.1f} us, SDPA {rec['library_ms'] * 1e3:.1f} us, "
            f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}); kernel / SDPA "
            f"{rec['ms'] / rec['library_ms']:.2f}, {rec['bound_ms'] / rec['ms']:.0%} of the bound")


def _sass_tensor_core_counts(lib_path) -> dict | None:
    """Tensor-core instructions (``HMMA`` / ``HGMMA`` / ``IMMA``) in each
    instantiation of K1 (the mma.sync kernel ``"fp32 D=64 MT=1"``, the TMA +
    wgmma kernel ``"bf16 D=64 wgmma"``, and ``"... wgmma ahead"`` for its
    instantiation that issues the scores a tile ahead, whose counts are of
    ``HGMMA`` alone)
    and of K7 (``"K7 bf16 w g4"``: compute dtype, weight element (``w`` the
    compute dtype, ``i8`` int8), row groups) in the built library, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    import re
    import shutil
    from pathlib import Path

    from pytorch_models_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._find_nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, cur, pattern = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"encoder_attention_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", line)
            wg = re.search(r"encoder_attention_wgmma_kernelILi(\d+)ELb([01])E", line)
            k7 = re.search(r"decode_step_kernelI(f|13__nv_bfloat16)(f|a|S\d*_)Li(\d+)E", line)
            cur, pattern = None, r"\b(HG?MMA|IMMA)\."
            if m is not None:
                cur = f"{'fp32' if m.group(1) == 'f' else 'bf16'} D={m.group(2)} MT={m.group(3)}"
            elif wg is not None:
                cur, pattern = f"bf16 D={wg.group(1)} wgmma{' ahead' if wg.group(2) == '1' else ''}", r"\bHGMMA\."
            elif k7 is not None:
                cur = (f"K7 {'fp32' if k7.group(1) == 'f' else 'bf16'} {'i8' if k7.group(2) == 'a' else 'w'} "
                       f"g{k7.group(3)}")
            if cur is not None:
                counts[cur] = 0
        elif cur is not None and re.search(pattern, line):
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
        # the families and audio phases' shapes: BERT-base's B=8 x 512 tokens, 12 heads of 64; DETR-R50's on
        # two 800 x 1066 images, 8 heads of 32: the encoder's 850 tokens, the decoder's 100 queries, their
        # cross-attention over the 850-token memory; the wav2vec2 family's B=8 x 499 frames (SEW's 249)
        rec["rows"] = []
        for shape, b, lq, lk, h, d in K1_FAMILY_SHAPES:
            qf = rnd(b, lq, h * d, dtype=dtype)
            kf, vf = (rnd(b, lk, h * d, dtype=dtype) for _ in range(2))
            row = _k1_case(f"encoder_attention {shape} {dn}", qf, kf, vf, h, False, 20)
            rec["err"] = max(rec["err"], row["err"])
            rec["rows"].append({"shape": f"{shape} B={b} Lq={lq} Lk={lk} H={h} D={d}", "dtype": dn,
                                "max_abs_err": row["err"],
                                **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
            print(f"phase kernel encoder_attention {dn} ({shape}): B={b} Lq={lq} Lk={lk} H={h} D={d} dense "
                  f"max_abs_err={row['err']:.3g} (atol, rtol)={tol} | {_k1_times(row)} [{card}]")
            del qf, kf, vf

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
        # GPT-1's tied head: V=40478 at the families phase's B=8, forced tie at rows 7 and 40000
        emb1 = rnd(40478, 768, dtype=dtype)
        x = rnd(8, 768, dtype=dtype)
        emb1[7] = emb1[40000] = x[0] * 4
        e, decided = _check_greedy(f"greedy_argmax_tied GPT-1 V=40478 B=8 {dn}", x, emb1, 7)
        k4 = _ab_ms([lambda: greedy_argmax_tied(x, emb1)], [lambda: greedy_argmax_tied_plain(x, emb1)], 50)
        head = _time_ms([lambda: torch.argmax(torch.matmul(x, emb1.t()), dim=-1)], 50)
        r = _rec(e, *k4, (emb1.numel() + x.numel()) * x.element_size(), 2 * 8 * emb1.numel(), dn, tf32x3=True)
        rec["err"] = max(rec["err"], e)
        rec["rows"] = [{"shape": "GPT-1 V=40478 d=768 B=8", "dtype": dn, "max_abs_err": e, "head_matmul_ms": head,
                        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}]
        print(f"phase kernel greedy_argmax_tied {dn} (GPT-1): V=40478 d=768 B=8: {decided}/8 decided rows equal, "
              f"tie->lowest ok, max score regret {e:.3g} | kernel {k4[0] * 1e3:.1f} us, plain {k4[1] * 1e3:.1f} us, "
              f"head matmul + argmax {head * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}) "
              f"[{card}]")
        del emb, emb1
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
    vocab 51865), Whisper large-v3's (``whisper-large``: d 1280, 20 heads,
    dff 5120, vocab 51866; W_LARGE_K7_LAYERS of its 32 layers) or the
    T5-base decoder (12 layers, d 768, RMSNorm, GEGLU
    mlp 2048, cross-attention, untied (d, V) classifier, vocab 32128). Norms
    are drawn off their identity init, so the check covers their parameters.
    Returns ``(layer config, layers, head table, final norm)``."""
    import torch

    from pytorch_models_tpu_torch import transformer as tfm
    from pytorch_models_tpu_torch.models.text.t5 import T5Config, t5_block_init
    from pytorch_models_tpu_torch.utils import tree_map

    gen = torch.Generator().manual_seed(SEED + 5)
    if kind == "whisper-large":  # large-v3's decoder layers, depth cut to W_LARGE_K7_LAYERS
        n_layers, d, vocab, cross = W_LARGE_K7_LAYERS, 1280, 51866, True
        cfg = tfm.LayerConfig.make(d, cross_attn=True, act="gelu")
        layers = [tfm.layer_init(gen, cfg) for _ in range(n_layers)]
    elif kind == "t5":
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


# K7's kernel phases: one row group, two, the most rows of one launch (ops.decode_step.MAX_LAUNCH_ROWS), and
# batches served over row slices (32 + 1, 32 + 8, 32 + 32: K7_SLICED)
K7_BATCHES = (8, 16, 32, 33, 40, 64)
K7_SLICED = (33, 40, 64)
# Whisper large-v3's decoder width in the K7 phase (bf16 and fp32 at B=16: two launches of 8 rows, a block's
# weight share not fitting its ring whole above 8), at this depth
W_LARGE_K7_B, W_LARGE_K7_LAYERS = 16, 4
# K7 at one row, the speculative drafts' batch: at the whole stack (the identical draft) and at SPEC_DRAFT_LAYERS
SPEC_DRAFT_LAYERS = 2


def _cycle(vals: list, b: int) -> list:
    """``vals`` repeated to ``b`` entries (per-row pads and lengths at any B)."""
    return [vals[i % len(vals)] for i in range(b)]


def _k7_key(name: str, b: int, depth: int | None = None) -> str:
    """A K7 record's name at B rows (the B=8 records keep their names) and,
    for a truncated draft, ``depth`` layers."""
    return (name if b == 8 else f"{name}_b{b}") + ("" if depth is None else f"_l{depth}")


def decode_step_phases(dev, card: str, kinds=("gpt2", "whisper", "t5"), cases=None, acts=(None,)) -> dict:
    """K7 against its plain version at the full GPT-2-small, Whisper-base and
    T5-base shapes (``kinds``), B=8, 16 and 32 and over row slices at 33, 40
    and 64 (K7_BATCHES: the launches counted, one per slice of at most
    MAX_LAUNCH_ROWS, and the bound of reading the weights once a launch
    beside the bound), and B=1 (the speculative
    drafts: the whole stack, and its first SPEC_DRAFT_LAYERS layers; GPT-2
    also headless; ``cases``: other ``(B, depth)`` pairs), fp32 and bf16,
    with each model's own MLP activation or (``acts``) another one, whose
    records are named ``..._<act>`` (no per-op or headless step then): mixed left pads with one row whose
    cached range is empty until pos (every kind: T5's pools decode with
    them, masked before its self bias is added), per-row cross lengths with a short row, T5's seeded rel-pos self
    bias (which must move fp32 x_out by far more than its tolerance); x_out
    and the K/V written at pos elementwise, tok as the greedy head is
    checked. Times: the kernel, its plain version, and the per-op step it
    replaces (kernels on; layer stack + final norm + greedy head), in turns.
    At B=16 and 32 the headless step is checked at the same rows."""
    import torch

    from pytorch_models_tpu_torch import transformer as tfm
    from pytorch_models_tpu_torch.models.text.t5 import T5Config, _t5_decode_layers, relative_position_bias, rms_norm
    from pytorch_models_tpu_torch.ops import layer_norm
    from pytorch_models_tpu_torch.ops.decode_step import (
        MAX_LAUNCH_ROWS,
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
    cases = cases or [(b, None) for b in K7_BATCHES] + [(1, None), (1, SPEC_DRAFT_LAYERS)]
    for kind, (b, depth), act in [(kind, case, act) for kind in kinds for case in cases for act in acts]:
        if b == cases[0][0] and act == acts[0]:
            model_cfg, layers32, emb32, final32 = _k7_model(dev, kind)
        cfg32 = model_cfg if act is None else model_cfg.with_(act=act)
        cross, t5 = kind != "gpt2", kind == "t5"
        name = {"gpt2": "fused_decode_step", "whisper": "fused_cross_decode_step",
                "whisper-large": "fused_cross_decode_step_large", "t5": "fused_cross_decode_step_t5"}[kind]
        key = _k7_key(name, b, depth) + ("" if act is None else f"_{act}")
        stack = layers32[:depth]
        n_layers, d, hd = len(stack), cfg32.d_model, cfg32.n_heads * cfg32.head_dim
        l_max, pos = (1024, 127) if kind == "gpt2" else (128, 40)
        # mixed left pads, one row's cached range empty until pos (T5 too: its pools decode with them); a draft's
        # one row has none
        pads = None if b == 1 else torch.tensor(_cycle([0, 5, pos, 3, 0, pos // 2, 1, 17], b), dtype=torch.int32,
                                                device=dev)
        if t5:  # T5's cross rows are prompts of 7-64 tokens in a 128-slot cache
            lx = 128
            lens = torch.tensor(_cycle([64, 64, 7, 64, 50, 64, 12, 64], b), dtype=torch.int32, device=dev)
            table = T5_BIAS_SCALE * torch.randn(12, 32, generator=g, device=dev)  # a seeded rel-pos table
            t5cfg = T5Config(32128, 768, 12, 12, 2048)
            bias_hl = relative_position_bias(table, torch.arange(l_max, device=dev), torch.arange(l_max, device=dev),
                                             False, t5cfg)[:, pos]  # (H, Lp): query pos, every key
            variant = dict(norm="rms", gated=True, sbias=bias_hl.t().contiguous())
        else:
            lx, variant = 1536, {}
            lens = torch.tensor(_cycle([1500, 1500, 7, 1500, 1200, 1500, 300, 1500], b), dtype=torch.int32,
                                device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).removeprefix("torch.")
            layers = cast_tree(stack, dtype)
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
            fn = fused_cross_decode_step if cross else fused_decode_step
            before = fn.launches
            got_x, got_tok = kernel()
            torch.cuda.synchronize()
            n_launch = fn.launches - before  # above one launch's rows (or a plan refused whole): one per row slice
            tol = DS_TOL[dn]
            err = _check_close(f"{name} x_out {dn}", got_x, ref_x, tol)
            use = ((got_x.float() - ref_x.float()).abs() / (tol[0] + tol[1] * ref_x.float().abs())).max().item()
            # layer 0's K/V at pos to one bf16 step, and in bf16 the shift of a first-norm output element that
            # rounds the other way (_ln_flip_bound); the deeper layers' to DS_TOL
            kv0, flip = 0.0, 0.0
            if dtype == torch.bfloat16:
                flip = _ln_flip_bound(packed, x, cfg32.norm_eps, "rms" if t5 else "ln", hd)
            for i, (c, c_ref, what) in enumerate(((kc, kc_p, "k"), (vc, vc_p, "v"))):
                fl = flip[:, i * hd:(i + 1) * hd] if dtype == torch.bfloat16 else 0.0
                kv0 = max(kv0, _check_close(f"{name} layer 0 {what} at pos {dn}", c[0, :, pos], c_ref[0, :, pos],
                                            TOL[dn], of_larger=True, extra=fl))
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
                    h = _t5_decode_layers(p, t5cfg, x[:, None], views, cross_views, bias_hl[:, None], pos, pads)
                    return greedy_argmax(rms_norm(final, h[:, 0]), emb)
                h, _ = tfm.decoder_apply(p, cfg32, x[:, None], self_caches=views, cross_caches=cross_views,
                                         pos=pos, pad_lens=pads)
                return greedy_argmax_tied(layer_norm(final, h[:, 0], cfg32.norm_eps), head["emb"])

            with torch.inference_mode():  # the host-bound twin and per-op step over fewer calls a turn
                ms, plain_ms = _ab_ms([kernel], [plain], 10, plain_iters=1)
                # the per-op step beside every batch one launch serves and the largest sliced one (the script's time)
                timed_op = act is None and b not in K7_SLICED[:-1]
                ms2, op_ms = _ab_ms([kernel], [per_op], 10, plain_iters=3) if timed_op else (None, None)
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
            r = res[(key, dn)] = _rec(err, ms, plain_ms, nbytes, flops, dn)
            if op_ms is not None:
                r["per_op_ms"] = op_ms
            r["shape"] = f"{kind} {n_layers} layers d={d} B={b} pos={pos}"
            # over row slices the weights and the head leave HBM once per launch: the bound of that schedule
            r["launches_a_step"] = n_launch
            slice_bytes = nbytes + (n_launch - 1) * (w_el + head["emb"].numel()) * item
            r["slice_bound_ms"] = max(r["bound_ms"], slice_bytes / HBM_BYTES_PER_S * 1e3)
            print(f"phase kernel {name}{'' if act is None else '_' + act} {dn}: {kind} {n_layers} layers d={d} "
                  f"B={b} pos={pos} act {cfg32.act} "
                  + (f"pads {pads.tolist()}" if pads is not None else "no pads")
                  + (f" cross lens {lens.tolist()} of {lx}" if cross else "")
                  + (f", rel-pos table N(0, 1) x {T5_BIAS_SCALE}, untied head" if t5 else "")
                  + f" | max |kernel - plain| (x_out, K/V at pos) {err:.3g} (atol, rtol)={tol}, x_out at {use:.2f} of its "
                  f"tolerance, layer 0 K/V at pos {kv0:.3g} (atol, rtol)={TOL[dn]}{moved}; tok {got_tok.tolist()}"
                  f" ({int(decided.sum())}/{b} decided, equal), max regret {regret.abs().max().item():.3g} | kernel "
                  f"{ms * 1e3:.1f} us" + ("" if ms2 is None else f" ({ms2 * 1e3:.1f} us in the second pair)")
                  + f", plain {plain_ms * 1e3:.1f} us, " + ("" if op_ms is None else f"per-op step {op_ms * 1e3:.1f} us, ")
                  + f"bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}, {nbytes / 1e6:.1f} MB)"
                  + ("" if n_launch == 1 else f"; {n_launch} launches (row slices), bound with the weights read once "
                     f"a launch {r['slice_bound_ms'] * 1e3:.1f} us") + f" [{card}]")
            if n_launch != -(-b // MAX_LAUNCH_ROWS) and kind != "whisper-large":
                raise AssertionError(f"{name} B={b}: {n_launch} launches, {-(-b // MAX_LAUNCH_ROWS)} wanted")
            if act is not None or kind == "whisper-large" or (b == 1 and (kind != "gpt2" or depth is not None)):
                continue  # the one-row headless step serves the sampled drafts, GPT-2's identical draft
            res.update(_headless_check(kind, name, dn, card, x, packed, kc, vc, xk, xv, lens, pos, pads, cfg32,
                                       variant, final32, head, None if b == 8 else b))
    torch.cuda.synchronize()
    return res


def _headless_check(kind: str, name: str, dn: str, card: str, x, packed, kc, vc, xk, xv, lens, pos: int, pads, cfg,
                    variant: dict, final32, head, rows: int | None = None) -> dict:
    """K7 headless (no final norm, no head: the sampled and beam loops) at
    the rows the new paths give it (GPT-2: 8, the sampled batch and G=2 x
    W=4 beams; Whisper and T5: W=4 beams), or at ``rows``, on ``decode_step_phases``'s
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
    b = rows or (8 if kind == "gpt2" else BEAM_W)
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
    fn = fused_cross_decode_step if cross else fused_decode_step
    before = fn.launches
    got_x, got_tok = kernel()
    torch.cuda.synchronize()
    n_launch = fn.launches - before
    if got_tok is not None or ref_tok is not None:
        raise AssertionError(f"{name} headless: a token came back")
    tol = DS_TOL[dn]
    err = _check_close(f"{name} headless x_out {dn}", got_x, ref_x, tol)
    flip = _ln_flip_bound(packed, hx, cfg.norm_eps, "rms" if t5 else "ln", hd) if dn == "bfloat16" else None
    for i, (c, c_ref, what) in enumerate(((hk, kp, "k"), (hv, vp, "v"))):
        fl = 0.0 if flip is None else flip[:, i * hd:(i + 1) * hd]
        err = max(err, _check_close(f"{name} headless layer 0 {what} at pos {dn}", c[0, :, pos], c_ref[0, :, pos],
                                    TOL[dn], of_larger=True, extra=fl),
                   _check_close(f"{name} headless {what} at pos {dn}", c[1:, :, pos], c_ref[1:, :, pos], tol))
    final = {k: v.to(hx.dtype) for k, v in final32.items()}
    emb = head["emb"].to(hx.dtype)
    xn = rms_norm(final, got_x) if t5 else layer_norm(final, got_x, cfg.norm_eps)
    with torch.inference_mode():
        ms, plain_ms = _ab_ms([kernel], [lambda: plain(hk, hv)], 10, plain_iters=1)
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
    rec["shape"] = f"{kind} {n_layers} layers B={b} pos={pos}, headless"
    rec["launches_a_step"] = n_launch
    rec["slice_bound_ms"] = max(rec["bound_ms"], (nbytes + (n_launch - 1) * w_el * item) / HBM_BYTES_PER_S * 1e3)
    print(f"phase kernel {name} headless {dn}: {kind} {n_layers} layers B={b} pos={pos} | max |kernel - plain| (x_out, "
          f"K/V at pos) {err:.3g} (atol, rtol)={tol} | kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
          f"{rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']}, {nbytes / 1e6:.1f} MB, no head)"
          + ("" if n_launch == 1 else f"; {n_launch} launches (row slices), bound with the weights read once a launch "
             f"{rec['slice_bound_ms'] * 1e3:.1f} us")
          + f"; the head matmul that follows it ({b} x {emb.shape[1]} x {emb.shape[0]}) {head_ms * 1e3:.1f} us "
          f"[{card}]")
    return {(_k7_key(f"{name}_headless", rows or 8), dn): rec}


# K7's per-phase breakdown: (kind, dtype, int8 serving options of _k7_step, rows), each launched this many
# times with stamps
BREAKDOWN = (("gpt2", "bfloat16", {}, 8), ("gpt2", "float32", {}, 8), ("whisper", "bfloat16", {}, 8),
             ("t5", "bfloat16", {}, 8), ("gpt2", "float32", {"q8": True, "kv": True}, 8), ("gpt2", "bfloat16", {}, 32),
             ("whisper", "bfloat16", {}, 32), ("t5", "bfloat16", {}, 32),
             ("gpt2", "bfloat16", {"q8": True, "kv": True}, 32),
             ("gpt2", "bfloat16", {"a8": True, "q8": True, "kv": True}, 32))
BREAKDOWN_RUNS = 5


def _k7_step(dev, kind: str, dtype, g, model=None, a8=False, kv=False, kvx=False, q8=False, embed=False, b=8):
    """One K7 step at ``decode_step_phases``'s shapes (B rows, 8) on fresh random
    inputs: GPT-2 (pos 127 of 1024), Whisper (pos 40, cross lengths 7-1500
    of 1536) or T5 (pos 40, cross lengths 7-64 of 128, a seeded rel-pos self
    bias), each with mixed left pads, optionally in an int8 serving variant as
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
    cross, t5 = kind != "gpt2", kind == "t5"
    n_layers, d, hd = len(layers32), cfg.d_model, cfg.n_heads * cfg.head_dim
    l_max, pos = (1024, 127) if kind == "gpt2" else (128, 40)
    variant = {}
    pads = torch.tensor(_cycle([0, 5, pos, 3, 0, pos // 2, 1, 17], b), dtype=torch.int32, device=dev)
    if t5:
        lx = 128
        lens = torch.tensor(_cycle([64, 64, 7, 64, 50, 64, 12, 64], b), dtype=torch.int32, device=dev)
        table = T5_BIAS_SCALE * torch.randn(12, 32, generator=g, device=dev)
        bias_hl = relative_position_bias(table, torch.arange(l_max, device=dev), torch.arange(l_max, device=dev),
                                         False, T5Config(32128, 768, 12, 12, 2048))[:, pos]
        variant = dict(norm="rms", gated=True, sbias=bias_hl.t().contiguous())
    else:
        lx = 1536
        lens = torch.tensor(_cycle([1500, 1500, 7, 1500, 1200, 1500, 300, 1500], b), dtype=torch.int32, device=dev)
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
        ids = torch.tensor(_cycle([5, 50256, 0, 17, 99999, 1234, 42, 7], b), device=dev)
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


def decode_step_breakdown(dev, card: str, rows=K7_BATCHES) -> dict:
    """K7's time per phase, split in four parts from each block's
    %globaltimer stamps (``stamps=`` of the wrappers; never on the
    generators' path): barrier wait and skew, input load (norm, merge,
    gate), matvec or attention, epilogue, the barrier's own latency and the
    busiest block's time (``ops.decode_step.phase_breakdown``); µs, the
    median over the phases of one kind, over BREAKDOWN_RUNS launches after a
    warm-up, for each of BREAKDOWN at a batch in ``rows``. Prints one line
    per variant, with the sum over one step's phases of barrier and busy;
    above one row group also the head phase's µs beside the greedy head K4
    at the same batch and head (``k4_us``, timed in the same run)."""
    import torch

    from pytorch_models_tpu_torch.ops import _build
    from pytorch_models_tpu_torch.ops.decode_step import pack_greedy_head, phase_breakdown, step_phase_kinds
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax, greedy_argmax_tied

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    models, res = {}, {}
    for kind, dn, opts, b in [case for case in BREAKDOWN if case[3] in rows]:
        if kind not in models:
            models[kind] = _k7_model(dev, kind)
        call, n_layers, cross = _k7_step(dev, kind, getattr(torch, dn), g, models[kind], **opts, b=b)
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
        bd = res[(kind, dn, b)] = phase_breakdown(st, kinds)
        parts = ("wait", "load", "compute", "epilogue", "barrier", "busy")
        sums = {p: sum(bd[k][p] * bd[k]["n"] for k in dict.fromkeys(kinds)) for p in parts[-2:]}
        head_vs = ""
        # the head phase beside K4 on the same head at this batch (a library of K7 alone, kernel_ab.py's, has no K4)
        if b > 8 and not opts and hasattr(_build.load_library(), "pmt_greedy_argmax"):
            _, _, emb32, final32 = models[kind.split()[0]]
            t5 = kind.startswith("t5")
            w = pack_greedy_head(emb32, final32, getattr(torch, dn), tied=not t5)["emb"]
            xh = torch.randn(b, w.shape[1], generator=g, device=dev).to(w.dtype)
            wt = w.t().contiguous() if t5 else None  # the untied head as K4 reads it, (d, V)
            k4 = ((lambda: greedy_argmax(xh, wt)) if t5 else (lambda: greedy_argmax_tied(xh, w)))
            bd["k4_us"] = _time_ms([k4], 20) * 1e3
            head_vs = (f"; head phase {bd['head']['busy']:.1f} us (norm {bd['head']['load']:.1f}, scores "
                       f"{bd['head']['compute']:.1f}), K4 at B={b} on the same head {bd['k4_us']:.1f} us")
        print(f"phase breakdown K7 {kind} {dn}: B={b}, {len(kinds)} phases, step {bd['step']:.1f} us (stamped); "
              "per phase, us (median over the kind's phases; max over blocks but barrier: min) "
              "wait/load/compute/epilogue/barrier/busy: "
              + "; ".join(f"{k} x{bd[k]['n']} " + "/".join(f"{bd[k][p]:.2f}" for p in parts)
                          for k in dict.fromkeys(kinds))
              + " | summed over the step: " + ", ".join(f"{p} {sums[p]:.1f}" for p in sums) + head_vs + f" [{card}]")
    torch.cuda.synchronize()
    return res


class _Tok:
    eos_token_id = None


# decode routes: (every dispatch flag, USE_FUSED_STEP)
ROUTES = {"fused": (None, None), "per-op": (None, False), "plain": (False, False)}
FUSED_PER_OP = {k: ROUTES[k] for k in ("fused", "per-op")}  # the rates of the batched paths (the script's time limit)


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


def _scale_matrices(layers: list, factor: float, blocks: tuple | None = None) -> None:
    """Every linear weight ``{"w": ...}`` of the layers' blocks (or of the
    blocks named in ``blocks``), times ``factor``."""
    for lp in layers:
        for name, block in lp.items():
            if blocks is not None and name not in blocks:
                continue
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


def _check_routes(what: str, outs: dict, gap_fn, ref_route: str = "plain") -> str:
    """fp32 token rows of every route against the ``ref_route``'s, row by
    row. A row may part only at a step whose plain top-2 logits lie within
    GAP_TOL (``gap_fn(row, prefix)`` gives the plain (top logit, top-2 gap)
    after ``prefix``); the parting is printed. Returns the partings."""
    notes = []
    for route, rows in outs.items():
        for i, (row, ref) in enumerate(zip(rows, outs[ref_route])):
            if row == ref:
                continue
            n = min(len(row), len(ref))
            j = next((k for k in range(n) if row[k] != ref[k]), n)
            top, gap = gap_fn(i, ref[:j])
            note = (f"{route} row {i} parts from {ref_route} at token {j}: plain top-2 logits {gap:.4g} apart at "
                    f"{top:.6g}")
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
    from pytorch_models_tpu_torch.ops.decode_step import MAX_LAUNCH_ROWS

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
    # one row above what one K7 launch serves: B=33 decodes fused (the flags auto) over two row slices a step, 32
    # rows and 1, the greedy head inside the kernel (no K4)
    n33 = MAX_LAUNCH_ROWS + 1
    r33 = np.random.default_rng(SEED + 16)
    prompts33 = [r33.integers(0, 50257, n).tolist() for n in _cycle(list(PROMPT_LENS), n33)]
    outs33, k4_33, k7_33 = {}, 0, (0, 0)
    k7 = kernels["fused_decode_step"]
    for route in ("plain", "fused"):
        _route(route)
        before = kernels["greedy_argmax_tied"].launches, k7.launches, k7.variant_launches["b32"]
        outs33[route] = gen.generate_tokens_batch(prompts33, max_tokens=B33_NEW)
        k4_33 = kernels["greedy_argmax_tied"].launches - before[0]
        k7_33 = k7.launches - before[1], k7.variant_launches["b32"] - before[2]
    torch.cuda.synchronize()
    for route, rows in outs33.items():
        if any(row[:len(p)] != p or len(row) != len(p) + B33_NEW for row, p in zip(rows, prompts33)):
            raise AssertionError(f"fp32 B={n33} generation ({route}): malformed row")
    steps33 = B33_NEW - 1
    if k7_33 != (2 * steps33, steps33) or k4_33:
        raise AssertionError(f"flags auto at B={n33}: K7 launched {k7_33[0]} times ({k7_33[1]} of 17-32 rows) for "
                             f"{steps33} decode steps of 32 + 1 rows, K4 {k4_33} times (0 wanted)")
    partings33 = _check_routes(f"main fp32 B={n33}", outs33, gap_fn)
    print(f"phase main fp32 generate_tokens_batch B={n33} (one row above one K7 launch's {MAX_LAUNCH_ROWS}): "
          f"{B33_NEW} new tokens each, flags auto (K7 over row slices) and plain token-identical (partings at "
          f"near-ties: {partings33}); K7 launched {k7_33[0]} times = {steps33} decode steps x 2 slices (32 + 1 "
          f"rows), K4 0 times")
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
I8_NEW = 32  # GPT-2's new tokens in phase "int8 gpt2" (fewer than N_NEW: the script's time limit)
# the a8 head, held exactly on the kernel's own x_out: its final norm, summed in another order than the plain
# one, is taken as uncertain by this share of the row's absmax; an 8-bit hidden level within it of a rounding
# boundary may be either level, and the kernel's id must be the plain argmax for one such choice (enumerated up
# to A8_MAX_UNCERTAIN such levels in a row; above, the kernel's id at its best must reach every id's worst)
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


K6_PLAIN_ITERS = 5  # calls a turn of K6's plain version, a Python walk over the 128-key blocks (ms a call)


def int8_kernel_phases(dev, card: str) -> dict:
    """K6 (int8 decode attention) vs its plain version, fp32 and bf16: at
    GPT-2's shape (B=8, H=12, cache 1024, K2's mixed ranges with an empty row,
    without and with the current position), Whisper-base's cross shape (B=8,
    H=8, 1500 frames in a 1536 cache, per-row lengths 0-1500), T5-base's
    (B=8, H=12, cache 128 at pos 41 and 1024 at pos 1000, the current position
    and the key-major rel-pos bias) and a tensor-parallel rank's
    (``int8_decode_attention_tp_scale``: GPT-2-small's tp=2 shard of 6 heads,
    384 wide, K2's mixed ranges, the current key at the full 768-wide row's
    scale ``cur_ks``). Library call: masked SDPA over the dequantized cache
    (and the current key) in the serving dtype (a yardstick: it reads twice
    the bytes and quantizes nothing)."""
    import torch
    import torch.nn.functional as F

    from pytorch_models_tpu_torch.ops.int8_kv import (
        int8_decode_attention,
        int8_decode_attention_cluster,
        int8_decode_attention_plain,
        quantize_kv_caches,
        quantize_rows,
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
                        for c, q in zip(cs, qs)], 50, plain_iters=K6_PLAIN_ITERS)
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
                    [lambda c=c, q=q: int8_decode_attention_plain(q, *kv(c), lens, 8) for c, q in zip(cs, qx)], 50,
                    plain_iters=K6_PLAIN_ITERS)
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
                         for c, q in zip(cs, qt)], 50, plain_iters=K6_PLAIN_ITERS)
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

        # a tensor-parallel rank's step: GPT-2-small's tp=2 shard (6 of 12 heads, 384 wide), K2's mixed ranges,
        # the current key scored with the full 768-wide row's scale (cur_ks), which the shard's absmax is not
        cs = caches(8, 1024, 384, 4)
        qp = []
        for _ in cs:
            full_k = rnd(8, 768).to(dtype)
            full_k[:, 384:] *= 3.0  # the other rank's half holds each row's absmax
            k_half = full_k[:, :384].contiguous()
            qp.append((rnd(8, 1, 384).to(dtype), k_half, rnd(8, 384).to(dtype), quantize_rows(full_k)[1]))
        if torch.equal(qp[0][3], quantize_rows(qp[0][1])[1]):
            raise AssertionError("int8_decode_attention_tp_scale: the full row's scale must not be the shard's own")

        def tp_call(fn, c, q):
            return fn(q[0], *kv(c), ends, 6, pads, q[1], q[2], cur_ks=q[3])

        got = tp_call(int8_decode_attention, cs[0], qp[0])
        e = _check_close(f"int8_decode_attention_tp_scale {dn}", got,
                         tp_call(int8_decode_attention_plain, cs[0], qp[0]), tol)
        tt = _ab_ms([lambda c=c, q=q: tp_call(int8_decode_attention, c, q) for c, q in zip(cs, qp)],
                    [lambda c=c, q=q: tp_call(int8_decode_attention_plain, c, q) for c, q in zip(cs, qp)], 50,
                    plain_iters=K6_PLAIN_ITERS)

        def dequantized_tp(c, q):  # (q, K, V) split-head: the dequantized cache, then the current K/V as one key more
            kd, vd = (torch.cat([deq(c, key, dtype, 6), cur.unflatten(-1, (6, 64))[:, :, None]], dim=2)
                      for key, cur in (("k", q[1]), ("v", q[2])))
            return q[0].unflatten(-1, (6, 64)).transpose(1, 2), kd, vd

        col = torch.arange(1025, device=dev)
        tpmask = (((col >= pads[:, None]) & (col < ends[:, None])) | (col == 1024))[:, None, None, :]
        dqp = [dequantized_tp(c, q) for c, q in zip(cs, qp)]
        libp = _time_ms([lambda t=t: F.scaled_dot_product_attention(*t, attn_mask=tpmask) for t in dqp], 50)
        keys = int((ends - pads).clamp_min(0).sum())
        pb, po = bound(keys, 8, 384, item, cur=True)
        nbytes_tp = pb + 8 * 4  # and the (B, 1) fp32 scales
        rp = res[("int8_decode_attention_tp_scale", dn)] = _rec(e, *tt, nbytes_tp, po, "int8", libp)
        print(f"phase kernel int8_decode_attention_tp_scale {dn}: GPT-2-small's tp=2 shard, B=8 Lk=1024 H=6 (384 "
              f"wide) K2's pads/ends ({keys} keys), the current key at the full 768-wide row's scale (cur_ks), "
              f"cluster {int8_decode_attention_cluster(8, 1024, 6)}: max_abs_err={e:.3g} (atol, rtol)={tol} | "
              f"kernel {tt[0] * 1e3:.1f} us, plain {tt[1] * 1e3:.1f} us, masked SDPA over the dequantized cache and "
              f"the current key {libp * 1e3:.1f} us, bound {rp['bound_ms'] * 1e3:.2f} us ({rp['bound_by']}, "
              f"{nbytes_tp / 1e6:.2f} MB) [{card}]")
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
            # too many choices to enumerate (a row with an outlier): the kernel's id must reach, with every open
            # level at its better side, the best score any id has with every open level at its worse side
            part = torch.matmul(torch.where(lo[i] == hi[i], mid, 0.0).double(), table)
            t_open = table[open_]
            ends = torch.stack([lo[i, open_].double()[:, None] * t_open, hi[i, open_].double()[:, None] * t_open])
            s_max = ((part + ends.amax(0).sum(0)).float() * head["emb_s"])
            s_min = ((part + ends.amin(0).sum(0)).float() * head["emb_s"])
            if s_max[tok[i]] < s_min.max():
                raise AssertionError(f"{name}: row {i} id {tok[i].item()} cannot be the a8 head's argmax on the "
                                     f"kernel's x_out for any choice of its {len(open_)} uncertain hidden levels")
            continue
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


def _qkv_replica(packed: dict, i: int, x, eps: float, norm: str, a8: bool, h_q=None, h=None):
    """Layer ``i``'s QKV phase as the plain twin computes it, from the
    layer's input ``x``: ``(q|k|v (B, 3*H*D) in x's dtype, its w8a8 input
    levels and row scales or None)``; ``h_q`` replaces the input levels,
    ``h`` the normed input."""
    import torch

    from pytorch_models_tpu_torch.ops.decode_step import _norm
    from pytorch_models_tpu_torch.ops.int8_kv import quantize_rows

    if h is None:
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
    kernel's norm, summed in another order, rounding it the other way), or,
    in bf16, with some of the row's norm outputs that lie within
    A8_NORM_NOISE of the row's absmax of a bf16 rounding midpoint rounded
    to their other bf16 neighbour (the same cause one step earlier, as
    ``_ln_flip_bound`` bounds it for the float variants; up to
    A8_MAX_UNCERTAIN such outputs, every subset tried), and the scales must
    agree to 1e-5 of the explaining value's. Returns the counts of
    differing levels and of rows explained by a moved input level or norm
    output."""
    import itertools

    import torch

    from pytorch_models_tpu_torch.ops.decode_step import _norm
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
        if not ok and dt == torch.bfloat16:  # norm outputs of the row rounded to their other bf16 neighbour
            y = _norm(packed["ln1_s"][i], packed["ln1_b"][i], x[row:row + 1].float(), eps, norm)  # fp32
            yb = y.to(dt).float()
            _, e = torch.frexp(yb)
            ulp = torch.where(yb == 0, torch.zeros_like(yb), torch.ldexp(torch.ones_like(yb), e - 8))
            noise = A8_NORM_NOISE * y.abs().amax()
            open_ = ((y - yb).abs() >= 0.5 * ulp - noise).nonzero()[:, 1].tolist()
            other = torch.where(y >= yb, yb + ulp, yb - ulp)  # the other neighbour around y
            for n in range(1, min(len(open_), A8_MAX_UNCERTAIN) + 1):
                for js in itertools.combinations(open_, n):
                    h = _norm(packed["ln1_s"][i], packed["ln1_b"][i], x, eps, norm).clone()
                    h[row, list(js)] = other[0, list(js)].to(dt)
                    if fits(kv_of(_qkv_replica(packed, i, x, eps, norm, a8, h=h)[0]), row):
                        ok, moved = True, moved + 1
                        break
                if ok:
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
    16 and 32, and over row slices at 33, 40 and 64 (K7_BATCHES), fp32 and
    bf16, one step: GPT-2 small w8a16 + int8 self-KV, and w8a8 with
    the int8 head + int8 self-KV (pos 127 in a 1024 cache, left pads);
    Whisper-base int8 self + cross KV (pos 40, 1500 frames in 1536, per-row
    lengths); T5-base w8a8 + int8 self + cross KV with the rel-pos self bias
    (pos 40, prompts of 7-64 tokens, mixed left pads as a T5 pool gives
    them); GPT-2 with the embed phase. The int8
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
    models = {}
    for (name, kind, a8, kv, kvx, q8, embed), b in [(v, b) for v in I8_VARIANTS for b in K7_BATCHES]:
        if kind not in models:
            models[kind] = _k7_model(dev, kind)
        cfg32, layers32, emb32, final32 = models[kind]
        cross, t5 = kind != "gpt2", kind == "t5"
        rec_key = _k7_key(name, b)
        n_layers, d, hd = len(layers32), cfg32.d_model, cfg32.n_heads * cfg32.head_dim
        l_max, pos = (1024, 127) if kind == "gpt2" else (128, 40)
        variant = {}
        pads = torch.tensor(_cycle([0, 5, pos, 3, 0, pos // 2, 1, 17], b), dtype=torch.int32, device=dev)
        if t5:
            lx = 128
            lens = torch.tensor(_cycle([64, 64, 7, 64, 50, 64, 12, 64], b), dtype=torch.int32, device=dev)
            table = T5_BIAS_SCALE * torch.randn(12, 32, generator=g, device=dev)
            bias_hl = relative_position_bias(table, torch.arange(l_max, device=dev), torch.arange(l_max, device=dev),
                                             False, T5Config(32128, 768, 12, 12, 2048))[:, pos]
            variant = dict(norm="rms", gated=True, sbias=bias_hl.t().contiguous())
        else:
            lx = 1536
            lens = torch.tensor(_cycle([1500, 1500, 7, 1500, 1200, 1500, 300, 1500], b), dtype=torch.int32,
                                device=dev)
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
                ids = torch.tensor(_cycle([5, 50256, 0, 17, 99999, 1234, 42, 7], b), device=dev)
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
            fn = fused_cross_decode_step if cross else fused_decode_step
            before = fn.launches
            got_x, got_tok = run(sc, False)
            torch.cuda.synchronize()
            n_launch = fn.launches - before  # one per row slice
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
                              f"rounding boundary; {trace['moved_inputs']} rows by a moved w8a8 input level or bf16 "
                              f"norm output)"
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
                # the int8 twin takes 25-120 ms a call: one a turn keeps the phase inside the script's time aim
                ms, plain_ms = _ab_ms([lambda: run(sc, False)], [lambda: run(ref_c, True)], 10, plain_iters=1)
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
            rec = res[(rec_key, dn)] = _rec(err, ms, plain_ms, nbytes, ops, "int8" if a8 else dn)
            rec["shape"] = f"{kind} {n_layers} layers d={d} B={b} pos={pos}"
            rec["launches_a_step"] = n_launch
            rec["slice_bound_ms"] = max(rec["bound_ms"],
                                        (nbytes + (n_launch - 1) * (w_bytes + h_bytes)) / HBM_BYTES_PER_S * 1e3)
            features = [f for f, on in (("w8a8 + int8 head", a8), ("w8a16", q8 and not a8), ("int8 self-KV", kv),
                                        ("int8 cross-KV", kvx), ("embed phase (ids incl. one out of range)", embed),
                                        ("rel-pos self bias", t5)) if on]
            print(f"phase kernel {name} {dn}: {kind} {n_layers} layers d={d} B={b} pos={pos}, " + ", ".join(features)
                  + f" | {checked}; tok {got_tok.tolist()} = the plain head on the kernel's x_out ("
                  + (f"exact, {uncertain} hidden levels within the norm's noise" if a8 else
                     f"max score regret {regret:.3g}") + f"; the twin's own {ref_tok.tolist()})"
                  f" | kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
                  f"{rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']}, {nbytes / 1e6:.1f} MB)"
                  + ("" if n_launch == 1 else f"; {n_launch} launches (row slices), bound with the weights read once "
                     f"a launch {rec['slice_bound_ms'] * 1e3:.1f} us") + f" [{card}]")
            if n_launch != -(-b // 32):
                raise AssertionError(f"{name} B={b}: {n_launch} launches, {-(-b // 32)} wanted")
    torch.cuda.synchronize()
    return res


# K7 over row slices in the kernels line: entry -> (its record: B=64, Whisper large-v3's width at B=16; its other
# rows). The int8 variants' rows at K7_SLICED join their B=8 entries instead (their limit is per layer)
SLICED_ENTRIES = {
    "fused_decode_step_sliced": ("fused_decode_step_b64", ["fused_decode_step_b33", "fused_decode_step_b40"]),
    "fused_decode_step_headless_sliced": ("fused_decode_step_headless_b64", ["fused_decode_step_headless_b33",
                                                                             "fused_decode_step_headless_b40"]),
    "fused_cross_decode_step_sliced": (f"fused_cross_decode_step_large_b{W_LARGE_K7_B}",
                                       [_k7_key(f"fused_cross_decode_step{h}", b) for h in ("", "_headless")
                                        for b in K7_SLICED]),
    "fused_cross_decode_step_t5_sliced": ("fused_cross_decode_step_t5_b64",
                                          ["fused_cross_decode_step_t5_b33", "fused_cross_decode_step_t5_b40"]
                                          + [_k7_key("fused_cross_decode_step_t5_headless", b) for b in K7_SLICED]),
}
ROW_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "slice_bound_ms", "launches_a_step")


def sliced_records(*results) -> dict:
    """The K7 records of the batches served over row slices, for the kernels
    line: each SLICED_ENTRIES entry's record (bf16 and fp32) with its other
    rows, and the int8 variants' records at K7_SLICED as rows of their B=8
    records (changed in place); a row's error counts in its entry's."""
    merged = {k: v for r in results for k, v in r.items()}

    def row(key, dn):
        rec = merged[(key, dn)]
        return {"shape": rec["shape"], "dtype": dn, "max_abs_err": rec["err"],
                **{k: rec[k] for k in ROW_KEYS if k in rec}}

    out = {}
    for dn in DS_TOL:
        for entry, (main, others) in SLICED_ENTRIES.items():
            rec = out[(entry, dn)] = dict(merged[(main, dn)])
            rec["rows"] = [row(key, dn) for key in others]
            rec["err"] = max([rec["err"]] + [r["max_abs_err"] for r in rec["rows"]])
        for name, *_ in I8_VARIANTS:
            rec = merged[(name, dn)]
            rec["rows"] = [row(_k7_key(name, b), dn) for b in K7_SLICED]
            rec["err"] = max([rec["err"]] + [r["max_abs_err"] for r in rec["rows"]])
    return out


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
            fn = (lambda: gen.generate_tokens_batch(prompts, max_tokens=I8_NEW))
            new = lambda rows: [row[len(p):] for row, p in zip(rows, prompts)]  # noqa: E731
            steps = lambda rows: _decode_steps([I8_NEW] * len(prompts), I8_NEW - 1, False)  # noqa: E731
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


# the families phase: GPT-1 greedy (PROMPT_LENS, FAM_GPT_NEW new tokens), BERT-base (B=8 x 512 tokens),
# DETR-R50 (two images padded to 800 x 1066 by DETRPipeline), and four conv / hybrid families at B=32
FAM_GPT_NEW = 32
GPT1_MLP_SCALE = 3.0  # GPT-1's MLP matrices, x the init's scale (a CPU reading: min top-2 gap 0.028 at |top| 148)
BERT_B, BERT_L = 8, 512
# bert-base-uncased's config.json (the port fetches nothing: from_hf takes it as a dict)
BERT_CONFIG = {"model_type": "bert", "vocab_size": 30522, "num_hidden_layers": 12, "hidden_size": 768,
               "max_position_embeddings": 512, "layer_norm_eps": 1e-12}
DETR_SIZES = ((800, 1066), (600, 900))  # (H, W) of the two images; DETRPipeline pads both to 800 x 1066
CONV_B = 32
# (name, class, constructor, its argument, image size); held on 2 images against the port's own CPU output
CONV_FAMILIES = (("MLP-Mixer-B/16", "MLPMixer", "from_google", "B/16", 224),
                 ("ConvNeXt-tiny", "ConvNeXt", "from_facebook", "tiny", 224),
                 ("MaxViT-tiny", "MaxViT", "from_google", "tiny", 224),
                 ("MobileViT-s", "MobileViT", "from_apple", "s", 256))
CONV_TOL = 10 * 2e-5  # PARITY.md's fp32 bound of the four families (max abs 2e-5), x 10
FAM_FORWARDS = 5  # forwards per timed turn
# bf16 K1 route vs SDPA route, relative L2 norm of the outputs: as VIT_BF16_REL, 12 layers of bf16 steps
FAM_BF16_REL = 12 * 2.0 ** -8


def _redraw(params, seed: int, scales: dict) -> None:
    """Leaves the init leaves degenerate (zero tables, ConvNeXt's 1e-6 layer
    scale), under the keys of ``scales``, redrawn N(0, 1) x scale from a
    seed on the CPU, in place, so that their paths are exercised."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def walk(t):
        items = t.items() if isinstance(t, dict) else enumerate(t) if isinstance(t, list) else ()
        for k, v in items:
            if k in scales and isinstance(v, torch.Tensor):
                t[k] = (scales[k] * torch.randn(v.shape, generator=g)).to(v.device, v.dtype)
            else:
                walk(v)

    walk(params)


def _turns(fns: dict, n: int) -> dict:
    """Mean ms of ``n`` calls of each of ``fns`` (route -> fn), the routes in
    turns (a, b, b, a), after a warm call each; CUDA events."""
    times: dict[str, list] = {}
    names = list(fns)
    for name in names + names[::-1]:
        fns[name]()
        ms, _ = _event_ms(lambda: [fns[name]() for _ in range(n)])
        times.setdefault(name, []).append(ms / n)
    return {name: float(np.mean(v)) for name, v in times.items()}


def _k1_route(model, route: str, x):
    """``model(x)`` on the K1 route (every flag auto) or the SDPA route
    (``USE_ENCODER_KERNEL = False``); the flag stays set."""
    from pytorch_models_tpu_torch.ops import attention as attn

    attn.USE_ENCODER_KERNEL = None if route == "K1" else False
    return model(x)


def _k1_calls(fn) -> tuple[int, object]:
    """K1's launches during ``fn()``, and its output."""
    import torch

    kernels = _kernels()
    before = kernels["encoder_attention"].launches
    out = fn()
    torch.cuda.synchronize()
    return kernels["encoder_attention"].launches - before, out


def families_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """The families this port serves beside GPT-2, Whisper, T5 and ViT, each
    at full published width with random weights from the seed, through its
    entry points:

    - GPT-1 (12 layers, d 768, vocab 40478; position embeddings seeded
      N(0, 1) and MLP matrices at GPT1_MLP_SCALE x the init's, so that
      streams move) through ``generate_tokens_batch``: post-norm, so per-op
      (K2, K3's ``embed_add``, K4 tied at V=40478); fp32 tokens identical to
      the plain route's up to near-ties; bf16 tok/s of both routes;
    - BERT-base (12 layers, d 768, 12 heads of 64; the PE seeded at 0.02) on
      B=8 x 512 tokens: fp32 the K1 route against the SDPA route, K1 12
      times a forward; bf16 sequences/s of both routes in turns;
    - DETR-R50 (the query embeddings seeded N(0, 1)) on two images padded to
      800 x 1066 by ``DETRPipeline``: fp32 logits and boxes of the K1 route
      against the SDPA route, K1 18 times a forward (6 encoder, 6 decoder
      self, 6 cross); the pipeline's post-processing; bf16 images/s;
    - MLP-Mixer-B/16, ConvNeXt-tiny and MaxViT-tiny at 224 and MobileViT-s
      at 256 (ConvNeXt's layer scales and MaxViT's relative-bias tables
      seeded): the card's fp32 output on 2 images against the port's own
      CPU output on the same params at CONV_TOL; bf16 images/s at B=32.

    Counts from 0 over the fp32 runs of GPT-1, BERT and DETR; returns them.
    With ``profile_dir``, a profiled bf16 forward of BERT and of DETR, K1
    route."""
    import torch

    from pytorch_models_tpu_torch import image
    from pytorch_models_tpu_torch.models.text import BERT, GPT, DecoderGenerator
    from pytorch_models_tpu_torch.models.text._decoder_lm import decoder_lm_fused_ok
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.utils import tree_map

    kernels = _kernels()
    t0 = time.perf_counter()
    gpt = GPT.from_openai(rng=SEED, device=dev)
    c = gpt.cfg
    # post-norm: at the init's scale every decode step returns its input token (the residual's share of the
    # final state), with every matrix at 4x (GPT-2's rescale) the context's average dominates and a row repeats
    # one token; MLP matrices at GPT1_MLP_SCALE and seeded position embeddings make the streams move
    gpt.params["pos_embs"] = torch.randn(gpt.params["pos_embs"].shape, generator=torch.Generator().manual_seed(
        SEED + 21)).to(dev)
    for lp in gpt.params["decoder"]["layers"]:
        _scale_matrices([{"mlp": lp["mlp"]}], GPT1_MLP_SCALE)
    bert = BERT.from_hf("bert-base-uncased", config=BERT_CONFIG, rng=SEED, device=dev)
    _redraw(bert.params, SEED + 22, {"pos_embs": 0.02})
    detr = image.DETR.from_facebook("resnet50", device=dev)
    _redraw(detr.params, SEED + 23, {"query_embed": 1.0})
    print(f"phase families: GPT-1 ({c.n_layers} layers, d {c.d_model}, vocab {c.vocab_size}), BERT-base "
          f"({bert.cfg.n_layers} layers, d {bert.cfg.d_model}, vocab {bert.cfg.vocab_size}), DETR-R50 "
          f"(backbone {list(detr.cfg.backbone_layers)}, d {detr.cfg.d_model}, {detr.cfg.n_queries} queries) built "
          f"from seed {SEED} on {dev} in {time.perf_counter() - t0:.1f} s")

    r = np.random.default_rng(SEED + 24)
    prompts = [r.integers(0, c.vocab_size, n).tolist() for n in PROMPT_LENS]
    tokens = torch.from_numpy(r.integers(0, BERT_CONFIG["vocab_size"], (BERT_B, BERT_L))).to(dev)
    images = [r.random((3, h, w), dtype=np.float32) for h, w in DETR_SIZES]
    padded, height, width = image.DETRPipeline.pad_batch(images)
    detr_x = torch.from_numpy(padded).to(dev)
    gen = DecoderGenerator(gpt, _Tok())

    def generate():
        return gen.generate_tokens_batch(prompts, max_tokens=FAM_GPT_NEW)

    def gap_fn(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(gpt(torch.tensor(prefix))[-1])

    # fp32, the main path's run, counts from 0
    _reset_launches()
    _route("per-op")
    if decoder_lm_fused_ok(gpt.params, c, len(prompts)):
        raise AssertionError("GPT-1 is post-norm: the fused step must refuse it")
    _route("plain")
    outs = {"plain": generate()}
    _route("per-op")
    before = {k: kernels[k].launches for k in ("decode_attention", "embed_add", "greedy_argmax_tied")}
    outs["per-op"] = generate()
    torch.cuda.synchronize()
    gpt_counts = {k: kernels[k].launches - v for k, v in before.items()}
    for route, rows in outs.items():
        if any(row[:len(p)] != p or len(row) != len(p) + FAM_GPT_NEW or not all(0 <= t < c.vocab_size for t in row)
               for row, p in zip(rows, prompts)):
            raise AssertionError(f"GPT-1 fp32 generation ({route}): malformed row")
    steps = FAM_GPT_NEW - 1  # no EOS: every decode step to the limit
    if (gpt_counts["greedy_argmax_tied"] != steps or gpt_counts["decode_attention"] != c.n_layers * steps
            or gpt_counts["embed_add"] < steps):
        raise AssertionError(f"GPT-1 per-op route: launches {gpt_counts} for {steps} decode steps of "
                             f"{c.n_layers} layers")
    distinct = _check_moving("families GPT-1 fp32", outs["per-op"], PROMPT_LENS)
    partings = _check_routes("families GPT-1 fp32", outs, gap_fn)
    print(f"phase families GPT-1 fp32 generate_tokens_batch B={len(prompts)} (position embeddings at scale 1, "
          f"MLP matrices at {GPT1_MLP_SCALE}x the init's): {FAM_GPT_NEW} new tokens each, per-op kernels and plain "
          f"token-identical (partings at near-ties: {partings}); the fused step refuses the post-norm stack; "
          f"launches K2 {gpt_counts['decode_attention']} = {c.n_layers} layers x {steps} steps, embed_add "
          f"{gpt_counts['embed_add']}, K4 (tied, V={c.vocab_size}) {gpt_counts['greedy_argmax_tied']} = {steps} "
          f"steps; distinct new tokens per row {distinct}")

    ref = _k1_route(bert, "SDPA", tokens)
    n_k1, got = _k1_calls(lambda: _k1_route(bert, "K1", tokens))
    if n_k1 != bert.cfg.n_layers or got.shape != (BERT_B, BERT_L, bert.cfg.d_model):
        raise AssertionError(f"BERT fp32: K1 launched {n_k1} times, output {tuple(got.shape)}")
    err = _check_close("BERT fp32 K1 route vs SDPA route", got, ref, DS_TOL["float32"])
    print(f"phase families BERT-base fp32 B={BERT_B} x {BERT_L} tokens (TF32 off): encoder output (|x| <= "
          f"{ref.abs().max().item():.3g}) of the K1 route vs the SDPA route max_abs_err={err:.3g} (atol, rtol)="
          f"{DS_TOL['float32']}; K1 launched {n_k1} times = {bert.cfg.n_layers} layers per forward")

    ref = _k1_route(detr, "SDPA", detr_x)
    n_k1, got = _k1_calls(lambda: _k1_route(detr, "K1", detr_x))
    n_attn = 3 * detr.cfg.n_dec_layers + detr.cfg.n_enc_layers - detr.cfg.n_dec_layers  # enc self, dec self + cross
    if n_k1 != n_attn or got[0].shape != (2, detr.cfg.n_queries, detr.cfg.n_classes + 1):
        raise AssertionError(f"DETR fp32: K1 launched {n_k1} times ({n_attn} wanted), logits {tuple(got[0].shape)}")
    errs = [_check_close(f"DETR fp32 K1 route vs SDPA route {what}", g_, r_, DS_TOL["float32"])
            for what, g_, r_ in zip(("logits", "boxes"), got, ref)]
    attn.USE_ENCODER_KERNEL = None
    dets = image.DETRPipeline(detr, threshold=0.0)(images)
    for classes, boxes, probs in dets:
        if (len(classes) != detr.cfg.n_queries or not set(classes) <= set(image.DETRPipeline.COCO_CLASSES)
                or not np.isfinite(boxes).all() or not ((probs >= 0) & (probs <= 1)).all()):
            raise AssertionError("DETRPipeline: malformed detections")
    print(f"phase families DETR-R50 fp32 B=2 ({' and '.join(f'{h}x{w}' for h, w in DETR_SIZES)} padded to "
          f"{height}x{width} by DETRPipeline: a {height // 32} x {-(-width // 32)} memory): the K1 route vs the SDPA "
          f"route logits max_abs_err={errs[0]:.3g}, boxes {errs[1]:.3g} (atol, rtol)={DS_TOL['float32']}; K1 "
          f"launched {n_k1} times = {detr.cfg.n_enc_layers} encoder + {detr.cfg.n_dec_layers} decoder self + "
          f"{detr.cfg.n_dec_layers} cross per forward; DETRPipeline(threshold 0) gave {len(dets)} x "
          f"{len(dets[0][0])} detections")
    launches = _launches({"encoder_attention", "decode_attention", "embed_add", "greedy_argmax_tied"})
    print("phase families launches: " + " ".join(f"{k}={v}" for k, v in launches.items() if v))

    # bf16: GPT-1 tok/s per route; BERT and DETR, K1 route against SDPA route, agreement then rates in turns
    gpt.to_bf16()
    rates = {}
    for route in ("plain", "per-op", "per-op", "plain"):
        _route(route)
        ms, _ = _event_ms(generate)
        rates.setdefault(route, []).append(ms)
    _route("fused")
    n_tok = len(prompts) * FAM_GPT_NEW
    print(f"phase families time bf16 GPT-1 generate_tokens_batch B={len(prompts)} x {FAM_GPT_NEW} new (prefill "
          f"included, CUDA events): " + ", ".join(f"{k} {n_tok / (np.mean(v) / 1e3):.1f} tok/s ({np.mean(v):.1f} ms, "
                                                 f"turns {', '.join(f'{t:.1f}' for t in v)})" for k, v in rates.items())
          + f" [{card}]")
    for name, model, x, unit, n in (("BERT-base", bert, tokens, "sequences", BERT_B),
                                    ("DETR-R50", detr, detr_x.to(torch.bfloat16), "images", 2)):
        model.to_bf16()
        outs16 = {route: _k1_route(model, route, x) for route in ("SDPA", "K1")}
        a, b = (o[0] if isinstance(o, tuple) else o for o in (outs16["K1"], outs16["SDPA"]))
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        if not bool(torch.isfinite(a.float()).all()) or rel > FAM_BF16_REL:
            raise AssertionError(f"{name} bf16: K1 route vs SDPA route relative L2 {rel:.3g} (limit {FAM_BF16_REL})")
        ms = _turns({route: (lambda route=route: _k1_route(model, route, x)) for route in ("SDPA", "K1")},
                    FAM_FORWARDS)
        attn.USE_ENCODER_KERNEL = None
        print(f"phase families time bf16 {name} B={n}: K1 route vs SDPA route relative L2 {rel:.3g} (limit "
              f"{FAM_BF16_REL:.3g}); " + "; ".join(f"{route} route {n / (ms[route] / 1e3):.1f} {unit}/s "
                                                  f"({ms[route]:.3f} ms per forward)" for route in ("K1", "SDPA"))
              + f" (CUDA events over {FAM_FORWARDS} forwards a turn, turns SDPA, K1, K1, SDPA) [{card}]")
        if profile_dir is not None:
            profile_phase(lambda: model(x), f"bf16 {name} forward B={n}, K1 route",
                          f"profile_bf16_{name.split('-')[0].lower()}.json", profile_dir, card, lambda out: 1, "forward")
    del gpt, bert, detr, gen

    # the conv / hybrid families: no kernel of the port on their paths (MaxViT's biased windows and
    # MobileViT's head widths 36/48/60 take sdpa, as in the JAX package)
    g = torch.Generator().manual_seed(SEED + 25)
    for name, cls_name, ctor, arg, size in CONV_FAMILIES:
        cls = getattr(image, cls_name)
        t0 = time.perf_counter()
        model = getattr(cls, ctor)(arg, device=dev)
        _redraw(model.params, SEED + 26, {"gamma": 0.1, "attn_bias": 0.5})
        twin = getattr(cls, ctor)(arg, device="cpu")
        twin.params = tree_map(lambda t: t.cpu(), model.params)
        imgs = torch.randn(CONV_B, 3, size, size, generator=g)
        built = time.perf_counter() - t0
        ref = twin(imgs[:2])
        got = model(imgs[:2].to(dev))
        torch.cuda.synchronize()
        err = (got.cpu() - ref).abs().max().item()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()) or err > CONV_TOL:
            raise AssertionError(f"{name} fp32: the card's output {tuple(got.shape)} vs the CPU's max |diff| {err:.3g} "
                                 f"(limit {CONV_TOL})")
        model.to_bf16()
        xb = imgs.to(dev, torch.bfloat16)
        out = model(xb)
        if out.shape != (CONV_B, ref.shape[-1]) or not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{name} bf16: output {tuple(out.shape)} not finite")
        ms = _turns({"bf16": lambda: model(xb)}, FAM_FORWARDS)["bf16"]
        print(f"phase families {name} at {size}: built in {built:.1f} s; fp32 (TF32 off) card vs the port's CPU "
              f"output on 2 images (|x| <= {ref.abs().max().item():.3g}) max_abs_err={err:.3g} (limit {CONV_TOL:.3g}); "
              f"bf16 B={CONV_B} {CONV_B / (ms / 1e3):.1f} images/s ({ms:.3f} ms per forward, CUDA events over "
              f"{FAM_FORWARDS} forwards a turn, 2 turns) [{card}]")
        del model, twin
    return launches


# the audio phase (``audio_path``): the wav2vec2 family's encoders at full published width on AUDIO_B clips of
# AUDIO_SECONDS s at 16 kHz; EnCodec 24 / 48 kHz on ENCODEC_B clips of AUDIO_SECONDS s; w8a8 linears
AUDIO_B, AUDIO_SECONDS, ENCODEC_B = 8, 10, 4
# each encoder's config.json from its public source, the keys ``from_hf`` reads (the port fetches nothing)
W2V_MODELS = (
    ("facebook/wav2vec2-base", "Wav2Vec2",
     {"num_hidden_layers": 12, "hidden_size": 768, "num_attention_heads": 12, "conv_bias": False,
      "feat_extract_norm": "group", "do_stable_layer_norm": False}),
    ("facebook/wav2vec2-large-lv60", "Wav2Vec2",
     {"num_hidden_layers": 24, "hidden_size": 1024, "num_attention_heads": 16, "conv_bias": True,
      "feat_extract_norm": "layer", "do_stable_layer_norm": True}),
    ("facebook/data2vec-audio-base", "Data2VecAudio",
     {"num_hidden_layers": 12, "hidden_size": 768, "num_attention_heads": 12, "conv_bias": False,
      "feat_extract_norm": "layer"}),
    ("asapp/sew-tiny-100k", "SEW",
     {"num_hidden_layers": 12, "hidden_size": 256, "num_attention_heads": 4, "conv_bias": False,
      "feat_extract_norm": "group"}),
)
# EnCodec on the card against the port's own CPU output, fp32 (TF32 off): a quantizer level may pick another code
# than the CPU's only where the CPU's two nearest distances lie within RVQ_GAP_TOL of each other (distances of
# order 1e2 here, from encoder outputs that the card's convolutions and the CPU's sum in other orders; such a
# frame's later levels are not compared); the card's decode of its codes against the CPU's decode of the same
# codes within ENCODEC_TOL * max(1, |y|): PARITY.md's 1e-4 of the codec, x 10 for two devices' convolutions
RVQ_GAP_TOL = 1e-3
ENCODEC_TOL = 10 * 1e-4
# w8a8 vs bf16, the JAX package's own bounds (tests/ops/test_a8_linear.py): max |a8 - bf16| / max(|bf16|, 1) and
# the smallest row cosine
A8_REL, A8_COS = 8e-2, 0.99
# the w8a8 linear on the card against the same call on the CPU, bit for bit: (rows, in, out); <= 16 rows and
# sizes off a multiple of 8 take the padded cuBLAS product
A8_LINEAR_SHAPES = ((1, 768, 3072), (16, 768, 3072), (17, 768, 3072), (AUDIO_B * 499, 768, 3072), (5, 100, 36))


def _codec_clips(b: int, channels: int, rate: int, seed: int):
    """``b`` seeded clips of AUDIO_SECONDS s (noise under a slow envelope and a
    tone per channel): (b, channels, samples) fp32."""
    r = np.random.default_rng(seed)
    t = np.arange(AUDIO_SECONDS * rate) / rate
    x = 0.1 * r.standard_normal((b, channels, t.size)) * (1 + np.sin(2 * np.pi * 0.5 * t))
    x += 0.2 * np.sin(2 * np.pi * 220 * (1 + np.arange(b * channels).reshape(b, channels, 1)) * t)
    return x.astype(np.float32)


def _rvq_partings(name: str, model, x_cpu, codes, ref_codes) -> str:
    """Where the card's codes part from the CPU's: each frame's first
    differing level must be one whose CPU distances to its two nearest codes
    lie within RVQ_GAP_TOL (the CPU's residuals replayed from its encoder
    output and codes); later levels of that frame are not compared."""
    import torch

    from pytorch_models_tpu_torch.models.audio import encodec

    diff = codes.cpu() != ref_codes  # (B, nq, T)
    if not bool(diff.any()):
        return "none"
    x = x_cpu
    if model.cfg.normalize:
        x = x / (x.mean(1, keepdim=True).square().mean(2, keepdim=True).sqrt() + 1e-8)
    with torch.inference_mode():
        residual = encodec.encoder_apply(model.params["encoder"], model.cfg, x.transpose(1, 2))  # (B, T, D)
        gaps = []
        for codebook, idx in zip(model.params["quantizer"]["embed"], ref_codes.transpose(0, 1)):
            two = encodec.rvq_distances(residual, codebook).topk(2, dim=-1, largest=False).values
            gaps.append(two[..., 1] - two[..., 0])
            residual = residual - codebook[idx]
    gaps = torch.stack(gaps, 1)  # (B, nq, T)
    first = diff.int().argmax(1)  # each frame's first differing level (0 where none differ)
    parted = diff.any(1)
    at = gaps.gather(1, first[:, None]).squeeze(1)[parted]
    if bool((at >= RVQ_GAP_TOL).any()):
        raise AssertionError(f"{name}: codes part from the CPU's at a level whose nearest distances lie "
                             f"{at.max().item():.3g} apart (near-tie tolerance {RVQ_GAP_TOL})")
    return (f"{int(parted.sum())} frames part at a near-tie (first levels "
            f"{sorted(set(first[parted].tolist()))}, gaps <= {at.max().item():.3g})")


def audio_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """The audio families at full published width, random weights from the
    seed, through their entry points:

    - the wav2vec2 family (W2V_MODELS: wav2vec2-base, wav2vec2-large-lv60,
      data2vec-audio-base, SEW-tiny) through ``from_hf(tag, config=...)`` on
      AUDIO_B clips of 10 s at 16 kHz (499 frames; SEW's encoder at 249):
      fp32 the K1 route against the SDPA route (``USE_ENCODER_KERNEL =
      False``) to DS_TOL, K1 launched once per layer a forward; bf16
      audio-seconds/s of both routes in turns;
    - EnCodec 24 kHz (mono, 32 quantizers) and 48 kHz (stereo, 16) on
      ENCODEC_B clips of 10 s: fp32 codes from ``encode`` on the card against
      the port's own CPU codes on the same params (identical up to near-ties,
      ``_rvq_partings``), the card's ``decode`` against the CPU's decode of
      the same codes; fp32 and bf16 audio-seconds/s of encode + decode;
    - w8a8 (``quantize_int8()`` + ``ops.layers.USE_A8_LINEAR``): ``linear``
      on the card against the same call on the CPU bit for bit at
      A8_LINEAR_SHAPES; ViT-B/16 (B=128) and wav2vec2-base (B=8), bf16,
      against their bf16 route within A8_REL / A8_COS; images/s and
      audio-seconds/s of both in turns.

    Counts from 0 over the fp32 encoder runs; returns them. With
    ``profile_dir``, a profiled bf16 wav2vec2-base forward, K1 route."""
    import torch

    from pytorch_models_tpu_torch import audio
    from pytorch_models_tpu_torch.image import ViT
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.ops import layers
    from pytorch_models_tpu_torch.utils import quantize_tree_int8, tree_map

    waves = _waveforms(AUDIO_B, [AUDIO_SECONDS] * AUDIO_B, SEED + 31)[:, :AUDIO_SECONDS * 16_000]
    x32 = torch.from_numpy(waves).to(dev)
    audio_s = AUDIO_B * AUDIO_SECONDS

    # fp32, the main path's run, counts from 0
    _reset_launches()
    encoders = {}
    for tag, cls_name, config in W2V_MODELS:
        t0 = time.perf_counter()
        model = encoders[tag] = getattr(audio, cls_name).from_hf(tag, config=config, rng=SEED, device=dev)
        built = time.perf_counter() - t0
        c = model.cfg
        ref = _k1_route(model, "SDPA", x32)
        n_k1, got = _k1_calls(lambda: _k1_route(model, "K1", x32))
        frames = got.shape[1]
        if n_k1 != c.n_layers or got.shape != ref.shape or got.shape[::2] != (AUDIO_B, c.d_model):
            raise AssertionError(f"{tag} fp32: K1 launched {n_k1} times ({c.n_layers} layers), output "
                                 f"{tuple(got.shape)}")
        err = _check_close(f"{tag} fp32 K1 route vs SDPA route", got, ref, DS_TOL["float32"])
        print(f"phase audio {tag} fp32 B={AUDIO_B} x {AUDIO_SECONDS} s (TF32 off; {c.n_layers} layers, d "
              f"{c.d_model}, {c.layer.n_heads} heads of {c.layer.head_dim}, {'legacy' if c.stem_legacy else 'LN'} stem, "
              f"{'pre' if c.pre_norm else 'post'}-norm; {frames} frames, the encoder at "
              f"{frames // 2 if cls_name == 'SEW' else frames}; built from seed {SEED} in {built:.1f} s): encoder output "
              f"(|x| <= {ref.abs().max().item():.3g}) of the K1 route vs the SDPA route max_abs_err={err:.3g} "
              f"(atol, rtol)={DS_TOL['float32']}; K1 launched {n_k1} times = {c.n_layers} layers per forward")
    launches = _launches({"encoder_attention"})
    print("phase audio launches: " + " ".join(f"{k}={v}" for k, v in launches.items() if v))

    # bf16: agreement of the two routes, then their rates in turns
    for tag, model in encoders.items():
        c = model.cfg
        model.to_bf16()
        xb = x32.to(torch.bfloat16)
        outs = {route: _k1_route(model, route, xb) for route in ("SDPA", "K1")}
        a, b = outs["K1"].float(), outs["SDPA"].float()
        rel = ((a - b).norm() / b.norm()).item()
        limit = FAM_BF16_REL * c.n_layers / 12  # one bf16 step a layer, as FAM_BF16_REL
        if not bool(torch.isfinite(a).all()) or rel > limit:
            raise AssertionError(f"{tag} bf16: K1 route vs SDPA route relative L2 {rel:.3g} (limit {limit:.3g})")
        ms = _turns({route: (lambda route=route: _k1_route(model, route, xb)) for route in ("SDPA", "K1")},
                    FAM_FORWARDS)
        attn.USE_ENCODER_KERNEL = None
        print(f"phase audio time bf16 {tag} B={AUDIO_B}: K1 route vs SDPA route relative L2 {rel:.3g} (limit "
              f"{limit:.3g}); " + "; ".join(
                  f"{route} route {audio_s / (ms[route] / 1e3):.1f} audio-s/s ({ms[route]:.3f} ms per forward)"
                  for route in ("K1", "SDPA"))
              + f" (CUDA events over {FAM_FORWARDS} forwards a turn, turns SDPA, K1, K1, SDPA) [{card}]")
        if profile_dir is not None and tag == W2V_MODELS[0][0]:
            profile_phase(lambda: model(xb), f"bf16 {tag} forward B={AUDIO_B}, K1 route", "profile_bf16_wav2vec2.json",
                          profile_dir, card, lambda out: 1, "forward")
    w2v = encoders.pop(W2V_MODELS[0][0])
    del encoders, model

    # EnCodec: the card's fp32 codes and decode against the port's CPU output on the same params; rates
    for variant, channels, rate in (("24khz", 1, 24_000), ("48khz", 2, 48_000)):
        t0 = time.perf_counter()
        model = audio.EnCodec.from_facebook(variant, device=dev)
        twin = audio.EnCodec.from_facebook(variant, device="cpu")
        twin.params = tree_map(lambda t: t.cpu(), model.params)
        x_cpu = torch.from_numpy(_codec_clips(ENCODEC_B, channels, rate, SEED + 32))
        x = x_cpu.to(dev)
        codes, scale = model.encode(x)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_codes, ref_scale = twin.encode(x_cpu)
        n_q = model.cfg.n_quantizers
        if codes.shape != ref_codes.shape or codes.shape[:2] != (ENCODEC_B, n_q):
            raise AssertionError(f"EnCodec {variant}: codes {tuple(codes.shape)} vs the CPU's {tuple(ref_codes.shape)}")
        partings = _rvq_partings(f"EnCodec {variant}", twin, x_cpu, codes, ref_codes)
        y = model.decode(codes, scale)
        y_ref = twin.decode(codes.cpu(), ref_scale)  # the card's codes, the CPU's loudness scale
        t_cpu = time.perf_counter() - t0
        err = (y.cpu() - y_ref).abs().max().item()
        limit = ENCODEC_TOL * max(1.0, y_ref.abs().max().item())
        if y.shape != (ENCODEC_B, channels, x.shape[-1]) or not bool(torch.isfinite(y).all()) or err > limit:
            raise AssertionError(f"EnCodec {variant} fp32: decode {tuple(y.shape)}, card vs CPU max |diff| {err:.3g} "
                                 f"(limit {limit:.3g})")
        rates = {}
        for dn in ("float32", "bfloat16"):
            if dn == "bfloat16":
                model.to_bf16()
            xd = x.to(getattr(torch, dn))
            ms = _turns({dn: lambda: model.decode(*model.encode(xd))}, 1)[dn]
            rates[dn] = f"{dn} {ENCODEC_B * AUDIO_SECONDS / (ms / 1e3):.1f} audio-s/s ({ms:.1f} ms)"
        print(f"phase audio EnCodec {variant} B={ENCODEC_B} x {AUDIO_SECONDS} s ({channels} channel(s) at {rate} Hz, "
              f"{n_q} quantizers, {codes.shape[-1]} frames): fp32 (TF32 off) codes card vs CPU identical but for "
              f"near-ties within {RVQ_GAP_TOL} ({partings}); the card's decode vs the CPU's of the same codes "
              f"(|y| <= {y_ref.abs().max().item():.3g}) max_abs_err={err:.3g} (limit {limit:.3g}); card encode "
              f"{t_card:.1f} s cold, CPU encode + decode {t_cpu:.1f} s; encode + decode, 2 turns: "
              + ", ".join(rates.values()) + f" [{card}]")
        del model, twin

    # w8a8: the linear bit for bit across devices, then ViT-B/16 and wav2vec2-base against their bf16 routes
    g = torch.Generator().manual_seed(SEED + 33)
    saved = layers.USE_A8_LINEAR
    try:
        layers.USE_A8_LINEAR = True
        for rows, d_in, d_out in A8_LINEAR_SHAPES:
            w = torch.randn(d_in, d_out, generator=g) / d_in ** 0.5
            p = quantize_tree_int8({"fc1": {"w": w, "b": 0.1 * torch.randn(d_out, generator=g)}})["fc1"]
            xl = torch.randn(rows, d_in, generator=g).to(torch.bfloat16)
            xl[0] = 0.0  # a zero row
            got = layers.linear(tree_map(lambda t: t.to(dev), p), xl.to(dev))
            if not torch.equal(got.cpu(), layers.linear(p, xl)):
                raise AssertionError(f"w8a8 linear ({rows}, {d_in}) -> {d_out}: the card's result differs from the "
                                     "CPU's")
        print(f"phase audio w8a8 linear: the card's int8 product (torch._int_mm, padded to > 16 rows and sizes of "
              f"8) equals the CPU's bit for bit at (rows, in, out) {list(A8_LINEAR_SHAPES)}, bf16 input with a zero "
              f"row")
    finally:
        layers.USE_A8_LINEAR = saved

    vit = ViT.from_google("B/16_augreg", rng=SEED, device=dev)
    gv = torch.Generator(device=dev).manual_seed(SEED + 11)
    for key in ("pe", "cls_token"):
        vit.params[key] = 0.02 * torch.randn(vit.params[key].shape, generator=gv, device=dev)
    imgs = torch.randn(VIT_B, 3, 224, 224, generator=gv, device=dev).to(torch.bfloat16)
    for name, model, xin, unit, n in (("ViT-B/16", vit.to_bf16(), imgs, "images", VIT_B),
                                      ("wav2vec2-base", w2v, x32.to(torch.bfloat16), "audio-s", audio_s)):
        bf16_params = model.params
        int8_params = quantize_tree_int8(bf16_params)

        def route(r, model=model, xin=xin, bf16_params=bf16_params, int8_params=int8_params):
            model.params = int8_params if r == "w8a8" else bf16_params
            layers.USE_A8_LINEAR = r == "w8a8"
            return model(xin)

        try:
            base = route("bf16").float()
            n_k1, a8 = _k1_calls(lambda: route("w8a8"))
            a8 = a8.float()
            a, b = a8.reshape(-1, a8.shape[-1]), base.reshape(-1, base.shape[-1])
            rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1.0)
            cos = ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()
            n_layers = len(bf16_params["encoder"]["layers"])
            if rel >= A8_REL or cos <= A8_COS or n_k1 != n_layers:
                raise AssertionError(f"{name} w8a8 vs bf16: max relative {rel:.3g} (limit {A8_REL}), min row cosine "
                                     f"{cos:.5f} (limit {A8_COS}), K1 {n_k1} launches")
            ms = _turns({r: (lambda r=r: route(r)) for r in ("bf16", "w8a8")}, FAM_FORWARDS)
        finally:
            layers.USE_A8_LINEAR = saved
            model.params = bf16_params
        print(f"phase audio w8a8 {name} B={xin.shape[0]} (quantize_int8() + USE_A8_LINEAR; K1 {n_k1} times a "
              f"forward on the bf16 q/k/v): vs the bf16 route max relative {rel:.3g} (limit {A8_REL}), min row cosine "
              f"{cos:.5f} (limit {A8_COS}); " + "; ".join(f"{r} {n / (ms[r] / 1e3):.1f} {unit}/s ({ms[r]:.3f} ms "
                                                          f"per forward)" for r in ("w8a8", "bf16"))
              + f" (CUDA events over {FAM_FORWARDS} forwards a turn, turns bf16, w8a8, w8a8, bf16) [{card}]")
    return launches


# phase "pretrained": full-width checkpoints written from a seed into a fresh cache, read back by pretrained=True
PRE_NEW = 32  # new tokens per GPT-2 row
PRE_VIT_B = 8
PRE_VIT_TOL = (1e-4, 1e-4)  # ViT-B/16 fp32 on the card's K1 route vs the CPU forward of the same checkpoint
CACHE_ENV = "PYTORCH_MODELS_TPU_CACHE"
AUGREG_B16 = "B_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0.npz"


def _cpu(t):
    return t.detach().cpu().contiguous()


def _gpt2_hf_state_dict(params: dict) -> dict:
    """The port's GPT-2 tree as HF's ``gpt2`` state dict: Conv1D weights
    ``(in, out)``, q, k and v side by side in ``c_attn``; CPU tensors."""
    import torch

    sd = {"wte.weight": params["token_embs"], "wpe.weight": params["pos_embs"],
          "ln_f.weight": params["norm"]["scale"], "ln_f.bias": params["norm"]["bias"]}
    for i, lp in enumerate(params["decoder"]["layers"]):
        sa, h = lp["sa"], f"h.{i}"
        sd |= {f"{h}.ln_1.weight": lp["sa_norm"]["scale"], f"{h}.ln_1.bias": lp["sa_norm"]["bias"],
               f"{h}.attn.c_attn.weight": torch.cat([sa[k]["w"] for k in "qkv"], 1),
               f"{h}.attn.c_attn.bias": torch.cat([sa[k]["b"] for k in "qkv"]),
               f"{h}.attn.c_proj.weight": sa["o"]["w"], f"{h}.attn.c_proj.bias": sa["o"]["b"],
               f"{h}.ln_2.weight": lp["mlp_norm"]["scale"], f"{h}.ln_2.bias": lp["mlp_norm"]["bias"],
               f"{h}.mlp.c_fc.weight": lp["mlp"]["fc1"]["w"], f"{h}.mlp.c_fc.bias": lp["mlp"]["fc1"]["b"],
               f"{h}.mlp.c_proj.weight": lp["mlp"]["fc2"]["w"], f"{h}.mlp.c_proj.bias": lp["mlp"]["fc2"]["b"]}
    return {k: _cpu(v) for k, v in sd.items()}


def _whisper_openai_checkpoint(params: dict, cfg) -> dict:
    """The port's Whisper tree as OpenAI's ``.pt`` (``dims`` and
    ``model_state_dict``: ``nn.Linear`` weights ``(out, in)``, Conv1d ``(out,
    in, k)``, no key bias, which must be zero in ``params``); CPU tensors."""
    sd = {}

    def lin(pfx, p, bias=True):
        sd[f"{pfx}.weight"] = p["w"].t()
        if bias:
            sd[f"{pfx}.bias"] = p["b"]

    def ln(pfx, p):
        sd[f"{pfx}.weight"], sd[f"{pfx}.bias"] = p["scale"], p["bias"]

    def attn(pfx, p):
        if p["k"]["b"].any():
            raise AssertionError("OpenAI's key projections have no bias: zero it before writing")
        lin(f"{pfx}.query", p["q"])
        lin(f"{pfx}.key", p["k"], bias=False)
        lin(f"{pfx}.value", p["v"])
        lin(f"{pfx}.out", p["o"])

    enc, dec = params["encoder"], params["decoder"]
    for i in (1, 2):
        sd[f"encoder.conv{i}.weight"] = enc[f"conv{i}"]["w"].permute(2, 1, 0)
        sd[f"encoder.conv{i}.bias"] = enc[f"conv{i}"]["b"]
    sd["encoder.positional_embedding"] = enc["pos_embs"]
    sd["decoder.token_embedding.weight"] = dec["token_embs"]
    sd["decoder.positional_embedding"] = dec["pos_embs"]
    ln("encoder.ln_post", enc["norm"])
    ln("decoder.ln", dec["norm"])
    for side, stack in (("encoder", enc), ("decoder", dec)):
        for i, lp in enumerate(stack["layers"]):
            pfx = f"{side}.blocks.{i}"
            attn(f"{pfx}.attn", lp["sa"])
            ln(f"{pfx}.attn_ln", lp["sa_norm"])
            if "ca" in lp:
                attn(f"{pfx}.cross_attn", lp["ca"])
                ln(f"{pfx}.cross_attn_ln", lp["ca_norm"])
            lin(f"{pfx}.mlp.0", lp["mlp"]["fc1"])
            lin(f"{pfx}.mlp.2", lp["mlp"]["fc2"])
            ln(f"{pfx}.mlp_ln", lp["mlp_norm"])
    dims = {"n_mels": cfg.n_mels, "n_vocab": cfg.vocab_size, "n_audio_state": cfg.d_model,
            "n_audio_layer": cfg.n_layers, "n_text_state": cfg.d_model, "n_text_layer": cfg.n_layers}
    return {"dims": dims, "model_state_dict": {k: _cpu(v) for k, v in sd.items()}}


def _vit_augreg_arrays(params: dict, cfg) -> dict:
    """The port's ViT tree (cls pooling) as an AugReg Flax ``.npz``'s arrays:
    q/k/v kernels ``(d, H, hd)``, the output's ``(H, hd, d)``, the PE with
    a zero cls slot (the loader folds that slot into the cls token)."""
    import torch

    d, h, pe = cfg.d_model, cfg.n_heads, params["pe"]
    w = {"cls": params["cls_token"],
         "Transformer/posembed_input/pos_embedding": torch.cat([torch.zeros_like(pe[:, :1]), pe], 1),
         "embedding/kernel": params["patch_embed"]["w"], "embedding/bias": params["patch_embed"]["b"],
         "Transformer/encoder_norm/scale": params["norm"]["scale"],
         "Transformer/encoder_norm/bias": params["norm"]["bias"]}
    for i, lp in enumerate(params["encoder"]["layers"]):
        blk = f"Transformer/encoderblock_{i}"
        for name, norm in (("LayerNorm_0", "sa_norm"), ("LayerNorm_2", "mlp_norm")):
            w[f"{blk}/{name}/scale"], w[f"{blk}/{name}/bias"] = lp[norm]["scale"], lp[norm]["bias"]
        mha = f"{blk}/MultiHeadDotProductAttention_1"
        for proj, key in (("query", "q"), ("key", "k"), ("value", "v")):
            w[f"{mha}/{proj}/kernel"] = lp["sa"][key]["w"].reshape(d, h, d // h)
            w[f"{mha}/{proj}/bias"] = lp["sa"][key]["b"].reshape(h, d // h)
        w[f"{mha}/out/kernel"] = lp["sa"]["o"]["w"].reshape(h, d // h, d)
        w[f"{mha}/out/bias"] = lp["sa"]["o"]["b"]
        for j, fc in enumerate(("fc1", "fc2")):
            w[f"{blk}/MlpBlock_3/Dense_{j}/kernel"] = lp["mlp"][fc]["w"]
            w[f"{blk}/MlpBlock_3/Dense_{j}/bias"] = lp["mlp"][fc]["b"]
    return {k: _cpu(v).numpy() for k, v in w.items()}


def _trees_equal(what: str, got, expected) -> int:
    """Raises unless the two trees hold the same structure and every leaf
    the same dtype, shape and bits (compared on the CPU); returns the leaf count."""
    import torch

    if isinstance(expected, dict):
        if not isinstance(got, dict) or set(got) != set(expected):
            raise AssertionError(f"{what}: keys differ")
        return sum(_trees_equal(f"{what}/{k}", got[k], expected[k]) for k in expected)
    if isinstance(expected, list):
        if not isinstance(got, list) or len(got) != len(expected):
            raise AssertionError(f"{what}: lengths differ")
        return sum(_trees_equal(f"{what}/{i}", g, e) for i, (g, e) in enumerate(zip(got, expected)))
    if got.dtype != expected.dtype or got.shape != expected.shape or not torch.equal(got.cpu(), expected.cpu()):
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} differs from {expected.dtype} "
                             f"{tuple(expected.shape)}")
    return 1


def pretrained_path(dev, card: str) -> dict:
    """Phase "pretrained": ``pretrained=True`` from a local checkpoint cache.

    ``PYTORCH_MODELS_TPU_CACHE`` points at a fresh temporary directory
    (restored and removed at the end). Three full-width checkpoints are
    written there from the seed, each from the model its own phase builds and
    scaled as that phase scales it: GPT-2 small as HF's ``gpt2.bin``,
    Whisper-base as OpenAI's ``base.pt`` (its key biases zeroed: the format
    has none), ViT-B/16 as the AugReg ``.npz``. Each is loaded by
    ``from_*(tag, pretrained=True)`` on the card and with ``device="cpu"``:
    both trees must equal the written one bit for bit. fp32 on the card:
    GPT-2 ``generate_tokens_batch`` (B=8, PRE_NEW new) and Whisper-base
    ``transcribe_tokens_batch`` (8 segments) token-identical on the fused,
    per-op and plain routes (near-ties printed), K7 once per decode step,
    K3's ``embed_add`` once per step and per prefill, K5 and K1 launched;
    ViT-B/16 at B=PRE_VIT_B, the K1 route within PRE_VIT_TOL of the CPU
    model's forward, K1 once per layer. Then GPT-2 in bf16 through
    ``save`` / ``load`` into a model of another seed: the same bits and the
    same fused tokens. Counts from 0 over the fp32 runs; returns them."""
    import os
    import shutil
    import tempfile

    import torch

    from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
    from pytorch_models_tpu_torch.image import ViT
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.text import GPT2, DecoderGenerator

    kernels = _kernels()
    t_phase = time.perf_counter()
    saved_env = os.environ.get(CACHE_ENV)
    root = tempfile.mkdtemp(prefix="pmt_cache_")
    os.environ[CACHE_ENV] = root
    seconds = {}

    def loaded(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out

    try:
        # the three checkpoints, from the models (and the scales) of phases "main", "whisper" and "vit"
        t = time.perf_counter()
        src = GPT2.from_hf("gpt2", rng=SEED, device=dev)
        _make_streams_move(dev, SEED + 7, src.params, [src.params["decoder"]["layers"]])
        torch.save(_gpt2_hf_state_dict(src.params), os.path.join(root, "gpt2.bin"))
        gpt2_src = src.params
        src = Whisper.from_openai("base", rng=SEED, device=dev)
        _make_streams_move(dev, SEED + 3, src.params["decoder"],
                           [src.params["encoder"]["layers"], src.params["decoder"]["layers"]])
        for stack in (src.params["encoder"], src.params["decoder"]):
            for lp in stack["layers"]:
                for blk in ("sa", "ca"):
                    if blk in lp:
                        lp[blk]["k"]["b"].zero_()
        torch.save(_whisper_openai_checkpoint(src.params, src.cfg), os.path.join(root, "base.pt"))
        whisper_src = src.params
        src = ViT.from_google("B/16_augreg", rng=SEED, device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 11)
        for key in ("pe", "cls_token"):
            src.params[key] = 0.02 * torch.randn(src.params[key].shape, generator=g, device=dev)
        np.savez(os.path.join(root, AUGREG_B16), **_vit_augreg_arrays(src.params, src.cfg))
        vit_src = src.params
        del src
        sizes = {n: os.path.getsize(os.path.join(root, n)) / 2**20 for n in ("gpt2.bin", "base.pt", AUGREG_B16)}
        print(f"phase pretrained: cache {root}: " + ", ".join(f"{n} {mb:.1f} MiB" for n, mb in sizes.items())
              + f" written from seed {SEED} in {time.perf_counter() - t:.1f} s")

        gpt2 = loaded("GPT-2 small card", lambda: GPT2.from_hf("gpt2", pretrained=True, device=dev))
        gpt2_cpu = loaded("GPT-2 small cpu", lambda: GPT2.from_hf("gpt2", pretrained=True, device="cpu"))
        whisper = loaded("Whisper-base card", lambda: Whisper.from_openai("base", pretrained=True, device=dev))
        whisper_cpu = loaded("Whisper-base cpu", lambda: Whisper.from_openai("base", pretrained=True, device="cpu"))
        vit = loaded("ViT-B/16 card", lambda: ViT.from_google("B/16", pretrained=True, device=dev))
        vit_cpu = loaded("ViT-B/16 cpu", lambda: ViT.from_google("B/16", pretrained=True, device="cpu"))
        leaves = {}
        for name, (card_model, cpu_model, written) in {"GPT-2": (gpt2, gpt2_cpu, gpt2_src),
                                                       "Whisper": (whisper, whisper_cpu, whisper_src),
                                                       "ViT": (vit, vit_cpu, vit_src)}.items():
            _trees_equal(f"{name} card vs cpu", card_model.params, cpu_model.params)
            leaves[name] = _trees_equal(f"{name} card vs written", card_model.params, written)
        del gpt2_src, whisper_src, vit_src, gpt2_cpu, whisper_cpu
        print("phase pretrained loads (from_*(tag, pretrained=True), s): "
              + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
              + "; card and CPU trees equal bit for bit, and equal to the written ones ("
              + ", ".join(f"{k} {v} leaves" for k, v in leaves.items()) + ")")

        # GPT-2 fp32 through the three routes; counts from 0
        r = np.random.default_rng(SEED + 21)
        prompts = [r.integers(0, 50257, n).tolist() for n in PROMPT_LENS]
        gen = DecoderGenerator(gpt2, _Tok())

        def gpt2_gap(i, prefix):
            _route("plain")
            with torch.inference_mode():
                return _top2(gpt2(torch.tensor(prefix))[-1])

        _reset_launches()
        outs = {}
        for route in ("plain", "fused", "per-op"):
            _route(route)
            before = kernels["fused_decode_step"].launches, kernels["embed_add"].launches
            outs[route] = gen.generate_tokens_batch(prompts, max_tokens=PRE_NEW)
            if route == "fused":
                k7 = kernels["fused_decode_step"].launches - before[0]
                emb = kernels["embed_add"].launches - before[1]
        torch.cuda.synchronize()
        for route, rows in outs.items():
            if any(row[:len(p)] != p or len(row) != len(p) + PRE_NEW for row, p in zip(rows, prompts)):
                raise AssertionError(f"pretrained gpt2 ({route}): malformed row")
        steps = _decode_steps([PRE_NEW] * len(prompts), PRE_NEW - 1, False)
        if k7 != steps or not steps < emb <= steps + len(prompts):
            raise AssertionError(f"pretrained gpt2 fused route: K7 {k7} and embed_add {emb} launches for {steps} "
                                 "decode steps")
        distinct = _check_moving("pretrained gpt2 fp32", outs["fused"], PROMPT_LENS)
        partings = _check_routes("pretrained gpt2 fp32", outs, gpt2_gap)
        print(f"phase pretrained gpt2 fp32 generate_tokens_batch B={len(prompts)} x {PRE_NEW} new: fused, per-op and "
              f"plain token-identical (partings at near-ties: {partings}); fused route K7 {k7} launches = {steps} "
              f"decode steps, embed_add {emb} (the steps and {emb - steps} prefill); distinct new tokens per row "
              f"{distinct}")

        # Whisper-base fp32 through the three routes
        wgen = WhisperGenerator(whisper)
        wav = torch.from_numpy(_waveforms(8, W_SECONDS, SEED + 4)).to(dev)
        n_init, max_tokens = len(W_INIT), len(W_INIT) + N_NEW

        def whisper_gap(i, prefix):
            _route("plain")
            with torch.inference_mode():
                return _top2(whisper(wgen.preprocessor(wav[i:i + 1]), torch.tensor([prefix], device=dev))[0, -1])

        wouts = {}
        for route in ("plain", "fused", "per-op"):
            _route(route)
            before = kernels["fused_cross_decode_step"].launches
            wouts[route] = wgen.transcribe_tokens_batch(wav, W_INIT, W_EOT, max_tokens)
            if route == "fused":
                k7x = kernels["fused_cross_decode_step"].launches - before
        torch.cuda.synchronize()
        fused = wouts["fused"]
        if any(r[:n_init] != W_INIT or not n_init < len(r) <= max_tokens for rows in wouts.values() for r in rows):
            raise AssertionError("pretrained whisper: malformed row")
        wsteps = _decode_steps([len(r) - n_init for r in fused], max_tokens - n_init - 1,
                               all(W_EOT in r[n_init:] for r in fused))
        if k7x != wsteps:
            raise AssertionError(f"pretrained whisper fused route: K7 launched {k7x} times for {wsteps} decode steps")
        wdistinct = _check_moving("pretrained whisper fp32", fused, [n_init] * len(fused))
        wpartings = _check_routes("pretrained whisper fp32", wouts, whisper_gap)
        print(f"phase pretrained whisper fp32 transcribe_tokens_batch B=8: fused, per-op and plain token-identical "
              f"(partings at near-ties: {wpartings}); K7 (cross) {k7x} launches = {wsteps} decode steps; generated "
              f"lengths {[len(r) - n_init for r in fused]}, distinct tokens per row {wdistinct}")

        # ViT-B/16 fp32: the card's K1 route against the CPU model's forward
        imgs = torch.randn(PRE_VIT_B, 3, 224, 224, generator=torch.Generator().manual_seed(SEED + 13))
        attn.USE_ENCODER_KERNEL = None
        before = kernels["encoder_attention"].launches
        got = vit(imgs.to(dev))
        torch.cuda.synchronize()
        k1 = kernels["encoder_attention"].launches - before
        ref = vit_cpu(imgs)
        if k1 != vit.cfg.n_layers or got.shape != (PRE_VIT_B, vit.cfg.d_model):
            raise AssertionError(f"pretrained vit: K1 launched {k1} times, features {tuple(got.shape)}")
        err = _check_close("pretrained vit fp32 card K1 route vs CPU", got.cpu(), ref, PRE_VIT_TOL)
        print(f"phase pretrained vit fp32 B={PRE_VIT_B}: the card's K1 route vs the CPU forward of the same checkpoint "
              f"max_abs_err={err:.3g} (atol, rtol)={PRE_VIT_TOL} at |x| <= {ref.abs().max().item():.3g}; K1 "
              f"launched {k1} times = {vit.cfg.n_layers} layers")
        _route("fused")
        launches = _launches({"encoder_attention", "decode_attention", "embed_add", "greedy_argmax_tied",
                              "log_mel_spectrogram", "fused_decode_step", "fused_cross_decode_step"})
        print("phase pretrained launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
        del whisper, wgen, vit, vit_cpu

        # bf16 through save / load
        gpt2.to_bf16()
        out16 = gen.generate_tokens_batch(prompts, max_tokens=PRE_NEW)
        path = os.path.join(root, "gpt2_bf16.pt")
        t = time.perf_counter()
        gpt2.save(path)
        save_s = time.perf_counter() - t
        other = GPT2.from_hf("gpt2", rng=SEED + 1, device=dev)
        t = time.perf_counter()
        other.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        n16 = _trees_equal("GPT-2 bf16 loaded vs saved", other.params, gpt2.params)
        if other.params["token_embs"].dtype != torch.bfloat16 or other.params["token_embs"].device.type != "cuda":
            raise AssertionError("GPT-2 bf16 load: not bf16 on the card")
        again = DecoderGenerator(other, _Tok()).generate_tokens_batch(prompts, max_tokens=PRE_NEW)
        if again != out16:
            raise AssertionError("GPT-2 bf16: the loaded model's fused tokens differ from the saved model's")
        print(f"phase pretrained gpt2 bf16 save / load ({os.path.getsize(path) / 2**20:.1f} MiB, torch.save): "
              f"{n16} leaves bit-identical on the card, fused tokens identical; save {save_s:.2f} s, load "
              f"{load_s:.2f} s")
    finally:
        if saved_env is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = saved_env
        shutil.rmtree(root, ignore_errors=True)
        _route("fused")
    print(f"phase pretrained: {time.perf_counter() - t_phase:.1f} s [{card}]")
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
    plain, fused and per-op routes (the fused step headless once per step, over
    row slices above 32 rows), then bf16 rates of the fused and per-op routes and the
    beam cache reorder's time a step. Models and seeds as the greedy paths'.
    Returns each path's launches (counts from 0 just before it)."""
    import torch

    from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
    from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator, beam
    from pytorch_models_tpu_torch.ops.decode_step import MAX_LAUNCH_ROWS
    from pytorch_models_tpu_torch.text import T5Generator, T5Model

    kernels = _kernels()
    launches, rates = {}, {}
    r = np.random.default_rng(SEED)
    prompts = [r.integers(0, 50257, n).tolist() for n in PROMPT_LENS]
    model = GPT2.from_hf("gpt2", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 7, model.params, [model.params["decoder"]["layers"]])
    gen = DecoderGenerator(model, _Tok())
    c = model.cfg

    # ---- beam gpt2 fp32: G x W = 8 rows, 16 and 36 (the fused step headless; 36 rows over slices of 32 and 4)
    _route("plain")
    with torch.inference_mode():
        tol = _beam_tol(model(torch.tensor(prompts[0], device=dev))[-1])
    _reset_launches()
    for g in BEAM_G:
        gp = _cycle(prompts, g)

        def run(gp=gp):
            return gen.beam_search_tokens_batch(gp, max_tokens=BEAM_NEW, beam_width=BEAM_W, return_all=True)

        before = kernels["fused_decode_step"].variant_launches["headless"]
        outs, partings, steps = _beam_routes(f"beam gpt2 fp32 G={g}", run, _beam_rows_check(
            "beam gpt2", gp, c.vocab_size), tol)
        headless = kernels["fused_decode_step"].variant_launches["headless"] - before
        want = steps * -(-g * BEAM_W // MAX_LAUNCH_ROWS)  # a launch per row slice of at most 32 rows
        if headless != want:
            raise AssertionError(f"beam gpt2 G={g}: K7 headless launched {headless} times for {want} (fused beam "
                                 f"steps x row slices)")
        print(f"phase beam gpt2 fp32 G={g} x W={BEAM_W} ({g * BEAM_W} rows): fused, per-op and plain beams identical "
              f"(partings at near-ties: {partings}); {steps} beam steps, K7 headless launched {headless} times "
              f"({want // steps} a step); best scores {[round(s[0], 4) for s in outs['fused'][1]]}")
    launches["beam gpt2"] = _launches({"fused_decode_step", "decode_attention", "embed_add"})

    # ---- sample gpt2 fp32: B=8 prompts, 16 samples of one (the fused step headless)
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
        if headless != (BEAM_NEW - 1) * -(-len(rows_p) // MAX_LAUNCH_ROWS):  # a launch per row slice a step
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
    # both cases decode through K7 (8 and 16 rows, one launch a step): no per-op step, so no K2, runs here
    launches["sample gpt2"] = _launches({"fused_decode_step", "embed_add"})

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


# bench.py's batched greedy decode shapes, which K7 serves since it takes up to 32 rows: GPT-2 (rows, prompt
# tokens, new tokens), T5 (rows, input tokens, new tokens), Whisper (rows); the fp32 route-identity runs take
# BATCH_FP32_NEW new tokens (Whisper: N_NEW), the bf16 rates the full count
BATCH_GPT2, BATCH_T5, BATCH_WHISPER = (32, 32, 512), (32, 64, 64), 16
BATCH_FP32_NEW = 32


def _bucket_key(b: int) -> str:
    """K7's launch counter of b rows above one row group (ops.decode_step._count)."""
    return "b16" if b <= 16 else "b32"


def _k7_counts(kernel) -> dict:
    """K7's launches, and those of each row bucket and of row slices (ops.decode_step._count)."""
    return {"launches": kernel.launches} | {k: kernel.variant_launches[k] for k in ("b16", "b32", "sliced")}


def _slice_counts(slices: list[int]) -> dict:
    """What one step over these row slices adds to :func:`_k7_counts`."""
    want = {"launches": len(slices), "b16": 0, "b32": 0, "sliced": len(slices) if len(slices) > 1 else 0}
    for n in slices:
        if n > 8:
            want[_bucket_key(n)] += 1
    return want


def _batch_run(what: str, kernel, b: int, run, rows_ok, steps_of, gap_fn, slices=None) -> tuple[dict, str]:
    """fp32 plain, fused (flags auto: K7) and per-op routes of ``run``; rows
    checked by ``rows_ok(route, rows)``, tokens identical to plain up to
    near-ties (``_check_routes``), and K7 launched at this batch once per
    decode step (``steps_of(fused rows)``), or, given ``slices`` (the rows
    of each launch a step makes), once per row slice, each counted under
    its own rows. Returns the rows and a note."""
    import torch

    slices = slices or [b]
    outs, k7 = {}, {}
    for route in ("plain", "fused", "per-op"):
        _route(route)
        before = _k7_counts(kernel)
        outs[route] = run()
        if route == "fused":
            k7 = {k: v - before[k] for k, v in _k7_counts(kernel).items()}
    _route("fused")
    torch.cuda.synchronize()
    for route, rows in outs.items():
        rows_ok(route, rows)
    steps = steps_of(outs["fused"])
    want = {k: steps * v for k, v in _slice_counts(slices).items()}
    if k7 != want:
        raise AssertionError(f"{what}: K7 launched {k7} at B={b}, {want} wanted for {steps} decode steps over row "
                             f"slices of {slices}")
    partings = _check_routes(what, outs, gap_fn)
    over = "" if len(slices) == 1 else f" x {len(slices)} row slices ({' + '.join(map(str, slices))} rows)"
    return outs, (f"fused, per-op kernels and plain token-identical (partings at near-ties: {partings}); K7 "
                  f"launched {k7['launches']} times at B={b} = {steps} decode steps{over}")


def _route_rates(what: str, run, n_tok_of, card: str, routes=ROUTES) -> dict:
    """bf16 tokens/s of ``run`` on each route, in turns (CUDA events around
    each call); ``n_tok_of(rows)`` counts the generated tokens."""
    times, toks = {}, {}
    order = list(routes) + list(routes)[::-1]
    for route in order:
        _route(route)
        ms, rows = _event_ms(run)
        times.setdefault(route, []).append(ms)
        toks[route] = n_tok_of(rows)
    _route("fused")
    rates = {k: toks[k] / (np.mean(v) / 1e3) for k, v in times.items()}
    print(f"phase time bf16 {what}, CUDA events, prefill included: "
          + ", ".join(f"{k} {rates[k]:.1f} generated tok/s ({np.mean(times[k]):.1f} ms, {toks[k]} tokens)"
                      for k in routes) + f" [{card}]")
    return rates


def batch_paths(dev, card: str) -> dict:
    """bench.py's batched greedy decode through K7 above one row group:
    GPT-2 small at B=32 (32-token prompts), T5-base at B=32 (64-token
    inputs) and Whisper-base at B=16 (16 waveforms of 5-30 s), models and
    scales as the main paths'. fp32: the fused, per-op and plain routes
    token-identical (``_batch_run``), K7 once per decode step at that batch;
    bf16: generated tok/s of the fused and per-op routes in turns at the bench shapes (GPT-2
    512 new tokens, T5 64, Whisper N_NEW). Counts from 0 before each model;
    returns each model's launches."""
    import torch

    from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
    from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
    from pytorch_models_tpu_torch.text import T5Generator, T5Model

    kernels = _kernels()
    out = {}

    # ---- GPT-2 small, B=32
    b, p_len, n_new = BATCH_GPT2
    model = GPT2.from_hf("gpt2", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 7, model.params, [model.params["decoder"]["layers"]])
    gen = DecoderGenerator(model, _Tok())
    r = np.random.default_rng(SEED + 32)
    prompts = [r.integers(0, 50257, p_len).tolist() for _ in range(b)]

    def gpt2_ok(n):
        def ok(route, rows):
            if any(row[:p_len] != p or len(row) != p_len + n for row, p in zip(rows, prompts)):
                raise AssertionError(f"batch gpt2 B={b} ({route}): malformed row")
        return ok

    def gpt2_gap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(torch.tensor(prefix, device=dev))[-1])

    _reset_launches()
    rows, note = _batch_run(f"batch gpt2 fp32 B={b}", kernels["fused_decode_step"], b,
                            lambda: gen.generate_tokens_batch(prompts, max_tokens=BATCH_FP32_NEW),
                            gpt2_ok(BATCH_FP32_NEW), lambda rows: BATCH_FP32_NEW - 1, gpt2_gap)
    distinct = _check_moving(f"batch gpt2 B={b}", rows["fused"], [p_len] * b)
    print(f"phase batch gpt2 fp32 generate_tokens_batch B={b} x {p_len}-token prompts, {BATCH_FP32_NEW} new: {note}; "
          f"distinct new tokens per row {min(distinct)}-{max(distinct)}")
    model.to_bf16()
    _route_rates(f"batch gpt2 generate_tokens_batch B={b} x {p_len}-token prompts, {n_new} new (bench.py's)",
                 lambda: gen.generate_tokens_batch(prompts, max_tokens=n_new),
                 lambda rows: sum(len(x) - p_len for x in rows), card, FUSED_PER_OP)
    out["batch gpt2"] = _launches({"fused_decode_step", "embed_add"})
    del model, gen

    # ---- T5-base, B=32
    b, in_len, n_new = BATCH_T5
    model = T5Model.from_t5x("flan_t5-base", rng=SEED, device=dev)
    _make_t5_streams_move(dev, SEED + 9, model.params)
    gen = T5Generator(model=model)
    r = np.random.default_rng(SEED + 33)
    inputs = [r.integers(2, model.cfg.vocab_size, in_len).tolist() for _ in range(b)]

    def t5_ok(n_max):
        def ok(route, rows):
            for row in rows:
                if row[0] != T5_PAD or not 1 < len(row) <= n_max or not all(0 <= t < model.cfg.vocab_size for t in row):
                    raise AssertionError(f"batch t5 B={b} ({route}): malformed row {row}")
        return ok

    def t5_steps(n_max):
        return lambda rows: _decode_steps([len(x) for x in rows], n_max - 1, all(T5_EOS in x[1:] for x in rows))

    def t5_gap(i, prefix):
        _route("plain")
        return _top2(model(torch.tensor([inputs[i]], device=dev), torch.tensor([prefix], device=dev))[0, -1])

    _reset_launches()
    n32 = BATCH_FP32_NEW + 1  # rows hold the pad token first
    rows, note = _batch_run(f"batch t5 fp32 B={b}", kernels["fused_cross_decode_step"], b,
                            lambda: gen.generate_tokens_batch(inputs, n32, T5_PAD, T5_EOS), t5_ok(n32),
                            t5_steps(n32), t5_gap)
    print(f"phase batch t5 fp32 generate_tokens_batch B={b} x {in_len}-token inputs, rows of {n32} tokens at most: "
          f"{note}; generated lengths {min(len(x) for x in rows['fused'])}-{max(len(x) for x in rows['fused'])}")
    model.to_bf16()
    _route_rates(f"batch t5 generate_tokens_batch B={b} x {in_len}-token inputs, {n_new} new at most (bench.py's)",
                 lambda: gen.generate_tokens_batch(inputs, n_new + 1, T5_PAD, T5_EOS),
                 lambda rows: sum(len(x) - 1 for x in rows), card, FUSED_PER_OP)
    out["batch t5"] = _launches({"fused_cross_decode_step"})
    del model, gen

    # ---- Whisper-base, B=16
    b = BATCH_WHISPER
    model = Whisper.from_openai("base", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 3, model.params["decoder"],
                       [model.params["encoder"]["layers"], model.params["decoder"]["layers"]])
    gen = WhisperGenerator(model)
    wav = torch.from_numpy(_waveforms(b, _cycle(list(W_SECONDS), b), SEED + 34)).to(dev)
    n_init, w_max = len(W_INIT), len(W_INIT) + N_NEW

    def w_ok(route, rows):
        for row in rows:
            if row[:n_init] != W_INIT or not n_init < len(row) <= w_max:
                raise AssertionError(f"batch whisper B={b} ({route}): malformed row {row}")

    def w_steps(rows):
        return _decode_steps([len(x) - n_init for x in rows], w_max - n_init - 1,
                             all(W_EOT in x[n_init:] for x in rows))

    def w_gap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(gen.preprocessor(wav[i:i + 1]), torch.tensor([prefix], device=dev))[0, -1])

    _reset_launches()
    rows, note = _batch_run(f"batch whisper fp32 B={b}", kernels["fused_cross_decode_step"], b,
                            lambda: gen.transcribe_tokens_batch(wav, W_INIT, W_EOT, w_max), w_ok, w_steps, w_gap)
    print(f"phase batch whisper fp32 transcribe_tokens_batch B={b} ({N_NEW} new at most): {note}; generated lengths "
          f"{min(len(x) - n_init for x in rows['fused'])}-{max(len(x) - n_init for x in rows['fused'])}")
    model.to_bf16()
    _route_rates(f"batch whisper transcribe_tokens_batch B={b} (bench.py's), {N_NEW} new at most",
                 lambda: gen.transcribe_tokens_batch(wav, W_INIT, W_EOT, w_max),
                 lambda rows: sum(len(x) - n_init for x in rows), card, FUSED_PER_OP)
    out["batch whisper"] = _launches({"fused_cross_decode_step"})
    return out


# the continuous-batching engine on GPT-2 small: a pool of CB_POOL slots (K7 at its largest batch), CB_REQUESTS
# requests of CB_PROMPT tokens (uniform) with budgets of CB_BUDGET new tokens, with and without a shared prefix
# of CB_PREFIX tokens; the int8 pool serves the first CB_INT8_REQUESTS of them
# (phase "k7 slices" serves more requests, 128, to a pool of 64)
CB_POOL, CB_REQUESTS, CB_PROMPT, CB_BUDGET, CB_PREFIX, CB_INT8_REQUESTS = 32, 48, (5, 200), (16, 128), 48, 24
CB_BUCKET, CB_CHECK_EVERY = 64, 16


def cb_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """``ContinuousBatchingGenerator`` on GPT-2 small at full width (scaled
    as the main path's), a pool of CB_POOL slots decoding through K7 at B=32.
    fp32: every request's tokens identical to the plain route's generation
    (every request in one left-padded ``generate_tokens_batch``, each row cut
    to its budget: no EOS, so a row does not depend on the others), up to
    near-ties, with and without a shared prefix; K7 launched once per decode
    step, at B=32. The int8 self-KV pool: every step's token held against the
    plain head on the kernel's own x_out (``_StepSpy``), and where its rows
    part from the pool driving K7's plain twin (a reading). bf16: the fused
    pool's generated tok/s against the per-op pool's (USE_FUSED_STEP False)
    in turns, with ServingStats' occupancy; with ``profile_dir``, one
    profiled bf16 call of each pool. Returns the launches."""
    import torch

    from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
    from pytorch_models_tpu_torch.text import ContinuousBatchingGenerator

    kernels = _kernels()
    k7 = kernels["fused_decode_step"]
    model = GPT2.from_hf("gpt2", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 7, model.params, [model.params["decoder"]["layers"]])
    gen = DecoderGenerator(model, _Tok())
    r = np.random.default_rng(SEED + 96)
    reqs = [r.integers(0, 50257, int(r.integers(CB_PROMPT[0], CB_PROMPT[1] + 1))).tolist()
            for _ in range(CB_REQUESTS)]
    budgets = [int(m) for m in r.integers(CB_BUDGET[0], CB_BUDGET[1] + 1, CB_REQUESTS)]
    prefix = r.integers(0, 50257, CB_PREFIX).tolist()
    cb = ContinuousBatchingGenerator(model, _Tok(), batch_size=CB_POOL, prompt_bucket=CB_BUCKET,
                                     check_every=CB_CHECK_EVERY)

    def gap_fn(i, pre):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(torch.tensor(pre, device=dev))[-1])

    _reset_launches()
    for pre in ([], prefix):
        what = f"cb fp32 {'with a ' + str(len(pre)) + '-token shared prefix' if pre else 'no prefix'}"
        _route("plain")
        full = gen.generate_tokens_batch([pre + q for q in reqs], max_tokens=max(budgets))
        ref = [row[:len(pre) + len(q) + m] for row, q, m in zip(full, reqs, budgets)]
        _route("fused")
        before = k7.launches, k7.variant_launches["b32"]
        got = cb.generate_tokens_many(reqs, budgets, shared_prefix=pre or None)
        torch.cuda.synchronize()
        st = cb.last_stats
        launched = k7.launches - before[0], k7.variant_launches["b32"] - before[1]
        if launched != (st.decode_steps, st.decode_steps):
            raise AssertionError(f"{what}: K7 launched {launched[0]} times ({launched[1]} at B={CB_POOL}) for "
                                 f"{st.decode_steps} decode steps")
        if any(len(row) != len(pre) + len(q) + m or row[:len(pre) + len(q)] != pre + q
               for row, q, m in zip(got, reqs, budgets)):
            raise AssertionError(f"{what}: malformed row")
        partings = _check_routes(what, {"fused": got, "plain": ref}, gap_fn)
        print(f"phase {what}: ContinuousBatchingGenerator pool {CB_POOL}, {CB_REQUESTS} requests of "
              f"{CB_PROMPT[0]}-{CB_PROMPT[1]} tokens, budgets {CB_BUDGET[0]}-{CB_BUDGET[1]} (bucket {CB_BUCKET}, "
              f"check_every {CB_CHECK_EVERY}): every request token-identical to the plain route's generation "
              f"(partings at near-ties: {partings}); K7 launched {launched[0]} times at B={CB_POOL} = "
              f"{st.decode_steps} decode steps; {st.admissions} admissions, {st.epoch_resets} epoch resets, "
              f"{st.scheduling_points} scheduling points, occupancy {st.occupancy:.3f}")

    # the int8 pool: int8 self-KV through K7's int8 variant at B=32
    r8, b8 = reqs[:CB_INT8_REQUESTS], budgets[:CB_INT8_REQUESTS]
    _int8_flags(kv=True)
    with _StepSpy(plain=True):
        twin = cb.generate_tokens_many(r8, b8)
    before = k7.variant_launches["kv_int8_b32"]
    with _StepSpy(plain=False) as spy:
        got = cb.generate_tokens_many(r8, b8)
    torch.cuda.synchronize()
    st = cb.last_stats
    launched = k7.variant_launches["kv_int8_b32"] - before
    _int8_flags()
    _route("fused")
    if launched != st.decode_steps or spy.steps != st.decode_steps:
        raise AssertionError(f"cb int8 pool: K7 int8 launched {launched} times, {spy.steps} checked, for "
                             f"{st.decode_steps} decode steps")
    distinct = _check_moving("cb int8 pool", got, [len(q) for q in r8])
    print(f"phase cb int8 pool fp32 (USE_INT8_KV): {len(r8)} requests, pool {CB_POOL}: every step's tokens = the "
          f"plain head on the kernel's own x_out (max score regret {spy.regret:.3g}); K7's int8 variant launched "
          f"{launched} times at B={CB_POOL} = {st.decode_steps} decode steps; rows against the pool driving the "
          f"twin (a reading): {_parting(got, twin)}; distinct new tokens per row {min(distinct)}-{max(distinct)}")

    # bf16: the fused pool against the per-op pool, in turns
    model.to_bf16()
    rates, occ = {}, {}
    for route in ("per-op", "fused", "fused", "per-op"):
        _route(route)
        cb.generate_tokens_many(reqs, budgets)
        st = cb.last_stats
        rates.setdefault(route, []).append(st.tokens_per_s)
        occ[route] = st.occupancy
    _route("fused")
    print(f"phase time bf16 cb: ContinuousBatchingGenerator pool {CB_POOL}, {CB_REQUESTS} requests, generated tok/s "
          "(host clock over the call, the last copy synchronizing): "
          + ", ".join(f"{k} {np.mean(v):.1f} (occupancy {occ[k]:.3f})" for k, v in rates.items()) + f" [{card}]")
    if profile_dir is not None:
        for route in ("fused", "per-op"):
            _route(route)
            profile_phase(lambda: cb.generate_tokens_many(reqs, budgets), f"bf16 cb pool {CB_POOL}, {route} route",
                          f"profile_bf16_cb_{route}.json", profile_dir, card, lambda out: cb.last_stats.decode_steps)
        _route("fused")
    return _launches({"fused_decode_step", "embed_add"})


# phase "k7 slices", K7 over row slices at full width: GPT-2 small at SL_GPT2 = (rows, prompt tokens (bench.py's),
# new tokens); a GPT-2-small pool of SL_POOL slots serving SL_REQUESTS requests of CB_PROMPT tokens, budgets
# CB_BUDGET; Whisper large-v3 (32 + 32 layers, d 1280, 20 heads, 128 mels) on SL_W_SEGMENTS segments of 5-30 s, at
# most SL_W_NEW new tokens; T5-base at SL_T5 rows of 64-token inputs, rows of at most BATCH_FP32_NEW + 1 tokens;
# each with the row slices a step launches (the most rows the planner takes, at most 32)
SL_GPT2, SL_POOL, SL_REQUESTS, SL_W_SEGMENTS, SL_W_NEW, SL_T5 = (64, 32, 32), 64, 128, 16, 32, 48
SL_SLICES = {"gpt2": [32, 32], "pool": [32, 32], "whisper": [8, 8], "t5": [32, 16]}


def slices_path(dev, card: str) -> dict:
    """Phase "k7 slices": the decoders through K7 over row slices, at full
    width with random weights from the seed (scaled as the other paths'
    so the streams move), where one launch does not serve the batch. fp32:
    the fused, per-op and plain routes token-identical up to near-ties, K7
    launched steps x slices (SL_SLICES), each slice under its own rows:
    GPT-2 small ``generate_tokens_batch`` at B=64; T5-base at B=48; Whisper
    large-v3 ``transcribe_tokens_batch`` on 16 segments (its frontend's K5
    at 128 mels and its encoder's K1 at 20 heads run too); the GPT-2 pool of
    64 slots, every request identical to the plain route's generation. bf16:
    GPT-2 tok/s, the pool's tok/s and occupancy, Whisper large-v3's
    segments/s and audio-seconds/s, fused against per-op in turns. Counts
    from 0 before each model; returns each one's launches."""
    import torch

    from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
    from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
    from pytorch_models_tpu_torch.text import ContinuousBatchingGenerator, T5Generator, T5Model

    kernels = _kernels()
    k7, k7x = kernels["fused_decode_step"], kernels["fused_cross_decode_step"]
    out = {}

    # ---- GPT-2 small, B=64
    b, p_len, n_new = SL_GPT2
    model = GPT2.from_hf("gpt2", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 7, model.params, [model.params["decoder"]["layers"]])
    gen = DecoderGenerator(model, _Tok())
    r = np.random.default_rng(SEED + 64)
    prompts = [r.integers(0, 50257, p_len).tolist() for _ in range(b)]

    def gpt2_ok(route, rows):
        if any(row[:p_len] != q or len(row) != p_len + n_new for row, q in zip(rows, prompts)):
            raise AssertionError(f"k7 slices gpt2 B={b} ({route}): malformed row")

    def gpt2_gap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(torch.tensor(prefix, device=dev))[-1])

    _reset_launches()
    rows, note = _batch_run(f"k7 slices gpt2 fp32 B={b}", k7, b,
                            lambda: gen.generate_tokens_batch(prompts, max_tokens=n_new), gpt2_ok,
                            lambda rows: n_new - 1, gpt2_gap, SL_SLICES["gpt2"])
    distinct = _check_moving(f"k7 slices gpt2 B={b}", rows["fused"], [p_len] * b)
    print(f"phase k7 slices gpt2 fp32 generate_tokens_batch B={b} x {p_len}-token prompts, {n_new} new: {note}; "
          f"distinct new tokens per row {min(distinct)}-{max(distinct)}")

    # ---- the GPT-2 pool of SL_POOL slots (fp32 here, bf16 below with the B=64 rate)
    r = np.random.default_rng(SEED + 128)
    reqs = [r.integers(0, 50257, int(r.integers(CB_PROMPT[0], CB_PROMPT[1] + 1))).tolist()
            for _ in range(SL_REQUESTS)]
    budgets = [int(m) for m in r.integers(CB_BUDGET[0], CB_BUDGET[1] + 1, SL_REQUESTS)]
    cb = ContinuousBatchingGenerator(model, _Tok(), batch_size=SL_POOL, prompt_bucket=CB_BUCKET,
                                     check_every=CB_CHECK_EVERY)
    _route("plain")
    full = gen.generate_tokens_batch(reqs, max_tokens=max(budgets))
    ref = [row[:len(q) + m] for row, q, m in zip(full, reqs, budgets)]
    _route("fused")
    before = _k7_counts(k7)
    got = cb.generate_tokens_many(reqs, budgets)
    torch.cuda.synchronize()
    st = cb.last_stats
    launched = {k: v - before[k] for k, v in _k7_counts(k7).items()}
    want = {k: st.decode_steps * v for k, v in _slice_counts(SL_SLICES["pool"]).items()}
    if launched != want:
        raise AssertionError(f"k7 slices pool {SL_POOL}: K7 launched {launched}, {want} wanted for "
                             f"{st.decode_steps} decode steps")
    if any(len(row) != len(q) + m or row[:len(q)] != q for row, q, m in zip(got, reqs, budgets)):
        raise AssertionError(f"k7 slices pool {SL_POOL}: malformed row")
    partings = _check_routes(f"k7 slices pool {SL_POOL} fp32", {"fused": got, "plain": ref}, gpt2_gap)
    print(f"phase k7 slices pool fp32: ContinuousBatchingGenerator pool {SL_POOL}, {SL_REQUESTS} requests of "
          f"{CB_PROMPT[0]}-{CB_PROMPT[1]} tokens, budgets {CB_BUDGET[0]}-{CB_BUDGET[1]}: every request token-identical "
          f"to the plain route's generation (partings at near-ties: {partings}); K7 launched {launched['launches']} "
          f"times = {st.decode_steps} decode steps x 2 row slices (32 + 32 rows); {st.admissions} admissions, "
          f"{st.epoch_resets} epoch resets, occupancy {st.occupancy:.3f}")
    model.to_bf16()
    _route_rates(f"k7 slices gpt2 generate_tokens_batch B={b} x {p_len}-token prompts, {n_new} new",
                 lambda: gen.generate_tokens_batch(prompts, max_tokens=n_new),
                 lambda rows: sum(len(x) - p_len for x in rows), card, FUSED_PER_OP)
    _pool_rates(f"k7 slices pool {SL_POOL}, {SL_REQUESTS} requests",
                lambda: (cb.generate_tokens_many(reqs, budgets), cb.last_stats)[1], SL_REQUESTS, "requests",
                lambda st: (), card)
    out["slices gpt2"] = _launches({"fused_decode_step", "embed_add"})
    del model, gen, cb

    # ---- T5-base, B=48
    b, in_len = SL_T5, BATCH_T5[1]
    model = T5Model.from_t5x("flan_t5-base", rng=SEED, device=dev)
    _make_t5_streams_move(dev, SEED + 9, model.params)
    gen = T5Generator(model=model)
    r = np.random.default_rng(SEED + 48)
    inputs = [r.integers(2, model.cfg.vocab_size, in_len).tolist() for _ in range(b)]
    n32 = BATCH_FP32_NEW + 1  # rows hold the pad token first

    def t5_ok(route, rows):
        for row in rows:
            if row[0] != T5_PAD or not 1 < len(row) <= n32 or not all(0 <= t < model.cfg.vocab_size for t in row):
                raise AssertionError(f"k7 slices t5 B={b} ({route}): malformed row {row}")

    def t5_gap(i, prefix):
        _route("plain")
        return _top2(model(torch.tensor([inputs[i]], device=dev), torch.tensor([prefix], device=dev))[0, -1])

    _reset_launches()
    rows, note = _batch_run(f"k7 slices t5 fp32 B={b}", k7x, b, lambda: gen.generate_tokens_batch(inputs, n32, T5_PAD,
                                                                                                    T5_EOS),
                            t5_ok, lambda rows: _decode_steps([len(x) for x in rows], n32 - 1,
                                                              all(T5_EOS in x[1:] for x in rows)),
                            t5_gap, SL_SLICES["t5"])
    print(f"phase k7 slices t5 fp32 generate_tokens_batch B={b} x {in_len}-token inputs, rows of {n32} tokens at "
          f"most: {note}")
    out["slices t5"] = _launches({"fused_cross_decode_step"})
    del model, gen

    # ---- Whisper large-v3, B=16
    b = SL_W_SEGMENTS
    t0 = time.perf_counter()
    model = Whisper.from_openai("large-v3", rng=SEED, device=dev)
    # as Whisper-base's, but the decoder's cross-attention at the init's scale: at 4x its 32 layers pin every
    # stream to one or two tokens (an H100 reading: 1-2 distinct of 32; 10-18 with it at 1x, fp32 fused = plain)
    _make_streams_move(dev, SEED + 3, model.params["decoder"], [model.params["encoder"]["layers"]])
    _scale_matrices(model.params["decoder"]["layers"], 4.0, blocks=("sa", "mlp"))
    gen = WhisperGenerator(model)
    c = model.cfg
    print(f"phase k7 slices whisper: Whisper large-v3 ({c.n_layers} + {c.n_layers} layers, d {c.d_model}, "
          f"{c.d_model // 64} heads, {c.n_mels} mels, vocab {c.vocab_size}) built from seed {SEED} on {dev} in "
          f"{time.perf_counter() - t0:.1f} s")
    seconds = _cycle(list(W_SECONDS), b)
    wav = torch.from_numpy(_waveforms(b, seconds, SEED + 35)).to(dev)
    n_init, w_max = len(W_INIT), len(W_INIT) + SL_W_NEW

    def w_ok(route, rows):
        for row in rows:
            if row[:n_init] != W_INIT or not n_init < len(row) <= w_max:
                raise AssertionError(f"k7 slices whisper B={b} ({route}): malformed row {row}")

    def w_gap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(gen.preprocessor(wav[i:i + 1]), torch.tensor([prefix], device=dev))[0, -1])

    _reset_launches()
    rows, note = _batch_run(f"k7 slices whisper fp32 B={b}", k7x, b,
                            lambda: gen.transcribe_tokens_batch(wav, W_INIT, W_EOT, w_max), w_ok,
                            lambda rows: _decode_steps([len(x) - n_init for x in rows], w_max - n_init - 1,
                                                       all(W_EOT in x[n_init:] for x in rows)),
                            w_gap, SL_SLICES["whisper"])
    distinct = _check_moving(f"k7 slices whisper B={b}", rows["fused"], [n_init] * b)
    print(f"phase k7 slices whisper fp32 transcribe_tokens_batch B={b} ({SL_W_NEW} new at most): {note}; distinct "
          f"new tokens per row {min(distinct)}-{max(distinct)}")
    model.to_bf16()
    times, toks = {}, {}
    for route in ("fused", "per-op", "per-op", "fused"):
        _route(route)
        ms, rows = _event_ms(lambda: gen.transcribe_tokens_batch(wav, W_INIT, W_EOT, w_max))
        times.setdefault(route, []).append(ms)
        toks[route] = sum(len(x) - n_init for x in rows)
    _route("fused")
    print(f"phase time bf16 k7 slices whisper large-v3 transcribe_tokens_batch B={b} ({sum(seconds):.1f} s of audio, "
          f"{SL_W_NEW} new at most; frontend and encoder included, CUDA events): "
          + ", ".join(f"{k} {b / (np.mean(v) / 1e3):.2f} segments/s, {sum(seconds) / (np.mean(v) / 1e3):.1f} "
                      f"audio-s/s, {toks[k] / (np.mean(v) / 1e3):.1f} generated tok/s ({np.mean(v):.1f} ms)"
                      for k, v in times.items()) + f" [{card}]")
    out["slices whisper"] = _launches({"fused_cross_decode_step", "log_mel_spectrogram", "encoder_attention"})
    del model, gen
    gc.collect()
    torch.cuda.empty_cache()  # large-v3's tens of GB cached: give the card back to the phases that spawn ranks
    return out


# the Whisper and T5 continuous-batching engines at full width: Whisper-base with a pool of CBW_POOL slots
# (bench.py's Whisper batch; the fp32 check again at CBW_POOL32, K7 cross at 17-32 rows), CBW_SEGMENTS segments
# of 5-30 s, at most N_NEW new tokens; T5-base with a pool of CBT_POOL slots (bench.py's T5 batch),
# CBT_REQUESTS prompts of CBT_PROMPT tokens, at most CBT_NEW new tokens; the int8 pools serve the first
# CBW_INT8 segments / CBT_INT8 prompts. Random weights never emit the real EOT / EOS: the stop id is a token the
# fp32 streams emit after CB_STOP_AFTER new tokens (_pick_stop), so that rows end at spread lengths and
# admissions happen while other rows decode
CBW_POOL, CBW_POOL32, CBW_SEGMENTS, CBW_INT8 = 16, 32, 40, 16
CBT_POOL, CBT_REQUESTS, CBT_PROMPT, CBT_NEW, CBT_INT8 = 32, 48, (5, 200), 64, 24
CB_STOP_AFTER = 8


def _pick_stop(rows: list, n_prompt: int) -> tuple[int, list]:
    """A stop id for rows generated with none: among the tokens the rows emit
    after CB_STOP_AFTER new tokens, the one whose first occurrences end the
    rows at the most distinct lengths (then the most frequent, then the
    lowest id). Returns it and each row's new-token count with it."""
    gens = [r[n_prompt:] for r in rows]
    counts: dict[int, int] = {}
    for g in gens:
        for t in g[CB_STOP_AFTER:]:
            counts[t] = counts.get(t, 0) + 1

    def ends(t):
        return [g.index(t) + 1 if t in g else len(g) for g in gens]

    stop = max(counts, key=lambda t: (len(set(ends(t))), counts[t], -t))
    return stop, ends(stop)


def _cut_at(rows: list, n_prompt: int, stop: int) -> list:
    """Each greedy row as its generator returns it with ``stop`` as the stop
    id: through the first ``stop`` among the new tokens (greedy decoding does
    not depend on the stop id before it)."""
    out = []
    for r in rows:
        g = r[n_prompt:]
        out.append(r[:n_prompt + g.index(stop) + 1] if stop in g else r)
    return out


def _record_admissions(cb, method: str, positions_of) -> list:
    """The pool position of every admission of engine ``cb``: its admission
    method ``method`` wrapped on the instance, ``positions_of(*args)`` the
    positions one call admits at."""
    seen = []
    orig = getattr(cb, method)

    def wrapped(*args):
        seen.extend(positions_of(*args))
        return orig(*args)

    setattr(cb, method, wrapped)
    return seen


def _mid_flight(what: str, positions: list, base: int, stats) -> str:
    """Raises unless some admission took a slot while the pool was past its
    epoch base (other rows decoding); the spread of admission positions."""
    mid = sum(p != base for p in positions)
    if mid == 0 or len(positions) != stats.admissions:
        raise AssertionError(f"{what}: {len(positions)} admissions, none mid-flight (positions {positions})")
    return (f"admissions at positions {min(positions)}-{max(positions)} (median {int(np.median(positions))}, "
            f"{len(set(positions))} distinct, {mid} of {len(positions)} past the epoch base {base}, "
            f"{stats.epoch_resets} epoch resets)")


def _pool_rates(what: str, run, n_units: int, unit: str, extra, card: str) -> None:
    """bf16 rates of the fused pool against the per-op pool (USE_FUSED_STEP
    False), in turns, from ServingStats (host clock over the scheduling loop,
    its last copy synchronizing): ``n_units`` ``unit``/s, ``extra(stats)`` more
    rates, generated tok/s and occupancy."""
    rates = {}
    for route in ("per-op", "fused", "fused", "per-op"):
        _route(route)
        st = run()
        rates.setdefault(route, []).append((n_units / st.wall_time_s, *extra(st), st.tokens_per_s, st.occupancy))
    _route("fused")
    print(f"phase time bf16 {what}, host clock over the scheduling loop: "
          + "; ".join(f"{k}: " + " | ".join(", ".join(f"{x:.2f}" for x in turn) for turn in v)
                      for k, v in rates.items())
          + f" ({unit}/s, " + "".join(f"{name}, " for name in extra(None)) + "generated tok/s, occupancy; per turn) "
          f"[{card}]")


def cb_whisper_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """``WhisperContinuousBatchingGenerator`` on Whisper-base at full width
    (scaled as the main path's): CBW_SEGMENTS segments of 5-30 s, at most
    N_NEW new tokens. fp32, pools of CBW_POOL and CBW_POOL32: every segment's
    tokens identical to ``WhisperGenerator.transcribe_tokens`` on the plain
    route up to near-ties, K7 cross launched once per decode step at the
    pool's batch, admissions mid-flight. The int8 pool (self + cross KV):
    every step's token held against the plain head on the kernel's own
    x_out. bf16: segments/s, audio-seconds/s, generated tok/s and occupancy
    of the fused pool against the per-op pool, in turns. Returns the
    launches."""
    import torch

    from pytorch_models_tpu_torch.audio2text import Whisper, WhisperContinuousBatchingGenerator, WhisperGenerator

    k7 = _kernels()["fused_cross_decode_step"]
    model = Whisper.from_openai("base", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 3, model.params["decoder"],
                       [model.params["encoder"]["layers"], model.params["decoder"]["layers"]])
    gen = WhisperGenerator(model)
    # the main path's eight waveforms of W_SECONDS (5-30 s), five times over with other noise
    seconds = list(W_SECONDS) * (CBW_SEGMENTS // len(W_SECONDS))
    segs = [w for k in range(CBW_SEGMENTS // len(W_SECONDS))
            for w in _waveforms(len(W_SECONDS), W_SECONDS, SEED + 41 + k)]
    n_init, w_max = len(W_INIT), len(W_INIT) + N_NEW

    _reset_launches()
    _route("plain")
    free = [gen.transcribe_tokens(a, W_INIT, -1, w_max) for a in segs]
    eot, ends = _pick_stop(free, n_init)
    ref = _cut_at(free, n_init, eot)
    # random Whisper-base repeats a token on some of these segments (1-2 distinct new tokens), so the set of
    # streams, not each row, must move: at least 3 distinct new tokens per segment on average
    distinct = [len(set(r[n_init:])) for r in free]
    if np.mean(distinct) < 3:
        raise AssertionError(f"cb whisper: the greedy streams barely move (distinct new tokens per row {distinct})")

    def gap_fn(i, prefix):
        _route("plain")
        with torch.inference_mode():
            mel = gen.preprocessor(torch.from_numpy(segs[i][None]).to(dev))
            return _top2(model(mel, torch.tensor([prefix], device=dev))[0, -1])

    for pool in (CBW_POOL, CBW_POOL32):
        what = f"cb whisper fp32 pool {pool}"
        cb = WhisperContinuousBatchingGenerator(model, batch_size=pool, check_every=CB_CHECK_EVERY)
        adm = _record_admissions(cb, "_admit_row", lambda pool_, row, pos, memory, init: [pos])
        _route("fused")
        before = k7.variant_launches[_bucket_key(pool)]
        got = cb.transcribe_tokens_many(segs, W_INIT, eot, w_max)
        torch.cuda.synchronize()
        st = cb.last_stats
        launched = k7.variant_launches[_bucket_key(pool)] - before
        if launched != st.decode_steps:
            raise AssertionError(f"{what}: K7 cross launched {launched} times at B={pool} for {st.decode_steps} "
                                 "decode steps")
        if any(row[:n_init] != W_INIT or not n_init < len(row) <= w_max for row in got):
            raise AssertionError(f"{what}: malformed row")
        partings = _check_routes(what, {"fused": got, "plain": ref}, gap_fn)
        _route("fused")
        print(f"phase {what}: WhisperContinuousBatchingGenerator, {CBW_SEGMENTS} segments of {min(seconds):.1f}-"
              f"{max(seconds):.1f} s, at most {N_NEW} new tokens, stop id {eot} (new tokens per segment "
              f"{min(ends)}-{max(ends)}, {len(set(ends))} distinct; distinct new tokens per segment without a stop "
              f"{min(distinct)}-{max(distinct)}, mean {np.mean(distinct):.1f}): every segment token-identical to "
              f"transcribe_tokens on the plain route (partings at near-ties: {partings}); K7 cross launched "
              f"{launched} times at B={pool} = {st.decode_steps} decode steps; "
              f"{_mid_flight(what, adm, n_init + 1, st)}; {st.scheduling_points} scheduling points, occupancy "
              f"{st.occupancy:.3f} [{card}]")

    # the int8 pool: int8 self- and cross-KV through K7's int8 units at B=16
    r8 = segs[:CBW_INT8]
    cb = WhisperContinuousBatchingGenerator(model, batch_size=CBW_POOL, check_every=CB_CHECK_EVERY)
    _int8_flags(kv=True, kv_cross=True)
    with _StepSpy(plain=True):
        twin = cb.transcribe_tokens_many(r8, W_INIT, eot, w_max)
    before = k7.variant_launches[f"kv_int8_{_bucket_key(CBW_POOL)}"]
    with _StepSpy(plain=False) as spy:
        got = cb.transcribe_tokens_many(r8, W_INIT, eot, w_max)
    torch.cuda.synchronize()
    st = cb.last_stats
    launched = k7.variant_launches[f"kv_int8_{_bucket_key(CBW_POOL)}"] - before
    _int8_flags()
    _route("fused")
    if launched != st.decode_steps or spy.steps != st.decode_steps:
        raise AssertionError(f"cb whisper int8 pool: K7 int8 launched {launched} times, {spy.steps} checked, for "
                             f"{st.decode_steps} decode steps")
    print(f"phase cb whisper int8 pool fp32 (USE_INT8_KV + USE_INT8_KV_CROSS): {len(r8)} segments, pool {CBW_POOL}: "
          f"every step's tokens = the plain head on the kernel's own x_out (max score regret {spy.regret:.3g}); "
          f"K7's int8 variant launched {launched} times at B={CBW_POOL} = {st.decode_steps} decode steps; rows against "
          f"the pool driving the twin (a reading): {_parting(got, twin)} [{card}]")

    # bf16: the fused pool against the per-op pool, in turns
    model.to_bf16()
    cb = WhisperContinuousBatchingGenerator(model, batch_size=CBW_POOL, check_every=CB_CHECK_EVERY)

    def run():
        cb.transcribe_tokens_many(segs, W_INIT, eot, w_max)
        return cb.last_stats

    _pool_rates(f"cb whisper: pool {CBW_POOL}, {CBW_SEGMENTS} segments ({sum(seconds):.1f} s of audio)", run,
                CBW_SEGMENTS, "segments",
                lambda st: ("audio-seconds/s",) if st is None else (sum(seconds) / st.wall_time_s,), card)
    if profile_dir is not None:
        for route in ("fused", "per-op"):
            _route(route)
            profile_phase(run, f"bf16 cb whisper pool {CBW_POOL}, {route} route", f"profile_bf16_cbw_{route}.json",
                          profile_dir, card, lambda st: st.decode_steps)
        _route("fused")
    return _launches({"fused_cross_decode_step", "encoder_attention", "log_mel_spectrogram", "embed_add"})


def cb_t5_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """``T5ContinuousBatchingGenerator`` on T5-base at full width (scaled as
    the main path's): CBT_REQUESTS prompts of 5-200 tokens, at most CBT_NEW
    new tokens, a pool of CBT_POOL. fp32: every request's tokens identical
    to ``T5Generator.generate_tokens`` on the plain route (each row of
    ``generate_tokens_batch`` over CBT_POOL prompts at a time) up to
    near-ties, K7-T5 (with per-row pads) launched once per decode step at
    B=32, admissions mid-flight. The int8 pool (self + cross KV): every
    step's token held against the plain head on the kernel's own x_out.
    bf16: generated tok/s and occupancy of the fused pool against the per-op
    pool, in turns. Returns the launches."""
    import torch

    from pytorch_models_tpu_torch.text import T5ContinuousBatchingGenerator, T5Generator, T5Model

    k7 = _kernels()["fused_cross_decode_step"]
    model = T5Model.from_t5x("flan_t5-base", rng=SEED, device=dev)
    _make_t5_streams_move(dev, SEED + 9, model.params)
    gen = T5Generator(model=model)
    r = np.random.default_rng(SEED + 97)
    prompts = [r.integers(2, model.cfg.vocab_size, int(r.integers(CBT_PROMPT[0], CBT_PROMPT[1] + 1))).tolist()
               for _ in range(CBT_REQUESTS)]
    t_max = CBT_NEW + 1  # rows hold the pad token first

    _reset_launches()
    _route("plain")
    free = []
    for i in range(0, len(prompts), CBT_POOL):
        free += gen.generate_tokens_batch(prompts[i:i + CBT_POOL], t_max, T5_PAD, -1)
    eos, ends = _pick_stop(free, 1)
    ref = _cut_at(free, 1, eos)
    _check_moving("cb t5", free, [1] * len(free))

    def gap_fn(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(torch.tensor([prompts[i]], device=dev), torch.tensor([prefix], device=dev))[0, -1])

    what = f"cb t5 fp32 pool {CBT_POOL}"
    cb = T5ContinuousBatchingGenerator(model, batch_size=CBT_POOL, check_every=CB_CHECK_EVERY)
    adm = _record_admissions(cb, "_admit", lambda pool, pos, admissions, *rest: [pos] * len(admissions))
    _route("fused")
    bucket = _bucket_key(CBT_POOL)
    before = k7.variant_launches[bucket]
    got = cb.generate_tokens_many(prompts, t_max, T5_PAD, eos)
    torch.cuda.synchronize()
    st = cb.last_stats
    launched = k7.variant_launches[bucket] - before
    if launched != st.decode_steps:
        raise AssertionError(f"{what}: K7-T5 launched {launched} times at B={CBT_POOL} for {st.decode_steps} steps")
    if any(row[0] != T5_PAD or not 1 < len(row) <= t_max for row in got):
        raise AssertionError(f"{what}: malformed row")
    partings = _check_routes(what, {"fused": got, "plain": ref}, gap_fn)
    _route("fused")
    print(f"phase {what}: T5ContinuousBatchingGenerator, {CBT_REQUESTS} prompts of {CBT_PROMPT[0]}-{CBT_PROMPT[1]} "
          f"tokens, at most {CBT_NEW} new tokens, stop id {eos} (new tokens per request {min(ends)}-{max(ends)}, "
          f"{len(set(ends))} distinct): every request token-identical to generate_tokens on the plain route "
          f"(partings at near-ties: {partings}); K7-T5 with per-row pads launched {launched} times at "
          f"B={CBT_POOL} = {st.decode_steps} decode steps; {_mid_flight(what, adm, 1, st)}; "
          f"{st.scheduling_points} scheduling points, occupancy {st.occupancy:.3f} [{card}]")

    # the int8 pool: int8 self- and cross-KV (with the self bias and per-row pads) through K7's int8 units at B=32
    r8 = prompts[:CBT_INT8]
    _int8_flags(kv=True, kv_cross=True)
    with _StepSpy(plain=True):
        twin = cb.generate_tokens_many(r8, t_max, T5_PAD, eos)
    before = k7.variant_launches[f"kv_int8_{bucket}"]
    with _StepSpy(plain=False) as spy:
        got = cb.generate_tokens_many(r8, t_max, T5_PAD, eos)
    torch.cuda.synchronize()
    st = cb.last_stats
    launched = k7.variant_launches[f"kv_int8_{bucket}"] - before
    _int8_flags()
    _route("fused")
    if launched != st.decode_steps or spy.steps != st.decode_steps:
        raise AssertionError(f"cb t5 int8 pool: K7 int8 launched {launched} times, {spy.steps} checked, for "
                             f"{st.decode_steps} decode steps")
    print(f"phase cb t5 int8 pool fp32 (USE_INT8_KV + USE_INT8_KV_CROSS): {len(r8)} prompts, pool {CBT_POOL}: every "
          f"step's tokens = the plain head on the kernel's own x_out (max score regret {spy.regret:.3g}); K7-T5's "
          f"int8 variant launched {launched} times at B={CBT_POOL} = {st.decode_steps} decode steps; rows against "
          f"the pool driving the twin (a reading): {_parting(got, twin)} [{card}]")

    # bf16: the fused pool against the per-op pool, in turns
    model.to_bf16()
    cb = T5ContinuousBatchingGenerator(model, batch_size=CBT_POOL, check_every=CB_CHECK_EVERY)

    def run():
        cb.generate_tokens_many(prompts, t_max, T5_PAD, eos)
        return cb.last_stats

    _pool_rates(f"cb t5: pool {CBT_POOL}, {CBT_REQUESTS} prompts", run, CBT_REQUESTS, "requests",
                lambda st: (), card)
    if profile_dir is not None:
        for route in ("fused", "per-op"):
            _route(route)
            profile_phase(run, f"bf16 cb t5 pool {CBT_POOL}, {route} route", f"profile_bf16_cbt5_{route}.json",
                          profile_dir, card, lambda st: st.decode_steps)
        _route("fused")
    return _launches({"fused_cross_decode_step", "embed_add"})


# speculative decoding (spec_paths): k drafts a verify chunk; new tokens of the one-row GPT-2 runs, of the B=8
# batch and of the sampled run (whose identity-draft check covers one iteration: k drafts and the bonus)
SPEC_K = 4
SPEC_NEW, SPEC_BATCH_NEW, SPEC_SAMPLE_NEW = 32, 32, 32
SPEC_B = 8


class _Clock:
    """While active, ``getattr(module, attr)`` is wrapped: each call whose
    inputs ``pick(*args)`` accepts is counted, and each is bracketed by CUDA
    events (device time between the call's first and last launch, idle gaps
    included). The speculative loops look their forwards up at call time."""

    def __init__(self, module, attr: str, pick=lambda *a: True):
        self.module, self.attr, self.pick, self.pairs, self.calls = module, attr, pick, [], 0

    def __enter__(self):
        import torch

        self._orig = fn = getattr(self.module, self.attr)

        def clocked(*args, **kw):
            if not self.pick(*args):
                return fn(*args, **kw)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.pairs.append((start, end))
            self.calls += 1
            return out

        setattr(self.module, self.attr, clocked)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self._orig)

    def mean_ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return float(np.mean([a.elapsed_time(b) for a, b in self.pairs])) if self.pairs else float("nan")


def _spec_clocks(kind: str, k: int, batched: bool = False) -> tuple:
    """(verify-chunk clock, draft-step clock) of one model's speculative
    loop: the (k+1)-token per-op forward, and the draft's step (one-row:
    the fused step; GPT-2's batch: the per-op one-token forward)."""
    from pytorch_models_tpu_torch.models.audio2text import whisper as whisper_mod
    from pytorch_models_tpu_torch.models.text import speculative as spec_mod
    from pytorch_models_tpu_torch.models.text import t5 as t5_mod

    def width(i, s):  # calls whose token chunk, argument i, is s tokens wide
        return lambda *a: a[i].shape[1] == s

    if kind == "gpt2":
        draft = _Clock(spec_mod, "decoder_lm_hidden_cached_batch", width(2, 1)) if batched else \
            _Clock(spec_mod, "decoder_lm_fused_tok_batch")
        return _Clock(spec_mod, "decoder_lm_forward_cached_batch", width(2, k + 1)), draft
    if kind == "whisper":
        return _Clock(whisper_mod, "_decoder_logits_chunk", width(3, k + 1)), _Clock(whisper_mod, "_fused_whisper_step")
    return _Clock(t5_mod, "_t5_spec_chunk_forward", width(3, k + 1)), _Clock(t5_mod, "_fused_t5_step")


def _spec_run(what: str, kind: str, gen, run, k7_key: str, extra_steps: int = 0) -> tuple[list, dict]:
    """One fp32 one-row speculative call ``run(gen)`` on the fused route,
    its K7 launches held to the draft steps (k per iteration, + the pad
    token's for T5) and its verify chunks to ``gen.last_iters``. Returns
    ``(tokens, {k7_key: launches})``."""
    from pytorch_models_tpu_torch.ops.decode_step import fused_cross_decode_step, fused_decode_step

    k7 = fused_decode_step if kind == "gpt2" else fused_cross_decode_step
    before = k7.launches
    verify, _ = _spec_clocks(kind, gen.k)
    with verify:
        out = run(gen)
    launches = k7.launches - before
    steps = gen.k * gen.last_iters + extra_steps
    if launches != steps or verify.calls != gen.last_iters:
        raise AssertionError(f"{what}: K7 launched {launches} times for {steps} draft steps, {verify.calls} verify "
                             f"chunks for {gen.last_iters} iterations")
    print(f"phase {what}: {len(out)} tokens, {gen.last_iters} iterations = verify chunks, K7 at B=1 launched "
          f"{launches} times = draft steps, measured acceptance {gen.last_accept_rate:.4f}")
    return out, {k7_key: launches}


def _spec_rates(what: str, plain_fn, spec_fn, n_tok_of, spec_gen, kind: str, card: str, batched: bool = False) -> None:
    """bf16 tok/s of plain fused decoding and of speculative decoding, in
    turns (plain, spec, spec, plain) after a warm-up call of each, then one
    clocked speculative call: device ms per verify chunk and per draft
    step. Target and draft must both hold bf16 weights."""
    import torch

    from pytorch_models_tpu_torch.utils import tree_map

    for name, m in (("target", spec_gen.model), ("draft", spec_gen.draft_model)):
        dtypes = set()
        tree_map(lambda t: dtypes.add(t.dtype) if t.is_floating_point() else None, m.params)
        if dtypes != {torch.bfloat16}:
            raise AssertionError(f"time bf16 spec {what}: the {name}'s floating weights are {sorted(map(str, dtypes))}")
    plain_fn(), spec_fn()
    times, toks = {}, {}
    for name in ("plain", "spec", "spec", "plain"):
        ms, out = _event_ms(plain_fn if name == "plain" else spec_fn)
        times.setdefault(name, []).append(ms)
        toks[name] = n_tok_of(out)
    verify, draft = _spec_clocks(kind, spec_gen.k, batched)
    with verify, draft:
        spec_fn()
    rate = {n: toks[n] / (np.mean(t) / 1e3) for n, t in times.items()}
    it = "" if batched else f"{spec_gen.last_iters} iterations, acceptance {spec_gen.last_accept_rate:.4f}; "
    print(f"phase time bf16 spec {what} (CUDA events, prefill included): plain fused {rate['plain']:.1f} tok/s "
          f"({np.mean(times['plain']):.1f} ms), speculative k={spec_gen.k} {rate['spec']:.1f} tok/s "
          f"({np.mean(times['spec']):.1f} ms) = {rate['spec'] / rate['plain']:.3f}x; {it}verify chunk "
          f"{verify.mean_ms():.3f} ms ({verify.calls}), draft step {draft.mean_ms():.3f} ms ({draft.calls}) [{card}]")


def spec_paths(dev, card: str, profile_dir: str | None = None) -> dict:
    """Speculative decoding at full width (the rescaled weights of phases
    "main", "whisper fp32" and "t5 fp32"), k = SPEC_K, a draft of the
    target's first SPEC_DRAFT_LAYERS layers and the identical draft:
    fp32 one-row tokens identical to the plain route's (every flag False) up
    to near-ties, K7 at B=1 launched once per draft step, one verify chunk
    per iteration, the acceptance printed; GPT-2's B=8 batch (per-op drafts
    at per-row positions) row by row against the one-row path; sampling
    (top-k 40, top-p 0.9, T 0.8) with the identical draft, whose first
    iteration must be the positional plain sampler's draws and every token
    in the plain top-40; then bf16 tok/s of speculative against plain fused
    decoding in turns. Returns each phase's launches, with the one-row K7
    launches by draft depth (``..._b1`` the whole stack, ``..._b1_l2`` the
    truncated draft)."""
    import torch

    from pytorch_models_tpu_torch.audio2text import SpeculativeWhisperGenerator, Whisper, WhisperGenerator
    from pytorch_models_tpu_torch.models.text import speculative as spec_mod
    from pytorch_models_tpu_torch.models.text._decoder_lm import decoder_lm_apply
    from pytorch_models_tpu_torch.ops.decode_step import fused_decode_step
    from pytorch_models_tpu_torch.text import (
        GPT2,
        DecoderGenerator,
        SpeculativeDecoderGenerator,
        SpeculativeT5Generator,
        T5Generator,
        T5Model,
    )

    kernels = _kernels()
    res, k, dl = {}, SPEC_K, SPEC_DRAFT_LAYERS
    l2 = f"_l{dl}"

    # ---- GPT-2 small: main's prompts and weights
    r = np.random.default_rng(SEED)
    prompts = [r.integers(0, 50257, n).tolist() for n in PROMPT_LENS]
    model = GPT2.from_hf("gpt2", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 7, model.params, [model.params["decoder"]["layers"]])
    plain = DecoderGenerator(model, _Tok())
    drafts = {"truncated": SpeculativeDecoderGenerator.with_truncated_draft(model, _Tok(), dl, k=k),
              "identical": SpeculativeDecoderGenerator(model, model, _Tok(), k=k)}

    def gap_fn(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(torch.tensor(prefix))[-1])

    prompt = prompts[3]
    _route("plain")
    outs = {"plain": [plain.generate_tokens(prompt, SPEC_NEW)]}
    _reset_launches()
    _route("fused")
    counts = {}
    for name, gen in drafts.items():
        out, c = _spec_run(f"spec gpt2 fp32 {name} draft", "gpt2", gen, lambda g: g.generate_tokens(prompt, SPEC_NEW),
                           "fused_decode_step_b1" + (l2 if name == "truncated" else ""))
        outs[f"spec {name}"] = [out]
        counts.update(c)
    partings = _check_routes("spec gpt2 fp32", outs, lambda i, prefix: gap_fn(0, prefix))
    _check_moving("spec gpt2 fp32", outs["spec truncated"], [len(prompt)])
    res["spec gpt2"] = _launches({"embed_add", "fused_decode_step"}) | counts
    one_key = "fused_decode_step_b1" + l2
    print(f"phase spec gpt2 fp32: GPT-2 small, a {len(prompt)}-token prompt, {SPEC_NEW} new, k={k}: drafts of "
          f"{dl} layers and of 12 token-identical to the plain route (partings at near-ties: {partings})")

    # the B=8 batch: per-op drafts at per-row positions (K2 with per-row ends), against the one-row path
    _route("plain")
    ref_rows = plain.generate_tokens_batch(prompts, SPEC_BATCH_NEW)
    _route("fused")
    gen = drafts["truncated"]
    one_row, one_k7 = [], 0
    for p in prompts:
        out, c = _spec_run(f"spec gpt2 fp32 one-row {len(p)}-token prompt", "gpt2", gen,
                           lambda g, p=p: g.generate_tokens(p, SPEC_BATCH_NEW), one_key)
        one_row.append(out)
        one_k7 += c[one_key]
    _reset_launches()
    batch_rows = gen.generate_tokens_batch(prompts, SPEC_BATCH_NEW)
    torch.cuda.synchronize()
    res["spec gpt2 batch"] = _launches({"embed_add", "decode_attention"})
    if res["spec gpt2 batch"]["fused_decode_step"]:
        raise AssertionError("spec gpt2 batch: K7 launched (it takes one position for all rows)")
    res["spec gpt2 batch"][one_key] = one_k7  # the one-row runs it is held against
    partings = _check_routes("spec gpt2 fp32 B=8", {"plain": ref_rows, "spec one-row": one_row,
                                                    "spec batch": batch_rows},
                             lambda i, prefix: gap_fn(i, prefix))
    if any(len(a) != len(b) for a, b in zip(one_row, batch_rows)):
        raise AssertionError("spec gpt2 batch: a row's length differs from its one-row run")
    print(f"phase spec gpt2 fp32 B={SPEC_B}: {SPEC_BATCH_NEW} new tokens a row, the batch (per-op drafts at per-row "
          f"positions: K7 0 launches, K2 {res['spec gpt2 batch']['decode_attention']}) token-identical to the "
          f"one-row runs and the plain route (partings at near-ties: {partings})")

    # sampling, identical draft: its first iteration (k drafts and the bonus) is the positional plain sampler's
    # draws on the draft stream; a 32-token run stays in the plain top-40
    gen = drafts["identical"]
    _reset_launches()
    notes = []
    headless0 = kernels["fused_decode_step"].variant_launches["headless"]
    verify, _ = _spec_clocks("gpt2", k)
    with verify:
        firsts = [gen.generate_tokens(p, k + 1, **SAMPLE) for p in prompts]
        long = gen.generate_tokens(prompts[3], SPEC_SAMPLE_NEW, **SAMPLE)
    headless = kernels["fused_decode_step"].variant_launches["headless"] - headless0
    if headless != k * verify.calls:
        raise AssertionError(f"spec gpt2 sample: K7 headless launched {headless} times for {k * verify.calls} "
                             f"draft steps")
    rows1 = torch.zeros(1, dtype=torch.int64, device=dev)
    _route("plain")
    with torch.inference_mode():
        for p, row in zip(prompts, firsts):
            for t in range(len(p), len(row)):
                logits = model(torch.tensor(row[:t]))[-1]
                probs = spec_mod._filtered_probs(logits[None], SAMPLE["topk"], SAMPLE["top_p"],
                                                 SAMPLE["temperature"])[0]
                u = spec_mod._stream_uniforms(SAMPLE["seed"], spec_mod.DRAFT, rows1,
                                              torch.tensor([[t]], device=dev))[0, 0]
                want = int(spec_mod._sample_probs(probs, u))
                if want != row[t]:  # only where the draw lies on a CDF boundary the routes' logits can move
                    cdf = torch.cumsum(probs, -1)
                    margin = (cdf - u * cdf[-1]).abs().min().item()
                    bound = 2 * (GAP_TOL[0] + GAP_TOL[1] * logits.abs().max().item()) / SAMPLE["temperature"]
                    note = (f"prompt of {len(p)} parts at new token {t - len(p)}: margin {margin:.3g} "
                            f"(bound {bound:.3g})")
                    print(f"phase spec gpt2 sample: {note}")
                    if margin > bound:
                        raise AssertionError(f"spec gpt2 sample: {note}")
                    notes.append(note)
                    break
        top40 = [int(long[t] in model(torch.tensor(long[:t]))[-1].topk(SAMPLE["topk"]).indices.tolist())
                 for t in range(len(prompts[3]), len(long))]
    _route("fused")
    if not all(top40) or len(long) != len(prompts[3]) + SPEC_SAMPLE_NEW:
        raise AssertionError(f"spec gpt2 sample: tokens outside the plain top-{SAMPLE['topk']}: {top40}")
    res["spec gpt2 sample"] = _launches({"embed_add", "fused_decode_step"}) | {"fused_decode_step_headless_b1":
                                                                               headless}
    print(f"phase spec gpt2 sample fp32 (top-k {SAMPLE['topk']}, top-p {SAMPLE['top_p']}, T {SAMPLE['temperature']}, "
          f"identical draft): {len(prompts)} prompts' first iteration ({k + 1} tokens) equal to the positional plain "
          f"sampler (partings at CDF boundaries: {'; '.join(notes) or 'none'}); {SPEC_SAMPLE_NEW} new tokens of the "
          f"{len(prompts[3])}-token prompt all in the plain top-{SAMPLE['topk']}; K7 headless at B=1 {headless} "
          f"launches = {k} x {verify.calls} verify chunks")

    model.to_bf16()
    _route("fused")
    gen = drafts["truncated"]
    _spec_rates("gpt2 B=1", lambda: plain.generate_tokens(prompt, SPEC_NEW),
                lambda: gen.generate_tokens(prompt, SPEC_NEW), lambda out: len(out) - len(prompt), gen, "gpt2", card)
    _spec_rates(f"gpt2 B={SPEC_B}", lambda: plain.generate_tokens_batch(prompts, SPEC_BATCH_NEW),
                lambda: gen.generate_tokens_batch(prompts, SPEC_BATCH_NEW),
                lambda out: sum(len(o) - len(p) for o, p in zip(out, prompts)), gen, "gpt2", card, batched=True)
    if profile_dir is not None:
        profile_phase(lambda: gen.generate_tokens(prompt, SPEC_NEW), f"bf16 speculative generate_tokens k={k}, "
                      f"{dl}-layer draft", "profile_bf16_spec_gpt2.json", profile_dir, card, lambda out: gen.last_iters,
                      unit="iteration")
    del model, plain, drafts, gen

    # ---- Whisper-base: whisper fp32's weights, one segment
    model = Whisper.from_openai("base", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 3, model.params["decoder"],
                       [model.params["encoder"]["layers"], model.params["decoder"]["layers"]])
    wplain = WhisperGenerator(model)
    audio = _waveforms(8, W_SECONDS, SEED + 4)[1]
    max_tokens = len(W_INIT) + N_NEW
    wdrafts = {"truncated": SpeculativeWhisperGenerator.with_truncated_draft(model, None, dl, k=k),
               "identical": SpeculativeWhisperGenerator(model, model, k=k)}
    _route("plain")
    outs = {"plain": [wplain.transcribe_tokens(audio, W_INIT, W_EOT, max_tokens)]}
    _reset_launches()
    _route("fused")
    counts = {}
    for name, gen in wdrafts.items():
        out, c = _spec_run(f"spec whisper fp32 {name} draft", "whisper", gen,
                           lambda g: g.transcribe_tokens(audio, W_INIT, W_EOT, max_tokens),
                           "fused_cross_decode_step_b1" + (l2 if name == "truncated" else ""))
        outs[f"spec {name}"] = [out]
        counts.update(c)

    def wgap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            wav = torch.from_numpy(audio[None]).to(dev)
            return _top2(model(wplain.preprocessor(wav), torch.tensor([prefix], device=dev))[0, -1])

    partings = _check_routes("spec whisper fp32", outs, wgap)
    res["spec whisper"] = _launches({"log_mel_spectrogram", "encoder_attention", "embed_add",
                                     "fused_cross_decode_step"}) | counts
    print(f"phase spec whisper fp32: Whisper-base, one {W_SECONDS[1]} s segment, {len(outs['plain'][0]) - len(W_INIT)} "
          f"generated (at most {N_NEW}), k={k}: drafts of {dl} layers and of 8 (both encoders run on the segment) "
          f"token-identical to the plain route (partings at near-ties: {partings})")
    model.to_bf16()
    _route("fused")
    gen = wdrafts["truncated"]
    _spec_rates("whisper B=1", lambda: wplain.transcribe_tokens(audio, W_INIT, W_EOT, max_tokens),
                lambda: gen.transcribe_tokens(audio, W_INIT, W_EOT, max_tokens), lambda out: len(out) - len(W_INIT),
                gen, "whisper", card)
    del model, wplain, wdrafts, gen

    # ---- T5-base: t5 fp32's weights and prompts
    model = T5Model.from_t5x("flan_t5-base", rng=SEED, device=dev)
    _make_t5_streams_move(dev, SEED + 9, model.params)
    tplain = T5Generator(model=model)
    r = np.random.default_rng(SEED + 10)
    tprompt = [r.integers(2, model.cfg.vocab_size, n).tolist() for n in T5_PROMPT_LENS][3]
    tdrafts = {"truncated": SpeculativeT5Generator.with_truncated_draft(model, None, dl, k=k),
               "identical": SpeculativeT5Generator(model, model, k=k)}
    _route("plain")
    outs = {"plain": [tplain.generate_tokens(tprompt, T5_MAX, T5_PAD, T5_EOS)]}
    _reset_launches()
    _route("fused")
    counts = {}
    for name, gen in tdrafts.items():
        out, c = _spec_run(f"spec t5 fp32 {name} draft", "t5", gen,
                           lambda g: g.generate_tokens(tprompt, T5_MAX, T5_PAD, T5_EOS),
                           "fused_cross_decode_step_t5_b1" + (l2 if name == "truncated" else ""), extra_steps=1)
        outs[f"spec {name}"] = [out]
        counts.update(c)

    def tgap(i, prefix):
        _route("plain")
        return _top2(model(torch.tensor([tprompt], device=dev), torch.tensor([prefix], device=dev))[0, -1])

    partings = _check_routes("spec t5 fp32", outs, tgap)
    res["spec t5"] = _launches({"embed_add", "gather_rows", "fused_cross_decode_step"}) | counts
    print(f"phase spec t5 fp32: T5-base, a {len(tprompt)}-token prompt, rows of {T5_MAX} at most, k={k}: drafts of "
          f"{dl} layers and of 12 (K7-T5 at B=1, the pad token's step included) token-identical to the plain route "
          f"(partings at near-ties: {partings})")
    model.to_bf16()
    _route("fused")
    gen = tdrafts["truncated"]
    _spec_rates("t5 B=1", lambda: tplain.generate_tokens(tprompt, T5_MAX, T5_PAD, T5_EOS),
                lambda: gen.generate_tokens(tprompt, T5_MAX, T5_PAD, T5_EOS), lambda out: len(out) - 1, gen, "t5",
                card)
    _route("fused")
    return res


# tensor- and data-parallel serving (tp_path): TP_RANKS ranks on the one card, their all-reduces through host memory
# (gloo: NCCL refuses two ranks on one device; each all-reduce a device sync, ≈ 2 ms with two processes' contexts on
# an NVIDIA H100 80GB HBM3 at 700 W, so the pool's and the rate turns' work is kept small); the TP continuous-batching
# pool's slots, requests, prompt and budget ranges; new tokens of the speculative row and of the bf16 rate turns; the
# ranks' deadline, model builds included
TP_RANKS = 2
TP_CB_POOL, TP_CB_REQUESTS, TP_CB_PROMPT, TP_CB_BUDGET = 16, 12, (5, 64), (8, 32)
TP_W_SEGMENTS = 4
# new tokens at most of GPT-2's rows (fewer than N_NEW: the script's time limit), T5's rows, Whisper's transcripts
# and the speculative row
TP_NEW, TP_RATE_NEW = 32, 16
TP_JOIN_S = 300


def _gpt2_moving(dev):
    """GPT-2 small at full width from the main path's seed, rescaled so
    greedy streams move (fp32)."""
    from pytorch_models_tpu_torch.text import GPT2

    gpt2 = GPT2.from_hf("gpt2", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 7, gpt2.params, [gpt2.params["decoder"]["layers"]])
    return gpt2


def _tp_models(dev):
    """The TP phase's models at full width, from the main paths' seeds and
    scales (fp32): GPT-2 small, T5-base and Whisper-base."""
    from pytorch_models_tpu_torch.audio2text import Whisper
    from pytorch_models_tpu_torch.text import T5Model

    gpt2 = _gpt2_moving(dev)
    t5 = T5Model.from_t5x("flan_t5-base", rng=SEED, device=dev)
    _make_t5_streams_move(dev, SEED + 9, t5.params)
    whisper = Whisper.from_openai("base", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 3, whisper.params["decoder"],
                       [whisper.params["encoder"]["layers"], whisper.params["decoder"]["layers"]])
    return gpt2, t5, whisper


def _tp_inputs(t5_vocab: int) -> dict:
    """The main paths' GPT-2 prompts (B=8), T5 prompts and the first
    TP_W_SEGMENTS Whisper waveforms; the pool's requests and budgets."""
    r = np.random.default_rng(SEED)
    rt = np.random.default_rng(SEED + 10)
    rc = np.random.default_rng(SEED + 97)
    reqs = [rc.integers(0, 50257, int(rc.integers(TP_CB_PROMPT[0], TP_CB_PROMPT[1] + 1))).tolist()
            for _ in range(TP_CB_REQUESTS)]
    return {"prompts": [r.integers(0, 50257, n).tolist() for n in PROMPT_LENS],
            "t5_prompts": [rt.integers(2, t5_vocab, n).tolist() for n in T5_PROMPT_LENS],
            "audio": _waveforms(TP_W_SEGMENTS, W_SECONDS[:TP_W_SEGMENTS], SEED + 4),
            "reqs": reqs,
            "budgets": [int(m) for m in rc.integers(TP_CB_BUDGET[0], TP_CB_BUDGET[1] + 1, TP_CB_REQUESTS)]}


def _rank_entry(rank: int, world: int, init_file: str, work: str, out, args: tuple = ()) -> None:
    """One rank of a multi-rank phase, a spawned process on the card: joins
    the gloo group of ``world`` ranks, runs this module's ``work(rank, dev,
    *args)`` and puts its result (or its traceback) on ``out``."""
    import os
    import traceback

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks meet on the loopback device
    try:
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
        out.put((rank, "ok", globals()[work](rank, dev, *args)))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def _spawn_ranks(world: int, work: str, init_file: str, out, args: tuple = ()) -> list:
    import torch.multiprocessing as mp

    procs = [mp.get_context("spawn").Process(target=_rank_entry, args=(r, world, init_file, work, out, args),
                                             daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join_ranks(what: str, procs: list, out, t1: float, limit_s: float) -> dict:
    """Every rank's result, by rank; raises if a rank raised, died or is not
    done ``limit_s`` seconds after ``t1`` (the caller stops the processes)."""
    import queue

    got: dict = {}
    while len(got) < len(procs):
        left = t1 + limit_s - time.perf_counter()
        if left <= 0:
            raise AssertionError(f"{what}: ranks {sorted(set(range(len(procs))) - set(got))} hung past {limit_s} s")
        try:
            rank, status, value = out.get(timeout=min(left, 1.0))
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
            if dead:
                raise AssertionError(f"{what}: rank {dead[0]} died with exit code {procs[dead[0]].exitcode}")
            continue
        if status != "ok":
            raise AssertionError(f"{what}: rank {rank} raised:\n{value}")
        got[rank] = value
    for p in procs:
        p.join(max(t1 + limit_s - time.perf_counter(), 1.0))
        if p.exitcode != 0:
            raise AssertionError(f"{what}: a rank exited with code {p.exitcode}")
    return got


def _stop(procs: list) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)


def _tp_rank_work(rank: int, dev) -> dict:
    """The rank's share of the TP main path, counts from 0 just before it:
    GPT-2 at tp=2 and at dp=2 x tp=1, T5 and Whisper at tp=2, the GPT-2 pool
    at tp=2 with its full-precision and its int8 pool, speculative decoding
    at tp=2 (fp32, per-op: the fused step is never a tp path); then bf16
    GPT-2 tok/s at tp=2 and on rank 0 alone (per-op), in turns, B=8 x
    TP_RATE_NEW new."""
    import torch
    import torch.distributed as dist

    from pytorch_models_tpu_torch.models.text.speculative import TruncatedDraft
    from pytorch_models_tpu_torch.ops import _build
    from pytorch_models_tpu_torch.ops.int8_kv import int8_decode_attention
    from pytorch_models_tpu_torch.parallel import (
        TPContinuousBatchingGenerator,
        TPDecoderGenerator,
        TPSpeculativeGenerator,
        TPT5Generator,
        TPWhisperGenerator,
        make_mesh,
    )
    from pytorch_models_tpu_torch.text import DecoderGenerator

    t0 = time.perf_counter()
    _build.load_library()  # the parent's build, loaded from build/kernels/
    gpt2, t5, whisper = _tp_models(dev)
    inp = _tp_inputs(t5.cfg.vocab_size)
    tp_mesh = make_mesh(TP_RANKS, shape=(1, TP_RANKS), axes=("dp", "tp"), device=dev)
    dp_mesh = make_mesh(TP_RANKS, shape=(TP_RANKS, 1), axes=("dp", "tp"), device=dev)
    pool_mesh = make_mesh(TP_RANKS, shape=(TP_RANKS,), axes=("tp",), device=dev)
    gen = TPDecoderGenerator(gpt2, _Tok(), tp_mesh)
    gen_dp = TPDecoderGenerator(gpt2, _Tok(), dp_mesh)
    gen_t5 = TPT5Generator(t5, None, tp_mesh)
    gen_w = TPWhisperGenerator(whisper, tp_mesh)
    cb = TPContinuousBatchingGenerator(gpt2, _Tok(), pool_mesh, batch_size=TP_CB_POOL, prompt_bucket=CB_BUCKET,
                                       check_every=CB_CHECK_EVERY)
    spec = TPSpeculativeGenerator(gpt2, TruncatedDraft(gpt2, SPEC_DRAFT_LAYERS), _Tok(), pool_mesh, k=SPEC_K)
    res = {"build_s": time.perf_counter() - t0}

    _route("per-op")
    _reset_launches()
    int8_decode_attention.cur_ks_launches = 0
    t1 = time.perf_counter()
    res["gpt2"] = gen.generate_tokens_batch(inp["prompts"], max_tokens=TP_NEW)
    res["gpt2 dp=2"] = gen_dp.generate_tokens_batch(inp["prompts"], max_tokens=TP_NEW)
    res["t5"] = gen_t5.generate_tokens_batch(inp["t5_prompts"], TP_NEW + 1, T5_PAD, T5_EOS)
    res["whisper"] = gen_w.transcribe_tokens_batch(inp["audio"], W_INIT, W_EOT, len(W_INIT) + TP_NEW)
    res["cb"] = cb.generate_tokens_many(inp["reqs"], inp["budgets"])
    _int8_flags(kv=True, fused=False)
    res["int8 pool served"] = cb._use_int8_pool(cb._params_cfg()[1], TP_CB_POOL, False)
    res["cb int8"] = cb.generate_tokens_many(inp["reqs"], inp["budgets"])
    _int8_flags()
    _route("per-op")
    res["spec"] = spec.generate_tokens(inp["prompts"][0], TP_NEW)
    torch.cuda.synchronize()
    res["run_s"] = time.perf_counter() - t1
    res["launches"] = dict(_launches(set()), int8_decode_attention_tp_scale=int8_decode_attention.cur_ks_launches)

    # bf16 GPT-2 rates: tp=2 (both ranks) and one rank alone (rank 0, the other waiting), in turns
    gpt2.to_bf16()
    gen16 = TPDecoderGenerator(gpt2, _Tok(), tp_mesh)
    single = DecoderGenerator(gpt2, _Tok())

    def timed(run) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def tp_once() -> float:
        dist.barrier()
        return timed(lambda: gen16.generate_tokens_batch(inp["prompts"], max_tokens=TP_RATE_NEW))

    def single_once() -> float | None:
        s = timed(lambda: single.generate_tokens_batch(inp["prompts"], max_tokens=TP_RATE_NEW)) if rank == 0 else None
        dist.barrier()
        return s

    tp_once(), single_once()  # warm-up
    times = {"tp=2": [], "one rank": []}
    for kind in ("tp=2", "one rank", "one rank", "tp=2"):
        times[kind].append(tp_once() if kind == "tp=2" else single_once())
    res["bf16_s"] = times
    return res


def tp_path(dev, card: str) -> dict:
    """Tensor- and data-parallel serving (``parallel/``) through its entry
    points at full width: TP_RANKS ranks spawned on the one card, the gloo
    group's all-reduces staged through host memory (every kernel and matmul
    stays on the card). Each rank runs ``_tp_rank_work``; its fp32 tokens
    must equal the single-device per-op route's (computed here while the
    ranks start) up to printed near-ties, and every rank's the others'; K7
    launched 0 times, K1-K5 and K6 with the full-width scale (``cur_ks``, on
    the int8 pool) more than 0 on every rank. The int8 pool's rows against
    the single-device per-op int8 pool are a reading, printed beside the
    single device's own fused (K7) int8 pool against that per-op pool: int8
    levels turn fp32 summation-order differences into parted streams.
    Returns the ranks' summed launches."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from pytorch_models_tpu_torch.audio2text import WhisperGenerator
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.text import ContinuousBatchingGenerator, DecoderGenerator, T5Generator

    out = mp.get_context("spawn").Queue()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = _spawn_ranks(TP_RANKS, "_tp_rank_work", os.path.join(tmp, "init"), out)
        try:
            # the single-device references, fp32 per-op, while the ranks start and build their models
            gpt2, t5, whisper = _tp_models(dev)
            inp = _tp_inputs(t5.cfg.vocab_size)
            prompts, reqs, budgets = inp["prompts"], inp["reqs"], inp["budgets"]
            _route("per-op")
            gen = DecoderGenerator(gpt2, _Tok())
            wgen = WhisperGenerator(whisper)
            ref = {"gpt2": gen.generate_tokens_batch(prompts, max_tokens=TP_NEW)}
            ref["gpt2 dp=2"] = ref["gpt2"]
            ref["t5"] = T5Generator(model=t5).generate_tokens_batch(inp["t5_prompts"], TP_NEW + 1, T5_PAD, T5_EOS)
            wav = torch.from_numpy(inp["audio"]).to(dev)
            ref["whisper"] = wgen.transcribe_tokens_batch(wav, W_INIT, W_EOT, len(W_INIT) + TP_NEW)
            cb = ContinuousBatchingGenerator(gpt2, _Tok(), batch_size=TP_CB_POOL, prompt_bucket=CB_BUCKET,
                                             check_every=CB_CHECK_EVERY)
            ref["cb"] = cb.generate_tokens_many(reqs, budgets)
            _int8_flags(kv=True)
            k7_int8 = cb.generate_tokens_many(reqs, budgets)  # the single device's own int8 pool: fused, K7
            # the per-op int8 pool on one device (each key's scale its own full row's): the tp pool's numerics at tp=1
            cb._use_int8_pool = lambda cfg, b, fused: attn.use_int8_kv(b)
            _int8_flags(kv=True, fused=False)
            ref["cb int8"] = cb.generate_tokens_many(reqs, budgets)
            _int8_flags()
            _route("per-op")
            ref["spec"] = [gen.generate_tokens(prompts[0], max_tokens=TP_NEW)]
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t1
            got = _join_ranks("tp", procs, out, t1, TP_JOIN_S)
        finally:
            _stop(procs)
    ranks_s = time.perf_counter() - t1

    def gpt2_gap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(gpt2(torch.tensor(prefix, device=dev))[-1])

    def t5_gap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            enc = torch.tensor([inp["t5_prompts"][i]], device=dev)
            return _top2(t5(enc, torch.tensor([prefix], device=dev))[0, -1])

    def w_gap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(whisper(wgen.preprocessor(wav[i:i + 1]), torch.tensor([prefix], device=dev))[0, -1])

    r0 = got[0]
    notes = []
    for name in ("gpt2", "gpt2 dp=2", "t5", "whisper", "cb", "cb int8", "spec"):
        rows = [r0[name]] if name == "spec" else r0[name]
        for rank in range(1, TP_RANKS):
            if got[rank][name] != r0[name]:
                raise AssertionError(f"tp {name}: rank {rank}'s tokens part from rank 0's")
        if name == "cb int8":
            continue
        gap = {"t5": t5_gap, "whisper": w_gap}.get(name, gpt2_gap)
        partings = _check_routes(f"tp {name}", {"single device": ref[name], "tp": rows}, gap, "single device")
        notes.append(f"{name}: {partings}")
    if not r0["int8 pool served"]:
        raise AssertionError("tp: the pool did not serve int8 (its width gate)")
    for rows, n in ((r0["cb"], reqs), (r0["cb int8"], reqs)):
        if any(len(row) != len(q) + m or row[:len(q)] != q for row, q, m in zip(rows, n, budgets)):
            raise AssertionError("tp pool: malformed row")
    for rank, res in got.items():
        c = res["launches"]
        k7 = c["fused_decode_step"] + c["fused_cross_decode_step"]
        missing = [k for k in ("encoder_attention", "decode_attention", "embed_add", "greedy_argmax_tied",
                               "log_mel_spectrogram", "int8_decode_attention_tp_scale") if c[k] <= 0]
        if k7 or missing:
            raise AssertionError(f"tp rank {rank}: K7 launched {k7} times (0 wanted); never launched: {missing}")
    summed = {k: sum(res["launches"][k] for res in got.values()) for k in r0["launches"]}
    print(f"phase tp fp32: {TP_RANKS} ranks on one card ({card}), gloo, all-reduces through host memory; GPT-2 "
          f"small B={len(prompts)} x {TP_NEW} new at tp=2 and at dp=2 x tp=1, T5-base B={len(inp['t5_prompts'])} and "
          f"Whisper-base B={TP_W_SEGMENTS} x {TP_NEW} new at most at tp=2, the GPT-2 pool of {TP_CB_POOL} slots at "
          f"tp=2 ({TP_CB_REQUESTS} requests, full precision and int8), speculative GPT-2 at tp=2 (k={SPEC_K}, a "
          f"{SPEC_DRAFT_LAYERS}-layer draft, one row, {TP_NEW} new): every rank's tokens equal, and the single "
          f"device's per-op route's up to near-ties ({'; '.join(notes)}); the int8 pool's rows against the single "
          f"device's per-op int8 pool (a reading): {_parting(r0['cb int8'], ref['cb int8'])}; for scale, the single "
          f"device's fused (K7) int8 pool against that per-op pool: {_parting(k7_int8, ref['cb int8'])}")
    print("phase tp launches per rank: " + "; ".join(
        f"rank {rank}: " + " ".join(f"{k}={res['launches'][k]}" for k in (
            "encoder_attention", "decode_attention", "embed_add", "gather_rows", "greedy_argmax_tied",
            "greedy_argmax", "log_mel_spectrogram", "int8_kv", "int8_decode_attention_tp_scale",
            "fused_decode_step", "fused_cross_decode_step")) for rank, res in got.items()))
    n_tok = len(prompts) * TP_RATE_NEW
    tps = {k: n_tok / np.mean([t for t in v if t is not None]) for k, v in r0["bf16_s"].items()}
    print(f"phase time tp bf16 GPT-2 small generate_tokens_batch B={len(prompts)} x {TP_RATE_NEW} new, per-op, in "
          f"turns (two ranks on one card, all-reduces through host memory (gloo): a reading of the mechanism, not a "
          f"deployment's rate): tp=2 {tps['tp=2']:.1f} tok/s, one rank alone {tps['one rank']:.1f} tok/s [{card}]")
    print(f"phase tp clock: single-device references {ref_s:.1f} s while the ranks started; ranks {ranks_s:.1f} s "
          f"(model builds {max(res['build_s'] for res in got.values()):.1f} s, the counted run "
          f"{max(res['run_s'] for res in got.values()):.1f} s)")
    _route("fused")
    return summed


PET_RANKS = 4  # ranks of phase "pp ep train" on the one card
PET_NEW = 32  # new tokens of its generations (fewer than N_NEW: the script's time limit)
PET_TP_PP = (2, 2)  # its (pp, tp) mesh
PET_JOIN_S = 240
# the EP and train phases' MoE at GPT-2 small's widths (vocab, d, heads, layers) with 8 experts of GPT-2's MLP width
PET_MOE = dict(vocab_size=50257, d_model=768, n_heads=12, n_layers=12, n_experts=8, expert_hidden=3072,
               max_seq_len=1024)
PET_TRAIN = dict(vocab_size=50257, d_model=768, n_heads=12, n_stages=2, layers_per_stage=6, n_experts=8,
                 expert_hidden=3072, max_seq_len=256)
PET_TRAIN_B, PET_TRAIN_MICRO, PET_TRAIN_MESH = 8, 2, (1, 2, 2)  # batch rows, microbatches, (dp, pp, tp)
PET_TRAIN_TOL = 1e-6  # relative, the (1, 2, 2) losses against one rank's at capacity factor n_experts
PET_SHARD_TOL = 2e-5  # rtol and atol, each rank's stepped shard there against its shard of one rank's parameters


def _pet_inputs():
    """The phase's inputs, the same in every process: the main path's GPT-2
    prompts (B=8), the MoE decoder's parameters (seeded; position table at
    scale 3 so streams move), the MoE LM's initial parameters and its
    training batch (B=8 x 256 tokens), all on the host."""
    import torch

    from pytorch_models_tpu_torch.parallel.ep_serving import MoEDecoderConfig, moe_decoder_init
    from pytorch_models_tpu_torch.parallel.train import MoELMConfig, moe_lm_init

    r = np.random.default_rng(SEED)
    prompts = [r.integers(0, 50257, n).tolist() for n in PROMPT_LENS]
    cfg = MoEDecoderConfig(**PET_MOE)
    moe = moe_decoder_init(torch.Generator().manual_seed(SEED + 20), cfg, device="cpu")
    moe["pos_embs"] = 3.0 * torch.randn(moe["pos_embs"].shape, generator=torch.Generator().manual_seed(SEED + 21))
    tcfg = MoELMConfig(**PET_TRAIN)
    lm = moe_lm_init(torch.Generator().manual_seed(SEED + 22), tcfg, device="cpu")
    tokens = np.random.default_rng(SEED + 23).integers(0, tcfg.vocab_size, (PET_TRAIN_B, tcfg.max_seq_len))
    return {"prompts": prompts, "moe_cfg": cfg, "moe": moe, "lm_cfg": tcfg, "lm": lm, "tokens": tokens}


def _pet_rank_work(rank: int, dev, tmp: str) -> dict:
    """The rank's share of phase "pp ep train", each run's counts from 0
    just before it: GPT-2 small at pp=4 and at (pp, tp) = (2, 2) (fp32,
    B=8 x PET_NEW new; its stage moved to the card from a host copy, memory
    read before and during), bf16 pp=4 tok/s against rank 0 alone in turns;
    the MoE decoder at ep=4 (fp32, B=8 x PET_NEW new, all_to_all calls); two
    SGD steps of the MoE LM on (dp, pp, tp) = (1, 2, 2) at the default
    capacity (losses, every gradient leaf of the first, step times, K1
    launches) and two at capacity factor n_experts (losses; the stepped
    shard saved under ``tmp`` for the parent to hold against one rank's)."""
    import dataclasses
    import os
    import types

    import torch
    import torch.distributed as dist

    from pytorch_models_tpu_torch.ops import _build
    from pytorch_models_tpu_torch.parallel import PPDecoderGenerator, TPPPDecoderGenerator, make_mesh
    from pytorch_models_tpu_torch.parallel import mesh as pmesh
    from pytorch_models_tpu_torch.parallel.ep_serving import EPMoEGenerator
    from pytorch_models_tpu_torch.parallel.sharding import shard_params, tree_map_with_path
    from pytorch_models_tpu_torch.parallel.train import _loss_and_grads, make_train_step
    from pytorch_models_tpu_torch.text import DecoderGenerator
    from pytorch_models_tpu_torch.utils import cast_tree, tree_map

    t0 = time.perf_counter()
    _build.load_library()  # the parent's build, loaded from build/kernels/
    inp = _pet_inputs()
    prompts = inp["prompts"]
    gpt2 = _gpt2_moving(dev)
    on_card = gpt2.params
    gpt2.params = tree_map(lambda t: t.cpu(), on_card)  # the stages are moved to the card from the host
    del on_card
    torch.cuda.empty_cache()
    pp_mesh = make_mesh(PET_RANKS, shape=(PET_RANKS,), axes=("pp",), device=dev)
    tppp_mesh = make_mesh(PET_RANKS, shape=PET_TP_PP, axes=("pp", "tp"), device=dev)
    ep_mesh = make_mesh(PET_RANKS, shape=(PET_RANKS,), axes=("ep",), device=dev)
    train_mesh = make_mesh(PET_RANKS, shape=PET_TRAIN_MESH, axes=("dp", "pp", "tp"), device=dev)
    res = {"build_s": time.perf_counter() - t0}

    def serve(name, make, run):
        """Build on the card, then the counted run; memory over the host-only baseline."""
        base = torch.cuda.memory_allocated(dev)
        gen = make()
        res[f"{name} mem"] = torch.cuda.memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        calls = pmesh.all_to_all.calls
        t = time.perf_counter()
        res[name] = run(gen)
        torch.cuda.synchronize()
        res[f"{name} s"] = time.perf_counter() - t
        res[f"{name} peak"] = torch.cuda.max_memory_allocated(dev) - base
        res[f"{name} launches"] = _launches(set())
        res[f"{name} all_to_all"] = pmesh.all_to_all.calls - calls
        del gen
        torch.cuda.empty_cache()

    _route("per-op")
    serve("pp", lambda: PPDecoderGenerator(gpt2, _Tok(), pp_mesh),
          lambda g: g.generate_tokens_batch(prompts, max_tokens=PET_NEW))
    serve("tp_pp", lambda: TPPPDecoderGenerator(gpt2, _Tok(), tppp_mesh),
          lambda g: g.generate_tokens_batch(prompts, max_tokens=PET_NEW))
    if rank == 0:  # the whole model on one rank, for the memory line
        serve("one rank", lambda: DecoderGenerator(types.SimpleNamespace(
            params=tree_map(lambda t: t.to(dev), gpt2.params), cfg=gpt2.cfg, device=dev), _Tok()),
            lambda g: g.generate_tokens_batch(prompts, max_tokens=PET_NEW))
    dist.barrier()

    # bf16 GPT-2 rates: pp=4 (every rank) and rank 0 alone (the others waiting), in turns
    gpt2.params = cast_tree(gpt2.params, torch.bfloat16)
    gen16 = PPDecoderGenerator(gpt2, _Tok(), pp_mesh)
    single = None
    if rank == 0:
        single = DecoderGenerator(types.SimpleNamespace(params=tree_map(lambda t: t.to(dev), gpt2.params),
                                                        cfg=gpt2.cfg, device=dev), _Tok())

    def timed(run) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def pp_once() -> float:
        dist.barrier()
        return timed(lambda: gen16.generate_tokens_batch(prompts, max_tokens=TP_RATE_NEW))

    def single_once() -> float | None:
        s = timed(lambda: single.generate_tokens_batch(prompts, max_tokens=TP_RATE_NEW)) if rank == 0 else None
        dist.barrier()
        return s

    pp_once(), single_once()  # warm-up
    times = {"pp=4": [], "one rank": []}
    for kind in ("pp=4", "one rank", "one rank", "pp=4"):
        times[kind].append(pp_once() if kind == "pp=4" else single_once())
    res["bf16_s"] = times
    del gen16, single, gpt2
    torch.cuda.empty_cache()

    serve("ep", lambda: EPMoEGenerator(inp["moe"], inp["moe_cfg"], ep_mesh),
          lambda g: g.generate_tokens_batch(prompts, max_tokens=PET_NEW))

    # training: two SGD steps at the default capacity, then two at capacity factor n_experts
    tokens = torch.from_numpy(inp["tokens"]).to(dev)
    for name, cfg in (("train", inp["lm_cfg"]),
                      ("train high", dataclasses.replace(inp["lm_cfg"], capacity_factor=float(PET_MOE["n_experts"])))):
        step, specs = make_train_step(cfg, train_mesh, PET_TRAIN_MICRO)
        params = shard_params(inp["lm"], specs, train_mesh)
        _reset_launches()
        if name == "train":  # the first step's gradients, through the step's own first half
            leaves = []
            tree_map_with_path(lambda path, g: leaves.append((path, bool(torch.isfinite(g).all()),
                                                              float(g.abs().max()))),
                               _loss_and_grads(params, cfg, tokens, train_mesh, PET_TRAIN_MICRO)[1])
            res["train grads"] = leaves
        losses, secs = [], []
        for i in range(2):
            dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, loss = step(params, tokens)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t)
        res[name] = {"losses": losses, "s": secs, "launches": _launches(set())}
        if name == "train high":
            res["train index"] = tuple(train_mesh.index(a) for a in ("dp", "pp", "tp"))
            res["train high params"] = os.path.join(tmp, f"train_high_{rank}.pt")
            torch.save(tree_map(lambda t: t.cpu(), params), res["train high params"])
        del params, step
        torch.cuda.empty_cache()
    return res


def _pet_shard_err(res: dict, one_params: dict, specs, dev) -> tuple:
    """A rank's stepped "train high" shard (saved by the rank) against the
    same shard of one rank's stepped parameters: ``(the worst leaf's path,
    its largest |got - want| - PET_SHARD_TOL * (1 + |want|), the largest
    |got - want| of any leaf)``; the first is > 0 when a leaf fails."""
    import types

    import torch

    from pytorch_models_tpu_torch.parallel.sharding import shard_params, tree_map_with_path

    index = res["train index"]
    mesh = types.SimpleNamespace(shape=dict(zip(("dp", "pp", "tp"), PET_TRAIN_MESH)), device=dev,
                                 index=lambda a: index[("dp", "pp", "tp").index(a)])
    want = shard_params(one_params, specs, mesh)
    got = torch.load(res["train high params"], map_location=dev, weights_only=True)
    worst = ["", -float("inf"), 0.0]

    def leaf(path, w):
        g = got
        for part in path[1:-1].split("]["):
            g = g[part.strip("'")] if part.startswith("'") else g[int(part)]
        diff = (g - w).abs()
        excess = float((diff - PET_SHARD_TOL * (1 + w.abs())).max())
        if excess > worst[1]:
            worst[:2] = path, excess
        worst[2] = max(worst[2], float(diff.max()))

    tree_map_with_path(leaf, want)
    return tuple(worst)


def pp_ep_train_path(dev, card: str) -> dict:
    """Pipeline-, expert-parallel serving and the parallel train step
    (``parallel/``) at full width through their entry points: PET_RANKS
    ranks spawned on the one card over gloo (each running
    ``_pet_rank_work``), with the single-device references computed here
    while they start: GPT-2 small's per-op route (fp32, B=8 x PET_NEW), the
    MoE decoder's single-device ``MoEDecoderGenerator`` and the train step
    on a one-rank mesh at capacity factor n_experts. fp32 tokens equal on
    every rank and the single device's up to printed near-ties; K7 launched
    0 times, K2 and ``embed_add`` more than 0 on every rank; the EP run
    calls all_to_all twice per layer and forward; the two SGD steps' losses
    finite and falling, at capacity factor n_experts within PET_TRAIN_TOL of
    one rank's and each rank's stepped shard within PET_SHARD_TOL of its
    shard of one rank's parameters, every gradient leaf finite and non-zero,
    K1 launched 0 times in training. Returns the serving runs' summed
    launches."""
    import dataclasses
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from pytorch_models_tpu_torch import transformer as tfm
    from pytorch_models_tpu_torch.parallel import make_mesh
    from pytorch_models_tpu_torch.parallel.ep_serving import MoEDecoderGenerator, _forward, _moe_mlp_dense
    from pytorch_models_tpu_torch.parallel.sharding import shard_params
    from pytorch_models_tpu_torch.parallel.train import make_train_step
    from pytorch_models_tpu_torch.text import DecoderGenerator
    from pytorch_models_tpu_torch.utils import tree_map

    out = mp.get_context("spawn").Queue()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = _spawn_ranks(PET_RANKS, "_pet_rank_work", os.path.join(tmp, "init"), out, (tmp,))
        try:
            inp = _pet_inputs()
            prompts, cfg = inp["prompts"], inp["moe_cfg"]
            _route("per-op")
            gpt2 = _gpt2_moving(dev)
            ref = {"pp": DecoderGenerator(gpt2, _Tok()).generate_tokens_batch(prompts, max_tokens=PET_NEW)}
            ref["tp_pp"] = ref["pp"]
            moe = tree_map(lambda t: t.to(dev), inp["moe"])
            ref["ep"] = MoEDecoderGenerator(moe, cfg).generate_tokens_batch(prompts, max_tokens=PET_NEW)
            # the train step on a one-rank mesh (a process group of its own), capacity factor n_experts
            dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'one')}", rank=0, world_size=1)
            try:
                one = make_mesh(1, shape=(1, 1, 1), axes=("dp", "pp", "tp"), device=dev)
                step, specs = make_train_step(dataclasses.replace(
                    inp["lm_cfg"], capacity_factor=float(PET_MOE["n_experts"])), one, PET_TRAIN_MICRO)
                one_params, tokens, one_losses = shard_params(inp["lm"], specs, one), torch.from_numpy(inp["tokens"]), []
                for _ in range(2):
                    one_params, loss = step(one_params, tokens.to(dev))
                    one_losses.append(float(loss))
                del step
            finally:
                dist.destroy_process_group()
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t1
            got = _join_ranks("pp ep train", procs, out, t1, PET_JOIN_S)
            shard_err = {rank: _pet_shard_err(res, one_params, specs, dev) for rank, res in got.items()}
            del one_params
        finally:
            _stop(procs)
    ranks_s = time.perf_counter() - t1

    def gpt2_gap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(gpt2(torch.tensor(prefix, device=dev))[-1])

    def moe_gap(i, prefix):
        _route("plain")
        with torch.inference_mode():
            caches, _ = tfm.make_kv_cache(cfg.n_layers, (1,), cfg.n_heads, cfg.max_seq_len,
                                          cfg.d_model // cfg.n_heads, device=dev)
            logits = _forward(moe, cfg, torch.tensor([prefix], device=dev),
                              torch.arange(len(prefix), device=dev)[None], caches, 0, None,
                              lambda p, x: _moe_mlp_dense(p, x, cfg=cfg))
            return _top2(logits[0, -1])

    r0 = got[0]
    notes = []
    for name in ("pp", "tp_pp", "ep"):
        for rank in range(1, PET_RANKS):
            if got[rank][name] != r0[name]:
                raise AssertionError(f"pp ep train {name}: rank {rank}'s tokens part from rank 0's")
        what = f"pp ep train {name}"
        distinct = _check_moving(what, r0[name], PROMPT_LENS)
        partings = _check_routes(what, {"single device": ref[name], name: r0[name]},
                                 moe_gap if name == "ep" else gpt2_gap, "single device")
        notes.append(f"{name}: {partings} (distinct new tokens per row {distinct})")
        for rank, res in got.items():
            c = res[f"{name} launches"]
            k7 = c["fused_decode_step"] + c["fused_cross_decode_step"]
            missing = [k for k in ("decode_attention", "embed_add") if c[k] <= 0]
            if k7 or missing:
                raise AssertionError(f"{what} rank {rank}: K7 launched {k7} times (0 wanted); never launched: "
                                     f"{missing}")
    pad = -(-max(PROMPT_LENS) // 8) * 8  # the MoE generator's bucket of 8
    forwards = min(pad + PET_NEW, cfg.max_seq_len) - pad
    for rank, res in got.items():
        if res["ep all_to_all"] != 2 * cfg.n_layers * forwards:
            raise AssertionError(f"pp ep train ep rank {rank}: {res['ep all_to_all']} all_to_all calls, "
                                 f"{2 * cfg.n_layers * forwards} wanted (2 x {cfg.n_layers} layers x {forwards} "
                                 "forwards)")
        for name in ("train", "train high"):
            l0, l1 = res[name]["losses"]
            if not (np.isfinite(l0) and np.isfinite(l1) and l1 < l0):
                raise AssertionError(f"pp ep train {name} rank {rank}: losses {l0}, {l1} (finite and falling wanted)")
            if res[name]["launches"]["encoder_attention"]:
                raise AssertionError(f"pp ep train {name} rank {rank}: K1 launched in training")
        bad = [(p, finite, amax) for p, finite, amax in res["train grads"] if not finite or amax == 0]
        if bad:
            raise AssertionError(f"pp ep train rank {rank}: gradient leaves zero or not finite: {bad[:4]}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(res["train high"]["losses"], one_losses))
        if rel > PET_TRAIN_TOL:
            raise AssertionError(f"pp ep train rank {rank}: losses {res['train high']['losses']} part from one "
                                 f"rank's {one_losses} by {rel:.3g} relative (> {PET_TRAIN_TOL})")
        path, excess, max_abs = shard_err[rank]
        if excess > 0:
            raise AssertionError(f"pp ep train rank {rank}: stepped {path} parts from one rank's by more than "
                                 f"(rtol, atol) = ({PET_SHARD_TOL}, {PET_SHARD_TOL}) (max abs {max_abs:.3g})")
    mib = 2.0 ** 20
    print(f"phase pp ep train fp32: {PET_RANKS} ranks on one card ({card}), gloo, collectives through host memory; "
          f"GPT-2 small B={len(prompts)} x {PET_NEW} new at pp={PET_RANKS} and (pp, tp) = {PET_TP_PP}, the MoE decoder "
          f"(GPT-2 small's widths, {cfg.n_experts} experts x {cfg.expert_hidden}) at ep={PET_RANKS}: every rank's "
          f"tokens equal, and the single device's up to near-ties ({'; '.join(notes)}); all_to_all "
          f"{r0['ep all_to_all']} calls a rank (2 x {cfg.n_layers} layers x {forwards} forwards)")
    print("phase pp ep train memory (torch.cuda.memory_allocated over each process's host-only baseline, MiB: "
          "parameters on the card / peak in the generation): " + "; ".join(
              f"rank {rank}: pp=4 {res['pp mem'] / mib:.0f} / {res['pp peak'] / mib:.0f}, (2, 2) "
              f"{res['tp_pp mem'] / mib:.0f} / {res['tp_pp peak'] / mib:.0f}, ep=4 {res['ep mem'] / mib:.0f} / "
              f"{res['ep peak'] / mib:.0f}" for rank, res in sorted(got.items()))
          + f"; one rank, the whole GPT-2: {r0['one rank mem'] / mib:.0f} / {r0['one rank peak'] / mib:.0f} [{card}]")
    def counts(c: dict) -> str:
        return f"K2={c['decode_attention']} embed_add={c['embed_add']} K7={c['fused_decode_step']}"

    print("phase pp ep train launches per rank: " + "; ".join(
        f"rank {rank}: " + ", ".join(f"{name} {counts(res[f'{name} launches'])}" for name in ("pp", "tp_pp", "ep"))
        + f", train K1={res['train']['launches']['encoder_attention']}" for rank, res in sorted(got.items())))
    n_tok = len(prompts) * TP_RATE_NEW
    tps = {k: n_tok / np.mean([t for t in v if t is not None]) for k, v in r0["bf16_s"].items()}
    print(f"phase time pp ep train bf16 GPT-2 small generate_tokens_batch B={len(prompts)} x {TP_RATE_NEW} new, "
          f"in turns (four ranks on one card, broadcasts through host memory (gloo): a reading of the mechanism, "
          f"not a deployment's rate): pp=4 {tps['pp=4']:.1f} tok/s, one rank alone (per-op) "
          f"{tps['one rank']:.1f} tok/s [{card}]")
    tcfg = inp["lm_cfg"]
    n_train = PET_TRAIN_B * tcfg.max_seq_len
    step_s = [max(res["train"]["s"][i] for res in got.values()) for i in range(2)]
    print(f"phase pp ep train step fp32: MoELMConfig at GPT-2 small's widths ({tcfg.n_stages} stages x "
          f"{tcfg.layers_per_stage} layers, {tcfg.n_experts} experts x {tcfg.expert_hidden}, B={PET_TRAIN_B} x "
          f"L={tcfg.max_seq_len}, n_micro {PET_TRAIN_MICRO}) on (dp, pp, tp) = {PET_TRAIN_MESH}: losses "
          f"{r0['train']['losses']} (capacity factor {tcfg.capacity_factor}); at capacity factor "
          f"{PET_MOE['n_experts']} {r0['train high']['losses']} against one rank's {one_losses}, every stepped "
          f"shard within ({PET_SHARD_TOL}, {PET_SHARD_TOL}) of one rank's (max abs "
          f"{max(e[2] for e in shard_err.values()):.3g}); every gradient "
          f"leaf finite and non-zero ({len(r0['train grads'])} leaves a rank); K1 launched 0 times; step "
          f"{step_s[0]:.3f} s then {step_s[1]:.3f} s, {n_train / step_s[1]:.0f} tokens/s [{card}]")
    print(f"phase pp ep train clock: single-device references {ref_s:.1f} s while the ranks started; ranks "
          f"{ranks_s:.1f} s (inputs and models {max(res['build_s'] for res in got.values()):.1f} s)")
    _route("fused")
    return {k: sum(res[f"{name} launches"][k] for res in got.values() for name in ("pp", "tp_pp", "ep"))
            for k in r0["pp launches"]}


# ---------------------------------------------------------------------------
# phase "act": K7's relu / silu / identity codes
# ---------------------------------------------------------------------------

K7_ACTS = ("relu", "silu", "identity")  # the MLP activations beyond GELU (K7's act codes 2-4)
ACT_BATCHES = (8, 32)
ACT_TURNS = ("per-op", "fused", "fused", "per-op")  # the bf16 rate's turns


def act_kernel_phases(dev, card: str) -> dict:
    """Phase "act", kernels: K7 with each of K7_ACTS against its plain twin at
    GPT-2 small's shape (base: LayerNorm, tied head) and T5-base's (gated:
    RMSNorm, GEGLU, the rel-pos self bias, untied head), B=8 and 32 (pos 127
    and 40, left pads), fp32 and bf16, within DS_TOL (``decode_step_phases``
    with ``acts``). A code's record is GPT-2's at B=8,
    ``fused_decode_step_<act>``; the other shapes are its ``rows`` and their
    errors count in its ``err``."""
    res = decode_step_phases(dev, card, kinds=("gpt2", "t5"), cases=[(b, None) for b in ACT_BATCHES], acts=K7_ACTS)
    out = {}
    for act in K7_ACTS:
        for dn in DS_TOL:
            rec = res[(f"fused_decode_step_{act}", dn)]
            rec["rows"] = []
            for key in (f"fused_decode_step_b32_{act}", f"fused_cross_decode_step_t5_{act}",
                        f"fused_cross_decode_step_t5_b32_{act}"):
                row = res[(key, dn)]
                rec["err"] = max(rec["err"], row["err"])
                rec["rows"].append({"shape": row["shape"] + (", gated (T5-base)" if "_t5_" in key else ""),
                                    "dtype": dn, "max_abs_err": row["err"],
                                    **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
            out[(f"fused_decode_step_{act}", dn)] = rec
    return out


def act_path(dev, card: str) -> dict:
    """Phase "act", path: GPT-2 small at full width whose config takes each
    of K7_ACTS (``dataclasses.replace(model.cfg, act=...)``, as the JAX
    package's ``DecoderLMConfig.act`` allows; streams made to move as in
    phase "main") through ``DecoderGenerator.generate_tokens_batch`` (B=8,
    N_NEW new): fp32 tokens identical on the fused, per-op and plain routes
    up to printed near-ties, K7 launched once per decode step, every launch
    with that activation, ``embed_add`` launched; then bf16 tok/s fused
    against per-op in turns (silu). Counts from 0 before each activation's
    routes; returns ``{act: counts}``."""
    from dataclasses import replace

    import torch

    from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
    from pytorch_models_tpu_torch.ops import decode_step as ds

    r = np.random.default_rng(SEED + 31)
    prompts = [r.integers(0, 50257, n).tolist() for n in PROMPT_LENS]
    model = GPT2.from_hf("gpt2", rng=SEED, device=dev)
    _make_streams_move(dev, SEED + 7, model.params, [model.params["decoder"]["layers"]])
    gelu_cfg = model.cfg
    gen = DecoderGenerator(model, _Tok())
    acts_seen, real = [], ds._act_code

    def spy(act, dtype):  # the activation code of every K7 launch (the wrapper's _launch maps each call's act)
        acts_seen.append(act)
        return real(act, dtype)

    def generate():
        return gen.generate_tokens_batch(prompts, max_tokens=N_NEW)

    def gap_fn(i, prefix):
        _route("plain")
        with torch.inference_mode():
            return _top2(model(torch.tensor(prefix))[-1])

    counts = {}
    try:
        for act in K7_ACTS:
            model.cfg = replace(gelu_cfg, act=act)
            _reset_launches()
            outs = {}
            for route in ("plain", "fused", "per-op"):
                _route(route)
                acts_seen.clear()
                ds._act_code = spy
                try:
                    outs[route] = generate()
                finally:
                    ds._act_code = real
                if route == "fused":
                    fused_acts = set(acts_seen)
            torch.cuda.synchronize()
            counts[act] = _launches({"fused_decode_step", "embed_add", "decode_attention"})
            for route, rows in outs.items():
                if any(row[:len(p)] != p or len(row) != len(p) + N_NEW or not all(0 <= t < 50257 for t in row)
                       for row, p in zip(rows, prompts)):
                    raise AssertionError(f"act {act} ({route}): malformed row")
            steps = _decode_steps([N_NEW] * len(prompts), N_NEW - 1, False)
            if counts[act]["fused_decode_step"] != steps or fused_acts != {act}:
                raise AssertionError(f"act {act}: K7 launched {counts[act]['fused_decode_step']} times with "
                                     f"{fused_acts} for {steps} decode steps")
            distinct = _check_moving(f"act {act} fp32", outs["fused"], PROMPT_LENS)
            partings = _check_routes(f"act {act} fp32", outs, gap_fn)
            print(f"phase act {act} fp32 generate_tokens_batch (GPT-2 small, cfg.act={act!r}): B={len(prompts)} x "
                  f"{N_NEW} new, fused, per-op and plain token-identical (partings at near-ties: {partings}); K7 "
                  f"{counts[act]['fused_decode_step']} launches = {steps} decode steps, all with {act}; embed_add "
                  f"{counts[act]['embed_add']}; distinct new tokens per row {distinct}")
        model.cfg = replace(gelu_cfg, act="silu")
        model.to_bf16()
        times = {}
        for route in ACT_TURNS:
            _route(route)
            ms, _ = _event_ms(generate)
            times.setdefault(route, []).append(ms)
        n_tok = len(prompts) * N_NEW
        print(f"phase time bf16 act silu generate_tokens_batch B={len(prompts)} x {N_NEW} new (prefill included, "
              "CUDA events, turns " + ", ".join(ACT_TURNS) + "): "
              + ", ".join(f"{k} {n_tok / (np.mean(v) / 1e3):.1f} tok/s ({np.mean(v):.1f} ms)" for k, v in times.items())
              + f" [{card}]")
    finally:
        _route("fused")
    return counts


# ---------------------------------------------------------------------------
# phase "examples": the port's entry points, examples/torch_*.py
# ---------------------------------------------------------------------------

EXAMPLES = ("text_generate", "transcribe", "image_classify", "encodec_roundtrip", "serve_sharded")
ENCODEC_24K = "encodec_24khz-d7cc33bc.th"


def _encodec_facebook_state_dict(params: dict, n_stages: int) -> dict:
    """The port's EnCodec 24 kHz tree (weight-norm convs) as
    facebookresearch/encodec's checkpoint: a conv's kernel as ``weight_v``
    with ``weight_g`` its norm over the last two dims (the loader's ``g * v /
    ||v||`` gives it back), a ConvTranspose's unflipped to ``(in, out, k)``,
    an LSTM's bias as ``bias_ih`` beside a zero ``bias_hh``; CPU tensors."""
    import torch

    sd = {}

    def conv(pfx, p, transpose=False):
        inner = "convtr.convtr" if transpose else "conv.conv"
        w = p["w"].flip(0).permute(1, 2, 0) if transpose else p["w"].permute(2, 1, 0)
        sd[f"{pfx}.{inner}.weight_v"] = w
        sd[f"{pfx}.{inner}.weight_g"] = w.square().sum((1, 2), keepdim=True).sqrt()
        sd[f"{pfx}.{inner}.bias"] = p["b"]

    def block(pfx, p):
        for name, idx in (("conv1", "block.1"), ("conv2", "block.3"), ("shortcut", "shortcut")):
            conv(f"{pfx}.{idx}", p[name])

    def lstm(pfx, layers):
        for i, lp in enumerate(layers):
            sd.update({f"{pfx}.lstm.weight_ih_l{i}": lp["w_ih"].t(), f"{pfx}.lstm.weight_hh_l{i}": lp["w_hh"].t(),
                       f"{pfx}.lstm.bias_ih_l{i}": lp["b"], f"{pfx}.lstm.bias_hh_l{i}": torch.zeros_like(lp["b"])})

    enc, dec = params["encoder"], params["decoder"]
    conv("encoder.model.0", enc["conv_in"])
    for i, st in enumerate(enc["stages"]):
        block(f"encoder.model.{1 + 3 * i}", st["block"])
        conv(f"encoder.model.{3 + 3 * i}", st["down"])
    lstm(f"encoder.model.{1 + 3 * n_stages}", enc["lstm"])
    conv(f"encoder.model.{3 + 3 * n_stages}", enc["conv_out"])
    conv("decoder.model.0", dec["conv_in"])
    lstm("decoder.model.1", dec["lstm"])
    for i, st in enumerate(dec["stages"]):
        conv(f"decoder.model.{3 + 3 * i}", st["up"], transpose=True)
        block(f"decoder.model.{4 + 3 * i}", st["block"])
    conv(f"decoder.model.{3 + 3 * n_stages}", dec["conv_out"])
    for i, e in enumerate(params["quantizer"]["embed"]):
        sd[f"quantizer.vq.layers.{i}._codebook.embed"] = e
    return {k: _cpu(v) for k, v in sd.items()}


def _write_ranks(path: str, n: int) -> None:
    """A synthetic BPE rank table of ``n`` ranks in the ``.tiktoken`` format
    (``base64(token) rank`` a line): the 256 bytes, then byte pairs in
    order, each mergeable from its two bytes."""
    import base64

    toks = [bytes([i]) for i in range(256)] + [bytes([a, b]) for a in range(256) for b in range(256)]
    with open(path, "w") as f:
        f.writelines(f"{base64.b64encode(t).decode()} {i}\n" for i, t in enumerate(toks[:n]))


def _write_example_cache(root: str, dev) -> dict:
    """The four single-card scripts' checkpoints and the two rank tables,
    from the seed, under the names their ``--pretrained`` reads: GPT-2 small
    (HF ``gpt2.bin``), Whisper-tiny (OpenAI ``tiny.pt``; key biases zero,
    as the format has none), ViT-B/16 (AugReg ``.npz``), EnCodec 24 kHz
    (facebook ``.th``), ``gpt2_tokenizer/gpt2.tiktoken`` (50256 ranks: GPT-2's
    vocabulary without its EOT) and ``whisper_tokenizer/multilingual.tiktoken``
    (50257: with the specials, Whisper's 51865). Returns MiB by file."""
    import os

    import torch

    from pytorch_models_tpu_torch.audio import EnCodec
    from pytorch_models_tpu_torch.audio2text import Whisper
    from pytorch_models_tpu_torch.image import ViT
    from pytorch_models_tpu_torch.text import GPT2

    torch.save(_gpt2_hf_state_dict(GPT2.from_hf("gpt2", rng=SEED, device=dev).params), os.path.join(root, "gpt2.bin"))
    src = Whisper.from_openai("tiny", rng=SEED, device=dev)
    for stack in (src.params["encoder"], src.params["decoder"]):
        for lp in stack["layers"]:
            for blk in ("sa", "ca"):
                if blk in lp:
                    lp[blk]["k"]["b"].zero_()
    torch.save(_whisper_openai_checkpoint(src.params, src.cfg), os.path.join(root, "tiny.pt"))
    src = ViT.from_google("B/16_augreg", rng=SEED, device=dev)
    np.savez(os.path.join(root, AUGREG_B16), **_vit_augreg_arrays(src.params, src.cfg))
    src = EnCodec.from_facebook("24khz", device=dev)
    torch.save(_encodec_facebook_state_dict(src.params, len(src.cfg.strides)), os.path.join(root, ENCODEC_24K))
    for sub, name, n in (("gpt2_tokenizer", "gpt2.tiktoken", 50256), ("whisper_tokenizer", "multilingual.tiktoken",
                                                                        50257)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        _write_ranks(os.path.join(root, sub, name), n)
    names = ["gpt2.bin", "tiny.pt", AUGREG_B16, ENCODEC_24K, "gpt2_tokenizer/gpt2.tiktoken",
             "whisper_tokenizer/multilingual.tiktoken"]
    return {n: os.path.getsize(os.path.join(root, n)) / 2**20 for n in names}


def _check_example(name: str, out: dict, pretrained: bool) -> str:
    """Raises unless a script's outputs have its expected form; returns a
    summary."""
    import torch

    def finite(t):
        return bool(torch.isfinite(t.float()).all())

    if name == "image_classify":
        ok = (tuple(out["features"].shape) == (8, 768) and tuple(out["features_448"].shape) == (2, 768)
              and out["features"].dtype == torch.bfloat16 and finite(out["features"]) and finite(out["features_448"]))
        summary = f"features {tuple(out['features'].shape)} and {tuple(out['features_448'].shape)} bf16, finite"
    elif name == "encodec_roundtrip":
        codes, rec = out["codes"], out["reconstruction"]
        ok = (tuple(codes.shape) == (1, 32, 150) and int(codes.min()) >= 0 and int(codes.max()) < 1024
              and tuple(rec.shape) == (1, 1, 48000) and finite(rec))
        summary = f"codes {tuple(codes.shape)} in [0, 1024), reconstruction {tuple(rec.shape)} finite"
    elif name == "text_generate":
        texts = [out[k] for k in ("greedy", "nucleus", "beam", "speculative")] + out["batched"] + out["best-of-3"]
        ok = all(isinstance(t, str) and t for t in texts) and np.isfinite(out["perplexity"]) and out["perplexity"] > 0
        if not pretrained:  # fp32: speculative decoding is exact (bf16 routes may part at a near-tie)
            ok = ok and out["greedy"] == out["speculative"]
        summary = f"{len(texts)} texts, perplexity {out['perplexity']:.6g}"
    elif name == "transcribe":
        if pretrained:
            ok = isinstance(out["single"], str) and isinstance(out["long"], str)
            summary = f"texts of {len(out['single'])} and {len(out['long'])} characters"
        else:
            ok = out["single"][:3] == [50, 51, 52] and out["speculative"] == out["single"] and len(out["long"]) == 2
            summary = f"single {len(out['single'])} tokens, speculative equal, {len(out['long'])} long-form windows"
    else:
        ok = len(out["ranks"]) == 8
        summary = f"{len(out['ranks'])} ranks token-identical to the single device"
    if not ok:
        raise AssertionError(f"examples {name}{' --pretrained' if pretrained else ''}: unexpected outputs ({summary})")
    return summary


def examples_path(dev, card: str) -> dict:
    """Phase "examples": the port's five examples (``examples/torch_*.py``),
    each through its ``main`` in this process on the card, random weights:
    every count from 0 before a script, its launches per kernel read after it
    (serve_sharded: each of its 8 ranks' own, the ranks sharing the card over
    gloo), its seconds. Required: text_generate K7 and ``embed_add`` > 0;
    transcribe K5, K1 and K7 (cross) > 0; image_classify K1 = 12 per forward
    (two forwards); serve_sharded K2 and ``embed_add`` > 0 and K7 0 on every
    rank. Then the four single-card scripts with ``--pretrained`` at full
    width from a temporary cache written from the seed
    (``_write_example_cache``), with the same launch checks. Each script's
    outputs are checked for their form (``_check_example``; serve_sharded's
    ``main`` checks every rank's rows against the single device). Returns
    the counts by script."""
    import contextlib
    import importlib
    import io
    import os
    import shutil
    import tempfile

    import torch

    need = {"text_generate": {"fused_decode_step", "embed_add"},
            "transcribe": {"log_mel_spectrogram", "encoder_attention", "fused_cross_decode_step"},
            "image_classify": {"encoder_attention"}, "encodec_roundtrip": set()}

    def run(name: str, argv: list) -> tuple[dict, dict, float]:
        mod = importlib.import_module(f"examples.torch_{name}")
        _reset_launches()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        for line in buf.getvalue().splitlines():
            print(f"phase examples {name}{' --pretrained' if argv else ''} | {line[:300]}")
        return out, _launches(need.get(name, set())), seconds

    def check(name: str, argv: list, out: dict, counts: dict, seconds: float) -> None:
        if name == "image_classify" and counts["encoder_attention"] != 2 * 12:
            raise AssertionError(f"image_classify: K1 launched {counts['encoder_attention']} times for 2 forwards")
        shown = {k: v for k, v in counts.items() if v}
        print(f"phase examples {name}{' --pretrained' if argv else ''}: {seconds:.1f} s, "
              f"{_check_example(name, out, bool(argv))}; launches " + " ".join(f"{k}={v}" for k, v in shown.items())
              + f" [{card}]")

    counts = {}
    _route("fused")
    for name in EXAMPLES:
        out, c, seconds = run(name, [])
        if name == "serve_sharded":
            for rank, res in out["ranks"].items():
                lc = res["launches"]
                if lc["decode_attention"] <= 0 or lc["embed_add"] <= 0 or lc["fused_decode_step"]:
                    raise AssertionError(f"serve_sharded rank {rank}: launches {lc}")
            c = {f"rank {r}": res["launches"] for r, res in sorted(out["ranks"].items())}
            print(f"phase examples serve_sharded: {seconds:.1f} s, {_check_example(name, out, False)}; launches "
                  "per rank: " + "; ".join(f"{r}: " + " ".join(f"{k}={v}" for k, v in lc.items() if v)
                                           for r, lc in c.items()) + f" [{card}]")
        else:
            check(name, [], out, c, seconds)
        counts[name] = c
    saved_env = os.environ.get(CACHE_ENV)
    root = tempfile.mkdtemp(prefix="pmt_examples_cache_")
    os.environ[CACHE_ENV] = root
    try:
        t = time.perf_counter()
        sizes = _write_example_cache(root, dev)
        print(f"phase examples cache {root}: " + ", ".join(f"{n} {mb:.1f} MiB" for n, mb in sizes.items())
              + f" written from seed {SEED} in {time.perf_counter() - t:.1f} s")
        for name in EXAMPLES[:4]:
            out, c, seconds = run(name, ["--pretrained"])
            check(name, ["--pretrained"], out, c, seconds)
            counts[f"{name} --pretrained"] = c
    finally:
        if saved_env is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = saved_env
        shutil.rmtree(root, ignore_errors=True)
    return counts


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
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]  # the host's own time by op
    summary = {"card": card, "what": what, "wall_ms": wall_ms, "span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
               "idle_share": 1 - busy / span, "device_events": len(dev_events), unit.replace(" ", "_") + "s": steps,
               "by_name": [{"name": n, "calls": c, "ms": d / 1e3} for n, (c, d) in top],
               "host_self_ms": [{"name": e.key, "calls": e.count, "ms": e.self_cpu_time_total / 1e3} for e in host]}
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"phase profile {what}: wall {wall_ms:.2f} ms profiled, trace span "
          f"{span / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle share {1 - busy / span:.4f}, "
          f"{len(dev_events)} device events ({len(dev_events) / max(steps, 1):.1f} per {unit}, {steps} {unit}s"
          f"{', prefill included' if unit == 'decode step' else ''}); top: "
          + "; ".join(f"{n[:60]} {c}x {d / 1e3:.2f} ms" for n, (c, d) in top[:6]) + "; host self time: "
          + "; ".join(f"{e.key[:40]} {e.count}x {e.self_cpu_time_total / 1e3:.2f} ms" for e in host[:5]) + f" [{card}]")


def main() -> int:
    import argparse

    import torch

    import pytorch_models_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from pytorch_models_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile bf16 generations, transcriptions and forwards; write summaries under DIR")
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

    from pytorch_models_tpu_torch.ops.encoder_attention import ROUTE_WGMMA, SUPPORTED_HEAD_DIMS, kernel_route

    t_sass = time.perf_counter()
    sass = _sass_tensor_core_counts(lib_path)
    # the instantiations of each (dtype, head width) are of the kernel that the library's route names: bf16 the
    # TMA + wgmma kernel (HGMMA counted; D <= 64 also walks a tile ahead), fp32 the mma.sync kernel
    served = {f"{dn} D={d} " + ("wgmma" if kernel_route(dt, d) == ROUTE_WGMMA else "MT=1")
              for dn, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)) for d in SUPPORTED_HEAD_DIMS}
    k1 = None if sass is None else {k: n for k, n in sass.items() if not k.startswith("K7")}
    if k1 is not None and ({k.removesuffix(" ahead") for k in k1} != served or min(k1.values()) == 0):
        raise AssertionError(f"encoder_attention: every (dtype, head width) must run on the tensor cores of its "
                             f"route's kernel, HGMMA in every bf16 instantiation: {k1} (routes {sorted(served)})")
    print("phase sass encoder_attention: tensor-core instructions (HMMA/HGMMA) per instantiation "
          + ("not measured (no cuobjdump)" if k1 is None else json.dumps(k1))
          + f" ({time.perf_counter() - t_sass:.1f} s)")
    # K7: the bf16 launches above one row group (g4) run their matvec passes and head on the tensor cores; the
    # one-group (g1) and fp32 instantiations on the CUDA cores, none
    k7 = None if sass is None else {k: n for k, n in sass.items() if k.startswith("K7")}
    if k7 is not None:
        want = {f"K7 {dn} {w} g{g}" for dn in ("fp32", "bf16") for w in ("w", "i8") for g in (1, 4)}
        if set(k7) != want or any((n > 0) != (k.startswith("K7 bf16") and k.endswith("g4")) for k, n in k7.items()):
            raise AssertionError(f"decode_step: tensor-core instructions in the bf16 g4 instantiations only: {k7}")
    print("phase sass decode_step: tensor-core instructions (HMMA/IMMA) per instantiation "
          + ("not measured (no cuobjdump)" if k7 is None else json.dumps(k7)))

    clocks = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        clocks[name] = time.perf_counter() - t
        print(f"phase clock {name}: {clocks[name]:.1f} s (run so far {time.perf_counter() - t0:.1f} s)")
        return out

    res = timed("kernel phases", kernel_phases, dev, card)
    res_e = timed("embed_add", embed_kernel_phase, dev, card)
    res_w = timed("whisper kernels", whisper_kernel_phases, dev, card)
    res_t5 = timed("t5 kernels", t5_kernel_phases, dev, card)
    res_k7 = timed("K7", decode_step_phases, dev, card)
    res_wl = timed("K7 whisper large-v3", decode_step_phases, dev, card, ("whisper-large",), [(W_LARGE_K7_B, None)])
    timed("K7 breakdown", decode_step_breakdown, dev, card)
    res_i8 = timed("int8 kernels", int8_kernel_phases, dev, card)
    res_i8k7 = timed("K7 int8", int8_decode_step_phases, dev, card)
    res_sl = sliced_records(res_k7, res_wl, res_i8k7)
    paths = {name: timed(name, fn, dev, card, args.profile)
             for name, fn in (("gpt2", main_path), ("whisper", whisper_path), ("t5", t5_path), ("vit", vit_path))}
    paths["families"] = timed("families", families_path, dev, card, args.profile)
    paths["audio"] = timed("audio", audio_path, dev, card, args.profile)
    paths["pretrained"] = timed("pretrained", pretrained_path, dev, card)
    paths.update(timed("beam and sample", beam_sample_paths, dev, card))
    paths.update(timed("batch", batch_paths, dev, card))
    paths["cb"] = timed("cb", cb_path, dev, card, args.profile)
    paths["cb whisper"] = timed("cb whisper", cb_whisper_path, dev, card, args.profile)
    paths["cb t5"] = timed("cb t5", cb_t5_path, dev, card, args.profile)
    paths.update(timed("k7 slices", slices_path, dev, card))
    k6_path = timed("int8 stack", int8_stack_path, dev, card)
    i8 = timed("int8 paths", int8_paths, dev, card)
    spec = timed("spec", spec_paths, dev, card, args.profile)  # its K7 launches at one row feed the *_b1 rows only
    paths["tp"] = timed("tp", tp_path, dev, card)  # the ranks' summed launches; K6 with cur_ks only here
    paths["pp ep train"] = timed("pp ep train", pp_ep_train_path, dev, card)  # the serving runs' summed launches
    res_act = timed("act kernels", act_kernel_phases, dev, card)
    act_counts = timed("act", act_path, dev, card)  # K7's relu / silu / identity launches only, by code
    timed("examples", examples_path, dev, card)  # its launches are checked and printed per script

    # name: (source, TPU kernel it replaces, the dtype whose times are reported, its launches over the main paths;
    # the shapes are GPT-2's for K1-K4 and the fused decode step, Whisper's for K5 and the fused cross step,
    # T5-base's for the biased K2, the untied K4 and the T5 variant of the fused cross step)
    def total(name):
        return sum(counts[name] for counts in paths.values())

    k7_src = "decode_step_kernel.cuh"  # K7's kernel (decode_step.cu is its C interface)
    l2 = f"_l{SPEC_DRAFT_LAYERS}"
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
        # K7 rows of B <= 8 (one row group); the rows above it below
        "fused_decode_step": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                              total("fused_decode_step") - total("fused_decode_step_headless")
                              - sum(total(f"fused_decode_step_{k}") - total(f"fused_decode_step_headless_{k}")
                                    for k in ("b16", "b32"))),
        "fused_cross_decode_step": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                    paths["whisper"]["fused_cross_decode_step"]
                                    + paths["pretrained"]["fused_cross_decode_step"]),
        "fused_cross_decode_step_t5": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                       paths["t5"]["fused_cross_decode_step"]),
        # int8 serving: K6 on the per-op int8 step's path, K7's variants on the int8 serving paths
        "int8_kv": ("int8_kv.cu", "pytorch_models_tpu/ops/int8_kv.py:353", "bfloat16", k6_path["int8_kv"]),
        # K6 scoring the current key with a tensor-parallel rank's full-width scale (cur_ks), on the tp int8 pool
        "int8_decode_attention_tp_scale": ("int8_kv.cu", "pytorch_models_tpu/ops/int8_kv.py:353", "bfloat16",
                                           paths["tp"]["int8_decode_attention_tp_scale"]),
        "fused_decode_step_int8": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                   i8["gpt2"]["fused_decode_step_kv_int8"] - i8["gpt2"]["fused_decode_step_a8"]),
        "fused_decode_step_a8": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                 i8["gpt2"]["fused_decode_step_a8"]),
        "fused_cross_decode_step_int8": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                         i8["whisper"]["fused_cross_decode_step_kv_int8"]),
        "fused_cross_decode_step_t5_a8": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                          i8["t5"]["fused_cross_decode_step_a8"]),
        "fused_decode_step_embed": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                    i8["gpt2"]["fused_decode_step_embed"]),
        # the headless step (no final norm, no head) on the sampled and beam paths
        "fused_decode_step_headless": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                       total("fused_decode_step_headless") - total("fused_decode_step_headless_b16")
                                       - total("fused_decode_step_headless_b32")),
        "fused_cross_decode_step_headless": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397",
                                             "bfloat16", paths["beam whisper"]["fused_cross_decode_step_headless"]),
        "fused_cross_decode_step_t5_headless": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397",
                                                "bfloat16", paths["beam t5"]["fused_cross_decode_step_headless"]),
        # above one row group (K7's rows 9-32; timed at the batch named): GPT-2 with its head at 17-32 rows (the
        # B=32 batch and the CB pool, int8 pool aside), headless at 9-16 (beams G=4 x W=4, 16 samples); Whisper
        # at 9-16 (the B=16 batch); T5 at 17-32 (the B=32 batch); the int8 CB pool's int8 self-KV at 17-32
        "fused_decode_step_b32": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                  total("fused_decode_step_b32") - total("fused_decode_step_headless_b32")
                                  - total("fused_decode_step_kv_int8_b32")),
        "fused_decode_step_headless_b16": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359",
                                           "bfloat16", total("fused_decode_step_headless_b16")),
        # Whisper at 9-16 rows: the B=16 batch, and the pool of 16 (its int8 pool aside)
        "fused_cross_decode_step_b16": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397",
                                        "bfloat16", paths["batch whisper"]["fused_cross_decode_step_b16"]
                                        + paths["cb whisper"]["fused_cross_decode_step_b16"]
                                        - paths["cb whisper"]["fused_cross_decode_step_kv_int8_b16"]),
        # T5 at 17-32 rows: the B=32 batch, and the T5 pool with per-row pads (its int8 pool aside)
        "fused_cross_decode_step_t5_b32": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397",
                                           "bfloat16", paths["batch t5"]["fused_cross_decode_step_b32"]
                                           + paths["cb t5"]["fused_cross_decode_step_b32"]
                                           - paths["cb t5"]["fused_cross_decode_step_kv_int8_b32"]),
        "fused_decode_step_int8_b32": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                       paths["cb"]["fused_decode_step_kv_int8_b32"]),
        # the Whisper pools: cross at 17-32 rows (the pool of 32), int8 self + cross KV at 9-16 (the int8 pool)
        "fused_cross_decode_step_b32": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                        paths["cb whisper"]["fused_cross_decode_step_b32"]),
        "fused_cross_decode_step_int8_b16": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397",
                                             "bfloat16", paths["cb whisper"]["fused_cross_decode_step_kv_int8_b16"]),
        # at one row: the speculative drafts, the whole stack (the identical draft) and its first
        # SPEC_DRAFT_LAYERS layers (the truncated draft); GPT-2 also headless (the sampled drafts)
        "fused_decode_step_b1": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                 spec["spec gpt2"]["fused_decode_step_b1"]),
        f"fused_decode_step_b1{l2}": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                      spec["spec gpt2"][f"fused_decode_step_b1{l2}"]
                                      + spec["spec gpt2 batch"][f"fused_decode_step_b1{l2}"]),
        "fused_decode_step_headless_b1": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                          spec["spec gpt2 sample"]["fused_decode_step_headless_b1"]),
        "fused_cross_decode_step_b1": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                       spec["spec whisper"]["fused_cross_decode_step_b1"]),
        f"fused_cross_decode_step_b1{l2}": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                            spec["spec whisper"][f"fused_cross_decode_step_b1{l2}"]),
        "fused_cross_decode_step_t5_b1": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                          spec["spec t5"]["fused_cross_decode_step_t5_b1"]),
        f"fused_cross_decode_step_t5_b1{l2}": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                               spec["spec t5"][f"fused_cross_decode_step_t5_b1{l2}"]),
        # over row slices (batches above one launch's 32 rows, or a width whose plan refuses the batch whole): GPT-2
        # with its head (phase "k7 slices" B=64 and its pool of 64, phase "main"'s B=33) and headless (beams of 36
        # rows); Whisper large-v3 at B=16 and T5-base at B=48 (phase "k7 slices"); each launch also counts under its
        # own rows above
        "fused_decode_step_sliced": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                     total("fused_decode_step_sliced") - total("fused_decode_step_headless_sliced")),
        "fused_decode_step_headless_sliced": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                              total("fused_decode_step_headless_sliced")),
        "fused_cross_decode_step_sliced": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                           paths["slices whisper"]["fused_cross_decode_step_sliced"]),
        "fused_cross_decode_step_t5_sliced": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1397", "bfloat16",
                                              paths["slices t5"]["fused_cross_decode_step_sliced"]),
        # the MLP activations beyond GELU: K7 (GPT-2 small, B=8) with relu, silu and identity on phase "act"'s path
        **{f"fused_decode_step_{a}": (k7_src, "pytorch_models_tpu/ops/decode_step.py:1359", "bfloat16",
                                      act_counts[a]["fused_decode_step"]) for a in K7_ACTS},
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
                 "fused_cross_decode_step_t5_headless", "fused_decode_step_b32", "fused_decode_step_headless_b16",
                 "fused_cross_decode_step_b16", "fused_cross_decode_step_t5_b32", "fused_cross_decode_step_b32",
                 "fused_decode_step_b1", f"fused_decode_step_b1{l2}", "fused_decode_step_headless_b1",
                 "fused_cross_decode_step_b1", f"fused_cross_decode_step_b1{l2}", "fused_cross_decode_step_t5_b1",
                 f"fused_cross_decode_step_t5_b1{l2}", *(f"fused_decode_step_{a}" for a in K7_ACTS), *SLICED_ENTRIES):
        limits[name] = {dn: list(DS_TOL[dn]) for dn in DS_TOL}
    for name in ("fused_decode_step_int8", "fused_decode_step_a8", "fused_cross_decode_step_int8",
                 "fused_cross_decode_step_t5_a8", "fused_decode_step_int8_b32",
                 "fused_cross_decode_step_int8_b16"):  # on x after each layer
        limits[name] = {dn: list(I8_LAYER_TOL[dn]) for dn in I8_LAYER_TOL}
    results = (res, res_e, res_w, res_t5, res_k7, res_i8, res_i8k7, res_act, res_sl)
    entries = []
    for name, (src, replaces, timed, launches) in meta.items():
        if launches <= 0:
            raise AssertionError(f"{name}: no launch on its main path")
        err = max(v["err"] for r in results for (k, _), v in r.items() if k == name)
        rec = next(r[(name, timed)] for r in results if (name, timed) in r)
        # other shapes a kernel serves on the main paths (K1 at BERT's and DETR's, K4 at GPT-1's vocab), each dtype
        rows = [row for r in results for (k, _), v in r.items() if k == name for row in v.get("rows", [])]
        entries.append({"name": name, "route": "cuda", "source": f"pytorch_models_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": launches, "max_abs_err": err, "limit": limits[name],
                        **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                        **{k: rec[k] for k in ("two_gathers_ms", "embedding_add_ms", "launch_floor_ms",
                                               "head_matmul_ms", "per_op_ms", "slice_bound_ms", "launches_a_step")
                           if k in rec},
                        **({"rows": rows} if rows else {})})
    print(f"phase total: {time.perf_counter() - t0:.1f} s, the kernels' build "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'} s of it; seconds by phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in clocks.items()) + f" [{card}]")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
