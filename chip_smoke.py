#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                   # what the checks need
    python3 chip_smoke.py --profile DIR     # and torch.profiler summaries in DIR

Builds the port's CUDA kernels from ``pytorch_models_tpu_torch/csrc/``,
holds each kernel against its plain PyTorch version at the GPT-2 and
Whisper serving shapes, then drives the port's two main paths and checks
that each went through its kernels:

- GPT-2 small at full width (12 layers, d_model 768, vocab 50257, context
  1024, random weights from a seed) through
  ``DecoderGenerator.generate_tokens_batch`` and ``score_tokens_batch``;
- Whisper-base at full width (8 + 8 layers, d_model 512, vocab 51865, 80
  mels, random weights from a seed) transcribing eight 5-30 s waveforms
  through ``WhisperGenerator.transcribe_tokens_batch`` and
  ``transcribe_tokens`` (log-mel kernel, conv stem, encoder, cross-attention
  decoder).

Prints one line per phase; the line before the last is a JSON summary of
the kernels (``max_abs_err`` is the largest |kernel - plain| output over
every shape and dtype checked; for the greedy head, whose outputs are ids,
it is the largest score regret ``s[plain id] - s[kernel id]``; for the
log-mel kernel it is taken where the plain value is at least its global
max - 8, the part the Whisper frontend keeps; ``launches`` sums both main
paths), and the last line is
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
PROMPT_LENS = (5, 12, 23, 31, 40, 47, 55, 60)
# kernel vs plain version on the same inputs, elementwise |got - ref| <=
# atol + rtol * |ref|. fp32 differs by summation order only (readings on an
# H100: 5.96e-7 encoder, 2.98e-7 decode attention). Both bf16 paths keep fp32
# inside and round once at the end, so an output may land one bf16 step of its
# own value (at most 2^-7 relative) apart (readings: 1.95e-3 encoder,
# 3.8e-6 decode attention).
TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
SCORE_TOL = 1e-3  # fp32 log-probs after 12 layers: attention sums differ in order
# log10 mel power, log-mel kernel vs plain where the plain value is at least
# its global max - 8 (what the Whisper frontend keeps): both fp32, summed in
# other orders. At this input (B=8 x 30 s of noise, a tone and silence) the
# plain version itself departs from a float64 reference by up to 2.1e-4
# (a CPU reading); the kernel is allowed ten times that.
MEL_TOL = 2e-3

# Whisper-base main path: <|startoftranscript|><|en|><|transcribe|><|notimestamps|>
W_INIT = [50258, 50259, 50359, 50363]
W_EOT = 50257
W_SECONDS = (5.0, 8.5, 12.0, 15.5, 19.0, 22.5, 26.0, 30.0)
W_SAMPLES = 30 * 16_000


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fns, iters: int) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``fns`` (several
    input copies keep a cache-sized working set out of L2), after warm-up,
    timed with CUDA events."""
    import torch

    for f in fns:
        f()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ab_ms(kernel_fns, plain_fns, iters: int) -> tuple[float, float]:
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1 = _time_ms(plain_fns, iters)
    k1 = _time_ms(kernel_fns, iters)
    k2 = _time_ms(kernel_fns, iters)
    p2 = _time_ms(plain_fns, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


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


def _check_greedy(name: str, x, emb, tie: int) -> tuple[float, int]:
    """Greedy head kernel vs plain on ``x`` (B, d), ``emb`` (V, d) whose rows
    ``tie`` and a later one hold the same best score for batch row 0.

    Measured error: the score regret ``s[b, plain id] - s[b, kernel id]``
    over all rows, held to the fp32 summation-order noise of a score (fp32)
    or one bf16 step of the top score (bf16). Ids must be equal where the
    top-2 gap exceeds that, and the tie must go to the lowest index.
    Returns (max |regret|, rows with a decided top-2)."""
    import torch

    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax_tied, greedy_argmax_tied_plain

    got = greedy_argmax_tied(x, emb)
    ref = greedy_argmax_tied_plain(x, emb)
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


def kernel_phases(dev, card: str) -> dict:
    """Each kernel vs its plain version at the slice's shapes, fp32 and bf16."""
    import torch

    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention, encoder_attention_plain
    from pytorch_models_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax_tied, greedy_argmax_tied_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        tol = TOL[dn]

        # K1: B=2, L in {7, 197, 1024}, dense and causal, H*D = 768
        err = 0.0
        for L in (7, 197, 1024):
            q, k, v = (rnd(2, L, 768, dtype=dtype) for _ in range(3))
            for causal in (False, True):
                err = max(err, _check_close(f"encoder_attention L={L} causal={causal} {dn}",
                                            encoder_attention(q, k, v, 12, causal),
                                            encoder_attention_plain(q, k, v, 12, causal), tol))
        k1_ms, k1_plain = _ab_ms([lambda: encoder_attention(q, k, v, 12, True)],
                                 [lambda: encoder_attention_plain(q, k, v, 12, True)], 20)
        res[("encoder_attention", dn)] = (err, k1_ms, k1_plain)
        print(f"phase kernel encoder_attention {dn}: B=2 L=7,197,1024 dense+causal max_abs_err={err:.3g} "
              f"(atol, rtol)={tol} | causal L=1024 kernel {k1_ms * 1e3:.1f} us, plain {k1_plain * 1e3:.1f} us [{card}]")

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
        res[("decode_attention", dn)] = (err, k2_ms, k2_plain)
        print(f"phase kernel decode_attention {dn}: B=8 L=1024 H=12 mixed pads/ends + empty row "
              f"max_abs_err={err:.3g} (atol, rtol)={tol} | kernel {k2_ms * 1e3:.1f} us, plain {k2_plain * 1e3:.1f} us [{card}]")

        # K3: V = 50257 and 1024, out-of-range ids, exact
        err = 0.0
        for V in (1024, 50257):
            table = rnd(V, 768, dtype=dtype)
            idx = torch.tensor([0, V - 1, -5, V + 17, 3, 3, 1000, 42], device=dev)
            err = max(err, _check_close(f"gather_rows V={V} {dn}", gather_rows(table, idx),
                                        gather_rows_plain(table, idx), (0.0, 0.0)))
        k3_ms, k3_plain = _ab_ms([lambda: gather_rows(table, idx)], [lambda: gather_rows_plain(table, idx)], 200)
        res[("gather_rows", dn)] = (err, k3_ms, k3_plain)
        print(f"phase kernel gather_rows {dn}: V=1024,50257 N=8 ids incl. out-of-range: max_abs_err={err} (exact) | "
              f"kernel {k3_ms * 1e3:.1f} us, plain {k3_plain * 1e3:.1f} us [{card}]")

        # K4: B=8, V=50257, forced tie at rows 7 and 50000 for batch row 0
        x, emb = rnd(8, 768, dtype=dtype), rnd(50257, 768, dtype=dtype)
        emb[7] = emb[50000] = x[0] * 4
        err, decided = _check_greedy(f"greedy_argmax_tied {dn}", x, emb, 7)
        k4_ms, k4_plain = _ab_ms([lambda: greedy_argmax_tied(x, emb)], [lambda: greedy_argmax_tied_plain(x, emb)], 50)
        res[("greedy_argmax_tied", dn)] = (err, k4_ms, k4_plain)
        # what the batch gate (ops/attention.py use_greedy_head) chooses between:
        # the kernel, or the model's own head matmul in its dtype + argmax
        head = {}
        for nb in (1, 8):
            xb = x[:nb].contiguous()
            head[nb] = _ab_ms([lambda: greedy_argmax_tied(xb, emb)],
                              [lambda: torch.argmax(torch.matmul(xb, emb.t()), dim=-1)], 50)
        print(f"phase kernel greedy_argmax_tied {dn}: B=8 V=50257 tie->lowest ok, ids equal on "
              f"{decided}/8 rows with top-2 gap > tol, max score regret {err:.3g} (tol per row: "
              f"{'1e-3' if dtype == torch.float32 else 'one bf16 step of the top score'}) | kernel "
              f"{k4_ms * 1e3:.1f} us, plain {k4_plain * 1e3:.1f} us; vs head matmul + argmax: "
              + ", ".join(f"B={nb} kernel {km * 1e3:.1f} us, head {hm * 1e3:.1f} us" for nb, (km, hm) in head.items())
              + f" [{card}]")
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

    from pytorch_models_tpu_torch.audio2text import WhisperPreprocessor
    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention, encoder_attention_plain
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax_tied, greedy_argmax_tied_plain
    from pytorch_models_tpu_torch.ops.mel import log_mel_spectrogram, log_mel_spectrogram_plain

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
    res[("log_mel_spectrogram", "float32")] = (max(err, pre_err), k5_ms, k5_plain)
    print(f"phase kernel log_mel_spectrogram float32: B=8 x 30 s (3001 frames), n_mels 80/128, -inf frames equal "
          f"({n_inf[80]}/{n_inf[128]} values), max |kernel - plain| where plain >= max-8: {err:.3g}, preprocessor "
          f"{pre_err:.3g} (tol {MEL_TOL}, {MEL_TOL / 4}) | n_mels 80 kernel {k5_ms * 1e3:.1f} us, plain "
          f"{k5_plain * 1e3:.1f} us [{card}]")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        tol = TOL[dn]
        # K1: the encoder's dense L=1500, and teacher-forced cross Lq=448, Lk=1500
        q, k, v = (rnd(8, 1500, 512, dtype=dtype) for _ in range(3))
        qx = rnd(8, 448, 512, dtype=dtype)
        e1 = _check_close(f"encoder_attention dense L=1500 {dn}", encoder_attention(q, k, v, 8),
                          encoder_attention_plain(q, k, v, 8), tol)
        e2 = _check_close(f"encoder_attention cross 448x1500 {dn}", encoder_attention(qx, k, v, 8),
                          encoder_attention_plain(qx, k, v, 8), tol)
        dense = _ab_ms([lambda: encoder_attention(q, k, v, 8)], [lambda: encoder_attention_plain(q, k, v, 8)], 10)
        cross = _ab_ms([lambda: encoder_attention(qx, k, v, 8)], [lambda: encoder_attention_plain(qx, k, v, 8)], 10)
        res[("encoder_attention", dn)] = (max(e1, e2), *dense)
        print(f"phase kernel encoder_attention {dn} (Whisper): B=8 H=8 dense L=1500 max_abs_err={e1:.3g}, cross "
              f"Lq=448 Lk=1500 {e2:.3g} (atol, rtol)={tol} | dense kernel {dense[0] * 1e3:.1f} us, plain "
              f"{dense[1] * 1e3:.1f} us; cross kernel {cross[0] * 1e3:.1f} us, plain {cross[1] * 1e3:.1f} us [{card}]")

        # K2: one query per row over the write-once cross cache, ends = len
        ends = torch.full((8,), 1500, dtype=torch.int32, device=dev)
        copies = [(rnd(8, 1, 512, dtype=dtype), rnd(8, 1536, 512, dtype=dtype), rnd(8, 1536, 512, dtype=dtype))
                  for _ in range(4)]
        e = _check_close(f"decode_attention cross {dn}", decode_attention(*copies[0], ends, 8),
                         decode_attention_plain(*copies[0], ends, 8), tol)
        k2 = _ab_ms([lambda c=c: decode_attention(*c, ends, 8) for c in copies],
                    [lambda c=c: decode_attention_plain(*c, ends, 8) for c in copies], 50)
        res[("decode_attention", dn)] = (e, *k2)
        print(f"phase kernel decode_attention {dn} (Whisper cross): B=8 L=1536 H=8 ends=1500 max_abs_err={e:.3g} "
              f"(atol, rtol)={tol} | kernel {k2[0] * 1e3:.1f} us, plain {k2[1] * 1e3:.1f} us [{card}]")

        # K4: the tied head at V=51865, d=512
        x, emb = rnd(8, 512, dtype=dtype), rnd(51865, 512, dtype=dtype)
        emb[11] = emb[51000] = x[0] * 4
        e, decided = _check_greedy(f"greedy_argmax_tied (Whisper) {dn}", x, emb, 11)
        k4 = _ab_ms([lambda: greedy_argmax_tied(x, emb)], [lambda: greedy_argmax_tied_plain(x, emb)], 50)
        res[("greedy_argmax_tied", dn)] = (e, *k4)
        print(f"phase kernel greedy_argmax_tied {dn} (Whisper): B=8 V=51865 d=512 tie->lowest ok, ids equal on "
              f"{decided}/8 decided rows, max score regret {e:.3g} | kernel {k4[0] * 1e3:.1f} us, plain "
              f"{k4[1] * 1e3:.1f} us [{card}]")
    torch.cuda.synchronize()
    return res


class _Tok:
    eos_token_id = None


def _set_flags(on: bool | None) -> None:
    from pytorch_models_tpu_torch.ops import attention as attn
    from pytorch_models_tpu_torch.ops import gather, mel

    attn.USE_DECODE_KERNEL = attn.USE_ENCODER_KERNEL = attn.USE_GREEDY_HEAD = gather.USE_GATHER_KERNEL = on
    mel.USE_MEL_KERNEL = on


def _kernels() -> dict:
    """Every kernel wrapper of the port, by name (each carries a launch count)."""
    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention
    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention
    from pytorch_models_tpu_torch.ops.gather import gather_rows
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax_tied
    from pytorch_models_tpu_torch.ops.mel import log_mel_spectrogram

    return {"encoder_attention": encoder_attention, "decode_attention": decode_attention,
            "gather_rows": gather_rows, "greedy_argmax_tied": greedy_argmax_tied,
            "log_mel_spectrogram": log_mel_spectrogram}


def _event_ms(fn) -> tuple[float, object]:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def main_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """GPT-2 small at full width through the port's entry points; with
    ``profile_dir``, then a profiled bf16 generation (:func:`profile_phase`)."""
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
          f"built from seed {SEED} on {dev} "
          f"in {time.perf_counter() - t0:.1f} s")

    # plain references first (every USE_* flag False: no kernel launches)
    _set_flags(False)
    plain32 = gen.generate_tokens_batch(prompts, max_tokens=N_NEW)
    plain_scores = gen.score_tokens_batch(seqs)

    # the main path with the kernels (flags auto = on for CUDA tensors)
    _set_flags(None)
    for fn in kernels.values():
        fn.launches = 0
    out32 = gen.generate_tokens_batch(prompts, max_tokens=N_NEW)
    scores = gen.score_tokens_batch(seqs)
    model.to_bf16()
    out16 = gen.generate_tokens_batch(prompts, max_tokens=N_NEW)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}

    for row, p in zip(out32, prompts):
        if row[:len(p)] != p or len(row) != len(p) + N_NEW or not all(0 <= t < 50257 for t in row):
            raise AssertionError("fp32 generation: malformed row")
    if out32 != plain32:
        raise AssertionError("fp32 generation with kernels differs from the plain path")
    print(f"phase main fp32 generate_tokens_batch: {len(prompts)} prompts of {min(PROMPT_LENS)}-{max(PROMPT_LENS)} tokens, "
          f"{N_NEW} new each: tokens identical to the plain path (every USE_* flag False)")

    err = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) for a, b in zip(scores, plain_scores))
    if not all(np.isfinite(s).all() and len(s) == 1023 for s in scores) or err > SCORE_TOL:
        raise AssertionError(f"score_tokens_batch: max |kernel - plain| = {err} > {SCORE_TOL}")
    print(f"phase main fp32 score_tokens_batch: 2 x 1024 tokens, max |kernel - plain| log-prob = {err:.3g} "
          f"(tol {SCORE_TOL})")

    _set_flags(False)
    plain16 = gen.generate_tokens_batch(prompts, max_tokens=N_NEW)
    _set_flags(None)
    new16 = [a[len(p):] for a, p in zip(out16, prompts)]
    agree = np.mean([x == y for a, b, p in zip(out16, plain16, prompts) for x, y in zip(a[len(p):], b[len(p):])])
    if not all(len(a) == N_NEW and all(0 <= t < 50257 for t in a) for a in new16):
        raise AssertionError("bf16 generation: malformed row")
    print(f"phase main bf16 generate_tokens_batch: {agree:.4f} of new tokens agree with the plain bf16 path")
    print("phase main launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    missing = [k for k, v in launches.items() if v <= 0 and k != "log_mel_spectrogram"]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

    # bf16 end-to-end rate, kernels vs plain in turns
    n_tok = len(prompts) * N_NEW
    times = {}
    for label, flag in (("plain", False), ("kernels", None), ("kernels", None), ("plain", False)):
        _set_flags(flag)
        ms, _ = _event_ms(lambda: gen.generate_tokens_batch(prompts, max_tokens=N_NEW))
        times.setdefault(label, []).append(ms)
    _set_flags(None)
    tps = {k: n_tok / (np.mean(v) / 1e3) for k, v in times.items()}
    print(f"phase time bf16 generate_tokens_batch B={len(prompts)} x {N_NEW} new: kernels {tps['kernels']:.1f} tok/s, "
          f"plain {tps['plain']:.1f} tok/s (prefill included, CUDA events) [{card}]")
    if profile_dir is not None:
        profile_phase(lambda: gen.generate_tokens_batch(prompts, max_tokens=N_NEW),
                      f"bf16 generate_tokens_batch B={len(prompts)} x {N_NEW} new, kernels on",
                      "profile_bf16_generate.json", profile_dir, card)
    return launches


def whisper_path(dev, card: str, profile_dir: str | None = None) -> dict:
    """Whisper-base at full width through the port's entry points: fp32
    batched and single transcription (kernels vs every flag False), bf16
    agreement, then a bf16 time phase; with ``profile_dir``, a profiled
    bf16 batch. Returns the launches of the fp32 and bf16 runs."""
    import torch

    from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
    from pytorch_models_tpu_torch.models.audio2text.whisper import whisper_encode

    kernels = _kernels()
    t0 = time.perf_counter()
    model = Whisper.from_openai("base", rng=SEED, device=dev)
    # Random weights at the init's scale make the tied greedy head repeat its
    # input token forever. Seeded position embeddings at scale 3 and the
    # layers' matrices at 4x the init's scale make the streams move, so token
    # identity compares something. At 6x the model amplifies fp32 rounding so
    # much that kernel and plain part at near-ties (top-2 logits 0.0136 apart
    # at 88.2, measured on an H100), which says nothing about the kernels.
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    pos = model.params["decoder"]["pos_embs"]
    model.params["decoder"]["pos_embs"] = 3.0 * torch.randn(pos.shape, generator=g, device=dev)
    for side in ("encoder", "decoder"):
        for lp in model.params[side]["layers"]:
            for block in lp.values():
                for lin in block.values():
                    if isinstance(lin, dict):
                        lin["w"] *= 4.0
    gen = WhisperGenerator(model)
    c = model.cfg
    audio = _waveforms(8, W_SECONDS, SEED + 4)
    wav = torch.from_numpy(audio).to(dev)
    max_tokens = len(W_INIT) + N_NEW
    print(f"phase whisper: Whisper({c.n_layers}+{c.n_layers} layers, {c.d_model}) vocab {c.vocab_size} "
          f"n_mels {c.n_mels} built from seed {SEED} on {dev} in {time.perf_counter() - t0:.1f} s; 8 waveforms of "
          f"{min(W_SECONDS)}-{max(W_SECONDS)} s, {len(W_INIT)} initial tokens, {N_NEW} new at most")

    def transcribe():
        return gen.transcribe_tokens_batch(wav, W_INIT, W_EOT, max_tokens)

    _set_flags(False)
    plain32 = transcribe()
    _set_flags(None)
    for fn in kernels.values():
        fn.launches = 0
    out32 = transcribe()
    single = gen.transcribe_tokens(audio[0][: int(W_SECONDS[0] * 16_000)], W_INIT, W_EOT, max_tokens)
    model.to_bf16()
    out16 = transcribe()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}

    for row in out32 + out16:
        if (row[:len(W_INIT)] != W_INIT or not len(W_INIT) < len(row) <= max_tokens
                or not all(0 <= t < c.vocab_size for t in row)):
            raise AssertionError(f"whisper transcription: malformed row {row}")
    if out32 != plain32:
        raise AssertionError("fp32 transcription with kernels differs from the plain path")
    if single != out32[0]:
        raise AssertionError("transcribe_tokens of row 0 differs from its row in the batch")
    distinct = [len(set(r[len(W_INIT):])) for r in out32]
    print(f"phase whisper fp32 transcribe_tokens_batch: tokens identical to the plain path (every USE_* flag "
          f"False); transcribe_tokens(row 0) equals batch row 0; generated lengths "
          f"{[len(r) - len(W_INIT) for r in out32]}, distinct tokens per row {distinct}")

    _set_flags(False)
    plain16 = transcribe()
    _set_flags(None)
    agree = np.mean([x == y for a, b in zip(out16, plain16) for x, y in zip(a[len(W_INIT):], b[len(W_INIT):])])
    print(f"phase whisper bf16 transcribe_tokens_batch: {agree:.4f} of generated tokens agree with the plain bf16 path")
    print("phase whisper launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"whisper path never launched: {missing}")

    # bf16 end-to-end rate, kernels vs plain in turns; then the kernels
    # path's stages (frontend, + encoder; the rest is the decode loop)
    times, n_gen = {}, {}
    for label, flag in (("plain", False), ("kernels", None), ("kernels", None), ("plain", False)):
        _set_flags(flag)
        ms, out = _event_ms(transcribe)
        times.setdefault(label, []).append(ms)
        n_gen[label] = sum(len(r) - len(W_INIT) for r in out)
    _set_flags(None)
    with torch.inference_mode():
        mel_ms, mel = _event_ms(lambda: gen.preprocessor(wav))
        enc_ms, _ = _event_ms(lambda: whisper_encode(model.params, c, gen.preprocessor(wav)))
    rate = {}
    for k, v in times.items():
        sec = np.mean(v) / 1e3
        rate[k] = (8 / sec, sum(W_SECONDS) / sec, n_gen[k] / sec, np.mean(v))
    print(f"phase time bf16 transcribe_tokens_batch B=8 (30 s segments holding {sum(W_SECONDS)} s of audio), CUDA "
          f"events: kernels {rate['kernels'][0]:.2f} segments/s, {rate['kernels'][1]:.1f} audio-s/s, "
          f"{rate['kernels'][2]:.1f} generated tok/s ({rate['kernels'][3]:.1f} ms, {n_gen['kernels']} tokens); plain "
          f"{rate['plain'][0]:.2f} segments/s, {rate['plain'][1]:.1f} audio-s/s, {rate['plain'][2]:.1f} tok/s "
          f"({rate['plain'][3]:.1f} ms, {n_gen['plain']} tokens); kernels path stages: log-mel {mel_ms:.2f} ms, "
          f"log-mel + encoder {enc_ms:.2f} ms [{card}]")
    if profile_dir is not None:
        profile_phase(transcribe, "bf16 transcribe_tokens_batch B=8, kernels on", "profile_bf16_whisper.json",
                      profile_dir, card)
        _set_flags(False)
        profile_phase(transcribe, "bf16 transcribe_tokens_batch B=8, every USE_* flag False",
                      "profile_bf16_whisper_plain.json", profile_dir, card)
        _set_flags(None)
    return launches


def profile_phase(fn, what: str, fname: str, out_dir: str, card: str) -> None:
    """One call of ``fn`` (after a warm-up call) under torch.profiler.

    Reads the Chrome trace: device busy time is the union of the kernel,
    memcpy and memset intervals, the span runs from the first to the last
    event of the trace, and the idle share is 1 - busy / span (profiler
    overhead included). Writes the summary, with device time per kernel
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
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
               "idle_share": 1 - busy / span, "device_events": len(dev_events),
               "by_name": [{"name": n, "calls": c, "ms": d / 1e3} for n, (c, d) in top]}
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"phase profile {what}: wall {wall_ms:.2f} ms profiled, trace span "
          f"{span / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle share {1 - busy / span:.4f}, "
          f"{len(dev_events)} device events; top: "
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

    res = kernel_phases(dev, card)
    res_w = whisper_kernel_phases(dev, card)
    launches = main_path(dev, card, args.profile)
    launches_w = whisper_path(dev, card, args.profile)

    # name: (source, TPU kernel it replaces, the dtype whose times are reported)
    meta = {
        "encoder_attention": ("encoder_attention.cu", "pytorch_models_tpu/ops/encoder_attention.py:166", "bfloat16"),
        "decode_attention": ("decode_attention.cu", "pytorch_models_tpu/ops/decode_attention.py:193", "bfloat16"),
        "gather_rows": ("gather.cu", "pytorch_models_tpu/ops/gather.py:87", "bfloat16"),
        "greedy_argmax_tied": ("greedy_head.cu", "pytorch_models_tpu/ops/greedy_head.py:85", "bfloat16"),
        "log_mel_spectrogram": ("mel.cu", "pytorch_models_tpu/ops/mel.py:66", "float32"),
    }
    entries = []
    for name, (src, replaces, timed) in meta.items():
        err = max(v[0] for r in (res, res_w) for (k, _), v in r.items() if k == name)
        _, ms, plain_ms = res.get((name, timed)) or res_w[(name, timed)]
        entries.append({"name": name, "route": "cuda", "source": f"pytorch_models_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": launches[name] + launches_w[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
