"""Scaled dot-product attention and the kernel dispatch flags (PyTorch port
of ``pytorch_models_tpu/ops/attention.py``).

The head-split entry point (:func:`sdpa`) is plain PyTorch. The hand-written
CUDA kernels (encoder_attention, decode_attention, greedy_head, gather,
decode_step) are selected UPSTREAM in transformer.py and the generators on
merged-head layouts, through the flags below.

Each flag: ``None`` = auto, which means "the tensor lies on a CUDA device"
(and, for the attention kernels, "the shape is one the kernel serves"), and
no input is one that autograd differentiates (``_build.needs_grad``: no
kernel has a backward, so a training forward takes the plain path);
``True`` forces the kernel's wrapper (on a CPU tensor the wrapper runs the
kernel's plain version, which is how the CPU tests reach the dispatch);
``False`` forces the plain PyTorch path of the JAX package's XLA route
(for ``USE_FUSED_STEP``: the per-op decode step, whose own kernels follow
their own flags).
"""

from __future__ import annotations

import math

import torch

from . import _build

# single-position self-attention decode (ops/decode_attention.py)
USE_DECODE_KERNEL: bool | None = None
# merged-head dense/causal attention with no bias (ops/encoder_attention.py)
USE_ENCODER_KERNEL: bool | None = None
# argmax(x @ emb.T), or argmax(x @ w) over an untied (d, V) classifier,
# without the (B, V) logits (ops/greedy_head.py); auto engages at batch >= 4
# (the JAX package's rule) up to the measured crossovers in use_greedy_head.
USE_GREEDY_HEAD: bool | None = None
# the whole greedy decode step in one kernel (ops/decode_step.py): layer
# stack [+ cross-attention] + final norm + greedy head. Auto takes
# it for CUDA tensors, as the JAX package takes it on its TPU, at any batch
# (over row slices above one launch's rows); a model the kernel does not
# serve (decode_step.fused_step_eligible) decodes per-op.
USE_FUSED_STEP: bool | None = None
# w8a8 decode (ops/decode_step.py ``a8=True``): when the fused step streams
# int8 weights (``model.quantize_int8()``), each phase also quantizes its
# input per row and multiplies int8 x int8 -> int32, and the greedy head
# runs over a per-vocab-row int8 table. Opt-in, as in the JAX package: it
# changes numerics, so int8 models keep w8a16 unless this is True.
USE_A8_DECODE: bool = False
# in-kernel embed phase of the fused step (ops/decode_step.py ``emb=``):
# layer 0 reads ``tok_emb[id] + pos_emb[p]`` itself instead of taking ``x``
# from two gather launches. None = auto, which is off, as in the JAX package
# (measured negative on its TPU); True forces it on.
USE_FUSED_EMBED: bool | None = None
# int8 self-KV caches for the fused step (ops/decode_step.py ``kv_scales=``,
# the arithmetic of ops/int8_kv.py): the prefilled cache is quantized once per
# key, and each step writes its K/V quantized. Opt-in: it changes numerics.
USE_INT8_KV: bool = False
# int8 cross-KV caches (``kv_scales_x=``): Whisper's and T5's write-once
# encoder caches, quantized once for the decode loop. Opt-in.
USE_INT8_KV_CROSS: bool = False


def _on_cuda(t: torch.Tensor) -> bool:
    """Takes the place of the JAX package's ``_on_tpu()``: the kernels run
    where the data lies."""
    return t.is_cuda


# the largest batch at which the greedy head kernel beats the head matmul +
# argmax, by (dtype, tied). On an H100 80GB (700 W; kernel_ab.py --head-mel,
# GPT-2's tied head V=50257 and T5's untied V=32128, d=768) the kernel took,
# against the matmul: fp32 tied 77.3 vs 98.3 us at B=16, 121.1 vs 97.1 at
# B=24; fp32 untied 52.2 vs 64.6 at B=16, 75.1 vs 64.0 at B=24; bf16 untied
# 23.7 vs 31.5 at B=32, 33.1 vs 32.4 at B=48, 48.1 vs 34.2 at B=96; bf16 tied
# won at every batch up to 200 (122.8 vs 221.1 us).
GREEDY_HEAD_MAX_BATCH = {(torch.float32, True): 16, (torch.float32, False): 16, (torch.bfloat16, False): 32}


def use_greedy_head(batch: int, w: torch.Tensor, tied: bool) -> bool:
    """Gate for the greedy head over the head weight ``w``: a tied ``(V,
    d)`` embedding or an untied ``(d, V)`` classifier. Auto takes the kernel
    on a CUDA head it serves (``greedy_head_fits``) from 4 rows up to the
    crossover of ``GREEDY_HEAD_MAX_BATCH``; else the head matmul + argmax."""
    if USE_GREEDY_HEAD is not None:
        return USE_GREEDY_HEAD
    if batch < 4 or not _on_cuda(w) or _build.needs_grad(w):
        return False
    from .greedy_head import greedy_head_fits

    return greedy_head_fits(w) and batch <= GREEDY_HEAD_MAX_BATCH.get((w.dtype, tied), batch)


def use_a8_decode(packed_wqkv_dtype: torch.dtype) -> bool:
    """True only when the mode is on AND the packed weights are int8."""
    return USE_A8_DECODE and packed_wqkv_dtype == torch.int8


def use_fused_embed(batch: int) -> bool:
    return bool(USE_FUSED_EMBED)


def _int8_kv_gate(flag: bool, batch: int) -> bool:
    """The JAX package's int8-KV batch rule (a batch of at most 8 rows, or a
    multiple of 8), kept because it decides routing."""
    return flag and (batch <= 8 or batch % 8 == 0)


def use_int8_kv(batch: int) -> bool:
    return _int8_kv_gate(USE_INT8_KV, batch)


def use_int8_kv_cross(batch: int) -> bool:
    return _int8_kv_gate(USE_INT8_KV_CROSS, batch)


def use_fused_step(t: torch.Tensor) -> bool:
    """Gate for the fused decode step on the model's tensor ``t``."""
    return _on_cuda(t) and not _build.needs_grad(t) if USE_FUSED_STEP is None else bool(USE_FUSED_STEP)


def use_decode_kernel(t: torch.Tensor, n_heads: int, *inputs: torch.Tensor) -> bool:
    """Gate for the decode kernel on the merged-head cache ``t`` and the
    kernel's other ``inputs``. Auto takes it on a CUDA tensor whose shape the
    kernel serves (``decode_attention_fits``) when autograd differentiates
    none of them; any other call goes to :func:`sdpa`, as in the JAX package.
    A forced ``True`` reaches the wrapper, which raises for a shape it does
    not serve or an input that requires grad."""
    if USE_DECODE_KERNEL is not None:
        return USE_DECODE_KERNEL
    if not _on_cuda(t) or _build.needs_grad(t, *inputs):
        return False
    from .decode_attention import decode_attention_fits

    return decode_attention_fits(t, n_heads)


def use_encoder_kernel(q_m: torch.Tensor, n_heads: int, attn_bias: torch.Tensor | None = None,
                       *kv: torch.Tensor) -> bool:
    """Gate for merged-head encoder attention on (..., L, H*D) projections
    ``q_m`` [and ``kv``]. The kernel takes no additive bias: a call with one
    (T5's rel-pos and pad biases) goes to :func:`sdpa` whatever the flag
    says, as in the JAX package. Auto takes the kernel on a CUDA tensor whose
    shape it serves (``encoder_attention_eligible``) when autograd
    differentiates none of the projections, else :func:`sdpa` (a training
    forward); a forced ``True`` reaches the wrapper, which raises for a shape
    it does not serve or an input that requires grad."""
    if attn_bias is not None:
        return False
    if USE_ENCODER_KERNEL is not None:
        return USE_ENCODER_KERNEL
    if not _on_cuda(q_m) or _build.needs_grad(q_m, *kv):
        return False
    from .encoder_attention import encoder_attention_eligible

    return encoder_attention_eligible(q_m, n_heads)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attn_bias: torch.Tensor | None = None,
         causal: bool = False) -> torch.Tensor:
    """Attention over ``(..., n_heads, L, head_dim)`` tensors.

    ``attn_bias`` is an additive mask/bias broadcastable to ``(..., H, Lq, Lk)``.
    ``causal`` masks key positions ``j > i`` (top-left aligned).

    fp32 inputs get an fp32 softmax. bf16 inputs keep the scores in bf16 but
    accumulate the softmax normaliser in fp32 — the JAX package's rule
    (attention.py:196-220), so numerics do not jump at kernel boundaries.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    acc_dtype = torch.float32 if q.dtype == torch.float32 else q.dtype
    logits = torch.matmul(q, k.transpose(-1, -2)).to(acc_dtype)
    logits = logits * torch.tensor(scale, dtype=acc_dtype)
    if attn_bias is not None:
        logits = logits + attn_bias.to(acc_dtype)
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if acc_dtype == torch.float32:
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
    else:
        m = logits.amax(-1, keepdim=True)
        e = torch.exp(logits - m)
        denom = e.float().sum(-1, keepdim=True)
        probs = (e.float() / denom).to(q.dtype)
    return torch.matmul(probs, v)
