"""Elementary functional layers over parameter dicts (PyTorch port of
``pytorch_models_tpu/ops/layers.py``).

Conventions match the JAX package so parameters transfer unchanged:
- Linear: ``{"w": (in, out), "b": (out,)}``; ``y = x @ w + b``.
- LayerNorm: ``{"scale": (d,), "bias": (d,)}``; eps inside the sqrt like torch.
- Conv1d: ``{"w": (k, in / groups, out), "b": (out,)}`` over NLC inputs.
- Conv2d: ``{"w": (kh, kw, in / groups, out)`` (HWIO), ``"b": (out,)}`` over
  NHWC inputs.
- BatchNorm (inference): ``{"scale", "bias", "mean", "var"}`` over the
  channel-last axis; pools over NHWC inputs.

Activations mirror the reference's MLP table: "gelu" is exact (erf) GELU,
"approximate_gelu" is tanh GELU. A weight-only int8 linear (``{"w": {"w_q",
"w_s"}}``, ``utils.params.quantize_tree_int8``) dequantizes to bf16 and
multiplies in bf16, as the JAX package's does; with ``USE_A8_LINEAR`` it
quantizes its input per row and multiplies int8 x int8 -> int32 instead
(w8a8, :func:`_a8_matmul`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in fp32. bf16 serving takes tanh-GELU, the JAX
    package's default policy (its FAST_GELU_BF16): |tanh-GELU - erf-GELU|
    peaks near 5e-4, below bf16's own rounding."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


ACT_FNS = {
    "gelu": _gelu_exact,
    "approximate_gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "identity": lambda x: x,
}


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, bias: bool = True) -> dict:
    """torch-style default init: U(-1/sqrt(in), 1/sqrt(in)) for weight and bias
    (drawn on the CPU from ``gen``, so a seed gives the same weights on any device)."""
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": torch.empty(in_dim, out_dim).uniform_(-bound, bound, generator=gen)}
    if bias:
        p["b"] = torch.empty(out_dim).uniform_(-bound, bound, generator=gen)
    return p


def ln_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def linear_dtype(p: dict) -> torch.dtype:
    """The dtype :func:`linear` computes and returns in for these params."""
    w = p["w"]
    return torch.bfloat16 if isinstance(w, dict) else w.dtype


# w8a8 for the encoder and prefill matmuls (opt-in, as in the JAX package):
# with int8-quantized weights (``model.quantize_int8()``) AND this flag,
# linear() quantizes its input symmetrically per row and multiplies int8 x
# int8 -> int32 (``torch._int_mm``: cuBLAS's int8 product on the card, exact
# on both devices), then rescales once per (row, column). Attention scores,
# softmax and norms stay bf16 / fp32. The JAX package's ``A8_LINEAR``
# environment override (a TPU A/B switch) is not carried over.
USE_A8_LINEAR = False


def use_a8_linear() -> bool:
    return USE_A8_LINEAR


_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)  # JAX's fp32 ``1.0 / 127.0``
# cuBLAS's int8 product (``torch._int_mm`` on CUDA) takes more than 16 rows
# and inner and outer sizes that are multiples of 8
_INT_MM_MIN_ROWS, _INT_MM_MULTIPLE = 17, 8


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``(M, K) int8 @ (K, N) int8 -> (M, N) int32``; on the card at
    the shapes and layout cuBLAS takes (:func:`_int_mm_padded`)."""
    return _int_mm_padded(a, b) if a.is_cuda else torch._int_mm(a, b)


def _int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` over operands zero-padded to more than 16 rows and
    to inner and outer sizes that are multiples of 8 (zero rows and columns
    add nothing; the padding is cut off again), ``b`` given column-major,
    the layout cuBLAS's int8 product serves."""
    (m, k), n = a.shape, b.shape[1]
    mult = _INT_MM_MULTIPLE
    mp, kp, np_ = max(m, _INT_MM_MIN_ROWS), -(-k // mult) * mult, -(-n // mult) * mult
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    b = F.pad(b, (0, np_ - n, 0, kp - k)).t().contiguous().t()
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def _a8_matmul(x: torch.Tensor, wd: dict) -> torch.Tensor:
    """``x (..., d)`` float @ an int8 ``{"w_q", "w_s"}`` weight -> ``(...,
    out)`` fp32, the JAX package's arithmetic step for step: per-row absmax,
    ``r_s = where(absmax == 0, 1, absmax) * (1 / 127)``, ``x_q = clip(round(x /
    r_s), -127, 127)`` (round half to even), the exact int32 product, then
    ``acc * r_s * w_s`` in fp32, in that order."""
    x32 = x.float()
    absmax = x32.abs().amax(-1, keepdim=True)
    r_s = torch.where(absmax == 0, torch.ones_like(absmax), absmax) * _INV_127
    x_q = torch.round(x32 / r_s).clamp(-127, 127).to(torch.int8)
    w_q = wd["w_q"]
    acc = _int_mm(x_q.reshape(-1, w_q.shape[-2]), w_q)
    y = acc.reshape(*x.shape[:-1], w_q.shape[-1]).float()
    return y * r_s * wd["w_s"].float()


def linear(p: dict, x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w + b``. The compute dtype follows the PARAMS, not the input:
    bf16 params force bf16 compute even for fp32 inputs, and so do int8
    ones, which dequantize as ``w_q.bf16 * w_s.bf16`` (one bf16 rounding)
    first, or, with ``USE_A8_LINEAR``, run :func:`_a8_matmul` and round its
    fp32 result to bf16 before the bias is added in bf16. With ``out`` the
    result is written into it."""
    w = p["w"]
    if isinstance(w, dict):
        if use_a8_linear():  # w8a8: the int8 product, a bf16 result like the dequantized path's
            y = _a8_matmul(x, w).to(torch.bfloat16)
            if "b" in p:
                y += p["b"].to(y.dtype)
            return y if out is None else out.copy_(y)
        w = w["w_q"].to(torch.bfloat16) * w["w_s"].to(torch.bfloat16)  # weight-only int8: dequantize
    if x.is_floating_point() and x.dtype != w.dtype:
        x = x.to(w.dtype)
    y = torch.matmul(x, w, out=out)
    if "b" in p:
        y += p["b"].to(y.dtype)
    return y


def conv1d_init(gen: torch.Generator, k: int, in_ch: int, out_ch: int, bias: bool = True,
                groups: int = 1) -> dict:
    """torch-style default init of a ``(k, in / groups, out)`` kernel [and its
    bias]: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(k * in_ch // groups)
    p = {"w": torch.empty(k, in_ch // groups, out_ch).uniform_(-bound, bound, generator=gen)}
    if bias:
        p["b"] = torch.empty(out_ch).uniform_(-bound, bound, generator=gen)
    return p


def conv1d(p: dict, x: torch.Tensor, stride: int = 1, padding: int | tuple[int, int] = 0, groups: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """NLC conv over ``(B, L, in)`` with a ``(k, in / groups, out)`` kernel
    (the JAX package's layouts); ``padding`` is torch-style symmetric or an
    explicit ``(lo, hi)`` pair. As in :func:`linear`, the compute dtype
    follows the params; an int8 ``{"w_q", "w_s"}`` kernel dequantizes to bf16
    first."""
    w = p["w"]
    if isinstance(w, dict):  # weight-only int8
        w = w["w_q"].to(torch.bfloat16) * w["w_s"].to(torch.bfloat16)
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    lo, hi = (padding, padding) if isinstance(padding, int) else padding
    xc = x.transpose(1, 2)
    if lo != hi:
        xc, lo = F.pad(xc, (lo, hi)), 0
    b = p["b"].to(w.dtype) if "b" in p else None
    y = F.conv1d(xc, w.permute(2, 1, 0), b, stride=stride, padding=lo, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv2d_init(gen: torch.Generator, kh: int, kw: int, in_ch: int, out_ch: int, bias: bool = True,
                groups: int = 1) -> dict:
    """torch-style default init of an HWIO ``(kh, kw, in / groups, out)``
    kernel and its bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(kh * kw * in_ch // groups)
    p = {"w": torch.empty(kh, kw, in_ch // groups, out_ch).uniform_(-bound, bound, generator=gen)}
    if bias:
        p["b"] = torch.empty(out_ch).uniform_(-bound, bound, generator=gen)
    return p


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size: int, k: int, stride: int, dilation: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: ``ceil(size / stride)``
    outputs, the extra row (if odd) at the end."""
    total = max((-(-size // stride) - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(p: dict, x: torch.Tensor, stride=1, padding=0, groups: int = 1, dilation=1) -> torch.Tensor:
    """NHWC conv over ``(N, H, W, in)`` with an HWIO kernel (the JAX package's
    layouts); ``padding`` is an int or an ``(h, w)`` pair like torch, pairs of
    ``(lo, hi)`` per axis, ``"SAME"`` or ``"VALID"``. As in :func:`linear`, the compute
    dtype follows the params. A patch embedding (stride = kernel, no padding,
    no groups or dilation, the image a whole number of patches) runs as
    ``(N * patches, kh * kw * in) @ (kh * kw * in, out)``, the patches in
    row-major order; any other conv as ``F.conv2d`` over an NCHW view."""
    w = p["w"]
    if isinstance(w, dict):  # weight-only int8
        w = w["w_q"].to(torch.bfloat16) * w["w_s"].to(torch.bfloat16)
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    kh, kw, cin, cout = w.shape
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    n, h, wd, c = x.shape
    if padding == "SAME":
        pads = (_same_pads(h, kh, sh, dh), _same_pads(wd, kw, sw, dw))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    elif isinstance(padding, int) or isinstance(padding[0], int):
        ph, pw = _pair(padding)
        pads = ((ph, ph), (pw, pw))
    else:
        pads = tuple(tuple(pp) for pp in padding)
    if ((sh, sw) == (kh, kw) and pads == ((0, 0), (0, 0)) and groups == 1 and (dh, dw) == (1, 1)
            and h % kh == 0 and wd % kw == 0):
        patches = x.reshape(n, h // kh, kh, wd // kw, kw, c).transpose(2, 3).reshape(n, h // kh, wd // kw, -1)
        y = torch.matmul(patches, w.reshape(kh * kw * cin, cout))
    else:
        xc = F.pad(x.permute(0, 3, 1, 2), (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        y = F.conv2d(xc, w.permute(3, 2, 0, 1), None, (sh, sw), 0, (dh, dw), groups).permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def bn_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim), "mean": torch.zeros(dim), "var": torch.ones(dim)}


def batch_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm over the channel-last axis from the running
    statistics: scale and bias folded in fp32, cast to ``x``'s dtype, then
    ``x * scale + bias``, as the JAX package does."""
    r = torch.rsqrt(p["var"].float() + eps)
    scale = (p["scale"].float() * r).to(x.dtype)
    bias = (p["bias"].float() - p["mean"].float() * p["scale"].float() * r).to(x.dtype)
    return x * scale + bias


def max_pool2d(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """torch MaxPool2d on NHWC data; the padding never wins (-inf, as
    ``lax.reduce_window`` pads)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window: int, stride: int | None = None) -> torch.Tensor:
    """torch AvgPool2d (no padding) on NHWC data."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return y.permute(0, 2, 3, 1)


def layer_norm(p: dict | None, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (biased variance, eps in the sqrt),
    cast back to the input dtype."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(dtype)
