"""Elementary functional layers over parameter dicts (PyTorch port of
``pytorch_models_tpu/ops/layers.py``).

Conventions match the JAX package so parameters transfer unchanged:
- Linear: ``{"w": (in, out), "b": (out,)}``; ``y = x @ w + b``.
- LayerNorm: ``{"scale": (d,), "bias": (d,)}``; eps inside the sqrt like torch.
- Conv1d: ``{"w": (k, in, out), "b": (out,)}`` over NLC inputs.
- Conv2d: ``{"w": (kh, kw, in / groups, out)`` (HWIO), ``"b": (out,)}`` over
  NHWC inputs.

Activations mirror the reference's MLP table: "gelu" is exact (erf) GELU,
"approximate_gelu" is tanh GELU. A weight-only int8 linear (``{"w": {"w_q",
"w_s"}}``, ``utils.params.quantize_tree_int8``) dequantizes to bf16 and
multiplies in bf16, as the JAX package's does; its w8a8 variant
(``USE_A8_LINEAR``) is not ported yet.
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


def linear(p: dict, x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w + b``. The compute dtype follows the PARAMS, not the input:
    bf16 params force bf16 compute even for fp32 inputs, and so do int8
    ones, which dequantize as ``w_q.bf16 * w_s.bf16`` (one bf16 rounding)
    first. With ``out`` the result is written into it."""
    w = p["w"]
    if isinstance(w, dict):  # weight-only int8: dequantize, then the bf16 matmul
        w = w["w_q"].to(torch.bfloat16) * w["w_s"].to(torch.bfloat16)
    if x.is_floating_point() and x.dtype != w.dtype:
        x = x.to(w.dtype)
    y = torch.matmul(x, w, out=out)
    if "b" in p:
        y += p["b"].to(y.dtype)
    return y


def conv1d_init(gen: torch.Generator, k: int, in_ch: int, out_ch: int) -> dict:
    """torch-style default init of a ``(k, in, out)`` kernel and its bias:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(k * in_ch)
    return {"w": torch.empty(k, in_ch, out_ch).uniform_(-bound, bound, generator=gen),
            "b": torch.empty(out_ch).uniform_(-bound, bound, generator=gen)}


def conv1d(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NLC conv over ``(B, L, in)`` with a ``(k, in, out)`` kernel (the JAX
    package's layouts) and torch-style symmetric ``padding``. As in
    :func:`linear`, the compute dtype follows the params."""
    w = p["w"]
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    b = p["b"].to(w.dtype) if "b" in p else None
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, stride=stride, padding=padding)
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
