"""EnCodec neural audio codec (PyTorch port of
``pytorch_models_tpu/models/audio/encodec.py``).

Encoder: conv stem -> 4 x [residual block + strided downsample conv (2, 4,
5, 8)] -> 2-layer residual LSTM -> projection. The decoder mirrors it with
transposed convs. Residual vector quantization over a stack of 32 / 16
codebooks. Variants: 24khz (mono, causal, weight norm, 32 quantizers) and
48khz (stereo, time group norm, 16 quantizers, loudness-normalized).

All convs run over NLC data. A transposed conv's kernel stays in the JAX
package's pre-flipped ``(k, in, out)`` layout (so ``from_jax_params``
carries it unchanged) and is un-flipped for ``F.conv_transpose1d``. Reflect
padding indexes the signal as ``jnp.pad``'s reflect mode does, also where a
pad reaches past the signal's length. The LSTM is torch's own LSTM op.
No TPU kernel is on this path. ``from_facebook(variant, pretrained=True)``
reads the official ``.th`` from the local cache (a miss downloads it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.layers import conv1d, conv1d_init
from ...utils import StateDict, hub_download, to_tensor, tree_map
from ...utils.checkpoint import load_torch_checkpoint
from ...utils.module import InferenceModel, resolve_device

ELU = F.elu


@dataclass(frozen=True)
class EnCodecConfig:
    audio_channels: int
    norm_type: str
    causal: bool
    n_quantizers: int
    normalize: bool
    base_dim: int = 32
    dim: int = 128
    strides: tuple[int, ...] = (2, 4, 5, 8)
    codebook_size: int = 1024


# ---------------------------------------------------------------------------
# Padded conv / transposed conv
# ---------------------------------------------------------------------------


def reflect_indices(length: int, left: int, right: int, device=None) -> torch.Tensor:
    """Source index of every position of ``[-left, length + right)`` under
    reflect padding (the edge sample not repeated), the signal reflected as
    often as the pads need: ``jnp.pad`` / ``np.pad`` ``mode="reflect"``,
    which, unlike ``F.pad``, take a pad as long as the signal or longer."""
    idx = torch.arange(-left, length + right, device=device)
    if length == 1:
        return torch.zeros_like(idx)
    period = 2 * (length - 1)
    idx = idx.remainder(period)
    return torch.where(idx >= length, period - idx, idx)


def pad1d(x: torch.Tensor, kernel_size: int, stride: int, causal: bool) -> torch.Tensor:
    """Reflect pad + extra right pad to a stride multiple. NLC."""
    total = kernel_size - stride
    right = 0 if causal else total // 2
    left = total - right
    length = x.shape[-2]
    extra = math.ceil(length / stride) * stride - length
    return x[:, reflect_indices(length, left, right + extra, x.device)]


def unpad1d(x: torch.Tensor, kernel_size: int, stride: int, causal: bool) -> torch.Tensor:
    """Trim the transposed conv's overhang. NLC."""
    total = kernel_size - stride
    right = total if causal else total // 2
    left = total - right
    return x[:, left: x.shape[-2] - right]


def group_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(1, C) on NLC data: normalize over (L, C) jointly per sample, in fp32."""
    x32 = x.float()
    mean = x32.mean((-2, -1), keepdim=True)
    var = (x32 - mean).square().mean((-2, -1), keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def ec_conv(p: dict, cfg: EnCodecConfig, x: torch.Tensor, kernel_size: int, stride: int = 1) -> torch.Tensor:
    y = conv1d(p, pad1d(x, kernel_size, stride, cfg.causal), stride=stride)
    if "norm" in p:
        y = group_norm(p["norm"], y)
    return y


def ec_conv_transpose(p: dict, cfg: EnCodecConfig, x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """torch ConvTranspose1d (no padding) + the unpad. The kernel is stored
    pre-flipped ``(k, in, out)``: flipped back to torch's ``(in, out, k)``."""
    w = p["w"]
    x = x.to(w.dtype)
    y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0), stride=stride).transpose(1, 2)
    y = y + p["b"].to(y.dtype)
    if "norm" in p:
        y = group_norm(p["norm"], y)
    return unpad1d(y, kernel_size, stride, cfg.causal)


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------


def lstm_apply(layers: list[dict], x: torch.Tensor) -> torch.Tensor:
    """Residual LSTM over NLC input: ``x + lstm(x)``, torch gate order i, f,
    g, o. The JAX package's ``(in, 4 * dim)`` kernels go to torch's own
    LSTM op transposed, its merged ``b = b_ih + b_hh`` in the ``b_ih`` slot
    and zeros in the ``b_hh`` slot (cuDNN's LSTM on the card in fp32; in
    bf16 and on the CPU torch's fused cells, frame by frame)."""
    dim = layers[0]["w_hh"].shape[0]
    params = []
    for lp in layers:
        b = lp["b"].to(x.dtype)
        params += [lp["w_ih"].to(x.dtype).t().contiguous(), lp["w_hh"].to(x.dtype).t().contiguous(), b,
                   torch.zeros_like(b)]
    h0 = x.new_zeros(len(layers), x.shape[0], dim)
    out = torch.lstm(x.contiguous(), (h0, h0), params, True, len(layers), 0.0, False, False, True)[0]
    return x + out


# ---------------------------------------------------------------------------
# Blocks / encoder / decoder
# ---------------------------------------------------------------------------


def ec_block(p: dict, cfg: EnCodecConfig, x: torch.Tensor) -> torch.Tensor:
    h = ec_conv(p["conv1"], cfg, ELU(x), 3, 1)
    h = ec_conv(p["conv2"], cfg, ELU(h), 1, 1)
    return ec_conv(p["shortcut"], cfg, x, 1, 1) + h


def encoder_apply(p: dict, cfg: EnCodecConfig, x: torch.Tensor) -> torch.Tensor:
    x = ec_conv(p["conv_in"], cfg, x, 7, 1)
    for stage, stride in zip(p["stages"], cfg.strides):
        x = ec_block(stage["block"], cfg, x)
        x = ec_conv(stage["down"], cfg, ELU(x), stride * 2, stride)
    x = lstm_apply(p["lstm"], x)
    return ec_conv(p["conv_out"], cfg, ELU(x), 7, 1)


def decoder_apply(p: dict, cfg: EnCodecConfig, x: torch.Tensor) -> torch.Tensor:
    x = ec_conv(p["conv_in"], cfg, x, 7, 1)
    x = lstm_apply(p["lstm"], x)
    for stage, stride in zip(p["stages"], cfg.strides[::-1]):
        x = ec_conv_transpose(stage["up"], cfg, ELU(x), stride * 2, stride)
        x = ec_block(stage["block"], cfg, x)
    return ec_conv(p["conv_out"], cfg, ELU(x), 7, 1)


# ---------------------------------------------------------------------------
# Residual vector quantization
# ---------------------------------------------------------------------------


def rvq_distances(residual: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``|r|^2 - 2 r.c + |c|^2`` of every residual row to every code: (..., K)."""
    return (residual.square().sum(-1, keepdim=True) - 2 * torch.matmul(residual, codebook.t())
            + codebook.square().sum(-1))


def rvq_quantize(embed: torch.Tensor, x: torch.Tensor, n_quantizers: int) -> torch.Tensor:
    """``embed``: (nq, K, D); ``x``: (..., D) -> codes (n_quantizers, ...),
    each level the nearest code (the first on ties) to what the levels
    before it left."""
    residual, codes = x, []
    for codebook in embed[:n_quantizers]:
        idx = torch.argmin(rvq_distances(residual, codebook), dim=-1)
        residual = residual - codebook[idx]
        codes.append(idx)
    return torch.stack(codes)


def rvq_dequantize(embed: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes: (nq_used, ...) -> (..., D); the sum of each level's codebook
    rows, level by level from zero."""
    out = embed.new_zeros(*codes.shape[1:], embed.shape[-1])
    for codebook, idx in zip(embed[:codes.shape[0]], codes):
        out = out + codebook[idx]
    return out


@torch.inference_mode()
def encodec_encode(params: dict, cfg: EnCodecConfig, x: torch.Tensor, n_quantizers: int):
    """(B, C, L) waveform -> ((B, nq, T) int64 codes, (B, 1, 1) scale or None)."""
    if cfg.normalize:
        scale = x.mean(1, keepdim=True).square().mean(2, keepdim=True).sqrt() + 1e-8
        x = x / scale
    else:
        scale = None
    h = encoder_apply(params["encoder"], cfg, x.transpose(1, 2))
    codes = rvq_quantize(params["quantizer"]["embed"], h, n_quantizers)
    return codes.transpose(0, 1), scale


@torch.inference_mode()
def encodec_decode(params: dict, cfg: EnCodecConfig, codes: torch.Tensor, scale=None) -> torch.Tensor:
    """(B, nq, T) codes [+ scale] -> (B, C, L) waveform."""
    h = rvq_dequantize(params["quantizer"]["embed"], codes.transpose(0, 1))
    y = decoder_apply(params["decoder"], cfg, h).transpose(1, 2)
    if scale is not None:
        y = y * scale
    return y


class EnCodec(InferenceModel):
    def __init__(self, audio_channels: int, norm_type: str, causal: bool, n_quantizers: int, normalize: bool,
                 rng: int = 0, device=None) -> None:
        self.cfg = EnCodecConfig(audio_channels, norm_type, causal, n_quantizers, normalize)
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = encodec_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    def encode(self, x, n_quantizers: int | None = None):
        return encodec_encode(self.params, self.cfg, to_tensor(x, self.device), n_quantizers or self.cfg.n_quantizers)

    def decode(self, codes, scale=None) -> torch.Tensor:
        scale = None if scale is None else to_tensor(scale, self.device)
        return encodec_decode(self.params, self.cfg, to_tensor(codes, self.device).long(), scale)

    @staticmethod
    def from_facebook(variant: str, pretrained: bool = False, device=None) -> "EnCodec":
        audio_channels, norm_type, causal, n_quantizers, normalize = {
            "24khz": (1, "weight_norm", True, 32, False),
            "48khz": (2, "time_group_norm", False, 16, True),
        }[variant]
        m = EnCodec(audio_channels, norm_type, causal, n_quantizers, normalize, device=device)
        if pretrained:
            ckpt = {"24khz": "encodec_24khz-d7cc33bc.th", "48khz": "encodec_48khz-7e698e3e.th"}[variant]
            m.load_facebook_state_dict(
                load_torch_checkpoint(hub_download("https://dl.fbaipublicfiles.com/encodec/v0/" + ckpt)))
        return m

    def load_facebook_state_dict(self, state_dict: dict) -> None:
        """Convert a facebookresearch/encodec checkpoint. Weight-norm convs
        ship ``weight_g`` / ``weight_v`` (torch's default dim 0):
        ``w = g * v / ||v||_(1,2)``, in numpy as the JAX package's converter
        computes it. ConvTranspose kernels ``(in, out, k)`` are pre-flipped
        into ``(k, in, out)``. The codebooks' training statistics are
        dropped."""
        sd = StateDict({k.removeprefix("model."): v for k, v in state_dict.items()})
        cfg = self.cfg
        wn = cfg.norm_type == "weight_norm"

        def conv(pfx: str, transpose: bool = False) -> dict:
            inner = "convtr.convtr" if transpose else "conv.conv"
            if wn:
                g = sd.pop(f"{pfx}.{inner}.weight_g", None)
                if g is None:
                    g = sd.pop(f"{pfx}.{inner}.parametrizations.weight.original0")
                    v = sd.pop(f"{pfx}.{inner}.parametrizations.weight.original1")
                else:
                    v = sd.pop(f"{pfx}.{inner}.weight_v")
                g, v = g.numpy(), v.numpy()
                w = g * v / np.sqrt(np.sum(v**2, axis=(1, 2), keepdims=True))
            else:
                w = sd.pop(f"{pfx}.{inner}.weight").numpy()
            p = {"b": sd.pop(f"{pfx}.{inner}.bias")}
            if transpose:  # (in, out, k) -> flipped (k, in, out)
                p["w"] = np.transpose(w[:, :, ::-1], (2, 0, 1))
            else:  # (out, in, k) -> (k, in, out)
                p["w"] = np.transpose(w, (2, 1, 0))
            if not wn:
                norm = "convtr.norm" if transpose else "conv.norm"
                p["norm"] = {"scale": sd.pop(f"{pfx}.{norm}.weight"), "bias": sd.pop(f"{pfx}.{norm}.bias")}
            return p

        def block(pfx: str) -> dict:
            return {"conv1": conv(f"{pfx}.block.1"), "conv2": conv(f"{pfx}.block.3"), "shortcut": conv(f"{pfx}.shortcut")}

        def lstm(pfx: str) -> list[dict]:
            out = []
            for i in range(2):
                w_ih = sd.pop(f"{pfx}.lstm.weight_ih_l{i}")
                w_hh = sd.pop(f"{pfx}.lstm.weight_hh_l{i}")
                b = sd.pop(f"{pfx}.lstm.bias_ih_l{i}") + sd.pop(f"{pfx}.lstm.bias_hh_l{i}")
                out.append({"w_ih": w_ih.t(), "w_hh": w_hh.t(), "b": b})
            return out

        n_stages = len(cfg.strides)
        enc = {
            "conv_in": conv("encoder.model.0"),
            "stages": [{"block": block(f"encoder.model.{1 + 3 * i}"), "down": conv(f"encoder.model.{3 + 3 * i}")}
                       for i in range(n_stages)],
            "lstm": lstm(f"encoder.model.{1 + 3 * n_stages}"),
            "conv_out": conv(f"encoder.model.{3 + 3 * n_stages}"),
        }
        dec = {
            "conv_in": conv("decoder.model.0"),
            "lstm": lstm("decoder.model.1"),
            "stages": [{"up": conv(f"decoder.model.{3 + 3 * i}", transpose=True),
                        "block": block(f"decoder.model.{4 + 3 * i}")}
                       for i in range(n_stages)],
            "conv_out": conv(f"decoder.model.{3 + 3 * n_stages}"),
        }
        embed = torch.stack([sd.pop(f"quantizer.vq.layers.{i}._codebook.embed") for i in range(cfg.n_quantizers)])
        for k in list(sd.keys()):  # training-only codebook statistics
            if k.endswith(("inited", "cluster_size", "embed_avg")) or k == "bandwidth":
                sd.pop(k)
        sd.finalize()
        p = {"encoder": enc, "decoder": dec, "quantizer": {"embed": embed}}
        self.params = tree_map(lambda t: to_tensor(t, self.device).float().contiguous(), p)


def encodec_init(gen: torch.Generator, cfg: EnCodecConfig, device=None) -> dict:
    """Random parameters with the checkpoint's topology, drawn on the CPU
    from ``gen`` (torch-default uniform convs, U(-1/sqrt(dim), 1/sqrt(dim))
    LSTMs, N(0, 1) codebooks), then moved to ``device``."""

    def conv_p(kern, cin, cout):
        p = conv1d_init(gen, kern, cin, cout)  # (k, in, out) serves both directions
        if cfg.norm_type == "time_group_norm":
            p["norm"] = {"scale": torch.ones(cout), "bias": torch.zeros(cout)}
        return p

    def block_p(dim):
        return {"conv1": conv_p(3, dim, dim // 2), "conv2": conv_p(1, dim // 2, dim), "shortcut": conv_p(1, dim, dim)}

    def lstm_p(dim):
        bound = 1 / math.sqrt(dim)
        return [{k: torch.empty(*shape).uniform_(-bound, bound, generator=gen)
                 for k, shape in (("w_ih", (dim, 4 * dim)), ("w_hh", (dim, 4 * dim)), ("b", (4 * dim,)))}
                for _ in range(2)]

    d = cfg.base_dim
    enc = {"conv_in": conv_p(7, cfg.audio_channels, d), "stages": []}
    for s in cfg.strides:
        enc["stages"].append({"block": block_p(d), "down": conv_p(s * 2, d, d * 2)})
        d *= 2
    enc["lstm"] = lstm_p(d)
    enc["conv_out"] = conv_p(7, d, cfg.dim)

    dec = {"conv_in": conv_p(7, cfg.dim, d), "lstm": lstm_p(d), "stages": []}
    for s in cfg.strides[::-1]:
        dec["stages"].append({"up": conv_p(s * 2, d, d // 2), "block": block_p(d // 2)})
        d //= 2
    dec["conv_out"] = conv_p(7, d, cfg.audio_channels)

    embed = torch.randn(cfg.n_quantizers, cfg.codebook_size, cfg.dim, generator=gen)
    p = {"encoder": enc, "decoder": dec, "quantizer": {"embed": embed}}
    return tree_map(lambda t: t.to(device), p)
