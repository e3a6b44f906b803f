"""Wav2Vec2 (also loads HuBERT / MMS / XLS-R checkpoints; PyTorch port of
``pytorch_models_tpu/models/audio/wav2vec2.py``).

7-layer strided Conv1d waveform feature encoder (total downsample 320x;
per-layer channel LayerNorm, or legacy mode = affine InstanceNorm on layer 0
only) -> LN (+ projection if the widths differ) -> grouped-conv relative PE
(kernel 128, groups 16, asymmetric same-pad for the even kernel) added
residually -> encoder (pre- or post-norm per config). All 1D convs run over
NLC data with ``(k, in / groups, out)`` kernels, the JAX package's layouts.

Self-attention goes through ``transformer.encoder_apply``, whose auto gate
sends head width 64 (wav2vec2-base / -large, data2vec-audio, SEW) to the
encoder-attention kernel on the card (``ops/encoder_attention.py``, K1).
``Wav2Vec2.from_hf(tag, config=...)`` takes the HF ``config.json`` as a
dict; without one it GETs the tag's ``config.json`` (uncached, as the JAX
package does). ``pretrained=True`` reads the HF checkpoint from the local
cache (``utils.download.load_hf_checkpoint``; a miss downloads it), its
``wav2vec2.`` prefix stripped.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from ... import transformer as tfm
from ...ops import ACT_FNS, layer_norm, linear
from ...ops.layers import conv1d, conv1d_init, linear_init, ln_init
from ...utils import StateDict, to_tensor, tree_map
from ...utils.module import InferenceModel, resolve_device


@dataclass(frozen=True)
class Wav2Vec2Config:
    n_layers: int
    d_model: int
    stem_dims: tuple[int, ...]
    stem_kernels: tuple[int, ...]
    stem_strides: tuple[int, ...]
    pe_kernel: int
    pe_groups: int
    stem_bias: bool = True
    stem_legacy: bool = False
    pre_norm: bool = True
    pe_layers: int = 1  # >1 only for Data2VecAudio

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, pre_norm=self.pre_norm)


def instance_norm_1d(p: dict | None, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch InstanceNorm1d on NLC data: normalize over time per (batch,
    channel) in fp32, [affine], cast back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(-2, keepdim=True)
    var = (x32 - mean).square().mean(-2, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def stem_init(gen: torch.Generator, cfg: Wav2Vec2Config) -> list[dict]:
    layers = []
    in_dim = 1
    for i, (out_dim, k) in enumerate(zip(cfg.stem_dims, cfg.stem_kernels)):
        lp = {"conv": conv1d_init(gen, k, in_dim, out_dim, bias=cfg.stem_bias)}
        if not cfg.stem_legacy or i == 0:  # legacy: the affine InstanceNorm on layer 0 only
            lp["norm"] = ln_init(out_dim)
        layers.append(lp)
        in_dim = out_dim
    return layers


def stem_apply(layers: list[dict], cfg: Wav2Vec2Config, x: torch.Tensor) -> torch.Tensor:
    """Waveform (B, L) -> features (B, T, C)."""
    x = x[..., None]  # (B, L, 1)
    gelu = ACT_FNS["gelu"]
    for i, (lp, stride) in enumerate(zip(layers, cfg.stem_strides)):
        x = conv1d(lp["conv"], x, stride=stride)
        if cfg.stem_legacy:
            if i == 0:
                x = instance_norm_1d(lp["norm"], x)
        else:
            x = layer_norm(lp["norm"], x)
        x = gelu(x)
    return x


def pe_conv_init(gen: torch.Generator, cfg: Wav2Vec2Config) -> list[dict]:
    d = cfg.d_model
    return [{"conv": conv1d_init(gen, cfg.pe_kernel, d, d, groups=cfg.pe_groups)} for _ in range(cfg.pe_layers)]


def pe_conv_apply(layers: list[dict], cfg: Wav2Vec2Config, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Grouped relative-PE conv; an even kernel takes the asymmetric same-pad
    ``(k // 2, k // 2 - 1)``. Data2VecAudio stacks ``pe_layers`` blocks of
    conv, non-affine channel LN and GELU instead."""
    k = cfg.pe_kernel
    if cfg.pe_layers > 1:
        for lp in layers:
            x = conv1d(lp["conv"], x, padding=k // 2, groups=cfg.pe_groups)
            x = ACT_FNS["gelu"](layer_norm(None, x))
        return x
    x = conv1d(layers[0]["conv"], x, stride=stride, padding=(k // 2, k // 2 - 1), groups=cfg.pe_groups)
    return ACT_FNS["gelu"](x)


def wav2vec2_init(gen: torch.Generator, cfg: Wav2Vec2Config, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (torch-default
    uniform convs and linears), then moved to ``device``."""
    in_dim = cfg.stem_dims[-1]
    p = {
        "stem": stem_init(gen, cfg),
        "proj_norm": ln_init(in_dim),
        "pe_conv": pe_conv_init(gen, cfg),
        "encoder": tfm.encoder_init(gen, cfg.n_layers, cfg.layer),
        "norm": ln_init(cfg.d_model),
    }
    if in_dim != cfg.d_model:
        p["proj"] = linear_init(gen, in_dim, cfg.d_model)
    return tree_map(lambda t: t.to(device), p)


def features(params: dict, cfg: Wav2Vec2Config, x: torch.Tensor) -> torch.Tensor:
    """The stem, its LayerNorm and the projection: (B, L) -> (B, T, d)."""
    x = layer_norm(params["proj_norm"], stem_apply(params["stem"], cfg, x))
    if "proj" in params:
        x = linear(params["proj"], x)
    return x


@torch.inference_mode()
def wav2vec2_apply(params: dict, cfg: Wav2Vec2Config, x: torch.Tensor) -> torch.Tensor:
    """Forward over a (B, L) waveform -> (B, T, d)."""
    x = features(params, cfg, x)
    x = x + pe_conv_apply(params["pe_conv"], cfg, x)
    if cfg.pre_norm:
        return layer_norm(params["norm"], tfm.encoder_apply(params["encoder"], cfg.layer, x))
    return tfm.encoder_apply(params["encoder"], cfg.layer, layer_norm(params["norm"], x))


def _pop_weight_norm_conv(sd: StateDict, prefix: str) -> dict:
    """Reverse ``torch.nn.utils.weight_norm`` (over dim 2) on the PE conv,
    either torch naming, in numpy as the JAX package's converter computes it
    (so both hold the same kernel bit for bit): ``w = g * v / ||v||_(0,1)``,
    (out, in / groups, k) -> (k, in / groups, out)."""
    g = sd.pop(f"{prefix}.weight_g", None)
    if g is None:
        g = sd.pop(f"{prefix}.parametrizations.weight.original0")  # newer torch naming
        v = sd.pop(f"{prefix}.parametrizations.weight.original1")
    else:
        v = sd.pop(f"{prefix}.weight_v")
    g, v = g.numpy(), v.numpy()
    w = g * v / np.sqrt(np.sum(v**2, axis=(0, 1), keepdims=True))
    return {"w": np.transpose(w, (2, 1, 0)), "b": sd.pop(f"{prefix}.bias")}


class Wav2Vec2(InferenceModel):
    STEM_DIMS = (512,) * 7
    STEM_KERNELS = (10,) + (3,) * 4 + (2,) * 2
    STEM_STRIDES = (5,) + (2,) * 6
    PE_KERNEL = 128
    PE_GROUPS = 16

    def __init__(
        self,
        n_layers: int,
        d_model: int,
        stem_bias: bool = True,
        stem_legacy: bool = False,
        dropout: float = 0.0,  # accepted for API parity; inference-only
        pre_norm: bool = True,
        rng: int = 0,
        device=None,
    ) -> None:
        self._build(Wav2Vec2Config(n_layers, d_model, self.STEM_DIMS, self.STEM_KERNELS, self.STEM_STRIDES,
                                   self.PE_KERNEL, self.PE_GROUPS, stem_bias, stem_legacy, pre_norm), rng, device)

    def _build(self, cfg: Wav2Vec2Config, rng: int, device) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = wav2vec2_init(torch.Generator().manual_seed(rng), cfg, self.device)

    def __call__(self, x) -> torch.Tensor:
        return wav2vec2_apply(self.params, self.cfg, to_tensor(x, self.device))

    @classmethod
    def from_hf(cls, model_tag: str, *, pretrained: bool = False, config: dict | None = None, **kwargs):
        """Architecture from an HF ``config.json``: ``config``, or fetched
        for the tag when None."""
        if config is None:
            import requests

            config = json.loads(requests.get(f"https://huggingface.co/{model_tag}/raw/main/config.json",
                                             timeout=30).content)
        if config["hidden_size"] != config["num_attention_heads"] * 64:
            raise ValueError(f"{model_tag}: head width {config['hidden_size']} / {config['num_attention_heads']} "
                             "is not 64")
        _kwargs = dict(n_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
                       stem_bias=config["conv_bias"])
        if cls is Wav2Vec2 and "feat_extract_norm" in config:
            _kwargs["stem_legacy"] = config["feat_extract_norm"] == "group"
        if cls is Wav2Vec2 and "do_stable_layer_norm" in config:
            _kwargs["pre_norm"] = config["do_stable_layer_norm"]
        m = cls(**_kwargs, **kwargs)
        if pretrained:
            from ...utils.download import load_hf_checkpoint

            state_dict = load_hf_checkpoint(model_tag)
            m.load_hf_state_dict({k.replace("wav2vec2.", ""): v for k, v in state_dict.items()})
        return m

    # the key layout the whole family shares
    def _pop_stem(self, sd: StateDict) -> list[dict]:
        layers = []
        for i in range(len(self.cfg.stem_dims)):
            pfx = f"feature_extractor.conv_layers.{i}"
            lp = {"conv": sd.pop_conv1d(f"{pfx}.conv", bias=self.cfg.stem_bias)}
            if (not self.cfg.stem_legacy) or i == 0:
                lp["norm"] = sd.pop_ln(f"{pfx}.layer_norm")
            layers.append(lp)
        return layers

    def _pop_encoder(self, sd: StateDict) -> dict:
        layers = []
        for i in range(self.cfg.n_layers):
            pfx = f"encoder.layers.{i}"
            layers.append({
                "sa": {
                    "q": sd.pop_linear(f"{pfx}.attention.q_proj"),
                    "k": sd.pop_linear(f"{pfx}.attention.k_proj"),
                    "v": sd.pop_linear(f"{pfx}.attention.v_proj"),
                    "o": sd.pop_linear(f"{pfx}.attention.out_proj"),
                },
                "sa_norm": sd.pop_ln(f"{pfx}.layer_norm"),
                "mlp": {
                    "fc1": sd.pop_linear(f"{pfx}.feed_forward.intermediate_dense"),
                    "fc2": sd.pop_linear(f"{pfx}.feed_forward.output_dense"),
                },
                "mlp_norm": sd.pop_ln(f"{pfx}.final_layer_norm"),
            })
        return {"layers": layers}

    def _drop_extra(self, sd: StateDict) -> None:
        for k in list(sd.keys()):
            if k.startswith(("quantizer.", "project_", "masked_spec_embed", "label_embs", "final_proj", "lm_head")):
                sd.pop(k)

    def _finish(self, sd: StateDict, p: dict) -> None:
        self._drop_extra(sd)
        sd.finalize()
        self.params = tree_map(lambda t: to_tensor(t, self.device).float().contiguous(), p)

    def load_hf_state_dict(self, state_dict: dict) -> None:
        """HF wav2vec2 / HuBERT keys -> the port's params (the PE conv's
        weight norm reversed; pretraining heads and quantizers skipped)."""
        sd = StateDict(state_dict)
        p: dict = {"stem": self._pop_stem(sd)}
        p["proj_norm"] = sd.pop_ln("feature_projection.layer_norm")
        if "feature_projection.projection.weight" in sd:
            p["proj"] = sd.pop_linear("feature_projection.projection")
        p["pe_conv"] = [{"conv": _pop_weight_norm_conv(sd, "encoder.pos_conv_embed.conv")}]
        p["norm"] = sd.pop_ln("encoder.layer_norm")
        p["encoder"] = self._pop_encoder(sd)
        self._finish(sd, p)
