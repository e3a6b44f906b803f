"""MLP-Mixer (PyTorch port of ``pytorch_models_tpu/models/image/mlp_mixer.py``).

Patch-embed conv (NHWC, HWIO) -> N x MixerBlock (a token-mixing MLP over the
transposed token axis + a channel-mixing MLP) -> LayerNorm -> mean pool.
The blocks are a list of per-block dicts run as a Python loop. No
attention, so no kernel of the port: plain PyTorch.
``from_google(tag, pretrained=True)`` reads the official Flax ``.npz``
from the local cache (a miss downloads it) into ``load_jax_weights``, which
takes the arrays as a dict.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import transformer as tfm
from ...ops import layer_norm
from ...ops.layers import conv2d, conv2d_init
from ...utils import StateDict, hub_download, to_tensor, tree_map
from ...utils.module import InferenceModel, resolve_device

NORM_EPS = 1e-6

# tag -> (n_layers, d_model): Table 1 of the paper
SIZES = dict(S=(8, 512), B=(12, 768), L=(24, 1024), H=(32, 1280))


@dataclass(frozen=True)
class MLPMixerConfig:
    n_layers: int
    d_model: int
    patch_size: int
    img_size: int = 224
    mlp_ratio: tuple[float, float] = (0.5, 4.0)


def mixer_init(gen: torch.Generator, cfg: MLPMixerConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (torch-default
    uniform conv and linears, unit LayerNorms), then moved to ``device``."""
    if cfg.img_size % cfg.patch_size:
        raise ValueError(f"img_size {cfg.img_size} is not a multiple of patch_size {cfg.patch_size}")
    n_tokens = (cfg.img_size // cfg.patch_size) ** 2
    tokens_dim, channels_dim = (int(cfg.d_model * r) for r in cfg.mlp_ratio)
    p = {"patch_embed": conv2d_init(gen, cfg.patch_size, cfg.patch_size, 3, cfg.d_model)}
    p["blocks"] = [{
        "norm1": tfm.ln_init(cfg.d_model),
        "token_mixing": tfm.mlp_init(gen, n_tokens, tokens_dim),
        "norm2": tfm.ln_init(cfg.d_model),
        "channel_mixing": tfm.mlp_init(gen, cfg.d_model, channels_dim),
    } for _ in range(cfg.n_layers)]
    p["norm"] = tfm.ln_init(cfg.d_model)
    return tree_map(lambda t: t.to(device), p)


def _mixer_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(p["norm1"], x, NORM_EPS).transpose(-1, -2)
    x = x + tfm.mlp_apply(p["token_mixing"], h).transpose(-1, -2)
    return x + tfm.mlp_apply(p["channel_mixing"], layer_norm(p["norm2"], x, NORM_EPS))


@torch.inference_mode()
def mixer_apply(params: dict, cfg: MLPMixerConfig, imgs: torch.Tensor) -> torch.Tensor:
    """Forward over ``imgs`` (N, 3, H, W) -> pooled features (N, d_model)."""
    x = conv2d(params["patch_embed"], imgs.permute(0, 2, 3, 1), stride=cfg.patch_size)
    x = x.reshape(x.shape[0], -1, cfg.d_model)
    for bp in params["blocks"]:
        x = _mixer_block(bp, x)
    return layer_norm(params["norm"], x, NORM_EPS).mean(dim=1)


class MLPMixer(InferenceModel):
    def __init__(
        self,
        n_layers: int,
        d_model: int,
        patch_size: int,
        img_size: int = 224,
        mlp_ratio: tuple[float, float] = (0.5, 4.0),
        dropout: float = 0.0,  # accepted for API parity; inference-only
        norm_eps: float = 1e-6,  # accepted for API parity; the model uses NORM_EPS, as the JAX package does
        rng: int = 0,
        device=None,
    ) -> None:
        self.cfg = MLPMixerConfig(n_layers, d_model, patch_size, img_size, tuple(mlp_ratio))
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = mixer_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    def __call__(self, imgs) -> torch.Tensor:
        return mixer_apply(self.params, self.cfg, to_tensor(imgs, self.device))

    @staticmethod
    def from_google(model_tag: str, *, pretrained: bool = False, **kwargs) -> "MLPMixer":
        """``"B/16"`` or ``"B/16_gsam"``."""
        model_tag, _, weights = model_tag.partition("_")
        weights = weights or "gsam"
        size, patch_size = model_tag.split("/")
        n_layers, d_model = SIZES[size]
        m = MLPMixer(n_layers, d_model, int(patch_size), **kwargs)
        if pretrained:
            url = f"https://storage.googleapis.com/mixer_models/{weights}/Mixer-{size}_{patch_size}.npz"
            m.load_jax_weights(dict(np.load(hub_download(url))))
        return m

    def load_jax_weights(self, ckpt: dict) -> None:
        """The Flax ``.npz`` layout (``stem``, ``MixerBlock_i``,
        ``pre_head_layer_norm``) -> the port's params, every key consumed."""
        sd = StateDict(ckpt)

        def flax_linear(pfx: str) -> dict:
            return {"w": sd.pop(f"{pfx}/kernel"), "b": sd.pop(f"{pfx}/bias")}

        def flax_ln(pfx: str) -> dict:
            return {"scale": sd.pop(f"{pfx}/scale"), "bias": sd.pop(f"{pfx}/bias")}

        blocks = []
        for i in range(self.cfg.n_layers):
            blk = f"MixerBlock_{i}"
            blocks.append({
                "norm1": flax_ln(f"{blk}/LayerNorm_0"),
                "token_mixing": {"fc1": flax_linear(f"{blk}/token_mixing/Dense_0"),
                                 "fc2": flax_linear(f"{blk}/token_mixing/Dense_1")},
                "norm2": flax_ln(f"{blk}/LayerNorm_1"),
                "channel_mixing": {"fc1": flax_linear(f"{blk}/channel_mixing/Dense_0"),
                                   "fc2": flax_linear(f"{blk}/channel_mixing/Dense_1")},
            })
        p = {"patch_embed": {"w": sd.pop("stem/kernel"), "b": sd.pop("stem/bias")}, "blocks": blocks,
             "norm": flax_ln("pre_head_layer_norm")}
        sd.finalize()
        self.params = tree_map(lambda t: t.to(device=self.device, dtype=torch.float32).contiguous(), p)
