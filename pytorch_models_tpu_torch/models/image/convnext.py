"""ConvNeXt (PyTorch port of ``pytorch_models_tpu/models/image/convnext.py``).

Stem conv 4x4 / 4 + LN -> 4 stages of [downsample LN + conv 2x2 / 2 for
stages > 0, then blocks: depthwise 7x7 conv (groups = d) -> LN -> Linear
x4 -> exact GELU -> Linear, layer-scale gamma on the residual] -> global
average pool -> LN. NHWC end to end (HWIO kernels); each stage's blocks are
a list run as a Python loop. No attention: plain PyTorch.
``from_facebook(variant, pretrained=True)`` reads the official ImageNet-22k
``.pth`` from the local cache (a miss downloads it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import transformer as tfm
from ...ops import ACT_FNS, layer_norm, linear
from ...ops.layers import conv2d, conv2d_init
from ...utils import StateDict, hub_download, to_tensor, tree_map
from ...utils.checkpoint import load_torch_checkpoint
from ...utils.module import InferenceModel, resolve_device

NORM_EPS = 1e-6
EXPANSION = 4

# variant -> (d_model of the first stage, blocks per stage)
VARIANTS = dict(
    atto=(40, (2, 2, 6, 2)),
    femto=(48, (2, 2, 6, 2)),
    pico=(64, (2, 2, 6, 2)),
    nano=(80, (2, 2, 8, 2)),
    tiny=(96, (3, 3, 9, 3)),
    small=(96, (3, 3, 27, 3)),
    base=(128, (3, 3, 27, 3)),
    large=(192, (3, 3, 27, 3)),
    xlarge=(256, (3, 3, 27, 3)),
    huge=(352, (3, 3, 27, 3)),
)


@dataclass(frozen=True)
class ConvNeXtConfig:
    d_model: int
    depths: tuple[int, ...]


def convnext_init(gen: torch.Generator, cfg: ConvNeXtConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (torch-default
    uniform convs and linears, layer-scale gamma 1e-6), then moved to
    ``device``."""
    d = cfg.d_model
    p: dict = {"stem": {"conv": conv2d_init(gen, 4, 4, 3, d), "norm": tfm.ln_init(d)}}
    stages = []
    for stage_idx, depth in enumerate(cfg.depths):
        stage: dict = {}
        if stage_idx > 0:
            stage["downsample"] = {"norm": tfm.ln_init(d), "conv": conv2d_init(gen, 2, 2, d, d * 2)}
            d *= 2
        stage["blocks"] = [{
            "dwconv": conv2d_init(gen, 7, 7, d, d, groups=d),
            "norm": tfm.ln_init(d),
            "pwconv1": tfm.linear_init(gen, d, d * EXPANSION),
            "pwconv2": tfm.linear_init(gen, d * EXPANSION, d),
            "gamma": torch.full((d,), 1e-6),
        } for _ in range(depth)]
        stages.append(stage)
    p["stages"] = stages
    p["norm"] = tfm.ln_init(d)
    return tree_map(lambda t: t.to(device), p)


def _block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["dwconv"], x, padding=3, groups=x.shape[-1])
    h = layer_norm(p["norm"], h, NORM_EPS)
    h = linear(p["pwconv2"], ACT_FNS["gelu"](linear(p["pwconv1"], h)))
    return x + h * p["gamma"].to(x.dtype)


@torch.inference_mode()
def convnext_apply(params: dict, cfg: ConvNeXtConfig, imgs: torch.Tensor) -> torch.Tensor:
    """Forward over ``imgs`` (N, 3, H, W) -> pooled features (N, d of the last stage)."""
    x = conv2d(params["stem"]["conv"], imgs.permute(0, 2, 3, 1), stride=4)
    x = layer_norm(params["stem"]["norm"], x, NORM_EPS)
    for stage in params["stages"]:
        if "downsample" in stage:
            x = layer_norm(stage["downsample"]["norm"], x, NORM_EPS)
            x = conv2d(stage["downsample"]["conv"], x, stride=2)
        for bp in stage["blocks"]:
            x = _block(bp, x)
    return layer_norm(params["norm"], x.mean(dim=(1, 2)), NORM_EPS)


class ConvNeXt(InferenceModel):
    def __init__(self, d_model: int, depths: tuple[int, ...], norm_eps: float = 1e-6, v2: bool = False,
                 rng: int = 0, device=None) -> None:
        if v2:
            raise NotImplementedError("ConvNeXt-V2 GRN is not supported (as in the JAX package)")
        self.cfg = ConvNeXtConfig(d_model, tuple(depths))
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = convnext_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    def __call__(self, imgs) -> torch.Tensor:
        return convnext_apply(self.params, self.cfg, to_tensor(imgs, self.device))

    @staticmethod
    def from_facebook(variant: str, *, pretrained: bool = False, device=None) -> "ConvNeXt":
        d_model, depths = VARIANTS[variant]
        m = ConvNeXt(d_model, depths, device=device)
        if pretrained:
            url = f"https://dl.fbaipublicfiles.com/convnext/convnext_{variant}_22k_224.pth"
            m.load_facebook_state_dict(load_torch_checkpoint(hub_download(url))["model"])
        return m

    def load_facebook_state_dict(self, state_dict: dict) -> None:
        """facebookresearch/ConvNeXt keys (``downsample_layers.N``,
        ``stages.N.M``) -> the port's params; the classifier head skipped,
        every other key consumed."""
        sd = StateDict(state_dict)
        p: dict = {"stem": {"conv": sd.pop_conv2d("downsample_layers.0.0"),
                            "norm": sd.pop_ln("downsample_layers.0.1")}}
        stages = []
        for stage_idx, depth in enumerate(self.cfg.depths):
            stage: dict = {}
            if stage_idx > 0:
                stage["downsample"] = {"norm": sd.pop_ln(f"downsample_layers.{stage_idx}.0"),
                                       "conv": sd.pop_conv2d(f"downsample_layers.{stage_idx}.1")}
            stage["blocks"] = [{
                "dwconv": sd.pop_conv2d(f"stages.{stage_idx}.{b}.dwconv"),
                "norm": sd.pop_ln(f"stages.{stage_idx}.{b}.norm"),
                "pwconv1": sd.pop_linear(f"stages.{stage_idx}.{b}.pwconv1"),
                "pwconv2": sd.pop_linear(f"stages.{stage_idx}.{b}.pwconv2"),
                "gamma": sd.pop(f"stages.{stage_idx}.{b}.gamma"),
            } for b in range(depth)]
            stages.append(stage)
        p["stages"] = stages
        p["norm"] = sd.pop_ln("norm")
        sd.pop("head.weight", None)
        sd.pop("head.bias", None)
        sd.finalize()
        self.params = tree_map(lambda t: t.to(device=self.device, dtype=torch.float32).contiguous(), p)
