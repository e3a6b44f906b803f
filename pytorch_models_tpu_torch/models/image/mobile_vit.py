"""MobileViT (PyTorch port of ``pytorch_models_tpu/models/image/mobile_vit.py``).

MobileNetV2 MBConv stages (pw-dw-pw + residual) interleaved with MobileViT
blocks: conv -> unfold into 2 x 2-strided patch groups -> a pre-norm
transformer encoder (4 heads, mlp_ratio 2, SiLU) -> fold back -> 1 x 1 proj
-> concat-fusion conv. Conv + BatchNorm + SiLU throughout; NHWC end to end.
The head widths (36, 48, 60 for MobileViT-S) are not ones the
encoder-attention kernel is built for, so ``transformer.encoder_apply``'s
auto gate sends them to :func:`ops.sdpa`, as in the JAX package.
``from_apple(variant, pretrained=True)`` reads Apple's CVNets ``.pt`` from
the local cache (a miss downloads it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ... import transformer as tfm
from ...ops import layer_norm
from ...ops.layers import batch_norm, bn_init, conv2d, conv2d_init
from ...utils import StateDict, hub_download, to_tensor, tree_map
from ...utils.checkpoint import load_torch_checkpoint
from ...utils.module import InferenceModel, resolve_device

# variant -> (channels, transformer widths, out_dim, expansion)
VARIANTS = dict(
    xxs=([16, 24, 48, 64, 80], [64, 80, 96], 320, 2),
    xs=([32, 48, 64, 80, 96], [96, 120, 144], 384, 4),
    s=([32, 64, 96, 128, 160], [144, 192, 240], 640, 4),
)


@dataclass(frozen=True)
class MobileViTConfig:
    channels: tuple[int, ...]
    d_models: tuple[int, ...]
    out_dim: int
    expansion: int
    patch_size: int = 2

    def vit_layer(self, d_model: int) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(d_model, n_heads=4, mlp_ratio=2.0, act="silu")


def _cna_init(gen, in_dim, out_dim, k, groups=1):
    return {"conv": conv2d_init(gen, k, k, in_dim, out_dim, bias=False, groups=groups), "bn": bn_init(out_dim)}


def _cna(p: dict, x: torch.Tensor, stride: int = 1, groups: int = 1, act: bool = True) -> torch.Tensor:
    k = p["conv"]["w"].shape[0]
    x = batch_norm(p["bn"], conv2d(p["conv"], x, stride=stride, padding=(k - 1) // 2, groups=groups))
    return F.silu(x) if act else x


def _mbconv_init(gen, in_dim, expansion, out_dim):
    hidden = in_dim * expansion
    return {"pw1": _cna_init(gen, in_dim, hidden, 1), "dw": _cna_init(gen, hidden, hidden, 3, groups=hidden),
            "pw2": _cna_init(gen, hidden, out_dim, 1)}


def _mbconv(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    hidden = p["dw"]["conv"]["w"].shape[-1]
    out = _cna(p["pw1"], x, 1)
    out = _cna(p["dw"], out, stride, groups=hidden)
    out = _cna(p["pw2"], out, 1, act=False)
    return x + out if x.shape[-1] == out.shape[-1] and stride == 1 else out


# unfold / fold over NHWC: (N, H, W, C) <-> (N, p*p, patches, C)
def unfold(x: torch.Tensor, p: int):
    n, h, w, c = x.shape
    nh, nw = h // p, w // p
    x = x.reshape(n, nh, p, nw, p, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n, p * p, nh * nw, c), (nh, nw)


def fold(x: torch.Tensor, p: int, n_patches) -> torch.Tensor:
    nh, nw = n_patches
    n, c = x.shape[0], x.shape[-1]
    x = x.reshape(n, p, p, nh, nw, c).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(n, nh * p, nw * p, c)


def _vit_block_init(gen, cfg: MobileViTConfig, in_dim, d_model, n_layers):
    return {
        "in_cna": _cna_init(gen, in_dim, in_dim, 3),
        "in_proj": {"w": conv2d_init(gen, 1, 1, in_dim, d_model, bias=False)["w"]},
        "encoder": tfm.encoder_init(gen, n_layers, cfg.vit_layer(d_model)),
        "norm": tfm.ln_init(d_model),
        "out_proj": _cna_init(gen, d_model, in_dim, 1),
        "out_fusion": _cna_init(gen, in_dim * 2, in_dim, 3),
    }


def _vit_block(p: dict, cfg: MobileViTConfig, x: torch.Tensor, d_model: int) -> torch.Tensor:
    out = conv2d(p["in_proj"], _cna(p["in_cna"], x, 1))
    out, n_patches = unfold(out, cfg.patch_size)
    out = layer_norm(p["norm"], tfm.encoder_apply(p["encoder"], cfg.vit_layer(d_model), out))
    out = _cna(p["out_proj"], fold(out, cfg.patch_size, n_patches), 1)
    return _cna(p["out_fusion"], torch.cat([x, out], dim=-1), 1)


def mobilevit_init(gen: torch.Generator, cfg: MobileViTConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (torch-default
    uniform convs and linears, unit BatchNorm statistics), then moved to
    ``device``."""
    ch, dm, e = cfg.channels, cfg.d_models, cfg.expansion
    p = {
        "stem_cna": _cna_init(gen, 3, 16, 3),
        "stem_mb": _mbconv_init(gen, 16, e, ch[0]),
        "s2": [_mbconv_init(gen, ch[0], e, ch[1]), _mbconv_init(gen, ch[1], e, ch[1]),
               _mbconv_init(gen, ch[1], e, ch[1])],
        "s3_mb": _mbconv_init(gen, ch[1], e, ch[2]),
        "s3_vit": _vit_block_init(gen, cfg, ch[2], dm[0], 2),
        "s4_mb": _mbconv_init(gen, ch[2], e, ch[3]),
        "s4_vit": _vit_block_init(gen, cfg, ch[3], dm[1], 4),
        "s5_mb": _mbconv_init(gen, ch[3], e, ch[4]),
        "s5_vit": _vit_block_init(gen, cfg, ch[4], dm[2], 3),
        "head_cna": _cna_init(gen, ch[4], cfg.out_dim, 1),
    }
    return tree_map(lambda t: t.to(device), p)


@torch.inference_mode()
def mobilevit_apply(params: dict, cfg: MobileViTConfig, imgs: torch.Tensor) -> torch.Tensor:
    """Forward over ``imgs`` (N, 3, H, W) -> pooled features (N, out_dim)."""
    dm = cfg.d_models
    x = _cna(params["stem_cna"], imgs.permute(0, 2, 3, 1), 2)
    x = _mbconv(params["stem_mb"], x)
    x = _mbconv(params["s2"][0], x, 2)
    x = _mbconv(params["s2"][1], x)
    x = _mbconv(params["s2"][2], x)
    x = _vit_block(params["s3_vit"], cfg, _mbconv(params["s3_mb"], x, 2), dm[0])
    x = _vit_block(params["s4_vit"], cfg, _mbconv(params["s4_mb"], x, 2), dm[1])
    x = _vit_block(params["s5_vit"], cfg, _mbconv(params["s5_mb"], x, 2), dm[2])
    return _cna(params["head_cna"], x, 1).mean(dim=(1, 2))


class MobileViT(InferenceModel):
    def __init__(self, channels, d_models, out_dim: int, expansion: int, rng: int = 0, device=None) -> None:
        self.cfg = MobileViTConfig(tuple(channels), tuple(d_models), out_dim, expansion)
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = mobilevit_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    def __call__(self, imgs) -> torch.Tensor:
        return mobilevit_apply(self.params, self.cfg, to_tensor(imgs, self.device))

    @staticmethod
    def from_apple(variant: str, *, pretrained: bool = False, device=None) -> "MobileViT":
        channels, d_models, out_dim, expansion = VARIANTS[variant]
        m = MobileViT(channels, d_models, out_dim, expansion, device=device)
        if pretrained:
            url = ("https://docs-assets.developer.apple.com/ml-research/models/cvnets/classification/"
                   f"mobilevit_{variant}.pt")
            m.load_apple_state_dict(load_torch_checkpoint(hub_download(url)))
        return m

    def load_apple_state_dict(self, state_dict: dict) -> None:
        """Apple CVNets keys -> the port's params: the fused qkv split in
        three, the BatchNorm statistics, and the first conv's input channels
        flipped BGR -> RGB (the v0.1 weights were trained on OpenCV images);
        the classifier skipped, every other key consumed."""
        sd = StateDict(state_dict)

        def bn(pfx):
            p = {"scale": sd.pop(f"{pfx}.weight"), "bias": sd.pop(f"{pfx}.bias"),
                 "mean": sd.pop(f"{pfx}.running_mean"), "var": sd.pop(f"{pfx}.running_var")}
            sd.pop(f"{pfx}.num_batches_tracked")
            return p

        def cna(pfx):
            return {"conv": sd.pop_conv2d(f"{pfx}.block.conv", bias=False), "bn": bn(f"{pfx}.block.norm")}

        def mbconv(pfx):
            return {"pw1": cna(f"{pfx}.exp_1x1"), "dw": cna(f"{pfx}.conv_3x3"), "pw2": cna(f"{pfx}.red_1x1")}

        def encoder(pfx, n_layers):
            layers = []
            for i in range(n_layers):
                lp = f"{pfx}.{i}"
                qkv_w = sd.pop(f"{lp}.pre_norm_mha.1.qkv_proj.weight").chunk(3, dim=0)
                qkv_b = sd.pop(f"{lp}.pre_norm_mha.1.qkv_proj.bias").chunk(3, dim=0)
                layers.append({
                    "sa_norm": sd.pop_ln(f"{lp}.pre_norm_mha.0"),
                    "sa": {"q": {"w": qkv_w[0].t(), "b": qkv_b[0]}, "k": {"w": qkv_w[1].t(), "b": qkv_b[1]},
                           "v": {"w": qkv_w[2].t(), "b": qkv_b[2]},
                           "o": sd.pop_linear(f"{lp}.pre_norm_mha.1.out_proj")},
                    "mlp_norm": sd.pop_ln(f"{lp}.pre_norm_ffn.0"),
                    "mlp": {"fc1": sd.pop_linear(f"{lp}.pre_norm_ffn.1"),
                            "fc2": sd.pop_linear(f"{lp}.pre_norm_ffn.4")},
                })
            return {"layers": layers}

        def vit_block(pfx, n_layers):
            return {
                "in_cna": cna(f"{pfx}.local_rep.conv_3x3"),
                "in_proj": {"w": sd.pop(f"{pfx}.local_rep.conv_1x1.block.conv.weight").permute(2, 3, 1, 0)},
                "encoder": encoder(f"{pfx}.global_rep", n_layers),
                "norm": sd.pop_ln(f"{pfx}.global_rep.{n_layers}"),
                "out_proj": cna(f"{pfx}.conv_proj"),
                "out_fusion": cna(f"{pfx}.fusion"),
            }

        stem_cna = cna("conv_1")
        stem_cna["conv"]["w"] = stem_cna["conv"]["w"].flip(2)  # BGR -> RGB (HWIO axis 2)
        p = {
            "stem_cna": stem_cna,
            "stem_mb": mbconv("layer_1.0.block"),
            "s2": [mbconv(f"layer_2.{i}.block") for i in range(3)],
            "s3_mb": mbconv("layer_3.0.block"),
            "s3_vit": vit_block("layer_3.1", 2),
            "s4_mb": mbconv("layer_4.0.block"),
            "s4_vit": vit_block("layer_4.1", 4),
            "s5_mb": mbconv("layer_5.0.block"),
            "s5_vit": vit_block("layer_5.1", 3),
            "head_cna": cna("conv_1x1_exp"),
        }
        sd.pop("classifier.fc.weight")
        sd.pop("classifier.fc.bias")
        sd.finalize()
        self.params = tree_map(lambda t: t.to(device=self.device, dtype=torch.float32).contiguous(), p)
