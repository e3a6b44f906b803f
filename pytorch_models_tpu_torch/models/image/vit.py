"""ViT — Vision Transformer (PyTorch port of ``pytorch_models_tpu/models/image/vit.py``).

Patch-embed conv (NHWC data, HWIO kernel: the JAX package's layouts) → +
learned PE → optional cls token → pre-norm encoder → LayerNorm → pooler
(``cls_token``, ``gap`` or SigLIP's ``mha`` probe). Self-attention and the
probe go through ``transformer.mha_apply``, whose auto gate sends a head
width the encoder-attention kernel serves (ViT-Ti..L: 64) to it on the card
(``ops/encoder_attention.py``, K1).

Public API as the JAX package's: ``ViT.from_google("B/16_augreg")``,
``ViT.from_facebook("B/16_deit3")``, ``model(imgs)`` with NCHW images,
``resize_pe(size)``, the ``load_flax_ckpt`` / ``load_facebook_state_dict``
converters. ``pretrained=True`` needs a download and raises. The model runs
on the CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from ... import transformer as tfm
from ...ops import layer_norm
from ...ops.layers import conv2d, conv2d_init
from ...utils import StateDict, to_tensor, tree_map
from ...utils.module import InferenceModel, resolve_device

NORM_EPS = 1e-6

# tag -> (n_layers, d_model, n_heads)
SIZES = dict(
    Ti=(12, 192, 3),
    S=(12, 384, 6),
    M=(12, 512, 8),
    B=(12, 768, 12),
    L=(24, 1024, 16),
    H=(32, 1280, 16),
)


@dataclass(frozen=True)
class ViTConfig:
    n_layers: int
    d_model: int
    n_heads: int
    patch_size: int
    img_size: int = 224
    cls_token: bool = True
    pool_type: str = "cls_token"

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, n_heads=self.n_heads, norm_eps=NORM_EPS)


def vit_init(gen: torch.Generator, cfg: ViTConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (the JAX init's
    distributions: torch-default uniform conv and linears, zero PE, cls
    token and probe), then moved to ``device``."""
    if cfg.img_size % cfg.patch_size:
        raise ValueError(f"img_size {cfg.img_size} is not a multiple of patch_size {cfg.patch_size}")
    n_patches = (cfg.img_size // cfg.patch_size) ** 2
    p = {
        "patch_embed": conv2d_init(gen, cfg.patch_size, cfg.patch_size, 3, cfg.d_model),
        "pe": torch.zeros(1, n_patches, cfg.d_model),
        "encoder": tfm.encoder_init(gen, cfg.n_layers, cfg.layer),
        "norm": tfm.ln_init(cfg.d_model),
    }
    if cfg.cls_token:
        p["cls_token"] = torch.zeros(1, 1, cfg.d_model)
    if cfg.pool_type == "mha":
        p["pooler"] = {
            "probe": torch.zeros(1, 1, cfg.d_model),
            "attn": tfm.mha_init(gen, cfg.layer),
            "norm": tfm.ln_init(cfg.d_model),
            "mlp": tfm.mlp_init(gen, cfg.d_model, cfg.d_model * 4),
        }
    return tree_map(lambda t: t.to(device), p)


def _pool(p: dict, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    """Poolers: cls_token / gap / the mha probe (SigLIP's MAP head)."""
    if cfg.pool_type == "cls_token":
        return x[:, 0]
    if cfg.pool_type == "gap":
        return x.mean(dim=1)
    pp = p["pooler"]
    probe = pp["probe"].to(x.dtype).expand(x.shape[0], 1, cfg.d_model)
    out = tfm.mha_apply(pp["attn"], cfg.layer, probe, x)[:, 0]
    return out + tfm.mlp_apply(pp["mlp"], layer_norm(pp["norm"], out, NORM_EPS))


@torch.inference_mode()
def vit_apply(params: dict, cfg: ViTConfig, imgs: torch.Tensor) -> torch.Tensor:
    """Forward over ``imgs`` (N, 3, H, W) -> pooled features (N, d_model)."""
    x = conv2d(params["patch_embed"], imgs.permute(0, 2, 3, 1), stride=cfg.patch_size)  # NHWC
    x = x.reshape(x.shape[0], -1, cfg.d_model)  # (N, H*W, C), patches in row-major order
    x = x + params["pe"].to(x.dtype)
    if "cls_token" in params:
        cls = params["cls_token"].to(x.dtype).expand(x.shape[0], 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1)
    x = tfm.encoder_apply(params["encoder"], cfg.layer, x)
    x = layer_norm(params["norm"], x, NORM_EPS)
    return _pool(params, cfg, x)


class ViT(InferenceModel):
    """The JAX package's ViT surface over a parameter dict."""

    def __init__(
        self,
        n_layers: int,
        d_model: int,
        n_heads: int,
        patch_size: int,
        img_size: int = 224,
        cls_token: bool = True,
        pool_type: str = "cls_token",
        dropout: float = 0.0,  # accepted for API parity; inference-only
        rng: int = 0,
        device=None,
    ) -> None:
        self.cfg = ViTConfig(n_layers, d_model, n_heads, patch_size, img_size, cls_token, pool_type)
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = vit_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    def __call__(self, imgs) -> torch.Tensor:
        return vit_apply(self.params, self.cfg, to_tensor(imgs, self.device))

    def resize_pe(self, size: int, interpolation_mode: str = "bicubic") -> None:
        """Resample the learned PE grid for a new input size, as
        ``jax.image.resize(..., "bicubic")`` does: torch's antialiased bicubic
        is its Keys cubic (a = -0.5) with half-pixel centres, a kernel
        widened when it shrinks and weights renormalised at the border."""
        if interpolation_mode != "bicubic":
            raise ValueError(f"interpolation_mode: only 'bicubic' is ported, got {interpolation_mode!r}")
        pe = self.params["pe"]
        old = int(round(pe.shape[1] ** 0.5))
        new = size // self.cfg.patch_size
        grid = pe.reshape(1, old, old, self.cfg.d_model).permute(0, 3, 1, 2).float()
        grid = F.interpolate(grid, size=(new, new), mode="bicubic", align_corners=False, antialias=True)
        self.params["pe"] = grid.permute(0, 2, 3, 1).reshape(1, new * new, self.cfg.d_model).to(pe.dtype)
        self.cfg = replace(self.cfg, img_size=new * self.cfg.patch_size)

    # ------------------------------------------------------------------
    # Google checkpoints: AugReg and SigLIP (big_vision) Flax .npz
    # ------------------------------------------------------------------

    @staticmethod
    def from_google(model_tag: str, *, pretrained: bool = False, **kwargs) -> "ViT":
        """``"B/16"`` or ``"B/16_augreg"`` (cls pooling), ``"B/16_siglip"``
        (no cls token, the MAP head)."""
        model_tag, _, weights = model_tag.partition("_")
        weights = weights or "augreg"
        size, patch_size = model_tag.split("/")
        n_layers, d_model, n_heads = SIZES[size]
        if weights == "siglip":
            kwargs = {"cls_token": False, "pool_type": "mha", **kwargs}
        if pretrained:
            raise NotImplementedError("pretrained ViT weights need a download; load a checkpoint with "
                                      "load_flax_ckpt instead")
        return ViT(n_layers, d_model, n_heads, int(patch_size), **kwargs)

    def load_flax_ckpt(self, ckpt: dict, *, big_vision: bool = False, prefix: str = "") -> None:
        """A Flax .npz param dict (AugReg, or big_vision/SigLIP with its other
        block names and no cls slot in the PE) -> the port's params, every
        key consumed (``StateDict.finalize`` raises on a leftover)."""
        if big_vision:
            mha_norm, mha, mlp_norm, mlp = "LayerNorm_0", "MultiHeadDotProductAttention_0", "LayerNorm_1", "MlpBlock_0"
        else:
            mha_norm, mha, mlp_norm, mlp = "LayerNorm_0", "MultiHeadDotProductAttention_1", "LayerNorm_2", "MlpBlock_3"

        sd = StateDict({k[len(prefix):]: v for k, v in ckpt.items() if k.startswith(prefix)})
        cfg, d = self.cfg, self.cfg.d_model
        p: dict = {}

        def flax_linear(pfx: str) -> dict:
            w = sd.pop(f"{pfx}/kernel")  # q/k/v kernels are (d, H, hd) -> (d, H*hd)
            return {"w": w.reshape(w.shape[0], -1) if w.ndim > 2 else w, "b": sd.pop(f"{pfx}/bias").reshape(-1)}

        def flax_out_linear(pfx: str) -> dict:  # (H, hd, d) -> (H*hd, d)
            return {"w": sd.pop(f"{pfx}/kernel").reshape(-1, d), "b": sd.pop(f"{pfx}/bias").reshape(-1)}

        def flax_ln(pfx: str) -> dict:
            return {"scale": sd.pop(f"{pfx}/scale"), "bias": sd.pop(f"{pfx}/bias")}

        def flax_mha(pfx: str) -> dict:
            return {"q": flax_linear(f"{pfx}/query"), "k": flax_linear(f"{pfx}/key"),
                    "v": flax_linear(f"{pfx}/value"), "o": flax_out_linear(f"{pfx}/out")}

        if cfg.cls_token:
            cls = sd.pop("cls").float()
        if big_vision:
            p["pe"] = sd.pop("pos_embedding")
        else:
            pe = sd.pop("Transformer/posembed_input/pos_embedding").float()
            cls = cls + pe[:, 0]  # the PE's cls slot folded into the token
            p["pe"] = pe[:, 1:]
        if cfg.cls_token:
            p["cls_token"] = cls
        p["patch_embed"] = {"w": sd.pop("embedding/kernel"), "b": sd.pop("embedding/bias")}
        p["norm"] = flax_ln("Transformer/encoder_norm")
        layers = []
        for i in range(cfg.n_layers):
            blk = f"Transformer/encoderblock_{i}"
            layers.append({
                "sa_norm": flax_ln(f"{blk}/{mha_norm}"),
                "sa": flax_mha(f"{blk}/{mha}"),
                "mlp_norm": flax_ln(f"{blk}/{mlp_norm}"),
                "mlp": {"fc1": flax_linear(f"{blk}/{mlp}/Dense_0"), "fc2": flax_linear(f"{blk}/{mlp}/Dense_1")},
            })
        p["encoder"] = {"layers": layers}
        if cfg.pool_type == "mha":  # big_vision only
            p["pooler"] = {
                "probe": sd.pop("MAPHead_0/probe"),
                "attn": flax_mha("MAPHead_0/MultiHeadDotProductAttention_0"),
                "norm": flax_ln("MAPHead_0/LayerNorm_0"),
                "mlp": {"fc1": flax_linear("MAPHead_0/MlpBlock_0/Dense_0"),
                        "fc2": flax_linear("MAPHead_0/MlpBlock_0/Dense_1")},
            }
        sd.finalize()
        self.params = tree_map(lambda t: t.to(device=self.device, dtype=torch.float32).contiguous(), p)

    # ------------------------------------------------------------------
    # Facebook checkpoints: DeiT-3 / DINO / DINOv2 (timm-style keys)
    # ------------------------------------------------------------------

    @staticmethod
    def from_facebook(model_tag: str, *, pretrained: bool = False, **kwargs) -> "ViT":
        """``"B/16"`` or ``"B/16_deit3"`` (224), ``"_dino"`` (224),
        ``"_dinov2"`` (518 by default)."""
        model_tag, _, weights = model_tag.partition("_")
        weights = weights or "deit3"
        size, patch_size = model_tag.split("/")
        if weights not in ("deit3", "dino", "dinov2"):
            raise ValueError(f"Unsupported {weights}")
        kwargs["img_size"] = kwargs.get("img_size", 518 if weights == "dinov2" else 224)
        n_layers, d_model, n_heads = SIZES[size]
        if pretrained:
            raise NotImplementedError("pretrained ViT weights need a download; load a state dict with "
                                      "load_facebook_state_dict instead")
        return ViT(n_layers, d_model, n_heads, int(patch_size), **kwargs)

    def load_facebook_state_dict(self, state_dict: dict) -> None:
        """timm-style keys -> the port's params: the fused qkv split in three,
        LayerScale's gammas folded into the out projection and fc2, the PE cut
        to the patch grid and an extra PE slot added into the cls token;
        every key consumed but dinov2's mask token and deit3's classifier."""
        sd = StateDict(state_dict)
        cfg = self.cfg
        p: dict = {"patch_embed": sd.pop_conv2d("patch_embed.proj")}
        pe = sd.pop("pos_embed").float()
        n_patches = (cfg.img_size // cfg.patch_size) ** 2
        p["pe"] = pe[:, -n_patches:]
        cls = sd.pop("cls_token").float()
        if pe.shape[1] > n_patches:
            cls = cls + pe[:, 0]
        p["cls_token"] = cls
        p["norm"] = sd.pop_ln("norm")

        def gamma(pfx: str, i: int):
            g = sd.pop(f"{pfx}.gamma_{i}", None)  # deit3
            return sd.pop(f"{pfx}.ls{i}.gamma", None) if g is None else g  # dinov2

        layers = []
        for i in range(cfg.n_layers):
            pfx = f"blocks.{i}"
            qkv_w = sd.pop(f"{pfx}.attn.qkv.weight").float().chunk(3, dim=0)
            qkv_b = sd.pop(f"{pfx}.attn.qkv.bias").float().chunk(3, dim=0)
            out = {k: t.float() for k, t in sd.pop_linear(f"{pfx}.attn.proj").items()}
            g1 = gamma(pfx, 1)
            if g1 is not None:
                out = {"w": out["w"] * g1.float()[None, :], "b": out["b"] * g1.float()}
            mlp = {"fc1": sd.pop_linear(f"{pfx}.mlp.fc1"), "fc2": sd.pop_linear(f"{pfx}.mlp.fc2")}
            g2 = gamma(pfx, 2)
            if g2 is not None:
                mlp["fc2"] = {"w": mlp["fc2"]["w"].float() * g2.float()[None, :],
                              "b": mlp["fc2"]["b"].float() * g2.float()}
            layers.append({
                "sa_norm": sd.pop_ln(f"{pfx}.norm1"),
                "sa": {"q": {"w": qkv_w[0].t(), "b": qkv_b[0]}, "k": {"w": qkv_w[1].t(), "b": qkv_b[1]},
                       "v": {"w": qkv_w[2].t(), "b": qkv_b[2]}, "o": out},
                "mlp_norm": sd.pop_ln(f"{pfx}.norm2"),
                "mlp": mlp,
            })
        p["encoder"] = {"layers": layers}
        # known extra keys the model does not use: dinov2's mask_token, deit3's classifier head
        for extra in ("mask_token", "head.weight", "head.bias"):
            sd.pop(extra, None)
        sd.finalize()
        self.params = tree_map(lambda t: t.to(device=self.device, dtype=torch.float32).contiguous(), p)
