"""MaxViT (PyTorch port of ``pytorch_models_tpu/models/image/maxvit.py``).

Stem convs -> 4 stages of MaxViT blocks: a pre-norm MBConv (squeeze-excite,
TF-"same" asymmetric padding at stride 2, an average-pooled shortcut), then
block attention (7 x 7 non-overlapping windows) and grid attention (a
dilated global grid), both with a learned 2D relative position bias. NHWC
end to end. The biased window attention takes :func:`ops.sdpa` (the
encoder-attention kernel takes no bias), as in the JAX package.
``from_google(variant, pretrained=True)`` reads the official TF checkpoint
(index and data shard) from the local cache (a miss downloads it) through
the port's numpy bundle reader (``utils/tf_ckpt.py``);
``load_google_state_dict`` takes any TF checkpoint reader.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ... import transformer as tfm
from ...ops import ACT_FNS, layer_norm, sdpa
from ...ops.layers import avg_pool2d, batch_norm, bn_init, conv2d, conv2d_init
from ...utils import hub_download, to_tensor, tree_map
from ...utils.module import InferenceModel, resolve_device

BN_EPS = 1e-3
GELU_TANH = ACT_FNS["approximate_gelu"]

# variant -> (stem_dim, blocks per stage, dims per stage): table 1 of the paper
VARIANTS = dict(
    tiny=(64, (2, 2, 5, 2), (64, 128, 256, 512)),
    small=(64, (2, 2, 5, 2), (96, 192, 384, 768)),
    base=(64, (2, 6, 14, 2), (96, 192, 384, 768)),
    large=(128, (2, 6, 14, 2), (128, 256, 512, 1024)),
    xlarge=(192, (2, 6, 14, 2), (192, 384, 768, 1536)),
)


@dataclass(frozen=True)
class MaxViTConfig:
    stem_dim: int
    n_blocks: tuple[int, ...]
    dims: tuple[int, ...]
    window_size: int = 7
    head_dim: int = 32


def _tf_conv(p: dict, x: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """A symmetric (k-1)//2 pad at stride 1; TF-"same"'s asymmetric (0, 1)
    pad at stride 2."""
    k = p["w"].shape[0]
    padding = ((0, 1), (0, 1)) if stride == 2 else (k - 1) // 2
    return conv2d(p, x, stride=stride, padding=padding, groups=groups)


def _cna(p: dict, x: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    return GELU_TANH(batch_norm(p["bn"], _tf_conv(p["conv"], x, stride, groups), BN_EPS))


def _se(p: dict, x: torch.Tensor) -> torch.Tensor:
    s = x.mean(dim=(1, 2), keepdim=True)
    s = torch.sigmoid(conv2d(p["expand"], F.silu(conv2d(p["reduce"], s))))
    return x * s


def _mbconv(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = batch_norm(p["pre_norm"], x, BN_EPS)
    h = _cna(p["expand"], h, 1)
    h = _cna(p["dw"], h, stride, groups=h.shape[-1])
    h = conv2d(p["shrink"], _se(p["se"], h))
    short = avg_pool2d(x, stride) if stride > 1 else x
    if "shortcut_conv" in p:
        short = conv2d(p["shortcut_conv"], short)
    return short + h


# window partitions over NHWC: (N, H, W, C) <-> (N, windows, s*s, C)
def window_block(x: torch.Tensor, s: int):
    n, h, w, c = x.shape
    nh, nw = h // s, w // s
    x = x.reshape(n, nh, s, nw, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, nh * nw, s * s, c), nh, nw


def window_unblock(x: torch.Tensor, nh: int, nw: int, s: int) -> torch.Tensor:
    n, c = x.shape[0], x.shape[-1]
    x = x.reshape(n, nh, nw, s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, nh * s, nw * s, c)


def window_grid(x: torch.Tensor, s: int):
    n, h, w, c = x.shape
    nh, nw = h // s, w // s
    x = x.reshape(n, s, nh, s, nw, c).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n, nh * nw, s * s, c), nh, nw


def window_ungrid(x: torch.Tensor, nh: int, nw: int, s: int) -> torch.Tensor:
    n, c = x.shape[0], x.shape[-1]
    x = x.reshape(n, nh, nw, s, s, c).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(n, s * nh, s * nw, c)


def _relative_bias(attn_bias: torch.Tensor, s: int) -> torch.Tensor:
    """(H, 2s-1, 2s-1) table -> (H, s*s, s*s) bias by 2D relative indices."""
    idx = torch.as_tensor(np.arange(s)[None, :] - np.arange(s)[:, None] + s - 1, device=attn_bias.device)
    b = attn_bias[:, idx][:, :, :, idx]  # (H, s, s, s, s)
    return b.permute(0, 1, 3, 2, 4).reshape(attn_bias.shape[0], s * s, s * s)


def _rel_attn_layer(p: dict, cfg: MaxViTConfig, x: torch.Tensor, d_model: int) -> torch.Tensor:
    """A pre-norm encoder layer whose attention adds the relative bias."""
    lc = tfm.LayerConfig.make(d_model, head_dim=cfg.head_dim, act="approximate_gelu")
    bias = _relative_bias(p["sa"]["attn_bias"], cfg.window_size)
    h = layer_norm(p["sa_norm"], x)
    qh, kh, vh = (tfm.split_heads(tfm.linear(p["sa"][n], h), lc.n_heads, lc.head_dim) for n in ("q", "k", "v"))
    x = x + tfm.linear(p["sa"]["o"], tfm.merge_heads(sdpa(qh, kh, vh, attn_bias=bias)))
    return x + tfm.mlp_apply(p["mlp"], layer_norm(p["mlp_norm"], x), "approximate_gelu")


def _block_apply(p: dict, cfg: MaxViTConfig, x: torch.Tensor, d_model: int, stride: int) -> torch.Tensor:
    x = _mbconv(p["mbconv"], x, stride)
    s = cfg.window_size
    xb, nh, nw = window_block(x, s)
    x = window_unblock(_rel_attn_layer(p["block_layer"], cfg, xb, d_model), nh, nw, s)
    xg, nh, nw = window_grid(x, s)
    return window_ungrid(_rel_attn_layer(p["grid_layer"], cfg, xg, d_model), nh, nw, s)


@torch.inference_mode()
def maxvit_apply(params: dict, cfg: MaxViTConfig, imgs: torch.Tensor) -> torch.Tensor:
    """Forward over ``imgs`` (N, 3, H, W) -> pooled features (N, dims[-1])."""
    x = _tf_conv(params["stem"]["conv1"], imgs.permute(0, 2, 3, 1), 2)
    x = GELU_TANH(batch_norm(params["stem"]["bn"], x, BN_EPS))
    x = _tf_conv(params["stem"]["conv2"], x, 1)
    for stage, dim in zip(params["stages"], cfg.dims):
        for i, bp in enumerate(stage):
            x = _block_apply(bp, cfg, x, dim, 2 if i == 0 else 1)
    return layer_norm(params["norm"], x.mean(dim=(1, 2)))


def maxvit_init(gen: torch.Generator, cfg: MaxViTConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (torch-default
    uniform convs and linears, unit BatchNorm statistics, zero relative-bias
    tables), then moved to ``device``."""
    s = cfg.window_size

    def mbconv_p(in_dim, out_dim):
        hidden = out_dim * 4
        p = {
            "pre_norm": bn_init(in_dim),
            "expand": {"conv": conv2d_init(gen, 1, 1, in_dim, hidden, bias=False), "bn": bn_init(hidden)},
            "dw": {"conv": conv2d_init(gen, 3, 3, hidden, hidden, bias=False, groups=hidden), "bn": bn_init(hidden)},
            "se": {"reduce": conv2d_init(gen, 1, 1, hidden, hidden // 16),
                   "expand": conv2d_init(gen, 1, 1, hidden // 16, hidden)},
            "shrink": conv2d_init(gen, 1, 1, hidden, out_dim),
        }
        if in_dim != out_dim:
            p["shortcut_conv"] = conv2d_init(gen, 1, 1, in_dim, out_dim)
        return p

    def attn_layer_p(d):
        return {
            "sa_norm": tfm.ln_init(d),
            "sa": {"attn_bias": torch.zeros(d // cfg.head_dim, 2 * s - 1, 2 * s - 1),
                   **{n: tfm.linear_init(gen, d, d) for n in ("q", "k", "v", "o")}},
            "mlp_norm": tfm.ln_init(d),
            "mlp": tfm.mlp_init(gen, d, d * 4),
        }

    p = {"stem": {"conv1": conv2d_init(gen, 3, 3, 3, cfg.stem_dim), "bn": bn_init(cfg.stem_dim),
                  "conv2": conv2d_init(gen, 3, 3, cfg.stem_dim, cfg.stem_dim)}}
    stages = []
    in_dim = cfg.stem_dim
    for n_block, dim in zip(cfg.n_blocks, cfg.dims):
        stage = []
        for _ in range(n_block):
            stage.append({"mbconv": mbconv_p(in_dim, dim), "block_layer": attn_layer_p(dim),
                          "grid_layer": attn_layer_p(dim)})
            in_dim = dim
        stages.append(stage)
    p["stages"] = stages
    p["norm"] = tfm.ln_init(in_dim)
    return tree_map(lambda t: t.to(device), p)


class MaxViT(InferenceModel):
    def __init__(self, stem_dim: int, n_blocks, dims, dropout: float = 0.0, rng: int = 0, device=None) -> None:
        # dropout: accepted at the JAX constructor's position for API parity; inference-only
        self.cfg = MaxViTConfig(stem_dim, tuple(n_blocks), tuple(dims))
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = maxvit_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    def __call__(self, imgs) -> torch.Tensor:
        return maxvit_apply(self.params, self.cfg, to_tensor(imgs, self.device))

    @staticmethod
    def from_google(variant: str, *, pretrained: bool = False, **kwargs) -> "MaxViT":
        stem_dim, n_blocks, dims = VARIANTS[variant]
        m = MaxViT(stem_dim, n_blocks, dims, **kwargs)
        if pretrained:
            from ...utils.tf_ckpt import load_tf_checkpoint

            ds, step = ("i1k", 92002) if variant in ("tiny", "small") else ("i21k_pt", 279498)
            url = f"https://storage.googleapis.com/gresearch/maxvit/ckpts/maxvit{variant}/{ds}/224/model.ckpt-{step}"
            hub_download(f"{url}.data-00000-of-00001", f"maxvit_{variant}")
            ckpt_path = hub_download(f"{url}.index", f"maxvit_{variant}").removesuffix(".index")
            reader = load_tf_checkpoint(ckpt_path)
            m.load_google_state_dict(reader)
            reader.close()
        return m

    def load_google_state_dict(self, reader) -> None:
        """A TF checkpoint reader's EMA variables -> the port's params.

        ``reader`` needs ``get_tensor(name)``; where it also has
        ``get_variable_to_shape_map()``, every EMA variable must be consumed.
        TF kernels are HWIO, the port's layout; a depthwise (kh, kw, C, 1)
        kernel swaps its last two axes; q/k/v weights (d, H, hd) flatten to
        (d, H*hd), the output's (H, hd, d) to (H*hd, d).
        """
        shape_map = getattr(reader, "get_variable_to_shape_map", None)
        left = None if shape_map is None else {k for k in shape_map() if k.endswith("ExponentialMovingAverage")}

        def get(name):
            full = f"maxvit/{name}/ExponentialMovingAverage"
            if left is not None:
                left.remove(full)
            return torch.from_numpy(np.array(reader.get_tensor(full), dtype=np.float32))

        def conv(pfx, bias=True, depthwise=False):
            p = {"w": get(f"{pfx}/depthwise_kernel").permute(0, 1, 3, 2) if depthwise else get(f"{pfx}/kernel")}
            if bias:
                p["b"] = get(f"{pfx}/bias")
            return p

        def lin(pfx, flatten_out=True):
            w = get(f"{pfx}/weight")
            if w.ndim == 3:
                w = w.reshape(w.shape[0], -1) if flatten_out else w.reshape(-1, w.shape[-1])
            return {"w": w, "b": get(f"{pfx}/bias").reshape(-1)}

        def ln(pfx):
            return {"scale": get(f"{pfx}/gamma"), "bias": get(f"{pfx}/beta")}

        def bn(pfx):
            return {"scale": get(f"{pfx}/gamma"), "bias": get(f"{pfx}/beta"),
                    "mean": get(f"{pfx}/moving_mean"), "var": get(f"{pfx}/moving_variance")}

        def attn_layer(pfx, suffix):
            a = f"{pfx}/attention{suffix}"
            return {
                "sa_norm": ln(f"{pfx}/attn_layer_norm{suffix}"),
                "sa": {"attn_bias": get(f"{a}/relative_bias"), "q": lin(f"{a}/q"), "k": lin(f"{a}/k"),
                       "v": lin(f"{a}/v"), "o": lin(f"{a}/o", flatten_out=False)},
                "mlp_norm": ln(f"{pfx}/ffn_layer_norm{suffix}"),
                "mlp": {"fc1": lin(f"{pfx}/ffn{suffix}/expand_dense"), "fc2": lin(f"{pfx}/ffn{suffix}/shrink_dense")},
            }

        cfg = self.cfg
        p = {"stem": {"conv1": conv("stem/conv_0"), "bn": bn("stem/norm_0"), "conv2": conv("stem/conv_1")}}
        stages = []
        in_dim = cfg.stem_dim
        for stage_idx, (n_block, dim) in enumerate(zip(cfg.n_blocks, cfg.dims)):
            stage = []
            for block_idx in range(n_block):
                pfx = f"block_{stage_idx:02d}_{block_idx:02d}"
                mb = f"{pfx}/mbconv"
                bp = {
                    "mbconv": {
                        "pre_norm": bn(f"{mb}/pre_norm"),
                        "expand": {"conv": conv(f"{mb}/expand_conv", bias=False), "bn": bn(f"{mb}/expand_norm")},
                        "dw": {"conv": conv(f"{mb}/depthwise_conv", bias=False, depthwise=True),
                               "bn": bn(f"{mb}/depthwise_norm")},
                        "se": {"reduce": conv(f"{mb}/se/reduce_conv2d"), "expand": conv(f"{mb}/se/expand_conv2d")},
                        "shrink": conv(f"{mb}/shrink_conv"),
                    },
                    "block_layer": attn_layer(pfx, ""),
                    "grid_layer": attn_layer(pfx, "_1"),
                }
                if in_dim != dim:
                    bp["mbconv"]["shortcut_conv"] = conv(f"{mb}/shortcut_conv")
                stage.append(bp)
                in_dim = dim
            stages.append(stage)
        p["stages"] = stages
        p["norm"] = ln("final_layer_norm")
        if left:
            raise ValueError(f"unconsumed TF variables: {sorted(left)[:5]}...")
        self.params = tree_map(lambda t: t.to(self.device).contiguous(), p)
