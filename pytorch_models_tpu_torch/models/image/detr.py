"""DETR object detection (PyTorch port of ``pytorch_models_tpu/models/image/detr.py``).

ResNet-50/101 backbone (NHWC) -> 1 x 1 input projection -> a fixed 2D
sinusoidal PE (normalised to 2 pi, sin/cos interleaved) -> 6 post-norm
encoder layers with the PE added to q and k only -> 6 decoder layers over
all 100 learned queries in parallel (the query embedding added to q and k,
the PE to the memory keys, no causal mask) -> a class head and a 3-layer
box MLP -> sigmoid cxcywh boxes. The attention goes through
``transformer.mha_apply``, whose auto gate sends DETR's head width 32 to the
encoder-attention kernel on the card (``ops/encoder_attention.py``, K1):
encoder self-attention, decoder self-attention and the decoder's
cross-attention over the memory, 18 launches a forward.
``DETRPipeline`` pads, normalises and post-processes in numpy, as the JAX
package does. ``from_facebook(pretrained=True)`` needs a download and raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ... import transformer as tfm
from ...ops import layer_norm
from ...ops.layers import batch_norm, bn_init, conv2d, conv2d_init, max_pool2d
from ...utils import StateDict, to_tensor, tree_map
from ...utils.module import InferenceModel, resolve_device


@dataclass(frozen=True)
class DETRConfig:
    backbone_layers: tuple[int, ...]
    d_model: int = 256
    n_classes: int = 91
    n_queries: int = 100
    n_enc_layers: int = 6
    n_dec_layers: int = 6

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, n_heads=8, act="relu", mlp_ratio=8, pre_norm=False)


# ---------------------------------------------------------------------------
# ResNet backbone
# ---------------------------------------------------------------------------


def _bottleneck_init(gen, in_dim, out_dim, stride):
    mid = out_dim // 4
    p = {
        "conv1": conv2d_init(gen, 1, 1, in_dim, mid, bias=False), "bn1": bn_init(mid),
        "conv2": conv2d_init(gen, 3, 3, mid, mid, bias=False), "bn2": bn_init(mid),
        "conv3": conv2d_init(gen, 1, 1, mid, out_dim, bias=False), "bn3": bn_init(out_dim),
    }
    if stride > 1 or in_dim != out_dim:
        p["down_conv"] = conv2d_init(gen, 1, 1, in_dim, out_dim, bias=False)
        p["down_bn"] = bn_init(out_dim)
    return p


def _bottleneck(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(batch_norm(p["bn1"], conv2d(p["conv1"], x)))
    h = F.relu(batch_norm(p["bn2"], conv2d(p["conv2"], h, stride=stride, padding=1)))
    h = batch_norm(p["bn3"], conv2d(p["conv3"], h))
    short = batch_norm(p["down_bn"], conv2d(p["down_conv"], x, stride=stride)) if "down_conv" in p else x
    return F.relu(short + h)


def resnet_apply(p: dict, cfg: DETRConfig, x: torch.Tensor) -> torch.Tensor:
    """The backbone over NHWC ``x`` -> the last stage's feature map (stride 32)."""
    x = F.relu(batch_norm(p["stem_bn"], conv2d(p["stem_conv"], x, stride=2, padding=3)))
    x = max_pool2d(x, 3, 2, padding=1)
    for stage_idx, stage in enumerate(p["stages"]):
        for block_idx, bp in enumerate(stage):
            x = _bottleneck(bp, x, 2 if (stage_idx > 0 and block_idx == 0) else 1)
    return x


def sinusoidal_pe_2d(h: int, w: int, d_model: int) -> np.ndarray:
    """(h, w, d_model) fp32: the y embedding's d_model / 2 channels, then the
    x embedding's, each normalised to 2 pi with sin and cos interleaved
    (computed in float64, as the JAX package does)."""
    d = d_model // 2
    freqs = 10_000.0 ** (-2 * np.arange(d // 2) / d)

    def make(n):
        ts = np.arange(1, n + 1, dtype=np.float64) / (n + 1e-6) * 2 * math.pi
        out = ts[:, None] * freqs
        return np.stack([np.sin(out), np.cos(out)], axis=2).reshape(n, -1)

    y_emb = np.broadcast_to(make(h)[:, None, :], (h, w, d))
    x_emb = np.broadcast_to(make(w)[None, :, :], (h, w, d))
    return np.concatenate([y_emb, x_emb], axis=2).astype(np.float32)


# ---------------------------------------------------------------------------
# Transformer layers
# ---------------------------------------------------------------------------


def _enc_layer(p: dict, cfg: DETRConfig, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    lc = cfg.layer
    qk = x + pos
    x = layer_norm(p["sa_norm"], x + tfm.mha_apply(p["sa"], lc, qk, qk, x))
    return layer_norm(p["mlp_norm"], x + tfm.mlp_apply(p["mlp"], x, "relu"))


def _dec_layer(p: dict, cfg: DETRConfig, x, memory, query_embed, pos) -> torch.Tensor:
    lc = cfg.layer
    qk = x + query_embed
    x = layer_norm(p["sa_norm"], x + tfm.mha_apply(p["sa"], lc, qk, qk, x))
    x = layer_norm(p["ca_norm"], x + tfm.mha_apply(p["ca"], lc, x + query_embed, memory + pos, memory))
    return layer_norm(p["mlp_norm"], x + tfm.mlp_apply(p["mlp"], x, "relu"))


def detr_init(gen: torch.Generator, cfg: DETRConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (torch-default
    uniform convs and linears, unit BatchNorm statistics, zero query
    embeddings), then moved to ``device``."""
    in_dim = 64
    stages = []
    for i, n_layer in enumerate(cfg.backbone_layers):
        out_dim = 256 * 2 ** i
        stage = [_bottleneck_init(gen, in_dim, out_dim, 1 if i == 0 else 2)]
        stage += [_bottleneck_init(gen, out_dim, out_dim, 1) for _ in range(n_layer - 1)]
        stages.append(stage)
        in_dim = out_dim
    lc = cfg.layer
    p = {
        "stem_conv": conv2d_init(gen, 7, 7, 3, 64, bias=False),
        "stem_bn": bn_init(64),
        "stages": stages,
        "input_proj": conv2d_init(gen, 1, 1, in_dim, cfg.d_model),
        "query_embed": torch.zeros(cfg.n_queries, cfg.d_model),
        "encoder": {"layers": [tfm.layer_init(gen, lc) for _ in range(cfg.n_enc_layers)]},
        "decoder": {"layers": [tfm.layer_init(gen, replace(lc, cross_attn=True)) for _ in range(cfg.n_dec_layers)]},
        "norm": tfm.ln_init(cfg.d_model),
        "classifier": tfm.linear_init(gen, cfg.d_model, cfg.n_classes + 1),
        "box_head": [tfm.linear_init(gen, cfg.d_model, cfg.d_model), tfm.linear_init(gen, cfg.d_model, cfg.d_model),
                     tfm.linear_init(gen, cfg.d_model, 4)],
    }
    return tree_map(lambda t: t.to(device), p)


@torch.inference_mode()
def detr_apply(params: dict, cfg: DETRConfig, imgs: torch.Tensor):
    """Forward over ``imgs`` (N, 3, H, W) -> (logits (N, Q, n_classes + 1),
    sigmoid cxcywh boxes (N, Q, 4))."""
    x = conv2d(params["input_proj"], resnet_apply(params, cfg, imgs.permute(0, 2, 3, 1)))
    h, w = x.shape[1], x.shape[2]
    pos = torch.from_numpy(sinusoidal_pe_2d(h, w, cfg.d_model).reshape(h * w, cfg.d_model)).to(x.device, x.dtype)
    x = x.reshape(x.shape[0], h * w, cfg.d_model)
    for lp in params["encoder"]["layers"]:
        x = _enc_layer(lp, cfg, x, pos)
    query = torch.zeros(x.shape[0], cfg.n_queries, cfg.d_model, dtype=x.dtype, device=x.device)
    qe = params["query_embed"].to(x.dtype)
    for lp in params["decoder"]["layers"]:
        query = _dec_layer(lp, cfg, query, x, qe, pos)
    query = layer_norm(params["norm"], query)
    logits = tfm.linear(params["classifier"], query)
    bh = params["box_head"]
    boxes = tfm.linear(bh[2], F.relu(tfm.linear(bh[1], F.relu(tfm.linear(bh[0], query)))))
    return logits, torch.sigmoid(boxes)


class DETR(InferenceModel):
    def __init__(self, backbone_layers, d_model: int = 256, n_classes: int = 91, n_queries: int = 100,
                 rng: int = 0, device=None) -> None:
        self.cfg = DETRConfig(tuple(backbone_layers), d_model, n_classes, n_queries)
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = detr_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    def __call__(self, imgs):
        return detr_apply(self.params, self.cfg, to_tensor(imgs, self.device))

    @staticmethod
    def from_facebook(model_tag: str, *, pretrained: bool = False, device=None) -> "DETR":
        backbone_layers = dict(resnet50=[3, 4, 6, 3], resnet101=[3, 4, 23, 3])[model_tag]
        if pretrained:
            raise NotImplementedError("pretrained DETR weights need a download; load a state dict with "
                                      "load_facebook_state_dict instead")
        return DETR(backbone_layers, device=device)

    def load_facebook_state_dict(self, state_dict: dict) -> None:
        """facebookresearch/detr keys -> the port's params: each
        ``in_proj`` split in three, the BatchNorm statistics
        (``num_batches_tracked`` dropped); every other key consumed."""
        sd = StateDict(state_dict)
        cfg = self.cfg

        def bn(pfx):
            p = {"scale": sd.pop(f"{pfx}.weight"), "bias": sd.pop(f"{pfx}.bias"),
                 "mean": sd.pop(f"{pfx}.running_mean"), "var": sd.pop(f"{pfx}.running_var")}
            sd.pop(f"{pfx}.num_batches_tracked", None)
            return p

        def mha(pfx):
            qw, kw, vw = sd.pop(f"{pfx}.in_proj_weight").chunk(3, dim=0)
            qb, kb, vb = sd.pop(f"{pfx}.in_proj_bias").chunk(3, dim=0)
            return {"q": {"w": qw.t(), "b": qb}, "k": {"w": kw.t(), "b": kb}, "v": {"w": vw.t(), "b": vb},
                    "o": sd.pop_linear(f"{pfx}.out_proj")}

        stages = []
        for stage_idx, n_layer in enumerate(cfg.backbone_layers):
            stage = []
            for block_idx in range(n_layer):
                pfx = f"backbone.0.body.layer{stage_idx + 1}.{block_idx}"
                bp = {}
                for i in (1, 2, 3):
                    bp[f"conv{i}"] = sd.pop_conv2d(f"{pfx}.conv{i}", bias=False)
                    bp[f"bn{i}"] = bn(f"{pfx}.bn{i}")
                if block_idx == 0:
                    bp["down_conv"] = sd.pop_conv2d(f"{pfx}.downsample.0", bias=False)
                    bp["down_bn"] = bn(f"{pfx}.downsample.1")
                stage.append(bp)
            stages.append(stage)

        def tf_layer(pfx, cross):
            lp = {"sa": mha(f"{pfx}.self_attn"), "sa_norm": sd.pop_ln(f"{pfx}.norm1"),
                  "mlp": {"fc1": sd.pop_linear(f"{pfx}.linear1"), "fc2": sd.pop_linear(f"{pfx}.linear2")}}
            if cross:
                lp["ca"] = mha(f"{pfx}.multihead_attn")
                lp["ca_norm"] = sd.pop_ln(f"{pfx}.norm2")
                lp["mlp_norm"] = sd.pop_ln(f"{pfx}.norm3")
            else:
                lp["mlp_norm"] = sd.pop_ln(f"{pfx}.norm2")
            return lp

        p = {
            "stem_conv": sd.pop_conv2d("backbone.0.body.conv1", bias=False),
            "stem_bn": bn("backbone.0.body.bn1"),
            "stages": stages,
            "input_proj": sd.pop_conv2d("input_proj"),
            "query_embed": sd.pop("query_embed.weight"),
            "encoder": {"layers": [tf_layer(f"transformer.encoder.layers.{i}", False)
                                   for i in range(cfg.n_enc_layers)]},
            "decoder": {"layers": [tf_layer(f"transformer.decoder.layers.{i}", True)
                                   for i in range(cfg.n_dec_layers)]},
            "norm": sd.pop_ln("transformer.decoder.norm"),
            "classifier": sd.pop_linear("class_embed"),
            "box_head": [sd.pop_linear(f"bbox_embed.layers.{i}") for i in range(3)],
        }
        sd.finalize()
        self.params = tree_map(lambda t: t.to(device=self.device, dtype=torch.float32).contiguous(), p)


class DETRPipeline:
    """Batched detection over images of any sizes: zero-padded to the
    largest, normalised, one forward, then per image the classes above the
    threshold with their xyxy pixel boxes and probabilities (numpy)."""

    # fmt: off
    COCO_CLASSES = [
        "N/A", "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat", "traffic light",
        "fire hydrant", "N/A", "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
        "elephant", "bear", "zebra", "giraffe", "N/A", "backpack", "umbrella", "N/A", "N/A", "handbag", "tie",
        "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
        "skateboard", "surfboard", "tennis racket", "bottle", "N/A", "wine glass", "cup", "fork", "knife", "spoon",
        "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake",
        "chair", "couch", "potted plant", "bed", "N/A", "dining table", "N/A", "N/A", "toilet", "N/A", "tv", "laptop",
        "mouse", "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink", "refrigerator", "N/A",
        "book", "clock", "vase", "scissors", "teddy bear", "hair drier", "toothbrush",
    ]
    # fmt: on

    MEAN = np.array([0.485, 0.456, 0.406], np.float32).reshape(3, 1, 1)
    STD = np.array([0.229, 0.224, 0.225], np.float32).reshape(3, 1, 1)

    def __init__(self, model: DETR, threshold: float = 0.7) -> None:
        self.model = model
        self.th = threshold

    @staticmethod
    def cxcywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
        x1 = boxes[..., 0] - boxes[..., 2] * 0.5
        y1 = boxes[..., 1] - boxes[..., 3] * 0.5
        x2 = boxes[..., 0] + boxes[..., 2] * 0.5
        y2 = boxes[..., 1] + boxes[..., 3] * 0.5
        return np.stack([x1, y1, x2, y2], axis=-1)

    @staticmethod
    def pad_batch(images: list) -> tuple[np.ndarray, int, int]:
        """(3, H, W) float images in [0, 1] -> the normalised batch, each
        zero-padded at the bottom and right to the largest height and width,
        and that height and width."""
        images = [np.asarray(img, np.float32) for img in images]
        height = max(img.shape[-2] for img in images)
        width = max(img.shape[-1] for img in images)
        padded = np.stack([np.pad(img, ((0, 0), (0, height - img.shape[-2]), (0, width - img.shape[-1])))
                           for img in images])
        return (padded - DETRPipeline.MEAN) / DETRPipeline.STD, height, width

    def __call__(self, images: list, th: float | None = None):
        """images: list of (3, H, W) float arrays in [0, 1]; returns per image
        ``[class names, xyxy pixel boxes, probabilities]``."""
        padded, height, width = self.pad_batch(images)
        logits, boxes = self.model(padded)
        logits, boxes = logits.float().cpu().numpy(), boxes.float().cpu().numpy()

        probs = _softmax_np(logits)[..., :-1]
        keep = probs.max(-1) >= (th or self.th)
        boxes = self.cxcywh_to_xyxy(boxes * np.array([width, height, width, height], np.float32))

        outputs = []
        for i in range(padded.shape[0]):
            img_probs = probs[i, keep[i]].max(-1)
            img_classes = [self.COCO_CLASSES[c] for c in probs[i, keep[i]].argmax(-1)]
            outputs.append([img_classes, boxes[i, keep[i]], img_probs])
        return outputs

    forward = __call__


def _softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)
