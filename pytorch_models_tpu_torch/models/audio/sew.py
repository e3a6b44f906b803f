"""SEW, Squeezed and Efficient Wav2Vec (PyTorch port of
``pytorch_models_tpu/models/audio/sew.py``).

A Wav2Vec2 with a deeper 13-layer stem of interleaved stride-1 convs, a
stride-2 PE conv beside an ``avg_pool1d(2)`` time squeeze, a post-norm
encoder at half rate, then an upsample Linear(d -> 2d) + GELU unflattened
back to full rate and right-padded to the stem's length. SEW-tiny's 4 heads
of 64 take the encoder-attention kernel (K1) on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import transformer as tfm
from ...ops import ACT_FNS, layer_norm, linear
from ...ops.layers import linear_init
from ...utils import StateDict, to_tensor
from .wav2vec2 import Wav2Vec2, Wav2Vec2Config, _pop_weight_norm_conv, features, pe_conv_apply


@torch.inference_mode()
def sew_apply(params: dict, cfg: Wav2Vec2Config, x: torch.Tensor) -> torch.Tensor:
    """Forward over a (B, L) waveform -> (B, T, d) at the stem's rate T."""
    x = features(params, cfg, x)
    b, t, d = x.shape
    pooled = x[:, : (t // 2) * 2].reshape(b, t // 2, 2, d).mean(2)
    x = pooled + pe_conv_apply(params["pe_conv"], cfg, x, stride=2)
    x = tfm.encoder_apply(params["encoder"], cfg.layer, layer_norm(params["norm"], x))
    x = ACT_FNS["gelu"](linear(params["upsample"], x))
    x = x.reshape(b, -1, d)  # (B, 2 * (T // 2), d)
    return F.pad(x, (0, 0, 0, t - x.shape[1]))


class SEW(Wav2Vec2):
    STEM_DIMS = (64,) + (128,) * 4 + (256,) * 4 + (512,) * 4
    STEM_KERNELS = (10,) + (3, 1) * 4 + (2, 1) * 2
    STEM_STRIDES = (5,) + (2, 1) * 6
    PE_KERNEL = 31

    def __init__(self, n_layers: int, d_model: int, stem_bias: bool = True, stem_legacy: bool = True,
                 dropout: float = 0.0, rng: int = 0, device=None) -> None:
        if not stem_legacy:
            raise ValueError("SEW's stem is the legacy (group-norm) stem")
        self._build(Wav2Vec2Config(n_layers, d_model, self.STEM_DIMS, self.STEM_KERNELS, self.STEM_STRIDES,
                                   self.PE_KERNEL, self.PE_GROUPS, stem_bias, stem_legacy, pre_norm=False),
                    rng, device)
        up = linear_init(torch.Generator().manual_seed(rng + 1), d_model, d_model * 2)
        self.params["upsample"] = {k: v.to(self.device) for k, v in up.items()}

    def __call__(self, x) -> torch.Tensor:
        return sew_apply(self.params, self.cfg, to_tensor(x, self.device))

    def load_hf_state_dict(self, state_dict: dict) -> None:
        """SEW's HF key layout: bare ``layer_norm`` / ``feature_projection``
        and an ``encoder.upsample.projection`` head."""
        sd = StateDict(state_dict)
        p: dict = {"stem": self._pop_stem(sd)}
        p["proj_norm"] = sd.pop_ln("layer_norm")
        if "feature_projection.weight" in sd:
            p["proj"] = sd.pop_linear("feature_projection")
        p["pe_conv"] = [{"conv": _pop_weight_norm_conv(sd, "encoder.pos_conv_embed.conv")}]
        p["norm"] = sd.pop_ln("encoder.layer_norm")
        p["encoder"] = self._pop_encoder(sd)
        p["upsample"] = sd.pop_linear("encoder.upsample.projection")
        self._finish(sd, p)
