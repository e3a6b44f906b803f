"""Data2Vec-Audio (PyTorch port of
``pytorch_models_tpu/models/audio/data2vec_audio.py``).

A Wav2Vec2 whose single PE conv is replaced by 5 stacked conv blocks
(kernel 19, non-affine channel LayerNorm, GELU); always post-norm, stem
conv bias off.
"""

from __future__ import annotations

from ...utils import StateDict
from .wav2vec2 import Wav2Vec2, Wav2Vec2Config


class Data2VecAudio(Wav2Vec2):
    PE_KERNEL = 19

    def __init__(self, n_layers: int, d_model: int, stem_bias: bool = False, dropout: float = 0.0, rng: int = 0,
                 device=None):
        self._build(Wav2Vec2Config(n_layers, d_model, self.STEM_DIMS, self.STEM_KERNELS, self.STEM_STRIDES,
                                   self.PE_KERNEL, self.PE_GROUPS, stem_bias, stem_legacy=False, pre_norm=False,
                                   pe_layers=5), rng, device)

    def load_hf_state_dict(self, state_dict: dict) -> None:
        """HF data2vec-audio keys."""
        sd = StateDict(state_dict)
        p: dict = {"stem": self._pop_stem(sd)}
        p["proj_norm"] = sd.pop_ln("feature_projection.layer_norm")
        if "feature_projection.projection.weight" in sd:
            p["proj"] = sd.pop_linear("feature_projection.projection")
        p["pe_conv"] = [{"conv": sd.pop_conv1d(f"encoder.pos_conv_embed.layers.{i}.conv")}
                        for i in range(self.cfg.pe_layers)]
        p["norm"] = sd.pop_ln("encoder.layer_norm")
        p["encoder"] = self._pop_encoder(sd)
        self._finish(sd, p)
