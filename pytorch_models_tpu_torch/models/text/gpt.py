"""GPT-1 (PyTorch port of ``pytorch_models_tpu/models/text/gpt.py``).

Post-norm causal decoder with tanh GELU, no final norm, vocab 40478 /
context 512, weight-tied logits. Being post-norm, it decodes per-op
(``_decoder_lm.decoder_lm_fused_ok`` refuses it): the decode attention,
the embedding kernel and the tied greedy head on the card.
``from_openai(pretrained=True)`` needs a download and raises; the loader
``load_openai_params`` takes OpenAI's ``params_shapes.json`` list and its
flat ``.npy`` shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import to_tensor
from ...utils.module import InferenceModel, resolve_device
from ._decoder_lm import DecoderLMConfig, decoder_lm_apply, decoder_lm_init

# tensors per layer in OpenAI's flat parameter list
_PER_LAYER = 12


class GPT(InferenceModel):
    vocab_size = 40478
    max_seq_len = 512

    def __init__(self, n_layers: int = 12, d_model: int = 768, dropout: float = 0.0, rng: int = 0,
                 device=None) -> None:
        # dropout: accepted at the JAX constructor's position for API parity; inference-only
        self.cfg = DecoderLMConfig(
            vocab_size=self.vocab_size,
            max_seq_len=self.max_seq_len,
            n_layers=n_layers,
            d_model=d_model,
            pre_norm=False,
            final_norm=False,
            act="approximate_gelu",
        )
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = decoder_lm_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    @torch.inference_mode()
    def __call__(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return decoder_lm_apply(self.params, self.cfg, tokens)

    @staticmethod
    def from_openai(*, pretrained: bool = False, **kwargs) -> "GPT":
        if pretrained:
            raise NotImplementedError("pretrained GPT-1 weights need a download; load OpenAI's shards with "
                                      "load_openai_params instead")
        return GPT(**kwargs)

    def load_openai_params(self, shapes: list, shards: list) -> None:
        """OpenAI's flat shards -> the port's params: the shards joined and
        cut at the cumulative sizes of ``shapes``; per layer the fused qkv
        kernel (1, d, 3d) and bias split three ways, then the out projection,
        sa_norm, fc1, fc2 and mlp_norm. Kernels are stored (1, in, out), the
        port's layout. The token table keeps its init rows past the
        checkpoint's."""
        offsets = np.cumsum([int(np.prod(s)) for s in shapes])
        flat = np.concatenate([np.asarray(s) for s in shards], axis=0)
        params = [p.reshape(s) for p, s in zip(np.split(flat, offsets)[:-1], shapes)]

        def t(a) -> torch.Tensor:
            return to_tensor(np.ascontiguousarray(a, dtype=np.float32), self.device)

        p = dict(self.params)
        p["pos_embs"] = t(params[0])
        tok = self.params["token_embs"].clone()
        tok[: params[1].shape[0]] = t(params[1])
        p["token_embs"] = tok

        layers = []
        for i in range(self.cfg.n_layers):
            a = [params[2 + i * _PER_LAYER + j] for j in range(_PER_LAYER)]
            qkv_w = np.split(a[0].squeeze(0), 3, axis=-1)
            qkv_b = np.split(a[1], 3, axis=-1)
            layers.append({
                "sa": {
                    "q": {"w": t(qkv_w[0]), "b": t(qkv_b[0])},
                    "k": {"w": t(qkv_w[1]), "b": t(qkv_b[1])},
                    "v": {"w": t(qkv_w[2]), "b": t(qkv_b[2])},
                    "o": {"w": t(a[2].squeeze(0)), "b": t(a[3])},
                },
                "sa_norm": {"scale": t(a[4]), "bias": t(a[5])},
                "mlp": {"fc1": {"w": t(a[6].squeeze(0)), "b": t(a[7])},
                        "fc2": {"w": t(a[8].squeeze(0)), "b": t(a[9])}},
                "mlp_norm": {"scale": t(a[10]), "bias": t(a[11])},
            })
        p["decoder"] = {"layers": layers}
        self.params = p
