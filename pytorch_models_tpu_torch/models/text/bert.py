"""BERT / RoBERTa encoder (PyTorch port of ``pytorch_models_tpu/models/text/bert.py``).

Token embeddings (the vocab padded to a multiple of 64) + learned PE cut to
the sequence length + LayerNorm -> post-norm encoder, no attention mask (as
the JAX package). Token-type row 0 is folded into the PE at load time and
RoBERTa's two unused PE rows are stripped. Self-attention goes through
``transformer.encoder_apply``, whose auto gate sends BERT's head width 64 to
the encoder-attention kernel on the card (``ops/encoder_attention.py``, K1).

``BERT.from_hf(tag, config=...)`` takes the HF ``config.json`` as a dict:
the port fetches nothing, and ``pretrained=True`` raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ... import transformer as tfm
from ...ops import layer_norm
from ...utils import StateDict, to_tensor, tree_map
from ...utils.module import InferenceModel, resolve_device


@dataclass(frozen=True)
class BERTConfig:
    vocab_size: int
    n_layers: int
    d_model: int
    max_seq_len: int = 512
    norm_eps: float = 1e-12

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, pre_norm=False, norm_eps=self.norm_eps)


def bert_init(gen: torch.Generator, cfg: BERTConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (the JAX init's
    distributions: N(0, 1) token embeddings, zero PE, torch-default uniform
    linears), then moved to ``device``."""
    p = {
        "token_embs": torch.randn(cfg.vocab_size, cfg.d_model, generator=gen),
        "pos_embs": torch.zeros(cfg.max_seq_len, cfg.d_model),
        "norm": tfm.ln_init(cfg.d_model),
        "encoder": tfm.encoder_init(gen, cfg.n_layers, cfg.layer),
    }
    return tree_map(lambda t: t.to(device), p)


@torch.inference_mode()
def bert_apply(params: dict, cfg: BERTConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Forward over ``(..., L)`` int tokens, batched or unbatched -> (..., L, d)."""
    x = params["token_embs"][tokens]
    x = x + params["pos_embs"][: tokens.shape[-1]].to(x.dtype)
    x = layer_norm(params["norm"], x, cfg.norm_eps)
    return tfm.encoder_apply(params["encoder"], cfg.layer, x)


class BERT(InferenceModel):
    def __init__(
        self,
        vocab_size: int,
        n_layers: int,
        d_model: int,
        max_seq_len: int = 512,
        dropout: float = 0.0,  # accepted for API parity; inference-only
        norm_eps: float = 1e-12,
        rng: int = 0,
        device=None,
    ) -> None:
        vocab_size = math.ceil(vocab_size / 64) * 64
        self.cfg = BERTConfig(vocab_size, n_layers, d_model, max_seq_len, norm_eps)
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = bert_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    def __call__(self, tokens) -> torch.Tensor:
        return bert_apply(self.params, self.cfg, torch.as_tensor(tokens, device=self.device).long())

    @staticmethod
    def from_hf(model_tag: str, *, pretrained: bool = False, config: dict | None = None, **kwargs) -> "BERT":
        """Build from an HF ``config.json`` passed in as ``config`` (RoBERTa's
        two offset PE rows taken off ``max_position_embeddings``)."""
        if config is None:
            raise NotImplementedError(f"{model_tag}: the HF config needs a download; pass config=dict(...)")
        if pretrained:
            raise NotImplementedError("pretrained BERT weights need a download; load a state dict with "
                                      "load_hf_state_dict instead")
        config = dict(config)
        if "roberta" in config["model_type"]:
            config["max_position_embeddings"] -= 2
        return BERT(
            vocab_size=config["vocab_size"],
            n_layers=config["num_hidden_layers"],
            d_model=config["hidden_size"],
            max_seq_len=config["max_position_embeddings"],
            norm_eps=config["layer_norm_eps"],
            **kwargs,
        )

    def load_hf_state_dict(self, state_dict: dict) -> None:
        """HF BERT / RoBERTa keys -> the port's params: the ``bert.`` /
        ``roberta.`` prefix dropped, token-type row 0 folded into the position
        embeddings, RoBERTa's first two PE rows stripped; the pooler, the LM
        and classifier heads and ``position_ids`` are skipped, every other
        key consumed."""
        is_roberta = any(k.startswith("roberta.") for k in state_dict)
        sd = StateDict({k.removeprefix("bert.").removeprefix("roberta."): v for k, v in state_dict.items()})

        p = dict(self.params)
        tok = self.params["token_embs"].clone()
        word = sd.pop("embeddings.word_embeddings.weight")
        tok[: word.shape[0]] = word.to(tok.device, tok.dtype)
        p["token_embs"] = tok

        pos = sd.pop("embeddings.position_embeddings.weight")
        if is_roberta:
            pos = pos[2:]
        p["pos_embs"] = pos + sd.pop("embeddings.token_type_embeddings.weight")[0]
        p["norm"] = sd.pop_ln("embeddings.LayerNorm")

        layers = []
        for i in range(self.cfg.n_layers):
            pfx = f"encoder.layer.{i}"
            layers.append({
                "sa": {
                    "q": sd.pop_linear(f"{pfx}.attention.self.query"),
                    "k": sd.pop_linear(f"{pfx}.attention.self.key"),
                    "v": sd.pop_linear(f"{pfx}.attention.self.value"),
                    "o": sd.pop_linear(f"{pfx}.attention.output.dense"),
                },
                "sa_norm": sd.pop_ln(f"{pfx}.attention.output.LayerNorm"),
                "mlp": {"fc1": sd.pop_linear(f"{pfx}.intermediate.dense"),
                        "fc2": sd.pop_linear(f"{pfx}.output.dense")},
                "mlp_norm": sd.pop_ln(f"{pfx}.output.LayerNorm"),
            })
        p["encoder"] = {"layers": layers}
        for k in list(sd.keys()):
            if k.startswith(("pooler.", "cls.", "lm_head.")) or k == "embeddings.position_ids":
                sd.pop(k)
        sd.finalize()
        self.params = tree_map(lambda t: to_tensor(t, self.device).float().contiguous(), p)
