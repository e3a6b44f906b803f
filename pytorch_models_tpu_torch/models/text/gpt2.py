"""GPT-2 (PyTorch port of ``pytorch_models_tpu/models/text/gpt2.py``).

Pre-norm causal decoder + final LayerNorm, tanh GELU, vocab 50257 / context
1024, weight-tied logits. The HF loader handles Conv1D ``(in, out)`` weights
and the fused ``c_attn`` split. ``from_hf(pretrained=True)`` needs a
download and is not available in the port yet.
"""

from __future__ import annotations

import torch

from ...utils import StateDict
from ...utils.module import InferenceModel, resolve_device
from ._decoder_lm import DecoderLMConfig, decoder_lm_apply, decoder_lm_init

VARIANTS = {
    "gpt2": (12, 768),
    "gpt2-medium": (24, 1024),
    "gpt2-large": (36, 1280),
    "gpt2-xl": (48, 1600),
}


class GPT2(InferenceModel):
    vocab_size = 50257
    max_seq_len = 1024

    def __init__(self, n_layers: int, d_model: int, rng: int = 0, device=None) -> None:
        self.cfg = DecoderLMConfig(
            vocab_size=self.vocab_size,
            max_seq_len=self.max_seq_len,
            n_layers=n_layers,
            d_model=d_model,
            pre_norm=True,
            final_norm=True,
            act="approximate_gelu",
        )
        self.device = resolve_device(device)  # None: the CUDA card
        self.params = decoder_lm_init(torch.Generator().manual_seed(rng), self.cfg, self.device)

    @torch.inference_mode()
    def __call__(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return decoder_lm_apply(self.params, self.cfg, tokens)

    @staticmethod
    def from_hf(model_tag: str, *, pretrained: bool = False, **kwargs) -> "GPT2":
        n_layers, d_model = VARIANTS[model_tag]
        if pretrained:
            raise NotImplementedError("pretrained GPT-2 weights need a download; load a state dict with "
                                      "load_hf_state_dict instead")
        return GPT2(n_layers, d_model, **kwargs)

    def load_hf_state_dict(self, state_dict: dict) -> None:
        """HF GPT-2 keys: Conv1D weights are stored ``(in, out)`` — this port's
        layout — and ``c_attn`` holds q, k and v side by side."""
        sd = StateDict({k.removeprefix("transformer."): v for k, v in state_dict.items()})

        def f32(t):
            return t.to(device=self.device, dtype=torch.float32)

        def lin(pfx):
            return {"w": f32(sd.pop(f"{pfx}.weight")), "b": f32(sd.pop(f"{pfx}.bias"))}

        def ln(pfx):
            return {k: f32(t) for k, t in sd.pop_ln(pfx).items()}

        tok = self.params["token_embs"].clone()
        wte = sd.pop("wte.weight")
        tok[: wte.shape[0]] = wte.to(tok.device, tok.dtype)
        p = dict(self.params)
        p["token_embs"] = tok
        p["pos_embs"] = f32(sd.pop("wpe.weight"))
        p["norm"] = ln("ln_f")

        layers = []
        for i in range(self.cfg.n_layers):
            pfx = f"h.{i}"
            qkv_w = f32(sd.pop(f"{pfx}.attn.c_attn.weight")).chunk(3, dim=1)
            qkv_b = f32(sd.pop(f"{pfx}.attn.c_attn.bias")).chunk(3, dim=0)
            layers.append({
                "sa_norm": ln(f"{pfx}.ln_1"),
                "sa": {
                    "q": {"w": qkv_w[0].contiguous(), "b": qkv_b[0].contiguous()},
                    "k": {"w": qkv_w[1].contiguous(), "b": qkv_b[1].contiguous()},
                    "v": {"w": qkv_w[2].contiguous(), "b": qkv_b[2].contiguous()},
                    "o": lin(f"{pfx}.attn.c_proj"),
                },
                "mlp_norm": ln(f"{pfx}.ln_2"),
                "mlp": {"fc1": lin(f"{pfx}.mlp.c_fc"), "fc2": lin(f"{pfx}.mlp.c_proj")},
            })
        # HF ships attn.bias causal-mask buffers in some exports; drop if present
        for k in list(sd.keys()):
            if k.endswith(".attn.bias") or k.endswith(".attn.masked_bias") or k == "lm_head.weight":
                sd.pop(k)
        p["decoder"] = {"layers": layers}
        sd.finalize()
        self.params = p
