"""Model-class conveniences for drop-in compatibility with the reference API."""

import torch

from .params import cast_tree, quantize_tree_int8


def resolve_device(device) -> torch.device:
    """A model's device: ``None`` means the CUDA card, as the port's entry
    points run on the card unless the caller asks for the CPU. Without a
    GPU that raises; it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's models run on the GPU by default; "
                           "pass device='cpu' to run the plain PyTorch paths on the CPU")
    return torch.device("cuda")


class InferenceModel:
    """Mixin giving the torch-style mode switches (models here are always
    inference-mode functions over a parameter tree) plus serving-dtype casts."""

    def eval(self):
        return self

    def train(self, mode: bool = True):
        raise NotImplementedError("training is not supported (matches the reference, README.md:9)")

    def to_bf16(self):
        """Cast floating params to bfloat16 — the serving fast path."""
        self.params = cast_tree(self.params, torch.bfloat16)
        return self

    def to_fp32(self):
        self.params = cast_tree(self.params, torch.float32)
        return self

    def save(self, path: str):
        """Persist the parameter tree (nested dicts and lists of tensors, int8
        ``{"w_q", "w_s"}`` leaves included) with ``torch.save``: every dtype
        kept, bit for bit. Not JAX's orbax format."""
        torch.save(self.params, path)
        return self

    def load(self, path: str):
        """Read a tree written by :meth:`save` onto this model's device
        (``torch.load(weights_only=True)``: tensors and containers only)."""
        self.params = torch.load(path, map_location=self.device, weights_only=True)
        return self

    def quantize_int8(self):
        """Weight-only int8 serving mode: every projection kernel becomes
        ``{"w_q", "w_s"}`` (``utils.params.quantize_tree_int8``); embeddings,
        norms and convs keep their dtype. ``to_bf16`` after it casts the
        fp32 scales too, as in the JAX package: keep the JAX order of the two
        calls to hold the same weights."""
        self.params = quantize_tree_int8(self.params)
        return self
