"""Tensor-parallel SPECULATIVE serving on ``torch.distributed`` (PyTorch
port of ``pytorch_models_tpu/parallel/spec_serving.py``): a tp-sharded
target and a draft replicated on every rank.

The target's heads and MLP shard over a ``("tp",)`` mesh (two all-reduces
per layer, ``parallel/serving.py``), while the small draft runs whole on
every rank: its k single-token steps need no communication. Each rank runs
the one-row speculative loop (``models/text/speculative.py``) on its shard,
the draft per-op, as in the JAX package's loop. Greedy and exact: the
output equals the single-device plain greedy generator's for any draft.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.text.generator import PROMPT_BUCKET, _eos_id
from ..models.text.speculative import _spec_generate, cut_at_eos
from ..utils import tree_map
from .serving import _serving_axes, decoder_lm_serving_pspecs, local_config
from .sharding import shard_params


class TPSpeculativeGenerator:
    """Sharded drop-in for ``SpeculativeDecoderGenerator.generate_tokens``
    over a ``("tp",)`` mesh (one row: the speculative regime)."""

    def __init__(self, model, draft_model, tokenizer, mesh, k: int = 4) -> None:
        if model.cfg.vocab_size != draft_model.cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.model = model
        self.draft_model = draft_model
        self.tokenizer = tokenizer
        self.k = k
        self.mesh = mesh
        n_heads = model.cfg.layer.n_heads
        _serving_axes(mesh, n_heads, {"tp"})
        self.cfg_local = local_config(model.cfg, mesh, n_heads)
        self.params = shard_params(model.params, decoder_lm_serving_pspecs(model.params), mesh)
        self.draft_params = tree_map(lambda t: t.to(mesh.device), draft_model.params)

    def generate(self, prompt: str, max_tokens: int = 100) -> str:
        return self.tokenizer.decode(self.generate_tokens(self.tokenizer.encode(prompt), max_tokens))

    def generate_tokens(self, tokens: list[int], max_tokens: int = 100) -> list[int]:
        cfg = self.model.cfg
        if max_tokens <= 0:
            return list(tokens)
        n = len(tokens)
        pad = min(-(-max(n, 1) // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        if n > pad:
            raise ValueError(f"prompt too long for context {cfg.max_seq_len}")
        if pad >= cfg.max_seq_len:
            return list(tokens)
        buf = np.zeros((1, pad), np.int64)
        buf[0, :n] = tokens
        eos = _eos_id(self.tokenizer)
        out, lengths, _ = _spec_generate(self.params, self.cfg_local, self.draft_params, self.draft_model.cfg,
                                         torch.from_numpy(buf).to(self.mesh.device), n,
                                         min(n + max_tokens, cfg.max_seq_len), self.k, eos, fused_draft=False)
        # cut at the first EOS among generated tokens: an accepted chunk can hold tokens past a mid-chunk EOS
        return cut_at_eos(out[0, : int(lengths[0])], n, eos)
