"""2D tensor x pipeline parallel SERVING: stage- AND head-sharded generation
(PyTorch port of ``pytorch_models_tpu/parallel/tp_pp_serving.py``).

Composes the two 1D serving stories (``serving.py`` TP, ``pp_serving.py``
PP) on one ``("pp", "tp")`` or ``("dp", "pp", "tp")`` mesh:

- decoder layers: a rank keeps its stage's layers (``stage_stack``), then
  Megatron head sharding over "tp" within the stage: column-parallel
  q/k/v/fc1 kernels and biases split on the output dim, row-parallel o/fc2
  kernels on the input dim and all-reduced (``transformer.reduce_linear``
  via the tp-local config's ``tp_axis``);
- KV caches: stage-local AND head-sharded ``(B, Lmax, H*D/tp)`` per rank;
- embeddings, final norm and the head: replicated;
- dp: the batch's rows split over the dp groups and gathered at the end, as
  ``TPDecoderGenerator`` does.

The schedule is ``pp_serving``'s: per forward ``pp`` ticks, the owning
stage's ranks run it tp-sharded and broadcast its output over "pp". Output
is token-identical to the single-device generator.
"""

from __future__ import annotations

import torch

from ..models.text.generator import _eos_id
from .pp_serving import _pp_generate_batch, stage_stack
from .serving import _dp_rows, _gather_rows, decoder_lm_serving_pspecs, left_pad_prompts, local_config, unpack_rows
from .sharding import Split, shard_params


def tp_pp_param_pspecs(staged_params) -> dict:
    """Specs of a :func:`stage_stack` decoder-LM tree: the stages split over
    "pp", each stage's layers under the serving-TP column / row split
    (``serving.decoder_lm_serving_pspecs``: column-parallel biases shard
    WITH their kernels); embeddings and the final norm replicated."""
    specs = decoder_lm_serving_pspecs(staged_params)
    specs["decoder"]["layers"] = Split("pp", specs["decoder"]["layers"])
    return specs


class TPPPDecoderGenerator:
    """2D/3D stage+head(-and-batch)-sharded drop-in for
    ``generate_tokens_batch`` over a ``("pp", "tp")`` or ``("dp", "pp",
    "tp")`` mesh; every rank takes the whole request list and returns every
    row, token-identical to the single-device generator."""

    def __init__(self, model, tokenizer, mesh) -> None:
        if set(mesh.shape) not in ({"pp", "tp"}, {"dp", "pp", "tp"}):
            raise ValueError(f'tp+pp serving mesh needs ("pp", "tp") or ("dp", "pp", "tp") axes, '
                             f"got {tuple(mesh.shape)}")
        self.model = model
        self.tokenizer = tokenizer
        self.mesh = mesh
        self.n_stages, self.dp = mesh.shape["pp"], mesh.size("dp")
        n_heads = model.cfg.layer.n_heads
        if n_heads % mesh.shape["tp"]:
            raise ValueError(f"{n_heads} heads not divisible by tp={mesh.shape['tp']}")
        self.cfg_local = local_config(model.cfg, mesh, n_heads)
        staged = stage_stack(model.params, self.n_stages)
        self.params = shard_params(staged, tp_pp_param_pspecs(staged), mesh)

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100) -> list[list[int]]:
        rows = _dp_rows(self.mesh, len(token_lists))
        packed = left_pad_prompts(token_lists, self.model.cfg.max_seq_len, max_tokens)
        if packed is None:
            return [list(ts) for ts in token_lists]
        buf, pad_lens, limit = packed
        dev = self.mesh.device
        out, lengths = _pp_generate_batch(self.params, self.cfg_local, self.mesh,
                                          torch.from_numpy(buf[rows]).to(dev),
                                          torch.from_numpy(pad_lens[rows]).to(dev), limit, _eos_id(self.tokenizer))
        out, lengths = _gather_rows(self.mesh, out, lengths)
        return unpack_rows(out, lengths, pad_lens)
