"""Pipeline-parallel SERVING: stage-sharded KV-cached generation (PyTorch
port of ``pytorch_models_tpu/parallel/pp_serving.py``).

A decoder LM whose layers do not fit one card generates over a ``("pp",)``
mesh, one process per rank: each rank holds one contiguous stage of
``n_layers / pp`` layers (a slice of the per-layer list) AND that stage's KV
caches only, so cache memory scales down with the stage count.

Schedule: greedy decode is sequential across stages (token t+1 needs token
t through every layer), so each forward runs ``pp`` ticks. At tick ``s``
only stage ``s``'s rank runs its layers, writing its caches in place, and
broadcasts the output over "pp": one collective per stage per step, as the
JAX package's one-hot ``psum``. The JAX body computes every stage on every
rank and keeps the owner's cache; here a rank that does not own a stage
never runs it, since ``transformer.mha_apply`` writes its cache in place.
The embeddings are one launch of the embedding kernel (K3 ``embed_add``)
and decode attention runs the decode kernel (K2) at the stage's layers; the
head is the tied matmul + argmax on every rank (replicated, as in the JAX
package), never the fused step K7, which has no collective inside. Output
is token-identical to the single-device generator.
"""

from __future__ import annotations

import torch

from .. import transformer as tfm
from ..models.text._decoder_lm import _head
from ..models.text.generator import DONE_CHECK_EVERY, _eos_id
from ..ops.gather import embed_tokens
from .serving import greedy_generate, left_pad_prompts, unpack_rows
from .sharding import Split, shard_params, tree_map_with_path


def stage_stack(params: dict, n_stages: int) -> dict:
    """``decoder.layers`` (L per-layer dicts) -> ``n_stages`` lists of
    ``L / n_stages`` contiguous layers (the JAX package's ``(L, ...) ->
    (n_stages, L / pp, ...)`` reshape, for the port's per-layer lists)."""
    layers = params["decoder"]["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers not divisible by pp={n_stages}")
    k = len(layers) // n_stages
    return dict(params, decoder=dict(params["decoder"], layers=[layers[s * k:(s + 1) * k] for s in range(n_stages)]))


def pp_param_pspecs(params) -> dict:
    """Specs of a :func:`stage_stack` tree: the stages split over "pp" (a
    rank keeps its own stage's list), everything else replicated."""
    specs = tree_map_with_path(lambda path, leaf: (), params)
    specs["decoder"]["layers"] = Split("pp", specs["decoder"]["layers"])
    return specs


@torch.inference_mode()
def _pp_generate_batch(params, cfg, mesh, prompt_buf: torch.Tensor, pad_lens: torch.Tensor, limit: int,
                       eos_id: int):
    """Greedy batched generation with this rank's stage (``params`` from
    :func:`pp_param_pspecs` or ``tp_pp_param_pspecs``: ``decoder.layers`` is
    ``[the stage's layers]``; ``cfg`` the rank's config, tp-local under
    tensor parallelism), through ``serving.greedy_generate``; returns
    ``(tokens (B, max_seq_len), lengths (B,))`` on the host, the same on
    every rank of the pp and tp groups."""
    b, dev, lc = prompt_buf.shape[0], prompt_buf.device, cfg.layer
    rank, n_stages = mesh.index("pp"), mesh.size("pp")
    stage = {"layers": params["decoder"]["layers"][0]}
    # THIS rank's stage caches only: cache memory scales as 1/pp
    caches, _ = tfm.make_kv_cache(len(stage["layers"]), (b,), lc.n_heads, cfg.max_seq_len, lc.head_dim,
                                  dtype=params["token_embs"].dtype, device=dev)

    def forward(tokens, pos_ids, pos):
        x = embed_tokens(params["token_embs"], tokens, params["pos_embs"], pos_ids)
        for s in range(n_stages):
            if s == rank:  # only the owner runs the stage: its caches are written in place
                x, _ = tfm.decoder_apply(stage, lc, x, self_caches=caches, pos=pos, pad_lens=pad_lens)
            x = mesh.broadcast(x, "pp", s)
        return _head(params, cfg, x)

    def every_few_steps(done, step: int) -> bool:  # the host reads the flag every DONE_CHECK_EVERY steps
        return step % DONE_CHECK_EVERY == 0 and bool(done.all())

    return greedy_generate(forward, prompt_buf, pad_lens, limit, eos_id, cfg.max_seq_len, every_few_steps)


class PPDecoderGenerator:
    """Stage-sharded drop-in for ``DecoderGenerator.generate_tokens_batch``
    over a ``("pp",)`` mesh: the rank holds its stage's layers (moved to the
    mesh's device; the others stay where the model lies) and caches; greedy
    output equals the single-device generator's on every rank."""

    def __init__(self, model, tokenizer, mesh) -> None:
        if set(mesh.shape) != {"pp"}:
            raise ValueError(f'pp serving mesh needs a ("pp",) axis, got {tuple(mesh.shape)}')
        self.model = model
        self.tokenizer = tokenizer
        self.mesh = mesh
        self.n_stages = mesh.shape["pp"]
        staged = stage_stack(model.params, self.n_stages)
        self.params = shard_params(staged, pp_param_pspecs(staged), mesh)

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100) -> list[list[int]]:
        packed = left_pad_prompts(token_lists, self.model.cfg.max_seq_len, max_tokens)
        if packed is None:
            return [list(ts) for ts in token_lists]
        buf, pad_lens, limit = packed
        dev = self.mesh.device
        out, lengths = _pp_generate_batch(self.params, self.model.cfg, self.mesh, torch.from_numpy(buf).to(dev),
                                          torch.from_numpy(pad_lens).to(dev), limit, _eos_id(self.tokenizer))
        return unpack_rows(out, lengths, pad_lens)
