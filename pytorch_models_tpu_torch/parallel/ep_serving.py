"""Expert-parallel SERVING: MoE decode with per-step all_to_all dispatch
(PyTorch port of ``pytorch_models_tpu/parallel/ep_serving.py``).

A top-1 mixture-of-experts decoder LM generates over an ``("ep",)`` mesh,
one process per rank, with

- the batch's rows split over "ep" (each rank decodes B/n rows and owns
  those rows' KV caches: attention is per row and needs no collective), and
- the expert weights split over "ep" (``E/n`` experts a rank); every
  forward routes the rank's tokens, packs per-expert capacity slots,
  exchanges them with an explicit ``all_to_all``, runs the local experts'
  MLPs and sends the results back with a second ``all_to_all`` (the
  training step's dispatch, ``train._moe_mlp_sparse_ep``).

``MoEDecoderGenerator`` is the single-device oracle (the same capacity
dispatch over all of a forward's tokens); with ``capacity_factor >=
n_experts`` nothing drops and the EP generator is token-identical to it.
The dispatch is the index form of the JAX package's one-hot einsums (a
token's row written to its expert's slot, read back and scaled by its
gate): the same values, bit for bit. The embeddings are one launch of K3
(``embed_add``), and decode attention runs K2 where its head width (64) is
the model's (the JAX demo width, d 128 over 4 heads, is 32: the plain path).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import transformer as tfm
from ..ops import layer_norm
from ..ops.gather import embed_tokens
from ..utils import tree_map
from ..utils.module import resolve_device
from .mesh import all_to_all_grad, psum
from .serving import greedy_generate, left_pad_prompts, unpack_rows
from .sharding import shard_params

PROMPT_BUCKET = 8  # prompts are LEFT-padded to a multiple of this (the JAX package's MoE generators' bucket)


@dataclass(frozen=True)
class MoEDecoderConfig:
    """Tiny top-1 MoE decoder LM (demo-scale; the dispatch is the point)."""

    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    n_experts: int = 4
    expert_hidden: int = 256
    max_seq_len: int = 64
    # >= n_experts -> no capacity drops -> exactly equals dense dispatch
    capacity_factor: float | None = None

    @property
    def cf(self) -> float:
        return float(self.n_experts if self.capacity_factor is None else self.capacity_factor)

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, n_heads=self.n_heads, pre_norm=True)


def moe_block_init(gen: torch.Generator, layer: tfm.LayerConfig, n_experts: int, expert_hidden: int) -> dict:
    """One MoE block: attention, the router and ``n_experts`` expert MLPs
    (``w1`` (E, d, H), ``w2`` (E, H, d), N(0, 0.02^2) as in the JAX init)."""
    d = layer.d_model
    return {
        "sa_norm": tfm.ln_init(d),
        "sa": tfm.mha_init(gen, layer),
        "mlp_norm": tfm.ln_init(d),
        "router": tfm.linear_init(gen, d, n_experts),
        "w1": torch.randn(n_experts, d, expert_hidden, generator=gen) * 0.02,
        "w2": torch.randn(n_experts, expert_hidden, d, generator=gen) * 0.02,
    }


def moe_decoder_init(gen: torch.Generator, cfg: MoEDecoderConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (the JAX init's
    distributions), then moved to ``device`` (None: the CUDA card, as the
    port's models; ``"cpu"`` keeps them on the host): per-layer block dicts under
    ``"layers"`` where the JAX tree stacks them (``utils.from_jax_params``
    carries a JAX tree across, ``utils.to_jax_params`` back)."""
    layers = [moe_block_init(gen, cfg.layer, cfg.n_experts, cfg.expert_hidden) for _ in range(cfg.n_layers)]
    p = {"token_embs": torch.randn(cfg.vocab_size, cfg.d_model, generator=gen) * 0.02,
         "pos_embs": torch.randn(cfg.max_seq_len, cfg.d_model, generator=gen) * 0.02,
         "layers": layers, "norm": tfm.ln_init(cfg.d_model)}
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device), p)


def route_slots(gates: torch.Tensor, n_experts: int, cap: int, offset: torch.Tensor | None = None):
    """Top-1 routing of T tokens by their router softmax ``gates`` (T, E)
    with capacity ``cap``: each token's expert ``(T,)``, its slot in the
    expert's queue (its rank among the tokens before it routed there, plus
    ``offset[expert]`` (E,), the tokens queued ahead of this group), whether
    the slot is within capacity, and its gate. The index form of the JAX
    package's dispatch matrix."""
    expert = torch.argmax(gates, dim=-1)
    gate = torch.gather(gates, 1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, n_experts)
    slot = (torch.cumsum(onehot, 0) * onehot).sum(1) - 1
    if offset is not None:
        slot = slot + offset[expert]
    return expert, slot, slot < cap, gate


def _route(p: dict, cfg: MoEDecoderConfig, flat: torch.Tensor):
    """Top-1 routing of a forward's ``flat`` (T, d) tokens with capacity
    ``max(int(cf * T / E), 1)``: :func:`route_slots` and the capacity."""
    cap = max(int(cfg.cf * flat.shape[0] / cfg.n_experts), 1)
    return route_slots(torch.softmax(tfm.linear(p["router"], flat), dim=-1), cfg.n_experts, cap), cap


def dispatch(flat: torch.Tensor, expert, slot, keep, n_experts: int, cap: int) -> torch.Tensor:
    """(E, C, d) expert inputs: each kept token's row at its expert's slot,
    zeros elsewhere (the one-hot einsum ``td,tec->ecd``)."""
    buf = flat.new_zeros((n_experts, cap, flat.shape[-1]))
    return buf.index_put((expert[keep], slot[keep]), flat[keep])


def combine(out: torch.Tensor, expert, slot, keep, gate) -> torch.Tensor:
    """(T, d): each kept token's expert output times its gate, zero for a
    dropped token (the einsum ``ecd,tec->td``, then the gate)."""
    y = out[expert, slot.clamp(0, out.shape[1] - 1)]
    return torch.where(keep[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device)) * gate[:, None]


def experts(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """(E, C, d) slots through their experts' MLPs: gelu (exact) between."""
    h = torch.nn.functional.gelu(torch.bmm(x, w1.to(x.dtype)))
    return torch.bmm(h, w2.to(x.dtype))


def exchange(expert_in: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, group) -> torch.Tensor:
    """Expert parallelism over ``group`` (n ranks, ``E/n`` local experts in
    ``w1`` / ``w2``): ``all_to_all`` the (E, C, d) slots so each rank holds
    every rank's slots of its experts, ``(E/n, n*C, d)`` (the JAX call's
    ``split_axis=0, concat_axis=1, tiled=True``), run them, and send the
    results back (``split_axis=1, concat_axis=0``): (E, C, d) in expert
    order. Differentiable (each all_to_all's backward is the reverse one)."""
    if group is None:
        return experts(expert_in, w1, w2)
    e, c, d = expert_in.shape
    n = e // w1.shape[0]
    recv = all_to_all_grad(expert_in, group).reshape(n, e // n, c, d).transpose(0, 1).reshape(e // n, n * c, d)
    out = experts(recv, w1, w2)
    back = out.reshape(e // n, n, c, d).transpose(0, 1).contiguous()
    return all_to_all_grad(back, group).reshape(e, c, d)


def _moe(p: dict, x: torch.Tensor, cfg: MoEDecoderConfig, group) -> torch.Tensor:
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    (expert, slot, keep, gate), cap = _route(p, cfg, flat)
    out = exchange(dispatch(flat, expert, slot, keep, cfg.n_experts, cap), p["w1"], p["w2"], group)
    return combine(out, expert, slot, keep, gate).reshape(b, s, d)


def _moe_mlp_dense(p: dict, x: torch.Tensor, *, cfg: MoEDecoderConfig) -> torch.Tensor:
    """Single-device capacity dispatch over all of ``x``'s (B, S, d) tokens."""
    return _moe(p, x, cfg, None)


def _moe_mlp_ep(p: dict, x: torch.Tensor, *, cfg: MoEDecoderConfig, group) -> torch.Tensor:
    """Expert-parallel MoE MLP on this rank: ``p["w1"]`` / ``p["w2"]`` are
    its LOCAL ``(E/n, ...)`` experts, ``x`` its local (B/n, S, d) tokens
    (capacity counts them alone, as each JAX rank's ``_route``); the
    exchange is an explicit ``all_to_all`` each way over ``group``."""
    return _moe(p, x, cfg, group)


def _forward(params: dict, cfg: MoEDecoderConfig, tokens, pos_ids, caches: list, pos: int, pad_lens, moe_mlp):
    """(b, S) token chunk at cache slots [pos, pos+S) -> logits (b, S, V);
    the caches are written in place."""
    x = embed_tokens(params["token_embs"], tokens, params["pos_embs"], pos_ids)
    lc = cfg.layer
    for lp, cache in zip(params["layers"], caches, strict=True):
        attn, _ = tfm.mha_apply(lp["sa"], lc, layer_norm(lp["sa_norm"], x), cache=cache, cache_pos=pos,
                                pad_lens=pad_lens)
        x = x + attn
        x = x + moe_mlp(lp, layer_norm(lp["mlp_norm"], x))
    x = layer_norm(params["norm"], x)
    return torch.matmul(x, params["token_embs"].to(x.dtype).t())


@torch.inference_mode()
def _generate_batch(params: dict, cfg: MoEDecoderConfig, prompt_buf, pad_lens, limit: int, eos_id: int, moe_mlp,
                    group=None):
    """Greedy batched generation (``serving.greedy_generate``). With a
    ``group`` (expert parallelism) every rank must take part in every
    forward (each carries two all_to_alls per layer), so the loop stops on
    the GLOBAL count of finished rows, all-reduced every step: a rank whose
    rows are all done keeps stepping, parked on EOS, until every rank's are."""
    b, dev, lc = prompt_buf.shape[0], prompt_buf.device, cfg.layer
    caches, _ = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, cfg.max_seq_len, lc.head_dim,
                                  dtype=params["token_embs"].dtype, device=dev)
    total = b if group is None else b * torch.distributed.get_world_size(group)

    def forward(tokens, pos_ids, pos):
        return _forward(params, cfg, tokens, pos_ids, caches, pos, pad_lens, moe_mlp)

    def all_done(done, step: int) -> bool:
        return int(psum(done.sum(dtype=torch.int64).reshape(1), group)) == total

    return greedy_generate(forward, prompt_buf, pad_lens, limit, eos_id, cfg.max_seq_len, all_done)


def ep_param_pspecs(cfg: MoEDecoderConfig) -> dict:
    """Specs of the MoE decoder tree: each layer's expert weights split over
    "ep" on the expert dim; everything else replicated."""
    lin = {"w": (), "b": ()}
    block = {"sa_norm": {"scale": (), "bias": ()}, "sa": {k: dict(lin) for k in ("q", "k", "v", "o")},
             "mlp_norm": {"scale": (), "bias": ()}, "router": dict(lin), "w1": ("ep",), "w2": ("ep",)}
    return {"token_embs": (), "pos_embs": (), "layers": [block] * cfg.n_layers, "norm": {"scale": (), "bias": ()}}


class MoEDecoderGenerator:
    """Single-device greedy generator for the MoE decoder LM (the oracle of
    the EP path), on the device its parameters lie on."""

    def __init__(self, params, cfg: MoEDecoderConfig) -> None:
        self.params, self.cfg = params, cfg

    def generate_tokens_batch(self, token_lists, max_tokens: int = 16, eos_id: int = -1):
        packed = left_pad_prompts(token_lists, self.cfg.max_seq_len, max_tokens, PROMPT_BUCKET)
        if packed is None:
            return [list(ts) for ts in token_lists]
        buf, pad_lens, limit = packed
        dev = self.params["token_embs"].device
        out, lengths = _generate_batch(self.params, self.cfg, torch.from_numpy(buf).to(dev),
                                       torch.from_numpy(pad_lens).to(dev), limit, eos_id,
                                       lambda p, x: _moe_mlp_dense(p, x, cfg=self.cfg))
        return unpack_rows(out, lengths, pad_lens)


class EPMoEGenerator:
    """Expert-parallel drop-in for :class:`MoEDecoderGenerator` over an
    ``("ep",)`` mesh: rows data-sharded, experts weight-sharded, an explicit
    all_to_all dispatch each way per layer and forward. Every rank takes the
    whole request list and returns every row; token-identical to the
    single-device oracle when ``capacity_factor >= n_experts``."""

    def __init__(self, params, cfg: MoEDecoderConfig, mesh) -> None:
        if set(mesh.shape) != {"ep"}:
            raise ValueError(f'EP serving mesh needs an ("ep",) axis, got {tuple(mesh.shape)}')
        self.n_ranks = mesh.shape["ep"]
        if cfg.n_experts % self.n_ranks:
            raise ValueError(f"{cfg.n_experts} experts not divisible by ep={self.n_ranks}")
        self.cfg, self.mesh = cfg, mesh
        self.params = shard_params(params, ep_param_pspecs(cfg), mesh)

    def generate_tokens_batch(self, token_lists, max_tokens: int = 16, eos_id: int = -1):
        b = len(token_lists)
        if b % self.n_ranks:
            raise ValueError(f"batch {b} not divisible by ep={self.n_ranks}")
        packed = left_pad_prompts(token_lists, self.cfg.max_seq_len, max_tokens, PROMPT_BUCKET)
        if packed is None:
            return [list(ts) for ts in token_lists]
        buf, pad_lens, limit = packed
        n = b // self.n_ranks
        rows = slice(self.mesh.index("ep") * n, (self.mesh.index("ep") + 1) * n)
        dev, group = self.mesh.device, self.mesh.group("ep")
        out, lengths = _generate_batch(self.params, self.cfg, torch.from_numpy(buf[rows]).to(dev),
                                       torch.from_numpy(pad_lens[rows]).to(dev), limit, eos_id,
                                       lambda p, x: _moe_mlp_ep(p, x, cfg=self.cfg, group=group), group)
        out, lengths = (self.mesh.all_gather(torch.from_numpy(np.ascontiguousarray(a)), "ep").numpy()
                        for a in (out, lengths))
        return unpack_rows(out, lengths, pad_lens)
