"""Multi-parallel training step: dp + pp + tp + sp + ep on one mesh (PyTorch
port of ``pytorch_models_tpu/parallel/train.py``).

A small top-1 MoE transformer LM trained with cross-entropy by SGD over a
``("dp", "pp", "tp")`` mesh of ``torch.distributed`` ranks, one process per
rank, each holding its shard (:func:`param_pspecs`, ``sharding.shard_params``):

- dp: the rows. Microbatch ``m`` is the global rows ``[m*B/M, (m+1)*B/M)``
  (the JAX package's reshape) and dp rank ``d`` takes its ``d``-th block of
  each microbatch's rows;
- pp: the stages, a GPipe schedule over send / recv (``pipeline.py``);
- tp: the heads (column-parallel q/k/v, row-parallel o);
- sp: between blocks the residual stream is sequence-sharded over "tp";
  the normed input is all-gathered before q/k/v and the out-projection's
  partial sums reduce-scattered back to the sequence shard;
- ep: the experts are sharded over "tp" and the rank's sequence shard is
  dispatched with an explicit all_to_all each way
  (:func:`_moe_mlp_sparse_ep`).

The arithmetic is the JAX step's: the MoE's capacity counts one
microbatch's tp sequence shard over ALL of that microbatch's rows in global
row order (the JAX ``shard_map`` is manual over "tp" only), so a dp rank
offsets its slots by the lower dp ranks' per-expert counts; the loss is the
mean over all ``B*(L-1)`` positions. Gradients of a leaf applied to a shard
of the tokens are summed over the axes that split them: every leaf over dp,
the norms, the router and o's bias also over tp, and the embeddings and the
final norm (used by the first stage's lookup and by the head, which each pp
rank applies to its share of the rows) over tp and pp. No kernel runs here:
none has a backward, and the attention's auto gate takes the plain path
under autograd.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import transformer as tfm
from ..ops import layer_norm
from ..utils import from_jax_params, to_jax_params, tree_map
from ..utils.module import resolve_device
from ..utils.params import _index_tree, _stack_len, stack_trees
from .ep_serving import combine, dispatch, exchange, experts, moe_block_init, route_slots
from .mesh import all_gather_grad, psum, reduce_from_group, reduce_scatter_grad
from .pipeline import _flatten, gpipe_apply
from .sharding import Split, tree_map_with_path


@dataclass(frozen=True)
class MoELMConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_stages: int = 2
    layers_per_stage: int = 2
    n_experts: int = 4
    expert_hidden: int = 256
    max_seq_len: int = 64
    # "ep": the explicit all_to_all dispatch over the experts sharded over "tp" (any mesh);
    # "sparse": GShard capacity dispatch over a whole microbatch on one rank (a mesh with dp = tp = 1);
    # "dense": every expert computes every token (E x FLOPs; the parity oracle; tp = 1)
    moe_impl: str = "ep"
    capacity_factor: float = 2.0

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, n_heads=self.n_heads)


def moe_lm_init(gen: torch.Generator, cfg: MoELMConfig, device=None) -> dict:
    """Random parameters drawn on the CPU from ``gen`` (the JAX init's
    distributions), then moved to ``device`` (None: the CUDA card, as the
    port's models; ``"cpu"`` keeps them on the host): ``"stages"`` is a list of
    ``n_stages`` lists of ``layers_per_stage`` block dicts, where the JAX tree
    stacks ``(n_stages, layers_per_stage, ...)`` leaves
    (:func:`moe_lm_from_jax` / :func:`moe_lm_to_jax` carry trees across)."""
    stages = [[moe_block_init(gen, cfg.layer, cfg.n_experts, cfg.expert_hidden) for _ in range(cfg.layers_per_stage)]
              for _ in range(cfg.n_stages)]
    p = {"token_embs": torch.randn(cfg.vocab_size, cfg.d_model, generator=gen) * 0.02,
         "pos_embs": torch.randn(cfg.max_seq_len, cfg.d_model, generator=gen) * 0.02,
         "stages": stages, "norm": tfm.ln_init(cfg.d_model)}
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device), p)


def moe_lm_from_jax(np_tree: dict, device=None) -> dict:
    """``moe_lm_init``'s JAX tree (numpy leaves) -> the port's tree."""
    out = from_jax_params({k: v for k, v in np_tree.items() if k != "stages"}, device)
    stages = np_tree["stages"]
    out["stages"] = [from_jax_params({"layers": _index_tree(stages, s)}, device)["layers"]
                     for s in range(_stack_len(stages))]
    return out


def moe_lm_to_jax(tree: dict) -> dict:
    """The port's MoE LM tree -> the JAX package's, as numpy arrays."""
    out = to_jax_params({k: v for k, v in tree.items() if k != "stages"})
    out["stages"] = stack_trees([stack_trees([to_jax_params(lp) for lp in stage]) for stage in tree["stages"]])
    return out


def _moe_mlp(p: dict, cfg: MoELMConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense-dispatch top-1 MoE: every expert computes every token (E x FLOPs)."""
    gates = torch.softmax(tfm.linear(p["router"], x), dim=-1)  # (mb, L, E)
    h = torch.nn.functional.gelu(torch.einsum("bld,edh->eblh", x, p["w1"].to(x.dtype)))
    out = torch.einsum("eblh,ehd->ebld", h, p["w2"].to(x.dtype))
    onehot = torch.nn.functional.one_hot(torch.argmax(gates, dim=-1), cfg.n_experts).to(x.dtype)
    gate_val = torch.sum(gates * onehot, dim=-1, keepdim=True)
    return torch.einsum("ebld,ble->bld", out, onehot) * gate_val


def _moe_mlp_sparse(p: dict, cfg: MoELMConfig, x: torch.Tensor) -> torch.Tensor:
    """GShard top-1 dispatch with per-expert capacity ``int(cf * T / E)``
    over the (mb, L, d) block's tokens; tokens beyond an expert's capacity
    are dropped (with ``capacity_factor >= E`` it equals the dense dispatch)."""
    mb, l, d = x.shape
    flat = x.reshape(mb * l, d)
    cap = int(cfg.capacity_factor * mb * l / cfg.n_experts)
    gates = torch.softmax(tfm.linear(p["router"], flat), dim=-1)
    expert, slot, keep, gate = route_slots(gates, cfg.n_experts, cap)
    out = experts(dispatch(flat, expert, slot, keep, cfg.n_experts, cap), p["w1"], p["w2"])
    return combine(out, expert, slot, keep, gate).reshape(mb, l, d)


def _moe_mlp_sparse_ep(p: dict, cfg: MoELMConfig, x: torch.Tensor, mesh) -> torch.Tensor:
    """Top-1 MoE with explicit ``all_to_all`` expert-parallel dispatch on
    this rank: ``x`` is its (mb/dp, L/tp, d) block of a microbatch (its dp
    rows, its tp sequence shard), ``p["w1"]`` / ``p["w2"]`` its ``E/tp``
    experts. Capacity is the JAX step's, ``max(int(cf * mb * L/tp / E), 1)``
    over the whole microbatch's rows of this sequence shard, and a token's
    slot counts the tokens before it in global row order: the lower dp ranks'
    (an ``(E,)`` all-gather over "dp") and then this rank's own. The
    exchange and its backward are all_to_alls over "tp"."""
    mb_loc, l_loc, d = x.shape
    e = cfg.n_experts
    cap = max(int(cfg.capacity_factor * mb_loc * mesh.size("dp") * l_loc / e), 1)
    flat = x.reshape(mb_loc * l_loc, d)
    gates = torch.softmax(tfm.linear(p["router"], flat), dim=-1)  # (T, E)
    offset = None
    if mesh.size("dp") > 1:
        counts = torch.bincount(torch.argmax(gates, dim=-1), minlength=e)
        offset = mesh.all_gather(counts[None], "dp")[: mesh.index("dp")].sum(0)
    expert, slot, keep, gate = route_slots(gates, e, cap, offset)
    out = exchange(dispatch(flat, expert, slot, keep, e, cap), p["w1"], p["w2"], mesh.group("tp"))
    return combine(out, expert, slot, keep, gate).reshape(mb_loc, l_loc, d)


def _block(p: dict, cfg: MoELMConfig, x: torch.Tensor, mesh) -> torch.Tensor:
    """One pre-norm MoE block on the rank's (mb/dp, L/tp, d) sequence shard:
    the normed shard all-gathered over "tp" for this rank's heads, the
    out-projection's partial sums reduce-scattered back to the shard (then
    o's bias), then the MoE on the shard."""
    tp = mesh.group("tp")
    lc = tfm.LayerConfig.make(cfg.d_model, n_heads=cfg.n_heads // mesh.size("tp"),
                              head_dim=cfg.d_model // cfg.n_heads)
    h = all_gather_grad(layer_norm(p["sa_norm"], x), tp, dim=1)
    partial = tfm.mha_apply(dict(p["sa"], o={"w": p["sa"]["o"]["w"]}), lc, h, causal=True)
    x = x + (reduce_scatter_grad(partial, tp, dim=1) + p["sa"]["o"]["b"])
    h = layer_norm(p["mlp_norm"], x)
    if cfg.moe_impl == "ep":
        return x + _moe_mlp_sparse_ep(p, cfg, h, mesh)
    if cfg.moe_impl == "sparse":
        return x + _moe_mlp_sparse(p, cfg, h)
    return x + _moe_mlp(p, cfg, h)


def _stage_fn(cfg: MoELMConfig, mesh):
    """``fn(stages, x)``: the rank's stages (a list of layer lists) in order."""
    def fn(stages, x):
        for stage in stages:
            for lp in stage:
                x = _block(lp, cfg, x, mesh)
        return x

    return fn


def _check_mesh(cfg: MoELMConfig, mesh) -> None:
    dp, pp, tp = (mesh.size(a) for a in ("dp", "pp", "tp"))
    if set(mesh.shape) != {"dp", "pp", "tp"}:
        raise ValueError(f'the train step runs over ("dp", "pp", "tp") axes, got {tuple(mesh.shape)}')
    if cfg.n_stages % pp or cfg.n_heads % tp or cfg.n_experts % tp:
        raise ValueError(f"{cfg.n_stages} stages, {cfg.n_heads} heads and {cfg.n_experts} experts must split "
                         f"over pp={pp} and tp={tp}")
    if (cfg.moe_impl == "dense" and tp > 1) or (cfg.moe_impl == "sparse" and dp * tp > 1):
        raise ValueError(f'moe_impl="{cfg.moe_impl}" holds whole experts and whole microbatches: '
                         'use "ep" on this mesh')


def _shards(tokens: torch.Tensor, mesh, n_micro: int):
    """This rank's ``(ids, labels, valid)``, each (M, mb/dp, L/tp): the
    microbatches' dp rows at the tp sequence shard, each position's next
    token and whether it has one (the global last position has none)."""
    b, l = tokens.shape
    dp, tp = mesh.size("dp"), mesh.size("tp")
    if b % (n_micro * dp) or l % tp:
        raise ValueError(f"batch {b} must split over n_micro={n_micro} x dp={dp}, length {l} over tp={tp}")
    mb, lt = b // n_micro // dp, l // tp
    rows = tokens.reshape(n_micro, b // n_micro, l)[:, mesh.index("dp") * mb:(mesh.index("dp") + 1) * mb]
    lo = mesh.index("tp") * lt
    nxt = torch.nn.functional.pad(rows, (0, 1))[..., lo + 1:lo + lt + 1]
    valid = (torch.arange(lo, lo + lt, device=tokens.device) < l - 1).expand_as(nxt)
    return rows[..., lo:lo + lt], nxt, valid


def _hidden(params: dict, cfg: MoELMConfig, ids: torch.Tensor, mesh) -> torch.Tensor:
    """(M, mb/dp, L/tp) ids -> the pipelined stage stack's (M, mb/dp, L/tp,
    d) outputs on every pp rank."""
    lo = mesh.index("tp") * ids.shape[-1]
    x = params["token_embs"][ids] + params["pos_embs"][lo:lo + ids.shape[-1]]
    return gpipe_apply(_stage_fn(cfg, mesh), params["stages"], x, mesh, mesh.size("pp"))


def moe_lm_forward(params: dict, cfg: MoELMConfig, tokens: torch.Tensor, mesh, n_micro: int) -> torch.Tensor:
    """(B, L) tokens (the whole batch, on every rank) -> this rank's logits
    ``(M, B/M/dp, L/tp, V)``: microbatch ``m``'s dp rows at the tp sequence
    shard, through the pipelined stage stack (the same on every pp rank).
    ``params`` is the rank's shard under :func:`param_pspecs`."""
    x = _hidden(params, cfg, _shards(tokens, mesh, n_micro)[0], mesh)
    x = layer_norm(params["norm"], x)
    return torch.matmul(x, params["token_embs"].to(x.dtype).t())


def _loss(params: dict, cfg: MoELMConfig, tokens: torch.Tensor, mesh, n_micro: int) -> torch.Tensor:
    """The mean next-token cross-entropy over all ``B*(L-1)`` positions, on
    every rank: each pp rank applies the head to its share of the rows."""
    ids, labels, valid = _shards(tokens, mesh, n_micro)
    h = _hidden(params, cfg, ids, mesh).flatten(0, 1)  # (rows, L/tp, d)
    share = torch.tensor_split(torch.arange(h.shape[0]), mesh.size("pp"))[mesh.index("pp")]
    rows = slice(int(share[0]), int(share[-1]) + 1) if len(share) else slice(0, 0)
    x = layer_norm(params["norm"], h[rows])
    logp = torch.log_softmax(torch.matmul(x, params["token_embs"].to(x.dtype).t()).float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.flatten(0, 1)[rows, :, None])[..., 0]
    loss = (nll * valid.flatten(0, 1)[rows]).sum() / (tokens.shape[0] * (tokens.shape[1] - 1))
    for axis in ("dp", "tp", "pp"):
        loss = reduce_from_group(loss, mesh.group(axis))
    return loss


def param_pspecs(cfg: MoELMConfig) -> dict:
    """Specs (``sharding.shard_params``): the stages split over "pp", heads
    over "tp" (q/k/v columns with their biases, o's input rows), experts over
    "tp" (expert parallelism shares the axis); everything else replicated."""
    col = {"w": (None, "tp"), "b": ("tp",)}
    block = {"sa_norm": {"scale": (), "bias": ()},
             "sa": {"q": col, "k": col, "v": col, "o": {"w": ("tp", None), "b": ()}},
             "mlp_norm": {"scale": (), "bias": ()}, "router": {"w": (), "b": ()}, "w1": ("tp",), "w2": ("tp",)}
    return {"token_embs": (), "pos_embs": (), "stages": Split("pp", [[block] * cfg.layers_per_stage] * cfg.n_stages),
            "norm": {"scale": (), "bias": ()}}


# the leaves of a stage block applied to the rank's tp sequence shard: their gradients also sum over "tp"
_SEQ_SHARD_LEAVES = ("['sa_norm']", "['mlp_norm']", "['router']", "['o']['b']")


def _grad_axes(path: str) -> tuple[str, ...]:
    """The axes over which a leaf's gradient sums: those that split the
    tokens it was applied to."""
    if not path.startswith("['stages']"):
        return ("dp", "tp", "pp")  # the embeddings and the final norm
    return ("dp", "tp") if any(k in path for k in _SEQ_SHARD_LEAVES) else ("dp",)


def _loss_and_grads(params: dict, cfg: MoELMConfig, tokens: torch.Tensor, mesh, n_micro: int):
    """``(loss, grads)``: the global mean loss (0-dim) and the gradient
    tree of this rank's shard ``params``, each leaf's gradient summed over
    the axes that split its tokens (one bucketed all-reduce per class of
    leaves and axis, in one order on every rank)."""
    paths = []
    tree_map_with_path(lambda path, leaf: paths.append(path), params)  # in _flatten's order
    leaves, rebuild = _flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss = _loss(rebuild(leaves), cfg, tokens, mesh, n_micro)
    loss.backward()
    grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in leaves]
    for axes in sorted({_grad_axes(p) for p in paths}):
        idx = [i for i, p in enumerate(paths) if _grad_axes(p) == axes]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        for axis in axes:
            flat = psum(flat, mesh.group(axis))
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])
    return loss.detach(), rebuild(grads)


def make_train_step(cfg: MoELMConfig, mesh, n_micro: int, lr: float = 1e-2):
    """One SGD step over the mesh, ``step(params, tokens) -> (params,
    loss)``: ``params`` this rank's shard, ``tokens`` the whole (B, L) batch
    (on every rank, on the mesh's device), ``loss`` the global mean as a
    0-dim tensor. Returns ``(step, specs)``;
    ``sharding.shard_params(params, specs, mesh)`` cuts a rank's shard from
    the whole tree (the JAX package's ``device_put`` over its shardings)."""
    _check_mesh(cfg, mesh)

    def step(params: dict, tokens: torch.Tensor):
        loss, grads = _loss_and_grads(params, cfg, tokens, mesh, n_micro)
        leaves, rebuild = _flatten(params)
        return rebuild([t.detach() - lr * g.to(t.dtype) for t, g in zip(leaves, _flatten(grads)[0])]), loss

    return step, param_pspecs(cfg)
