"""GPipe pipeline parallelism over the "pp" mesh axis (PyTorch port of
``pytorch_models_tpu/parallel/pipeline.py``).

Each pp rank holds one stage's parameters. Microbatch activations flow rank
-> rank+1 by ``send`` / ``recv`` in the classic GPipe schedule of ``n_micro
+ n_stages - 1`` ticks: at tick ``t`` rank ``p`` runs microbatch ``t - p``.
The last rank's outputs are broadcast over "pp", so every rank returns
them, as the JAX package's ``gpipe_apply`` does.

The schedule is one autograd node (:class:`_GPipe`): its forward keeps each
microbatch's graph of the stage; its backward runs the schedule in reverse,
receiving each output gradient from rank p+1, differentiating the stage and
sending the input gradient to rank p-1 (send <-> recv of the gradient), and
returns the gradients of the stage's parameters summed over microbatches.
The collectives inside the stage (tensor and sequence parallelism, the
expert all_to_all) run in both passes on every rank of their groups in the
same order, since those ranks share a pp index and so a schedule.
"""

from __future__ import annotations

import torch

from .mesh import psum


def _flatten(tree):
    """``(leaves, rebuild)`` of a dict/list tree of tensors."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        leaves.append(t)
        return len(leaves) - 1

    shape = walk(tree)

    def rebuild(new, s=shape):
        if isinstance(s, dict):
            return {k: rebuild(new, v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(rebuild(new, v) for v in s)
        return new[s]

    return leaves, rebuild


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, rebuild, mesh, n_stages: int, mbs: torch.Tensor, *leaves: torch.Tensor):
        last = n_stages - 1
        p, n_micro = mesh.index("pp"), mbs.shape[0]
        inner = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        params = rebuild(inner)
        outs = torch.zeros_like(mbs)
        saved = {}
        with torch.enable_grad():
            for t in range(n_micro + last):
                m = t - p
                if not 0 <= m < n_micro:  # this rank idles at this tick
                    continue
                x = mbs[m] if p == 0 else mesh.recv(mbs[m], "pp", p - 1)
                x = x.detach().requires_grad_(p > 0 or mbs.requires_grad)
                y = stage_fn(params, x)
                saved[m] = (x, y)
                if p < last:
                    mesh.send(y.detach(), "pp", p + 1)
                else:
                    outs[m] = y.detach()
        ctx.mesh, ctx.last, ctx.saved, ctx.inner = mesh, last, saved, inner
        return mesh.broadcast(outs, "pp", last)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh, last = ctx.mesh, ctx.last
        p, n_micro = mesh.index("pp"), grad.shape[0]
        grad = psum(grad.contiguous().clone(), mesh.group("pp"))  # every pp rank's use of the broadcast outputs
        wrt = [t for t in ctx.inner if t.requires_grad]
        sums = [None] * len(wrt)
        g_mbs = None
        for t in reversed(range(n_micro + last)):
            m = t - p
            if not 0 <= m < n_micro:
                continue
            x, y = ctx.saved.pop(m)
            dy = grad[m] if p == last else mesh.recv(y, "pp", p + 1)
            got = torch.autograd.grad(y, ([x] if x.requires_grad else []) + wrt, dy, allow_unused=True)
            if x.requires_grad:
                gx, got = got[0], got[1:]
                if p > 0:
                    mesh.send(gx, "pp", p - 1)
                else:
                    g_mbs = torch.zeros_like(grad) if g_mbs is None else g_mbs
                    g_mbs[m] = gx
            sums = [s if g is None else (g if s is None else s + g) for s, g in zip(sums, got)]
        it = iter(sums)
        return (None, None, None, None, g_mbs, *(next(it) if t.requires_grad else None for t in ctx.inner))


def gpipe_apply(stage_fn, stage_params, microbatches: torch.Tensor, mesh, n_stages: int) -> torch.Tensor:
    """Run ``stage_fn(stage_params, x) -> y`` (``y`` shaped as ``x``) over
    the pipeline's stages.

    ``stage_params``: THIS rank's stage (a tree of tensors; the JAX package
    passes every stage with a leading axis split over "pp"); ``microbatches``:
    (M, mb, ...) activations, read on the first rank. Returns the (M, mb,
    ...) outputs on every pp rank; differentiable with respect to both.
    With ``n_stages == 1`` the stage runs once per microbatch (not on the
    flattened batch: capacity-based MoE layers make results depend on the
    token grouping).
    """
    if n_stages == 1:
        return torch.stack([stage_fn(stage_params, mb) for mb in microbatches])
    if mesh.size("pp") != n_stages:
        raise ValueError(f"a pipeline of {n_stages} stages needs a pp axis of that size, got {mesh.size('pp')}")
    leaves, rebuild = _flatten(stage_params)
    return _GPipe.apply(stage_fn, rebuild, mesh, n_stages, microbatches, *leaves)
