"""Fused greedy decode step: the whole decoder layer stack for one token in
ONE kernel (PyTorch port of ``pytorch_models_tpu/ops/decode_step.py``: its
base variant, pre-norm LayerNorm, biased projections, GELU; the
cross-attention phase of Whisper; T5's variant, RMSNorm, GEGLU and a
key-major rel-pos self-attention bias; the greedy head over a tied or an
untied table).

:func:`fused_decode_step` (GPT-2) and :func:`fused_cross_decode_step`
(Whisper; T5 with ``norm="rms", gated=True, sbias=...``) launch the
hand-written CUDA kernel ``csrc/decode_step.cu`` on CUDA tensors and run
:func:`fused_decode_step_plain` on CPU tensors.

Cache convention: the JAX kernel returns the step's ``k_new, v_new (L, B,
H*D)`` and its caller writes them at ``pos``. The port keeps its in-place
convention (transformer.py): the kernel and its plain version write the new
K/V into the layer-stacked ``(L, B, Lp, H*D)`` caches at ``pos`` themselves,
then attend over ``[min(pad_b, pos), pos]``, and return ``(x_out, tok)``.
``k_caches[:, :, pos]`` afterwards holds what the JAX function returns as
``k_new``.

Numerics (the kernel and its plain version alike): LayerNorm (or RMSNorm:
no mean subtraction) statistics in fp32, ``y * scale + bias`` in fp32, the
normed input rounded once to the compute dtype (the JAX kernel's ``_norm``);
projections accumulate in fp32, add their fp32 bias, then round once; GEGLU
is ``round(round(gelu(round(a + b1))) * round(g))`` of the two halves of
fc1; q is scaled in fp32 and rounded; scores [+ the fp32 self bias], softmax
and ``P @ V`` in fp32 with the safe max, an empty cross range giving zeros;
residual adds in the compute dtype; in bf16 the head's scores are rounded to
bf16 before the argmax, whose ties go to the lowest index. The JAX kernel also rounds ``k * q`` and the probabilities to
bf16 inside its bf16 attention; the port keeps them in fp32 (its per-op
decode kernel does too).

Not ported here: int8 weights, ``a8``, int8 self/cross KV, and (by rule)
the in-kernel embed phase and the ``eager`` DMA-ordering flag.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .decode_attention import NEG_INF, _row_i32
from .greedy_head import greedy_argmax_tied_plain

HEAD_DIM = 64  # the kernel's head width (every family of the JAX package)
MAX_BATCH = 8  # rows the kernel serves; a larger batch decodes per-op
_ACT_CODES = ("gelu", "approximate_gelu")
_NORM_CODES = ("ln", "rms")


def _act_code(act: str, dtype: torch.dtype) -> int:
    """0: exact (erf) GELU, 1: tanh GELU. bf16 serving takes tanh-GELU for
    "gelu" too, the port's ACT_FNS policy (ops/layers.py)."""
    return 1 if act == "approximate_gelu" or dtype == torch.bfloat16 else 0


def _act(act: str, x: torch.Tensor) -> torch.Tensor:
    """GELU in fp32 on compute-dtype values, rounded once."""
    tanh = _act_code(act, x.dtype) == 1
    return F.gelu(x.float(), approximate="tanh" if tanh else "none").to(x.dtype)


def _norm_pair(p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    scale = p["scale"].float()
    return scale, (p["bias"].float() if "bias" in p else torch.zeros_like(scale))


def _bias(lin: dict, n: int, like: torch.Tensor) -> torch.Tensor:
    """A projection's fp32 bias; a missing one (Whisper's k) packs as zeros."""
    return lin["b"].float() if "b" in lin else torch.zeros(n, device=like.device)


def pack_decode_weights(layers: list, dtype=torch.bfloat16, cross: bool = False, gated: bool = False) -> dict:
    """Per-layer params (``transformer.layer_init`` trees) -> the kernel's
    layer-stacked ``(L, ...)`` tensors, once per generate call: q|k|v
    concatenated to ``wqkv (L, d, 3*H*D)``; weights cast to ``dtype``; biases
    and norm params fp32 (a missing bias, e.g. T5's, packs as zeros). With
    ``cross``, the q/o projections and norm of the cross-attention block too
    (its K/V are the precomputed caches). With ``gated`` the MLP is T5's
    GEGLU tree ``mlp.{w, v, wo}``: ``w1 = [w | v] (L, d, 2*dff)``, ``b1``
    zeros (L, dff), ``w2 = wo``. The pack does not depend on the norm kind."""

    def stack(fn, to=None):
        t = torch.stack([fn(lp) for lp in layers])
        return (t if to is None else t.to(to)).contiguous()

    def qkv_w(lp):
        return torch.cat([lp["sa"][k]["w"] for k in ("q", "k", "v")], dim=-1)

    def qkv_b(lp):
        return torch.cat([_bias(lp["sa"][k], lp["sa"][k]["w"].shape[-1], lp["sa"][k]["w"]) for k in ("q", "k", "v")])

    def lin(block, name, part):
        def fn(lp):
            leaf = lp[block][name]
            return leaf["w"] if part == "w" else _bias(leaf, leaf["w"].shape[-1], leaf["w"])
        return fn

    if gated:
        mlp = {"w1": stack(lambda lp: torch.cat([lp["mlp"]["w"]["w"], lp["mlp"]["v"]["w"]], dim=-1), dtype),
               "b1": stack(lin("mlp", "w", "b")), "w2": stack(lin("mlp", "wo", "w"), dtype),
               "b2": stack(lin("mlp", "wo", "b"))}
    else:
        mlp = {"w1": stack(lin("mlp", "fc1", "w"), dtype), "b1": stack(lin("mlp", "fc1", "b")),
               "w2": stack(lin("mlp", "fc2", "w"), dtype), "b2": stack(lin("mlp", "fc2", "b"))}
    out = {
        "wqkv": stack(qkv_w, dtype), "bqkv": stack(qkv_b),
        "wo": stack(lin("sa", "o", "w"), dtype), "bo": stack(lin("sa", "o", "b")),
        **mlp,
        "ln1_s": stack(lambda lp: _norm_pair(lp["sa_norm"])[0]),
        "ln1_b": stack(lambda lp: _norm_pair(lp["sa_norm"])[1]),
        "ln2_s": stack(lambda lp: _norm_pair(lp["mlp_norm"])[0]),
        "ln2_b": stack(lambda lp: _norm_pair(lp["mlp_norm"])[1]),
    }
    if cross:
        out.update({
            "wqc": stack(lin("ca", "q", "w"), dtype), "bqc": stack(lin("ca", "q", "b")),
            "woc": stack(lin("ca", "o", "w"), dtype), "boc": stack(lin("ca", "o", "b")),
            "lnc_s": stack(lambda lp: _norm_pair(lp["ca_norm"])[0]),
            "lnc_b": stack(lambda lp: _norm_pair(lp["ca_norm"])[1]),
        })
    return out


def pack_greedy_head(w: torch.Tensor, norm_p: dict, dtype=torch.bfloat16, tied: bool = True) -> dict:
    """Head table + final-norm params for the head phase: ``w`` is a tied
    ``(V, d)`` embedding, or with ``tied=False`` an untied ``(d, V)``
    classifier, stored transposed to ``(V, d)`` once per generate call as the
    JAX package stores it (the head phase then reads one layout). The kernel
    masks the ragged vocabulary edge itself, so the table is not padded (a
    tied table already in ``dtype`` is not copied)."""
    fn_s, fn_b = _norm_pair(norm_p)
    emb = w if tied else w.t()
    return {"emb": emb.to(dtype).contiguous(), "fn_s": fn_s.contiguous(), "fn_b": fn_b.contiguous()}


def fused_step_eligible(layers: list, cfg, batch: int, cross: bool = False, gated: bool = False) -> bool:
    """What the CUDA kernel serves: pre-norm layers with a GELU MLP (a GEGLU
    ``mlp.{w, v, wo}`` one with ``gated``), head_dim 64, widths that are
    multiples of 64 (16-byte loads over whole column slabs), 1 to 8 rows,
    and, for weights on a CUDA device, what the kernel's own launch planner
    accepts there (its phase input fits in shared memory, its grid is
    co-resident). Anything else decodes per-op."""
    if not cfg.pre_norm or cfg.act not in _ACT_CODES or cfg.head_dim != HEAD_DIM:
        return False
    if not 1 <= batch <= MAX_BATCH or not layers:
        return False
    lp = layers[0]
    try:
        mlp_keys = ("w", "v", "wo") if gated else ("fc1", "fc2")
        blocks = [lp["sa"][k]["w"] for k in ("q", "k", "v", "o")] + [lp["mlp"][k]["w"] for k in mlp_keys]
        norms = [lp["sa_norm"], lp["mlp_norm"]] + ([lp["ca_norm"]] if cross else [])
        if cross:
            blocks += [lp["ca"][k]["w"] for k in ("q", "o")]
    except (KeyError, TypeError):
        return False
    if not all(isinstance(w, torch.Tensor) and w.is_floating_point() for w in blocks) or not all(norms):
        return False
    d, hd = blocks[0].shape
    dff = lp["mlp"]["w" if gated else "fc1"]["w"].shape[-1]
    if d % 64 or hd % 64 or dff % 64 or hd != cfg.n_heads * HEAD_DIM:
        return False
    w = blocks[0]
    if not w.is_cuda:
        return True
    if w.dtype not in (torch.float32, torch.bfloat16):
        return False
    args = _Args(b=batch, d=d, hd=hd, dff=dff, n_heads=cfg.n_heads, dtype=_build.dtype_code(w), gated=int(gated))
    with torch.cuda.device(w.device):
        return _plan(args) > 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _norm(s, bias, x, eps: float, kind: str):
    """The kernel's LayerNorm or RMSNorm (no mean subtraction): fp32
    statistics, ``y * scale + bias`` in fp32, rounded once to x's dtype."""
    x32 = x.float()
    if kind == "rms":
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    else:
        mean = x32.mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + eps)
    return (y * s.float() + bias.float()).to(x.dtype)


def _attend(q, kc, vc, valid, n_heads: int, bias=None):
    """q (B, H*D) -> (B, H*D): fp32 scores [+ a key-major (L, H) fp32 bias]
    and softmax over the ``valid`` (B, L) keys of a (B, L, H*D) cache; an
    empty row gives zeros."""
    b, hd = q.shape
    d = hd // n_heads
    qf = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float().reshape(b, n_heads, d)
    kf = kc.float().reshape(b, kc.shape[1], n_heads, d)
    vf = vc.float().reshape(b, vc.shape[1], n_heads, d)
    s = torch.einsum("bhd,blhd->bhl", qf, kf)
    if bias is not None:
        s = s + bias.float().t()
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF / 2)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    out = torch.einsum("bhl,blhd->bhd", p, vf) / torch.where(denom == 0, torch.ones_like(denom), denom)
    return out.reshape(b, hd).to(q.dtype)


def fused_decode_step_plain(x, packed, k_caches, v_caches, pos: int, pad_lens, n_heads: int, act: str = "gelu",
                            eps: float = 1e-5, head: dict | None = None, cross_k=None, cross_v=None, cross_lens=None,
                            norm: str = "ln", gated: bool = False, sbias=None):
    """The kernel's math in plain PyTorch, layer by layer (see the module
    docstring). Writes this step's K/V into ``k_caches``/``v_caches`` at
    ``pos``; returns ``(x_out (B, d), tok (B,) int64 or None)``. ``sbias``:
    None or the key-major ``(Lp, H)`` fp32 self-attention bias of this
    step's query position, shared by every row and layer."""
    dt = x.dtype
    n_layers, b, l_max, _ = k_caches.shape
    dev = x.device
    pads = torch.zeros(b, dtype=torch.int32, device=dev) if pad_lens is None else _row_i32(pad_lens, b, dev)
    col = torch.arange(l_max, device=dev)[None, :]
    self_valid = (col >= pads.clamp(0, pos).long()[:, None]) & (col <= pos)
    if cross_k is not None:
        lens = _row_i32(cross_lens, b, dev)
        cross_valid = torch.arange(cross_k.shape[2], device=dev)[None, :] < lens.long()[:, None]

    def proj(h, w, bias):  # fp32 accumulation + fp32 bias, one rounding
        return (torch.matmul(h.float(), w.float()) + bias.float()).to(dt)

    def ln(s, bias, t):
        return _norm(s, bias, t, eps, norm)

    for i in range(n_layers):
        qkv = proj(ln(packed["ln1_s"][i], packed["ln1_b"][i], x), packed["wqkv"][i], packed["bqkv"][i])
        q, k, v = qkv.chunk(3, dim=-1)
        k_caches[i, :, pos] = k.to(k_caches.dtype)
        v_caches[i, :, pos] = v.to(v_caches.dtype)
        ctx = _attend(q, k_caches[i].to(dt), v_caches[i].to(dt), self_valid, n_heads, sbias)
        x = x + proj(ctx, packed["wo"][i], packed["bo"][i])
        if cross_k is not None:
            qc = proj(ln(packed["lnc_s"][i], packed["lnc_b"][i], x), packed["wqc"][i], packed["bqc"][i])
            ctx = _attend(qc, cross_k[i].to(dt), cross_v[i].to(dt), cross_valid, n_heads)
            x = x + proj(ctx, packed["woc"][i], packed["boc"][i])
        h2 = ln(packed["ln2_s"][i], packed["ln2_b"][i], x)
        if gated:  # GEGLU: gelu(a + b1) * g over the two halves of fc1, in the compute dtype
            m = torch.matmul(h2.float(), packed["w1"][i].float())
            a, g = m.chunk(2, dim=-1)
            h = _act(act, (a + packed["b1"][i].float()).to(dt)) * g.to(dt)
        else:
            h = _act(act, proj(h2, packed["w1"][i], packed["b1"][i]))
        x = x + proj(h, packed["w2"][i], packed["b2"][i])
    tok = None
    if head is not None:
        tok = greedy_argmax_tied_plain(ln(head["fn_s"], head["fn_b"], x), head["emb"].to(dt))
    return x, tok


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_PTRS = ("x", "x_out", "wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2", "ln1_s", "ln1_b", "ln2_s", "ln2_b",
         "wqc", "bqc", "woc", "boc", "lnc_s", "lnc_b", "k_cache", "v_cache", "pads", "xk", "xv", "xlens",
         "sbias", "emb", "fn_s", "fn_b", "tok", "workspace", "stream")
_INTS = ("n_layers", "b", "d", "hd", "dff", "n_heads", "l_max", "lx", "pos", "vocab", "act", "dtype", "has_cross",
         "has_head", "norm", "gated")


class _Args(ctypes.Structure):
    """csrc/decode_step.cu ``Args``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]
                + [("eps", ctypes.c_float), ("scale", ctypes.c_float)])


def _plan(args: _Args) -> int:
    """The kernel's launch planner (csrc/decode_step.cu ``plan``) on the
    current device: the workspace bytes, or a negated CUDA error. It reads
    only the shape fields and ``dtype`` of ``args``."""
    grid = ctypes.c_int(0)
    return _build.load_library().pmt_decode_step_workspace(ctypes.addressof(args), ctypes.addressof(grid))


def _launch(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head, cross_k, cross_v, cross_lens,
            norm="ln", gated=False, sbias=None):
    req = _build.require
    cross = cross_k is not None
    req(x.ndim == 2 and x.dtype in (torch.float32, torch.bfloat16), "fused decode step: x (B, d) fp32 or bf16")
    b, d = x.shape
    n_layers, _, l_max, hd = k_caches.shape
    dff = packed["w2"].shape[-2]
    dt, dev = x.dtype, x.device
    req(1 <= b <= MAX_BATCH, f"fused decode step: batch {b} not in [1, {MAX_BATCH}]")
    req(hd == n_heads * HEAD_DIM and d % 64 == 0 and hd % 64 == 0 and dff % 64 == 0,
        f"fused decode step: d {d}, H*D {hd}, dff {dff}, {n_heads} heads unsupported")
    req(act in _ACT_CODES, f"fused decode step: activation {act!r} unsupported")
    req(norm in _NORM_CODES, f"fused decode step: norm {norm!r} unsupported")
    req(0 <= pos < l_max, f"fused decode step: pos {pos} outside the cache of {l_max}")
    shapes = {"wqkv": (n_layers, d, 3 * hd), "bqkv": (n_layers, 3 * hd), "wo": (n_layers, hd, d), "bo": (n_layers, d),
              "w1": (n_layers, d, 2 * dff if gated else dff), "b1": (n_layers, dff),
              "w2": (n_layers, dff, d), "b2": (n_layers, d),
              "ln1_s": (n_layers, d), "ln1_b": (n_layers, d), "ln2_s": (n_layers, d), "ln2_b": (n_layers, d)}
    if cross:
        shapes.update({"wqc": (n_layers, d, hd), "bqc": (n_layers, hd), "woc": (n_layers, hd, d),
                       "boc": (n_layers, d), "lnc_s": (n_layers, d), "lnc_b": (n_layers, d)})
    tensors = {k: packed[k] for k in shapes}
    for k, shape in shapes.items():
        want = dt if k.startswith("w") else torch.float32
        req(tuple(tensors[k].shape) == shape and tensors[k].dtype == want,
            f"fused decode step: packed {k} must be {shape} {want}, got {tuple(tensors[k].shape)} {tensors[k].dtype}")
    caches = [k_caches, v_caches]
    req(v_caches.shape == k_caches.shape and k_caches.shape[1] == b, "fused decode step: caches (L, B, Lp, H*D)")
    if cross:
        lx = cross_k.shape[2]
        req(cross_k.shape == (n_layers, b, lx, hd) and cross_v.shape == cross_k.shape,
            "fused cross decode step: cross caches (L, B, Lx, H*D)")
        caches += [cross_k, cross_v]
    req(all(c.dtype == dt for c in caches), "fused decode step: caches must share x's dtype")
    if sbias is not None:
        req(tuple(sbias.shape) == (l_max, n_heads) and sbias.dtype == torch.float32,
            f"fused decode step: sbias must be ({l_max}, {n_heads}) fp32, got {tuple(sbias.shape)} {sbias.dtype}")
        tensors["sbias"] = sbias
    if head is not None:
        req(head["emb"].ndim == 2 and head["emb"].shape[1] == d and head["emb"].dtype == dt,
            "fused decode step: head emb (V, d) in x's dtype")
        req(head["fn_s"].shape == (d,) and head["fn_b"].shape == (d,), "fused decode step: head norm (d,)")
        tensors.update(emb=head["emb"], fn_s=head["fn_s"].float(), fn_b=head["fn_b"].float())
    everything = [x, *caches, *tensors.values()]
    req(all(t.is_cuda and t.device == dev and t.is_contiguous() for t in everything),
        "fused decode step: contiguous tensors on x's CUDA device only")

    x_out = torch.empty_like(x)
    tok = torch.empty((b,), dtype=torch.int64, device=dev) if head is not None else None
    pads = None if pad_lens is None else _row_i32(pad_lens, b, dev)
    lens = _row_i32(cross_lens, b, dev) if cross else None
    args = _Args(
        x=x.data_ptr(), x_out=x_out.data_ptr(), k_cache=k_caches.data_ptr(), v_cache=v_caches.data_ptr(),
        pads=None if pads is None else pads.data_ptr(), tok=None if tok is None else tok.data_ptr(),
        xk=cross_k.data_ptr() if cross else None, xv=cross_v.data_ptr() if cross else None,
        xlens=lens.data_ptr() if cross else None, stream=_build.stream_ptr(x),
        n_layers=n_layers, b=b, d=d, hd=hd, dff=dff, n_heads=n_heads, l_max=l_max, lx=cross_k.shape[2] if cross else 0,
        pos=pos, vocab=head["emb"].shape[0] if head is not None else 0, act=_act_code(act, dt),
        dtype=_build.dtype_code(x), has_cross=int(cross), has_head=int(head is not None),
        norm=_NORM_CODES.index(norm), gated=int(gated),
        eps=eps, scale=1.0 / math.sqrt(HEAD_DIM),
        **{k: t.data_ptr() for k, t in tensors.items()})
    ws = _plan(args)
    if ws <= 0:
        raise RuntimeError(f"pmt_decode_step: CUDA error {-ws} planning the launch (shared memory too small, "
                           "or grid not co-resident)")
    workspace = torch.empty((ws,), dtype=torch.uint8, device=dev)
    args.workspace = workspace.data_ptr()
    _build.check("pmt_decode_step", _build.load_library().pmt_decode_step(ctypes.addressof(args)))
    return x_out, tok


def fused_decode_step(x, packed, k_caches, v_caches, pos: int, pad_lens, n_heads: int, act: str = "gelu",
                      eps: float = 1e-5, head: dict | None = None):
    """One greedy decode step over a self-attention-only layer stack (GPT-2).

    ``x``: (B, d) hidden states (embeddings applied); ``packed``:
    :func:`pack_decode_weights`; ``k_caches``/``v_caches``: (L, B, Lp, H*D)
    stacked caches holding positions ``[0, pos)`` (this step's K/V are
    written at ``pos``); ``pad_lens``: (B,) left-pad lengths or None. With
    ``head`` (:func:`pack_greedy_head`) the final norm and the greedy argmax
    run in the same kernel. Returns ``(x_out (B, d), tok (B,) int64 or
    None)``."""
    if not x.is_cuda:
        return fused_decode_step_plain(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head)
    out = _launch(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head, None, None, None)
    fused_decode_step.launches += 1
    return out


def fused_cross_decode_step(x, packed, k_caches, v_caches, cross_k, cross_v, cross_lens, pos: int, pad_lens,
                            n_heads: int, act: str = "gelu", eps: float = 1e-5, head: dict | None = None,
                            norm: str = "ln", gated: bool = False, sbias=None):
    """:func:`fused_decode_step` with a cross-attention phase: Whisper
    (``norm="ln"``), or T5 (``norm="rms", gated=True`` with ``sbias`` the
    key-major ``(Lp, H)`` fp32 rel-pos bias of this step's query position,
    shared by every row and layer, and the untied head of
    ``pack_greedy_head(..., tied=False)``). ``cross_k``/``cross_v`` (L, B,
    Lx, H*D) precomputed encoder caches, ``cross_lens`` (B,) valid memory
    lengths; ``packed`` from ``pack_decode_weights(..., cross=True[,
    gated=True])``."""
    if not x.is_cuda:
        return fused_decode_step_plain(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head,
                                       cross_k, cross_v, cross_lens, norm, gated, sbias)
    out = _launch(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head, cross_k, cross_v, cross_lens,
                  norm, gated, sbias)
    fused_cross_decode_step.launches += 1
    return out


fused_decode_step.launches = 0
fused_cross_decode_step.launches = 0
