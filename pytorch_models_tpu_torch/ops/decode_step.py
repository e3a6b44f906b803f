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

int8 serving (the JAX kernel's variants, each in the kernel and its plain
version alike):
- int8 weights (``pack_decode_weights`` of a ``quantize_int8()`` model):
  w8a16, ``acc * s_col + bias`` rounded once, the sum over int8 values
  widened exactly to fp32; with ``a8`` (w8a8) each phase's input is
  quantized per row and the sums are int32, exact, then ``(f32(acc) *
  r_scale) * s_col + bias``;
- the a8 greedy head (``pack_greedy_head(..., a8=True)``): a per-vocab-row
  int8 table, the normed hidden state quantized per row, score
  ``f32(dot_i32) * emb_s``;
- int8 self-KV (``kv_scales``) and cross-KV (``kv_scales_x``): attention
  with ops/int8_kv.py's arithmetic; self-attention scores this step's key
  from its quantized K and its value from the unquantized V, then writes
  both quantized, with their row scales, at ``pos``;
- the embed phase (``emb``/``tok_ids``/``pos_rows``): layer 0 takes
  ``round(tok_emb[id] + pos_emb[p])`` (fp32 sum) instead of ``x``.
The JAX kernel's ``eager`` flag only orders its DMA requests on the TPU and
changes no output: the kernel's weight staging is its counterpart.

The kernel reads each layer weight it stages (``wqkv, wo, w1, w2, wqc,
woc``) in a unit-major copy, ``_unit_major``, made on its first launch over
a packed tensor and kept while that tensor lives (one more copy of the
packed weights on the card).

The plain version runs on CUDA tensors only when a caller passes
``plain=True`` (chip_smoke.py and the tests hold the kernel against it
that way); the wrappers never fall back to it.
"""

from __future__ import annotations

import ctypes
import math
import weakref

import torch
import torch.nn.functional as F

from ..utils.params import is_int8
from . import _build
from .decode_attention import NEG_INF, _row_i32
from .greedy_head import greedy_argmax_tied_plain
from .int8_kv import KV_BLOCK_INT8, int8_decode_attention_plain, quantize_rows

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


def _w(lin: dict) -> torch.Tensor:
    """A linear's kernel: the tensor, or an int8 leaf's ``w_q``."""
    return lin["w"]["w_q"] if is_int8(lin) else lin["w"]


def _bias(lin: dict) -> torch.Tensor:
    """A projection's fp32 bias; a missing one (Whisper's k) packs as zeros."""
    w = _w(lin)
    return lin["b"].float() if "b" in lin else torch.zeros(w.shape[-1], device=w.device)


def _scale(lin: dict) -> torch.Tensor:
    """An int8 linear's (out,) fp32 per-output-channel scales."""
    return lin["w"]["w_s"].float().reshape(-1)


# int8 weight -> the name of its packed (L, N) column scales
SCALE_KEYS = {"wqkv": "s_qkv", "wo": "s_o", "w1": "s_1", "w2": "s_2", "wqc": "s_qc", "woc": "s_oc"}


def pack_decode_weights(layers: list, dtype=torch.bfloat16, cross: bool = False, gated: bool = False) -> dict:
    """Per-layer params (``transformer.layer_init`` trees) -> the kernel's
    layer-stacked ``(L, ...)`` tensors, once per generate call: q|k|v
    concatenated to ``wqkv (L, d, 3*H*D)``; weights cast to ``dtype``; biases
    and norm params fp32 (a missing bias, e.g. T5's, packs as zeros). With
    ``cross``, the q/o projections and norm of the cross-attention block too
    (its K/V are the precomputed caches). With ``gated`` the MLP is T5's
    GEGLU tree ``mlp.{w, v, wo}``: ``w1 = [w | v] (L, d, 2*dff)``, ``b1``
    zeros (L, dff), ``w2 = wo``. The pack does not depend on the norm kind.

    Weight-only int8 layers (``quantize_int8()``) pack their int8 kernels as
    they are (``dtype`` is then the compute dtype, not theirs) with ``(L,
    N)`` fp32 column scales ``s_qkv, s_o, s_1, s_2[, s_qc, s_oc]``."""
    int8 = is_int8(layers[0]["sa"]["q"])
    wdt = torch.int8 if int8 else dtype

    def stack(fn, to=None):
        t = torch.stack([fn(lp) for lp in layers])
        return (t if to is None else t.to(to)).contiguous()

    def part(block, name, what):  # a per-layer getter of one linear's kernel, bias or scales
        get = {"w": _w, "b": _bias, "s": _scale}[what]
        return lambda lp: get(lp[block][name])

    def cat(block, names, what):
        return lambda lp: torch.cat([part(block, n, what)(lp) for n in names], dim=-1)

    mlp_in, mlp_out = (("w", "v"), "wo") if gated else (("fc1",), "fc2")
    out = {
        "wqkv": stack(cat("sa", ("q", "k", "v"), "w"), wdt), "bqkv": stack(cat("sa", ("q", "k", "v"), "b")),
        "wo": stack(part("sa", "o", "w"), wdt), "bo": stack(part("sa", "o", "b")),
        "w1": stack(cat("mlp", mlp_in, "w"), wdt), "b1": stack(part("mlp", mlp_in[0], "b")),
        "w2": stack(part("mlp", mlp_out, "w"), wdt), "b2": stack(part("mlp", mlp_out, "b")),
        "ln1_s": stack(lambda lp: _norm_pair(lp["sa_norm"])[0]),
        "ln1_b": stack(lambda lp: _norm_pair(lp["sa_norm"])[1]),
        "ln2_s": stack(lambda lp: _norm_pair(lp["mlp_norm"])[0]),
        "ln2_b": stack(lambda lp: _norm_pair(lp["mlp_norm"])[1]),
    }
    if int8:
        out.update(s_qkv=stack(cat("sa", ("q", "k", "v"), "s")), s_o=stack(part("sa", "o", "s")),
                   s_1=stack(cat("mlp", mlp_in, "s")), s_2=stack(part("mlp", mlp_out, "s")))
    if cross:
        out.update({
            "wqc": stack(part("ca", "q", "w"), wdt), "bqc": stack(part("ca", "q", "b")),
            "woc": stack(part("ca", "o", "w"), wdt), "boc": stack(part("ca", "o", "b")),
            "lnc_s": stack(lambda lp: _norm_pair(lp["ca_norm"])[0]),
            "lnc_b": stack(lambda lp: _norm_pair(lp["ca_norm"])[1]),
        })
        if int8:
            out.update(s_qc=stack(part("ca", "q", "s")), s_oc=stack(part("ca", "o", "s")))
    return out


def pack_greedy_head(w, norm_p: dict, dtype=torch.bfloat16, tied: bool = True, a8: bool = False) -> dict:
    """Head table + final-norm params for the head phase: ``w`` is a tied
    ``(V, d)`` embedding, or with ``tied=False`` an untied ``(d, V)``
    classifier, stored transposed to ``(V, d)`` once per generate call as the
    JAX package stores it (the head phase then reads one layout). The kernel
    masks the ragged vocabulary edge itself, so the table is not padded (a
    tied table already in ``dtype`` is not copied).

    An int8 classifier (``{"w_q", "w_s"}``, T5 after ``quantize_int8()``) is
    dequantized first (``w_q.f32 * w_s.f32``): its per-column scales are not
    the head's per-vocab-row axis. With ``a8`` the table is re-quantized per
    vocab row to int8 with fp32 row scales ``emb_s (V,)`` (the w8a8 head)."""
    fn_s, fn_b = _norm_pair(norm_p)
    if isinstance(w, dict):
        w = w["w_q"].float() * w["w_s"].float()
    emb = w if tied else w.t()
    out = {"fn_s": fn_s.contiguous(), "fn_b": fn_b.contiguous()}
    if a8:
        q, sc = quantize_rows(emb)
        return out | {"emb": q.contiguous(), "emb_s": sc[:, 0].contiguous()}
    return out | {"emb": emb.to(dtype).contiguous()}


def pack_embed_tables(token_embs: torch.Tensor, pos_embs: torch.Tensor | None = None, dtype=torch.bfloat16) -> dict:
    """The embed phase's tables in the serving dtype: ``{"tok"[, "pos"]}``.
    Unpadded: the kernel clamps ids to the table (the JAX package pads rows
    to its 8-row DMA windows)."""
    out = {"tok": token_embs.to(dtype).contiguous()}
    if pos_embs is not None:
        out["pos"] = pos_embs.to(dtype).contiguous()
    return out


def fused_step_eligible(layers: list, cfg, batch: int, cross: bool = False, gated: bool = False,
                        dtype: torch.dtype | None = None) -> bool:
    """What the CUDA kernel serves: pre-norm layers with a GELU MLP (a GEGLU
    ``mlp.{w, v, wo}`` one with ``gated``), head_dim 64, widths that are
    multiples of 64 (16-byte loads over whole column slabs), 1 to 8 rows,
    every projection float or every one weight-only int8, and, for weights
    on a CUDA device, what the kernel's own launch planner accepts there
    (its phase input fits in shared memory, its grid is co-resident).
    ``dtype``: the compute dtype (default: the weights'; int8 weights need
    it). Anything else decodes per-op."""
    if not cfg.pre_norm or cfg.act not in _ACT_CODES or cfg.head_dim != HEAD_DIM:
        return False
    if not 1 <= batch <= MAX_BATCH or not layers:
        return False
    lp = layers[0]
    try:
        mlp_keys = ("w", "v", "wo") if gated else ("fc1", "fc2")
        lins = [lp["sa"][k] for k in ("q", "k", "v", "o")] + [lp["mlp"][k] for k in mlp_keys]
        norms = [lp["sa_norm"], lp["mlp_norm"]] + ([lp["ca_norm"]] if cross else [])
        if cross:
            lins += [lp["ca"][k] for k in ("q", "o")]
        int8 = {is_int8(lin) for lin in lins}
        blocks = [_w(lin) for lin in lins]
    except (KeyError, TypeError, AttributeError):
        return False
    if len(int8) != 1 or not all(norms):
        return False
    int8 = int8.pop()
    if int8:
        if dtype is None or not all(isinstance(w, torch.Tensor) and w.dtype == torch.int8 for w in blocks):
            return False
    elif not all(isinstance(w, torch.Tensor) and w.is_floating_point() for w in blocks):
        return False
    d, hd = blocks[0].shape
    dff = _w(lp["mlp"]["w" if gated else "fc1"]).shape[-1]
    if d % 64 or hd % 64 or dff % 64 or hd != cfg.n_heads * HEAD_DIM:
        return False
    w = blocks[0]
    cdt = dtype if dtype is not None else w.dtype
    if not w.is_cuda:
        return True
    if cdt not in (torch.float32, torch.bfloat16):
        return False
    args = _Args(b=batch, d=d, hd=hd, dff=dff, n_heads=cfg.n_heads, dtype=_build.dtype_code(torch.empty(0, dtype=cdt)),
                 gated=int(gated), wt_int8=int(int8))
    with torch.cuda.device(w.device):
        return _plan(args)[0] > 0


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


def _embed_plain(emb: dict, tok_ids, pos_rows, b: int, device) -> torch.Tensor:
    """The embed phase: ``round(tok[id] + pos[p])`` with the sum in fp32 (a
    table lookup alone without a position table), ids clamped."""
    tok = emb["tok"]
    ids = _row_i32(tok_ids, b, device).long().clamp(0, tok.shape[0] - 1)
    if "pos" not in emb:
        return tok[ids]
    prow = _row_i32(pos_rows, b, device).long().clamp(0, emb["pos"].shape[0] - 1)
    return (tok[ids].float() + emb["pos"][prow].float()).to(tok.dtype)


def fused_decode_step_plain(x, packed, k_caches, v_caches, pos: int, pad_lens, n_heads: int, act: str = "gelu",
                            eps: float = 1e-5, head: dict | None = None, cross_k=None, cross_v=None, cross_lens=None,
                            norm: str = "ln", gated: bool = False, sbias=None, a8: bool = False, emb=None,
                            tok_ids=None, pos_rows=None, kv_scales=None, kv_scales_x=None):
    """The kernel's math in plain PyTorch, layer by layer (see the module
    docstring). Writes this step's K/V into ``k_caches``/``v_caches`` at
    ``pos`` (int8 caches: quantized, with their scales in ``kv_scales``);
    returns ``(x_out (B, d), tok (B,) int64 or None)``. ``sbias``: None or
    the key-major ``(Lp, H)`` fp32 self-attention bias of this step's query
    position, shared by every row and layer. With ``emb`` the input is
    built from the tables (``x`` is None)."""
    n_layers, b, l_max, _ = k_caches.shape
    if emb is not None:
        x = _embed_plain(emb, tok_ids, pos_rows, b, emb["tok"].device)
    dt = x.dtype
    dev = x.device
    wt_int8 = packed["wqkv"].dtype == torch.int8
    pads = torch.zeros(b, dtype=torch.int32, device=dev) if pad_lens is None else _row_i32(pad_lens, b, dev)
    col = torch.arange(l_max, device=dev)[None, :]
    self_valid = (col >= pads.clamp(0, pos).long()[:, None]) & (col <= pos)
    if cross_k is not None:
        lens = _row_i32(cross_lens, b, dev)
        cross_valid = torch.arange(cross_k.shape[2], device=dev)[None, :] < lens.long()[:, None]

    def acc_of(h, key, i):  # the fp32 (dequantized) sums of h @ W
        w = packed[key][i]
        if not wt_int8:
            return torch.matmul(h.float(), w.float())
        if a8:  # int8 levels x int8 weights: exact in float64, one rounding to fp32, then the row scale
            hq, r = quantize_rows(h)
            acc = torch.matmul(hq.double(), w.double()).float() * r
        else:
            acc = torch.matmul(h.float(), w.float())
        return acc * packed[SCALE_KEYS[key]][i]

    def proj(h, key, i, bias):  # (dequantized) fp32 sums + fp32 bias, one rounding
        return (acc_of(h, key, i) + bias.float()).to(dt)

    def ln(s, bias, t):
        return _norm(s, bias, t, eps, norm)

    for i in range(n_layers):
        qkv = proj(ln(packed["ln1_s"][i], packed["ln1_b"][i], x), "wqkv", i, packed["bqkv"][i])
        q, k, v = qkv.chunk(3, dim=-1)
        if kv_scales is not None:  # int8 self-KV: attend with this step's K/V, then write them quantized
            ks, vs = kv_scales["ks"][i], kv_scales["vs"][i]
            ctx = int8_decode_attention_plain(q[:, None], k_caches[i], v_caches[i], ks, vs, pos, n_heads, pads,
                                              k, v, sbias)[:, 0]
            for cache, scales, new in ((k_caches, ks, k), (v_caches, vs, v)):
                q8, sc = quantize_rows(new)
                cache[i, :, pos] = q8
                scales[:, pos] = sc[:, 0]
        else:
            k_caches[i, :, pos] = k.to(k_caches.dtype)
            v_caches[i, :, pos] = v.to(v_caches.dtype)
            ctx = _attend(q, k_caches[i].to(dt), v_caches[i].to(dt), self_valid, n_heads, sbias)
        x = x + proj(ctx, "wo", i, packed["bo"][i])
        if cross_k is not None:
            qc = proj(ln(packed["lnc_s"][i], packed["lnc_b"][i], x), "wqc", i, packed["bqc"][i])
            if kv_scales_x is not None:
                ctx = int8_decode_attention_plain(qc[:, None], cross_k[i], cross_v[i], kv_scales_x["ks"][i],
                                                  kv_scales_x["vs"][i], lens, n_heads)[:, 0]
            else:
                ctx = _attend(qc, cross_k[i].to(dt), cross_v[i].to(dt), cross_valid, n_heads)
            x = x + proj(ctx, "woc", i, packed["boc"][i])
        h2 = ln(packed["ln2_s"][i], packed["ln2_b"][i], x)
        if gated:  # GEGLU: gelu(a + b1) * g over the two halves of fc1, in the compute dtype
            a, g = acc_of(h2, "w1", i).chunk(2, dim=-1)
            h = _act(act, (a + packed["b1"][i].float()).to(dt)) * g.to(dt)
        else:
            h = _act(act, proj(h2, "w1", i, packed["b1"][i]))
        x = x + proj(h, "w2", i, packed["b2"][i])
    tok = None
    if head is not None:
        xn = ln(head["fn_s"], head["fn_b"], x)
        if "emb_s" in head:  # the a8 head: per-row int8 hidden state (its scale unapplied) x the int8 table
            xq, _ = quantize_rows(xn)
            s = torch.matmul(xq.double(), head["emb"].double().t()).float() * head["emb_s"]
            tok = torch.argmax(s, dim=-1)
        else:
            tok = greedy_argmax_tied_plain(xn, head["emb"].to(dt))
    return x, tok


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_PTRS = ("x", "x_out", "wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2", "ln1_s", "ln1_b", "ln2_s", "ln2_b",
         "wqc", "bqc", "woc", "boc", "lnc_s", "lnc_b", "k_cache", "v_cache", "pads", "xk", "xv", "xlens",
         "sbias", "emb", "fn_s", "fn_b", "tok", "workspace", "stream",
         "s_qkv", "s_o", "s_1", "s_2", "s_qc", "s_oc", "ks", "vs", "xks", "xvs", "emb_s",
         "tok_emb", "pos_emb", "tok_ids", "pos_ids")
_INTS = ("n_layers", "b", "d", "hd", "dff", "n_heads", "l_max", "lx", "pos", "vocab", "act", "dtype", "has_cross",
         "has_head", "norm", "gated", "wt_int8", "a8", "kv_int8", "kvx_int8", "head_a8", "embed", "tok_rows",
         "pos_rows")


class _Args(ctypes.Structure):
    """csrc/decode_step.cu ``Args``, field for field. ``stamps`` comes last,
    so every earlier field keeps its offset and a library built from an
    older tree reads this structure's prefix unchanged."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]
                + [("eps", ctypes.c_float), ("scale", ctypes.c_float), ("stamps", ctypes.c_void_p)])


def _plan(args: _Args) -> tuple[int, int]:
    """The kernel's launch planner (csrc/decode_step.cu ``plan``) on the
    current device: ``(workspace bytes or a negated CUDA error, grid)``. It
    reads only the shape fields, ``dtype``, ``wt_int8``, ``gated`` and
    ``head_a8`` of ``args``."""
    grid = ctypes.c_int(0)
    ws = _build.load_library().pmt_decode_step_workspace(ctypes.addressof(args), ctypes.addressof(grid))
    return ws, grid.value


MATRIX_SHAPES = ("qkv", "o", "qc", "fc1", "fc2")  # the kernel's staged matrix shapes (o_c shares o's)


def step_plan(args: _Args) -> dict:
    """The kernel's launch plan on the current device, as its planner makes
    it (``pmt_decode_step_plan``): ``grid``, ``pass_cols`` (columns per
    matvec pass), ``ring_bytes`` (the shared-memory ring), and per matrix
    shape of MATRIX_SHAPES ``(kc, slots, steps)``: K rows per ring slot, the
    ring's slots, and the most copy steps a block's share takes (passes x
    chunks; more steps than slots: the share streams through the ring,
    refilled while the matvec reads it). Raises on a shape the planner
    refuses."""
    out = (ctypes.c_int * (3 + 3 * len(MATRIX_SHAPES)))()
    _build.check("pmt_decode_step_plan", _build.load_library().pmt_decode_step_plan(ctypes.addressof(args), out))
    v = list(out)
    return {"grid": v[0], "pass_cols": v[1], "ring_bytes": v[2],
            **{m: tuple(v[3 + 3 * i: 6 + 3 * i]) for i, m in enumerate(MATRIX_SHAPES)}}


def step_phase_kinds(n_layers: int, cross: bool, head: bool) -> list[str]:
    """The kernel's phases in order, one name each (a grid barrier ends every
    phase but the last): per layer ``qkv, attn, o[, qc, xattn, oc], fc1,
    fc2``, then ``head`` (final norm + each block's vocab chunk) and
    ``argmax`` (block 0 reduces the blocks' bests)."""
    layer = ["qkv", "attn", "o"] + (["qc", "xattn", "oc"] if cross else []) + ["fc1", "fc2"]
    return layer * n_layers + (["head", "argmax"] if head else [])


def phase_breakdown(stamps: torch.Tensor, kinds: list[str]) -> dict:
    """Per phase kind, µs: the median over that kind's phases of the largest
    value over the grid's blocks of each part: ``wait`` (from this block's
    arrival at the barrier before the phase to its start: barrier latency
    and skew; the first phase has none), ``load`` (the phase input: norm,
    merge, gate), ``compute`` (matvec or attention), ``epilogue`` (bias,
    residual, writes); and ``barrier``, the least wait over the blocks
    (what the last block to arrive waits: the barrier's own latency), and
    ``busy``, the largest time over the blocks from the phase's start to
    arriving at its end barrier (so ``barrier + busy`` per phase sums to
    about the step). ``stamps``: one launch's (phases, grid, 4)
    %globaltimer ns, or several launches stacked on a leading axis (the
    median then runs over every launch's phases). Adds ``step``: µs from the
    first block's start to the last block's end, median over launches."""
    t = stamps.double().reshape(-1, *stamps.shape[-3:])
    parts = {"wait": torch.full_like(t[..., 0], float("nan")), "load": t[..., 1] - t[..., 0],
             "compute": t[..., 2] - t[..., 1], "epilogue": t[..., 3] - t[..., 2]}
    parts["wait"][:, 1:] = t[:, 1:, :, 0] - t[:, :-1, :, 3]
    worst = {k: v.amax(-1) / 1e3 for k, v in parts.items()}  # (launches, phases)
    worst["barrier"] = parts["wait"].amin(-1) / 1e3
    worst["busy"] = (t[..., 3] - t[..., 0]).amax(-1) / 1e3
    out = {}
    for kind in dict.fromkeys(kinds):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        out[kind] = {k: torch.nanquantile(v[:, idx].reshape(-1), 0.5).item() for k, v in worst.items()}
        out[kind]["n"] = len(idx)
    out["step"] = ((t[:, -1, :, 3].amax(-1) - t[:, 0, :, 0].amin(-1)) / 1e3).median().item()
    return out


# weights the kernel stages, read in its unit-major layout (_unit_major)
_STAGED = ("wqkv", "wo", "w1", "w2", "wqc", "woc")
_UNIT_MAJOR: dict[int, tuple] = {}  # id(packed weight) -> (weak reference, version, unit-major copy)


def _unit_major(w: torch.Tensor) -> torch.Tensor:
    """A packed ``(L, K, N)`` weight in the kernel's layout ``(L, N / cu, K,
    cu)``: ``cu`` columns per unit, one lane's vector (4 fp32, 8 bf16, 8
    int8), each unit's K rows contiguous, so a block's run of column units is
    one contiguous copy. Made once per packed tensor (and per in-place
    version of it; an inference tensor counts no versions, and the port
    never changes one in place) and kept while the tensor lives. A slice of
    whole layers of a packed tensor is the same slice of the packed
    tensor's copy."""
    base = w._base
    if base is not None and base.dim() == 3 and base.shape[1:] == w.shape[1:] and base.is_contiguous():
        layer, rest = divmod(w.storage_offset() - base.storage_offset(), w.shape[1] * w.shape[2])
        if rest == 0:
            return _unit_major(base)[layer:layer + w.shape[0]]
    key, version = id(w), None if w.is_inference() else w._version
    hit = _UNIT_MAJOR.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version:
        return hit[2]
    n_layers, k, n = w.shape
    cu = 8 if w.dtype == torch.int8 else 16 // w.element_size()
    out = w.view(n_layers, k, n // cu, cu).transpose(1, 2).contiguous()
    _UNIT_MAJOR[key] = (weakref.ref(w, lambda _, key=key: _UNIT_MAJOR.pop(key, None)), version, out)
    return out


def _launch(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head, cross_k, cross_v, cross_lens,
            norm="ln", gated=False, sbias=None, a8=False, emb=None, tok_ids=None, pos_rows=None, kv_scales=None,
            kv_scales_x=None, stamps=None):
    req = _build.require
    cross = cross_k is not None
    n_layers, b, l_max, hd = k_caches.shape
    if emb is not None:
        req(x is None and tok_ids is not None, "fused decode step: emb takes tok_ids in place of x")
        dt, dev, d = emb["tok"].dtype, emb["tok"].device, emb["tok"].shape[1]
    else:
        req(x.ndim == 2 and x.shape[0] == b, "fused decode step: x (B, d)")
        dt, dev, d = x.dtype, x.device, x.shape[1]
    req(dt in (torch.float32, torch.bfloat16), "fused decode step: compute dtype fp32 or bf16")
    dff = packed["w2"].shape[-2]
    wt_int8 = packed["wqkv"].dtype == torch.int8
    req(not a8 or wt_int8, "fused decode step: a8 needs int8-packed weights")
    req(1 <= b <= MAX_BATCH, f"fused decode step: batch {b} not in [1, {MAX_BATCH}]")
    req(hd == n_heads * HEAD_DIM and d % 64 == 0 and hd % 64 == 0 and dff % 64 == 0,
        f"fused decode step: d {d}, H*D {hd}, dff {dff}, {n_heads} heads unsupported")
    req(act in _ACT_CODES, f"fused decode step: activation {act!r} unsupported")
    req(norm in _NORM_CODES, f"fused decode step: norm {norm!r} unsupported")
    req(0 <= pos < l_max, f"fused decode step: pos {pos} outside the cache of {l_max}")
    n1 = 2 * dff if gated else dff
    shapes = {"wqkv": (n_layers, d, 3 * hd), "bqkv": (n_layers, 3 * hd), "wo": (n_layers, hd, d), "bo": (n_layers, d),
              "w1": (n_layers, d, n1), "b1": (n_layers, dff), "w2": (n_layers, dff, d), "b2": (n_layers, d),
              "ln1_s": (n_layers, d), "ln1_b": (n_layers, d), "ln2_s": (n_layers, d), "ln2_b": (n_layers, d)}
    if cross:
        shapes.update({"wqc": (n_layers, d, hd), "bqc": (n_layers, hd), "woc": (n_layers, hd, d),
                       "boc": (n_layers, d), "lnc_s": (n_layers, d), "lnc_b": (n_layers, d)})
    if wt_int8:
        shapes.update({SCALE_KEYS[k]: (n_layers, shapes[k][2]) for k in list(shapes) if k in SCALE_KEYS})
    tensors = {k: packed[k] for k in shapes}
    wdt = torch.int8 if wt_int8 else dt
    for k, shape in shapes.items():
        want = wdt if k in SCALE_KEYS else torch.float32
        req(tuple(tensors[k].shape) == shape and tensors[k].dtype == want,
            f"fused decode step: packed {k} must be {shape} {want}, got {tuple(tensors[k].shape)} {tensors[k].dtype}")
    req(v_caches.shape == k_caches.shape, "fused decode step: caches (L, B, Lp, H*D)")
    kv_dt = torch.int8 if kv_scales is not None else dt
    req(k_caches.dtype == kv_dt and v_caches.dtype == kv_dt,
        f"fused decode step: self caches must be {kv_dt} (int8 with kv_scales, else x's dtype)")
    caches = [k_caches, v_caches]
    if kv_scales is not None:
        req(l_max % KV_BLOCK_INT8 == 0, f"fused decode step: int8 caches need Lp a multiple of {KV_BLOCK_INT8}")
        for key in ("ks", "vs"):
            req(kv_scales[key].shape == (n_layers, b, l_max) and kv_scales[key].dtype == torch.float32,
                "fused decode step: kv_scales (L, B, Lp) fp32")
        tensors.update(ks=kv_scales["ks"], vs=kv_scales["vs"])
    if cross:
        lx = cross_k.shape[2]
        req(cross_k.shape == (n_layers, b, lx, hd) and cross_v.shape == cross_k.shape,
            "fused cross decode step: cross caches (L, B, Lx, H*D)")
        xdt = torch.int8 if kv_scales_x is not None else dt
        req(cross_k.dtype == xdt and cross_v.dtype == xdt,
            f"fused cross decode step: cross caches must be {xdt} (int8 with kv_scales_x, else x's dtype)")
        caches += [cross_k, cross_v]
        if kv_scales_x is not None:
            for key in ("ks", "vs"):
                req(kv_scales_x[key].shape == (n_layers, b, lx) and kv_scales_x[key].dtype == torch.float32,
                    "fused cross decode step: kv_scales_x (L, B, Lx) fp32")
            tensors.update(xks=kv_scales_x["ks"], xvs=kv_scales_x["vs"])
    else:
        req(kv_scales_x is None, "fused decode step: kv_scales_x without cross caches")
    if sbias is not None:
        req(tuple(sbias.shape) == (l_max, n_heads) and sbias.dtype == torch.float32,
            f"fused decode step: sbias must be ({l_max}, {n_heads}) fp32, got {tuple(sbias.shape)} {sbias.dtype}")
        tensors["sbias"] = sbias
    head_a8 = head is not None and "emb_s" in head
    if head is not None:
        hdt = torch.int8 if head_a8 else dt
        req(head["emb"].ndim == 2 and head["emb"].shape[1] == d and head["emb"].dtype == hdt,
            f"fused decode step: head emb (V, d) {hdt}")
        req(head["fn_s"].shape == (d,) and head["fn_b"].shape == (d,), "fused decode step: head norm (d,)")
        tensors.update(emb=head["emb"], fn_s=head["fn_s"].float(), fn_b=head["fn_b"].float())
        if head_a8:
            req(head["emb_s"].shape == (head["emb"].shape[0],) and head["emb_s"].dtype == torch.float32,
                "fused decode step: head emb_s (V,) fp32")
            tensors["emb_s"] = head["emb_s"]
    ids = {}
    if emb is not None:
        req(emb["tok"].ndim == 2 and ("pos" not in emb or (emb["pos"].shape[1] == d and emb["pos"].dtype == dt)),
            "fused decode step: emb tables (rows, d) in one dtype")
        tensors["tok_emb"] = emb["tok"]
        ids["tok_ids"] = _row_i32(tok_ids, b, dev)
        if "pos" in emb:
            req(pos_rows is not None, "fused decode step: a position table takes pos_rows")
            tensors["pos_emb"] = emb["pos"]
            ids["pos_ids"] = _row_i32(pos_rows, b, dev)
    everything = ([] if x is None else [x]) + [*caches, *tensors.values()]
    req(all(t.is_cuda and t.device == dev and t.is_contiguous() for t in everything),
        "fused decode step: contiguous tensors on one CUDA device only")
    tensors.update({k: _unit_major(tensors[k]) for k in _STAGED if k in tensors})

    x_out = torch.empty((b, d), dtype=dt, device=dev)
    tok = torch.empty((b,), dtype=torch.int64, device=dev) if head is not None else None
    pads = None if pad_lens is None else _row_i32(pad_lens, b, dev)
    lens = _row_i32(cross_lens, b, dev) if cross else None
    args = _Args(
        x=None if x is None else x.data_ptr(), x_out=x_out.data_ptr(), k_cache=k_caches.data_ptr(),
        v_cache=v_caches.data_ptr(), pads=None if pads is None else pads.data_ptr(),
        tok=None if tok is None else tok.data_ptr(),
        xk=cross_k.data_ptr() if cross else None, xv=cross_v.data_ptr() if cross else None,
        xlens=lens.data_ptr() if cross else None, stream=_build.stream_ptr(k_caches),
        n_layers=n_layers, b=b, d=d, hd=hd, dff=dff, n_heads=n_heads, l_max=l_max, lx=cross_k.shape[2] if cross else 0,
        pos=pos, vocab=head["emb"].shape[0] if head is not None else 0, act=_act_code(act, dt),
        dtype=_build.dtype_code(x_out), has_cross=int(cross), has_head=int(head is not None),
        norm=_NORM_CODES.index(norm), gated=int(gated), wt_int8=int(wt_int8), a8=int(a8),
        kv_int8=int(kv_scales is not None), kvx_int8=int(kv_scales_x is not None), head_a8=int(head_a8),
        embed=int(emb is not None), tok_rows=emb["tok"].shape[0] if emb is not None else 0,
        pos_rows=emb["pos"].shape[0] if emb is not None and "pos" in emb else 0,
        eps=eps, scale=1.0 / math.sqrt(HEAD_DIM),
        **{k: t.data_ptr() for k, t in (tensors | ids).items()})
    ws, grid = _plan(args)
    if ws <= 0:
        raise RuntimeError(f"pmt_decode_step: CUDA error {-ws} planning the launch (shared memory too small, "
                           "or grid not co-resident)")
    workspace = torch.empty((ws,), dtype=torch.uint8, device=dev)
    args.workspace = workspace.data_ptr()
    if stamps is not None:
        st = torch.zeros((len(step_phase_kinds(n_layers, cross, head is not None)), grid, 4), dtype=torch.int64,
                         device=dev)
        args.stamps = st.data_ptr()
        stamps.append(st)
    _build.check("pmt_decode_step", _build.load_library().pmt_decode_step(ctypes.addressof(args)))
    return x_out, tok


def _count(fn, a8: bool, kv_int8: bool, emb, head) -> None:
    """One launch of ``fn``, and of each variant it ran: the int8 serving
    features (the launches of the ``..._int8``, ``..._a8`` and ``..._embed``
    kernels in chip_smoke.py's record) and the headless step (no head: the
    sampled and beam decode loops)."""
    fn.launches += 1
    for key, on in (("kv_int8", kv_int8), ("a8", a8), ("embed", emb is not None), ("headless", head is None)):
        fn.variant_launches[key] += int(on)


def fused_decode_step(x, packed, k_caches, v_caches, pos: int, pad_lens, n_heads: int, act: str = "gelu",
                      eps: float = 1e-5, head: dict | None = None, a8: bool = False, emb=None, tok_ids=None,
                      pos_rows=None, kv_scales=None, plain: bool = False, stamps: list | None = None):
    """One greedy decode step over a self-attention-only layer stack (GPT-2).

    ``x``: (B, d) hidden states (embeddings applied), or None with ``emb``
    (:func:`pack_embed_tables`), ``tok_ids`` (B,) and ``pos_rows`` (B,): the
    embed phase; ``packed``: :func:`pack_decode_weights`; ``k_caches``/
    ``v_caches``: (L, B, Lp, H*D) stacked caches holding positions ``[0,
    pos)`` (this step's K/V are written at ``pos``), int8 with ``kv_scales``
    ``{"ks", "vs"}: (L, B, Lp)`` fp32; ``pad_lens``: (B,) left-pad lengths
    or None. With ``head`` (:func:`pack_greedy_head`) the final norm and the
    greedy argmax run in the same kernel. ``a8``: w8a8 over int8-packed
    weights. ``plain=True`` runs the plain version on any device (for
    comparisons only). ``stamps``: a list to which the launch appends its
    ``(phases, grid, 4)`` int64 tensor of each block's %globaltimer ns at
    four points of every phase (:func:`step_phase_kinds`,
    :func:`phase_breakdown`); for measurement only. Returns ``(x_out (B, d), tok (B,) int64 or None)``.
    ``launches`` counts the kernel's launches; ``variant_launches`` those of
    each int8 serving variant and those without a head (``headless``)."""
    ref = x if x is not None else emb["tok"]
    if plain or not ref.is_cuda:
        return fused_decode_step_plain(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head,
                                       a8=a8, emb=emb, tok_ids=tok_ids, pos_rows=pos_rows, kv_scales=kv_scales)
    out = _launch(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head, None, None, None, a8=a8,
                  emb=emb, tok_ids=tok_ids, pos_rows=pos_rows, kv_scales=kv_scales, stamps=stamps)
    _count(fused_decode_step, a8, kv_scales is not None, emb, head)
    return out


def fused_cross_decode_step(x, packed, k_caches, v_caches, cross_k, cross_v, cross_lens, pos: int, pad_lens,
                            n_heads: int, act: str = "gelu", eps: float = 1e-5, head: dict | None = None,
                            norm: str = "ln", gated: bool = False, sbias=None, a8: bool = False, emb=None,
                            tok_ids=None, pos_rows=None, kv_scales=None, kv_scales_x=None, plain: bool = False,
                            stamps: list | None = None):
    """:func:`fused_decode_step` with a cross-attention phase: Whisper
    (``norm="ln"``), or T5 (``norm="rms", gated=True`` with ``sbias`` the
    key-major ``(Lp, H)`` fp32 rel-pos bias of this step's query position,
    shared by every row and layer, and the untied head of
    ``pack_greedy_head(..., tied=False)``). ``cross_k``/``cross_v`` (L, B,
    Lx, H*D) precomputed encoder caches, int8 with ``kv_scales_x`` ``{"ks",
    "vs"}: (L, B, Lx)`` fp32; ``cross_lens`` (B,) valid memory lengths;
    ``packed`` from ``pack_decode_weights(..., cross=True[, gated=True])``;
    the int8 serving arguments, ``plain`` and ``stamps`` as in
    :func:`fused_decode_step`."""
    ref = x if x is not None else emb["tok"]
    if plain or not ref.is_cuda:
        return fused_decode_step_plain(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head,
                                       cross_k, cross_v, cross_lens, norm, gated, sbias, a8, emb, tok_ids, pos_rows,
                                       kv_scales, kv_scales_x)
    out = _launch(x, packed, k_caches, v_caches, pos, pad_lens, n_heads, act, eps, head, cross_k, cross_v, cross_lens,
                  norm, gated, sbias, a8, emb, tok_ids, pos_rows, kv_scales, kv_scales_x, stamps)
    _count(fused_cross_decode_step, a8, kv_scales is not None or kv_scales_x is not None, emb, head)
    return out


for _fn in (fused_decode_step, fused_cross_decode_step):
    _fn.launches = 0
    _fn.variant_launches = {"kv_int8": 0, "a8": 0, "embed": 0, "headless": 0}
