"""PyTorch port ops vs the JAX package, on the CPU.

Every kernel module of the port keeps a plain PyTorch version beside its CUDA
kernel; on CPU tensors the wrapper runs that version. Here it is held against
the JAX kernel function, run in Pallas interpret mode as the JAX package's
own tests run it (``tests/ops/test_*.py``). Inputs come from
``numpy.random.default_rng(seed)`` and go to both packages.

The kernels themselves need an NVIDIA GPU: tests/test_torch_cuda.py holds
each kernel against its plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytorch_models_tpu.ops import layers as jax_layers
from pytorch_models_tpu.ops.attention import _sdpa_xla
from pytorch_models_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from pytorch_models_tpu.ops.encoder_attention import encoder_attention as jax_encoder_attention
from pytorch_models_tpu.ops.gather import gather_rows as jax_gather_rows
from pytorch_models_tpu.ops.greedy_head import greedy_argmax as jax_greedy_argmax
from pytorch_models_tpu.ops.greedy_head import greedy_argmax_tied as jax_greedy_argmax_tied
from pytorch_models_tpu_torch import transformer as tfm
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import layers
from pytorch_models_tpu_torch.ops import decode_attention as k2
from pytorch_models_tpu_torch.ops import encoder_attention as k1
from pytorch_models_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_fits,
    decode_attention_plain,
)
from pytorch_models_tpu_torch.ops.encoder_attention import (
    encoder_attention,
    encoder_attention_eligible,
    encoder_attention_plain,
)
from pytorch_models_tpu_torch.ops.gather import embed_rows, gather_rows, gather_rows_plain
from pytorch_models_tpu_torch.ops.greedy_head import (
    greedy_argmax,
    greedy_argmax_plain,
    greedy_argmax_tied,
    greedy_argmax_tied_plain,
)

torch.set_num_threads(1)

# fp32 attention on both sides: full-precision dots and an fp32 softmax, so
# the outputs differ only by summation order (~1e-6 relative at these sizes);
# 2e-5 is the JAX package's own kernel-vs-einsum tolerance.
ATTN_TOL = 2e-5


def _randn(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K1 encoder attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,l,h,causal", [
    (2, 197, 2, False),  # ViT length: one K block in the JAX kernel (_kernel_single)
    (2, 600, 2, True),   # two K blocks: the online-softmax path (nk > 1)
])
def test_encoder_attention_matches_jax(b, l, h, causal):
    r = np.random.default_rng(11)
    q, k, v = (_randn(r, b, l, h * 64) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_encoder_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, causal))
    got = encoder_attention(_t(q), _t(k), _t(v), h, causal)
    np.testing.assert_allclose(got.numpy(), expected, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_array_equal(got.numpy(), encoder_attention_plain(_t(q), _t(k), _t(v), h, causal).numpy())


def test_encoder_attention_cross_matches_jax():
    """Lq != Lk: teacher-forced cross-attention over encoder memory."""
    r = np.random.default_rng(13)
    q, k, v = _randn(r, 2, 20, 128), _randn(r, 2, 300, 128), _randn(r, 2, 300, 128)
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_encoder_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, False))
    got = encoder_attention(_t(q), _t(k), _t(v), 2)
    np.testing.assert_allclose(got.numpy(), expected, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_encoder_attention_unbatched():
    r = np.random.default_rng(12)
    q, k, v = (_randn(r, 50, 128) for _ in range(3))
    got = encoder_attention(_t(q), _t(k), _t(v), 2, True)
    full = encoder_attention(_t(q)[None], _t(k)[None], _t(v)[None], 2, True)[0]
    assert got.shape == (50, 128)
    np.testing.assert_array_equal(got.numpy(), full.numpy())


def _bf16(r, *shape):
    """bf16 values as fp32 numpy (exact in both packages) and as a torch bf16 tensor."""
    t = torch.from_numpy(_randn(r, *shape)).to(torch.bfloat16)
    return t.float().numpy(), t


def _p_rounding_bound(q, k, v, n_heads, causal, o_ref):
    """Per-element bound between two bf16 flash attentions that round each p
    once to bf16 against different running maxima: 2^-8 * (P @ |V|) / l from
    the fp32 scores (P = exp(s - max), l = sum P), plus one output rounding
    on each side (2^-7 * |o|), plus 1e-6."""
    b, lq, hd = q.shape
    lk, d = k.shape[1], hd // n_heads
    qh, kh, vh = (t.float().reshape(b, -1, n_heads, d).transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / np.sqrt(d))
    if causal:
        s = s.masked_fill(torch.ones(lq, lk, dtype=torch.bool).tril().logical_not(), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    spread = torch.matmul(p, vh.abs()) / p.sum(-1, keepdim=True)
    return (2.0 ** -8 * spread.transpose(1, 2).reshape(b, lq, hd) + 2.0 ** -7 * o_ref.abs() + 1e-6).numpy()


@pytest.mark.parametrize("b,l,h,d,causal", [
    (2, 197, 2, 64, False),  # one JAX block (_kernel_single)
    (2, 600, 2, 64, True),   # two JAX blocks of 512 (_kernel)
    (2, 600, 4, 32, False),  # DETR's head width
    (1, 600, 8, 80, True),   # ViT-H's head width
])
def test_encoder_attention_bf16_matches_jax(b, l, h, d, causal):
    """bf16: both round p to bf16 before P @ V, against different running
    maxima (JAX's blocks of 512 keys, the twin's K_TILE), and round the
    output once; held per element to that rounding's bound."""
    r = np.random.default_rng(14)
    (qn, q), (kn, k), (vn, v) = (_bf16(r, b, l, h * d) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        expected = jax_encoder_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (qn, kn, vn)), h, causal)
    expected = torch.from_numpy(np.array(expected.astype(jnp.float32)))
    got = encoder_attention(q, k, v, h, causal)
    assert got.dtype == torch.bfloat16
    bound = _p_rounding_bound(q, k, v, h, causal, expected)
    diff = (got.float() - expected).abs().numpy()
    assert (diff <= bound).all(), f"max excess {(diff - bound).max()}"
    assert torch.equal(got, encoder_attention_plain(q, k, v, h, causal))


def test_encoder_attention_fp32_head_width_80_matches_jax():
    r = np.random.default_rng(15)
    q, k, v = (_randn(r, 2, 197, 8 * 80) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_encoder_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 8, True))
    got = encoder_attention(_t(q), _t(k), _t(v), 8, True)
    np.testing.assert_allclose(got.numpy(), expected, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("rule,d", [("encoder", d) for d in k1.SUPPORTED_HEAD_DIMS]
                         + [("decode", d) for d in k2.SUPPORTED_HEAD_DIMS])
def test_attention_shape_rules_accept_each_supported_width(rule, d):
    x = torch.zeros(2, 5, 4 * d)
    if rule == "encoder":
        assert encoder_attention_eligible(x, 4) and encoder_attention_eligible(x[0], 4)
    else:
        assert decode_attention_fits(x, 4)


def test_attention_shape_rules_refuse_what_the_kernels_do_not_serve():
    q48, q = torch.zeros(2, 5, 4 * 48), torch.zeros(2, 5, 256)
    assert not encoder_attention_eligible(q48, 4) and not decode_attention_fits(q48, 4)  # D = 48
    assert not encoder_attention_eligible(q, 3) and not decode_attention_fits(q, 3)  # 256 % 3 != 0
    assert not encoder_attention_eligible(q, 4, torch.zeros(2, 4, 5, 5))  # K1 takes no bias
    assert not encoder_attention_eligible(q[None], 4)  # (B, L, H*D) at most
    assert not decode_attention_fits(torch.zeros(2, 5, 4 * 32), 4)  # K2 serves D = 64 only


def test_auto_gates_route_by_the_kernels_shape_rules(monkeypatch):
    """Auto takes a kernel only for a shape it serves; forced True takes the
    wrapper whatever the shape (on a CUDA tensor it raises for D = 48)."""
    x64, x48 = torch.zeros(1, 3, 128), torch.zeros(1, 3, 96)
    assert not attn.use_encoder_kernel(x64, 2) and not attn.use_decode_kernel(x64, 2)  # a CPU tensor
    monkeypatch.setattr(attn, "_on_cuda", lambda t: True)
    assert attn.use_encoder_kernel(x64, 2) and attn.use_decode_kernel(x64, 2)
    assert not attn.use_encoder_kernel(x48, 2) and not attn.use_decode_kernel(x48, 2)
    monkeypatch.setattr(attn, "USE_ENCODER_KERNEL", True)
    monkeypatch.setattr(attn, "USE_DECODE_KERNEL", True)
    assert attn.use_encoder_kernel(x48, 2) and attn.use_decode_kernel(x48, 2)


# ---------------------------------------------------------------------------
# K2 decode attention
# ---------------------------------------------------------------------------


def test_decode_attention_matches_jax_per_row_ranges():
    r = np.random.default_rng(21)
    b, h, l_max, d = 4, 2, 256, 64
    q = _randn(r, b, 1, h * d)
    k, v = _randn(r, b, l_max, h * d), _randn(r, b, l_max, h * d)
    ends = np.asarray([256, 100, 5, 130], np.int32)
    pads = np.asarray([0, 7, 5, 129], np.int32)  # row 2: empty range -> zeros
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                   jnp.asarray(ends), h, pad_lens=jnp.asarray(pads)))
    got = decode_attention(_t(q), _t(k), _t(v), _t(ends), h, _t(pads))
    np.testing.assert_allclose(got.numpy(), expected, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert not got[2].any()


def test_decode_attention_matches_jax_at_batch_32():
    """B = 32, the per-op route's batch above the fused step's 8 rows: a
    1024-slot cache, mixed pads and ends (ranges inside key tiles, a full
    row, an empty row, single keys)."""
    r = np.random.default_rng(24)
    b, h, l_max, d = 32, 2, 1024, 64
    q = _randn(r, b, 1, h * d)
    k, v = _randn(r, b, l_max, h * d), _randn(r, b, l_max, h * d)
    ends = r.integers(1, l_max + 1, b).astype(np.int32)
    pads = (r.random(b) * ends).astype(np.int32)
    ends[:4], pads[:4] = [1024, 300, 1, 513], [0, 300, 0, 511]  # full, empty, one key, two keys
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                   jnp.asarray(ends), h, pad_lens=jnp.asarray(pads)))
    got = decode_attention(_t(q), _t(k), _t(v), _t(ends), h, _t(pads))
    np.testing.assert_allclose(got.numpy(), expected, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert not got[1].any() and got[0].abs().max() > 0


def test_decode_attention_shared_end_matches_jax():
    r = np.random.default_rng(22)
    b, h, l_max, d = 2, 2, 128, 64
    q = _randn(r, b, 1, h * d)
    k, v = _randn(r, b, l_max, h * d), _randn(r, b, l_max, h * d)
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 78, h))
    got = decode_attention(_t(q), _t(k), _t(v), 78, h)
    np.testing.assert_allclose(got.numpy(), expected, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_bias_matches_jax(per_row):
    """K2-bias: a key-major additive bias, (1, L, H) shared (T5's rel-pos
    decode bias) or (B, L, H) per row with left pads, at a scale (3.0) where
    it changes the output far beyond the tolerance."""
    r = np.random.default_rng(23)
    b, h, l_max, d = 4, 2, 256, 64
    q = _randn(r, b, 1, h * d)
    k, v = _randn(r, b, l_max, h * d), _randn(r, b, l_max, h * d)
    bias = 3.0 * _randn(r, b if per_row else 1, l_max, h)
    ends = np.asarray([256, 100, 37, 130], np.int32) if per_row else np.int32(77)
    pads = np.asarray([0, 7, 36, 129], np.int32) if per_row else None
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ends), h,
                                                   pad_lens=None if pads is None else jnp.asarray(pads),
                                                   bias=jnp.asarray(bias)))
    args = (_t(q), _t(k), _t(v), _t(ends) if per_row else 77, h, None if pads is None else _t(pads))
    got = decode_attention(*args, bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), expected, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_array_equal(got.numpy(), decode_attention_plain(*args, bias=_t(bias)).numpy())
    assert np.abs(decode_attention(*args).numpy() - expected).max() > 1000 * ATTN_TOL  # the bias matters


def test_encoder_gate_refuses_a_bias(monkeypatch):
    """K1 takes no bias: with one, the uncached path runs plain SDPA even
    with the kernel flag forced on (a CUDA launch would drop the bias)."""
    r = np.random.default_rng(24)
    cfg = tfm.LayerConfig.make(128, n_heads=2)
    p = tfm.mha_init(torch.Generator().manual_seed(0), cfg)
    x = _t(_randn(r, 2, 9, 128))
    bias = _t(3.0 * _randn(r, 2, 9, 9))
    monkeypatch.setattr(attn, "USE_ENCODER_KERNEL", True)
    assert attn.use_encoder_kernel(x, 2, None) and not attn.use_encoder_kernel(x, 2, bias)
    got = tfm.mha_apply(p, cfg, x, attn_bias=bias)
    monkeypatch.setattr(attn, "USE_ENCODER_KERNEL", False)
    torch.testing.assert_close(got, tfm.mha_apply(p, cfg, x, attn_bias=bias), rtol=0, atol=0)
    assert (got - tfm.mha_apply(p, cfg, x)).abs().max() > 0.1


# ---------------------------------------------------------------------------
# K3 gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_matches_jax_with_out_of_range_ids(dtype):
    r = np.random.default_rng(31)
    table = _randn(r, 300, 128)
    idx = np.asarray([0, 299, 7, -3, 350, 42, 7], np.int32)  # -3 and 350 clamp like jnp.take
    jt = jnp.asarray(table, jnp.dtype(dtype))
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_gather_rows(jt, jnp.asarray(idx)).astype(jnp.float32))
    tt = _t(table).to(getattr(torch, dtype))
    got = gather_rows(tt, _t(idx))
    np.testing.assert_array_equal(got.float().numpy(), expected)  # a copy: exact
    np.testing.assert_array_equal(embed_rows(tt, _t(idx).reshape(7, 1)).float().numpy()[:, 0], expected)


# ---------------------------------------------------------------------------
# K4 greedy head
# ---------------------------------------------------------------------------


def test_greedy_argmax_matches_jax_ragged_vocab_and_tie():
    r = np.random.default_rng(41)
    b, d, v = 4, 128, 9001  # the JAX kernel takes 6144-row chunks in fp32: 2 chunks, ragged edge
    x = _randn(r, b, d)
    emb = _randn(r, v, d)
    emb[10] = emb[9000] = 3.0 * x[0]  # forced exact tie for row 0 across chunks: lowest index wins
    emb[8999] = 3.0 * x[1]  # row 1's winner sits in the ragged last chunk
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_greedy_argmax_tied(jnp.asarray(x), jnp.asarray(emb)))
    got = greedy_argmax_tied(_t(x), _t(emb))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), expected)
    assert got[0] == 10 and got[1] == 8999


def test_greedy_argmax_untied_matches_jax_ragged_vocab_and_tie():
    """K4-untied: a (d, V) classifier (T5), ragged vocabulary, a forced tie."""
    r = np.random.default_rng(42)
    b, d, v = 4, 128, 9001  # the JAX kernel takes 6144-column chunks in fp32: 2 chunks, ragged edge
    x = _randn(r, b, d)
    w = _randn(r, d, v)
    w[:, 10] = w[:, 9000] = 3.0 * x[0]  # forced exact tie for row 0 across chunks: lowest index wins
    w[:, 8999] = 3.0 * x[1]  # row 1's winner sits in the ragged last chunk
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_greedy_argmax(jnp.asarray(x), jnp.asarray(w)))
    got = greedy_argmax(_t(x), _t(w))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), expected)
    assert got[0] == 10 and got[1] == 8999
    np.testing.assert_array_equal(greedy_argmax_plain(_t(x), _t(w)).numpy(), expected)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("b", [16, 32])
def test_greedy_argmax_plain_matches_jax_above_the_fused_rows(tied, b):
    """K4's plain versions at the per-op batches above the fused step's 8
    rows: forced ties across the kernel's 16-row tile edge (15/16), its
    128-row span (127/128) and on the last row of a ragged vocabulary."""
    r = np.random.default_rng(43 + b)
    d, v = 64, 1001
    x = _randn(r, b, d)
    rows = _randn(r, v, d)
    for i, (lo, hi) in enumerate(((15, 16), (127, 128), (500, v - 1))):
        rows[lo] = rows[hi] = 3.0 * x[i]
    head = rows if tied else np.ascontiguousarray(rows.T)
    jax_fn, fn, plain = ((jax_greedy_argmax_tied, greedy_argmax_tied, greedy_argmax_tied_plain) if tied
                         else (jax_greedy_argmax, greedy_argmax, greedy_argmax_plain))
    with pltpu.force_tpu_interpret_mode():
        expected = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(head)))
    np.testing.assert_array_equal(plain(_t(x), _t(head)).numpy(), expected)
    np.testing.assert_array_equal(fn(_t(x), _t(head)).numpy(), expected)
    assert expected[:3].tolist() == [15, 127, 500]


def test_greedy_argmax_plain_bf16_rounds_scores():
    """bf16: scores round to bf16 before the argmax, so near-equal fp32
    scores tie and the lowest index wins (the JAX kernel's rule)."""
    x = torch.ones(1, 4, dtype=torch.bfloat16)
    emb = torch.tensor([[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0078125]], dtype=torch.bfloat16)
    # fp32 scores 4.0 and 4.0078125 both round to 4.0 in bf16 -> index 0
    assert greedy_argmax_tied_plain(x, emb).item() == 0
    assert greedy_argmax_tied_plain(x.float(), emb.float()).item() == 1


# ---------------------------------------------------------------------------
# layers and plain attention
# ---------------------------------------------------------------------------


def test_linear_and_layer_norm_match_jax():
    r = np.random.default_rng(51)
    x = _randn(r, 2, 5, 16)
    p = {"w": _randn(r, 16, 8), "b": _randn(r, 8)}
    ln = {"scale": _randn(r, 16), "bias": _randn(r, 16)}
    tp = {k: _t(a) for k, a in p.items()}
    tln = {k: _t(a) for k, a in ln.items()}
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jln = {k: jnp.asarray(a) for k, a in ln.items()}
    # fp32 on both sides; summation order differs by a few ulps
    np.testing.assert_allclose(layers.linear(tp, _t(x)).numpy(), np.asarray(jax_layers.linear(jp, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layers.layer_norm(tln, _t(x)).numpy(),
                               np.asarray(jax_layers.layer_norm(jln, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    # bf16 params force bf16 compute on an fp32 input, as in the JAX package
    y = layers.linear({k: a.bfloat16() for k, a in tp.items()}, _t(x))
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["gelu", "approximate_gelu", "relu", "silu"])
def test_act_fns_match_jax(act):
    x = _randn(np.random.default_rng(52), 64)
    np.testing.assert_allclose(layers.ACT_FNS[act](_t(x)).numpy(), np.asarray(jax_layers.ACT_FNS[act](jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True)])
def test_sdpa_matches_jax(causal, with_bias):
    r = np.random.default_rng(53)
    q, k, v = (_randn(r, 2, 3, 20, 16) for _ in range(3))
    bias = _randn(r, 2, 1, 20, 20) if with_bias else None
    expected = np.asarray(_sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    None if bias is None else jnp.asarray(bias), causal))
    got = attn.sdpa(_t(q), _t(k), _t(v), None if bias is None else _t(bias), causal)
    np.testing.assert_allclose(got.numpy(), expected, rtol=ATTN_TOL, atol=ATTN_TOL)
