"""int8 serving of the PyTorch port vs the JAX package, on the CPU: its parts.

Covers the quantizers (``quantize_rows``, the cache writes,
``quantize_kv_caches``, ``quantize_tree_int8``: bit for bit), the int8
decode attention's plain version (K6) against the JAX kernel in interpret
mode (and, with the bias that kernel lacks, its exact-math oracle), the
per-op ``mha_apply`` route over int8 caches and the per-op int8 linear, and
the fused step's plain twin with every int8 variant (int8 self- and
cross-KV, w8a16, w8a8 with the int8 head, the embed phase) against the JAX
kernel in interpret mode. GPT-2, Whisper and T5 generation in int8 serving
are held to JAX's in tests/test_torch_int8_serving.py (two files, so that
each runs in about a minute on one worker).

Sizes: caches of at most 256 keys where JAX runs a Pallas kernel in
interpret mode (two 128-key blocks, the interpret-safe maximum of
tests/ops/test_int8_kv.py); d 128, 2 layers, 2 heads of 64 for the fused
step (JAX's int8 K7 takes 128-lane multiples); H 4 x D 32 for K6, as in the
JAX tests. Inputs are made with ``numpy.random.default_rng`` and handed to
both sides; parameters come from the JAX package's init or loaders
(converted with ``from_jax_params``).

Tolerances, fp32 throughout: int8 dot products are exact on both sides,
and every int8 level depends on elementwise values only, so the two sides
differ by fp32 rounding of their sums (the softmax denominator, the
projections' matmuls) and by the ulp of an ``exp``: K6 outputs are held to
1e-6 (readings <= 1.2e-7), the fused step's ``x_out`` over two layers to
1e-5 (readings <= 7.2e-7), as are the scales of the K/V the step writes
(the absmax of a projection; readings 4.3e-7 relative), and every int8
level written to a cache and every token exactly. A difference above that
noise would be a
flipped int8 level (one step of a per-block probability scale), which these
bounds do not admit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pytorch_models_tpu.models.text as jax_text
import pytorch_models_tpu.ops.decode_step as jax_ds
import pytorch_models_tpu.ops.int8_kv as jax_i8
import pytorch_models_tpu.transformer as jax_tfm
from pytorch_models_tpu.models.text import t5 as jax_t5
from pytorch_models_tpu.models.text._decoder_lm import quantize_kv_caches as jax_quantize_kv_caches
from pytorch_models_tpu.utils.params import cast_tree as jax_cast_tree
from pytorch_models_tpu.utils.params import quantize_tree_int8 as jax_quantize_tree_int8
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch import transformer as tfm
from pytorch_models_tpu_torch.models.text import GPT2
from pytorch_models_tpu_torch.ops import decode_step as ds
from pytorch_models_tpu_torch.ops import int8_kv
from pytorch_models_tpu_torch.utils import cast_tree, from_jax_params, quantize_tree_int8

torch.set_num_threads(1)

K6_TOL = 1e-6
X_TOL = 1e-5
L_MAX = 2 * int8_kv.KV_BLOCK_INT8  # two 128-key blocks


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(to_np, tree)


def _assert_trees_equal(got, expected):
    """Every leaf equal, bit for bit, with the same dtype."""
    g = dict(jax.tree_util.tree_leaves_with_path(got))
    e = dict(jax.tree_util.tree_leaves_with_path(expected))
    assert g.keys() == e.keys()
    for path, leaf in e.items():
        assert g[path].dtype == leaf.dtype, path
        assert torch.equal(g[path], leaf), path


# a step's K/V reach the cache through each library's own fp32 matmul, whose summation order differs by
# library and by CPU: their per-key scales (absmax / 127) may differ by a few fp32 ulp
SCALE_ULPS = 4


def _assert_levels_match(name, got_q, got_s, ref_q, ref_s):
    """int8 rows ``(..., H*D)`` and their per-key scales ``(...)`` quantized by
    two libraries from their own projections of the same input: scales within
    SCALE_ULPS fp32 ulp; levels equal where the two scales are equal, at most
    one apart where they differ (chip_smoke.py's ``_int8_levels`` rule)."""
    got_s, ref_s = got_s.float(), ref_s.float()
    ulp = torch.abs(torch.nextafter(ref_s, torch.full_like(ref_s, float("inf"))) - ref_s)
    assert bool(((got_s - ref_s).abs() <= SCALE_ULPS * ulp).all()), f"{name}: scales beyond {SCALE_ULPS} ulp"
    d = (got_q.int() - ref_q.int()).abs()
    same = (got_s == ref_s)[..., None].expand_as(d)
    assert bool((d[same] == 0).all()), f"{name}: levels differ under equal scales"
    assert int(d.max()) <= 1, f"{name}: levels more than one apart"


# ---------------------------------------------------------------------------
# quantizers and caches: bit for bit
# ---------------------------------------------------------------------------


def test_quantize_rows_matches_jax():
    """Random rows, an all-zero row (scale 1/127), and exact ties: a row
    whose absmax is 127 has scale exactly 1, so its x.5 values must round
    half to even as JAX's do."""
    r = np.random.default_rng(0)
    x = (3 * r.standard_normal((3, 5, 96))).astype(np.float32)
    x[1, 2] = 0.0
    x[2, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    assert np.float32(127) * np.float32(1 / 127) == 1.0
    for dim in (-1, 1):
        q, s = int8_kv.quantize_rows(_t(x), dim)
        jq, js = jax_i8.quantize_rows(jnp.asarray(x), axis=dim)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert int8_kv.quantize_rows(_t(x[2, 0, :8]))[0].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]


def test_cache_writes_match_jax():
    """make/prefill at an offset, then single-position writes: the caches
    and the scale planes (JAX's batch-padded rows dropped) bit for bit."""
    b, hd = 3, 128
    r = np.random.default_rng(1)
    chunk = r.standard_normal((2, b, 40, hd)).astype(np.float32)
    steps = r.standard_normal((2, b, 3, hd)).astype(np.float32)
    jc = jax_i8.make_int8_kv_cache(b, L_MAX, hd)
    jc = jax_i8.prefill_int8_kv(*jc, jnp.asarray(chunk[0]), jnp.asarray(chunk[1]), start_pos=10)
    ours = int8_kv.make_int8_kv_cache(b, L_MAX, hd)
    int8_kv.prefill_int8_kv(*ours, _t(chunk[0]), _t(chunk[1]), start_pos=10)
    for p in range(3):
        jc = jax_i8.write_int8_kv(*jc, jnp.asarray(steps[0][:, p:p + 1]), jnp.asarray(steps[1][:, p:p + 1]), 50 + p)
        int8_kv.write_int8_kv(*ours, _t(steps[0][:, p:p + 1]), _t(steps[1][:, p:p + 1]), 50 + p)
    got = dict(zip(("k", "v", "ks", "vs"), ours))
    _assert_trees_equal(got, int8_kv.int8_kv_from_jax(dict(zip(("k", "v", "ks", "vs"), map(np.asarray, jc))), b))


def test_quantize_kv_caches_matches_jax():
    """Layer-stacked prefilled caches with unwritten (zero) slots, and a
    cross cache whose ``len`` passes through."""
    r = np.random.default_rng(2)
    k = r.standard_normal((2, 3, L_MAX, 128)).astype(np.float32)
    v = r.standard_normal((2, 3, L_MAX, 128)).astype(np.float32)
    k[:, :, 100:], v[:, :, 100:] = 0.0, 0.0
    lens = np.asarray([256, 7, 0], np.int32)
    expected = jax_quantize_kv_caches({"k": jnp.asarray(k), "v": jnp.asarray(v), "len": jnp.asarray(lens)})
    got = int8_kv.quantize_kv_caches({"k": _t(k), "v": _t(v), "len": _t(lens)})
    _assert_trees_equal(got, int8_kv.int8_kv_from_jax(jax.tree.map(np.asarray, expected), 3))


# ---------------------------------------------------------------------------
# GPT-2, as the generation tests below use it
# ---------------------------------------------------------------------------

D, N_LAYERS = 128, 2
GPT_VOCAB, GPT_CTX = 300, 128
GPT_PROMPTS = [[5, 6, 7], [9] * 40, [11, 12], list(range(20, 41))]


class Tok:
    def __init__(self, eos=None):
        self.eos_token_id = eos


def _gpt2_state_dict(seed=7, w=0.3):
    """Synthetic HF GPT-2 weights; matrices at 0.3 and position embeddings at
    1.0 (a checkpoint's are ~0.02-0.1) so that the greedy streams move."""
    r = np.random.default_rng(seed)

    def rn(*shape, s=0.02):
        return (r.standard_normal(shape) * s).astype(np.float32)

    sd = {"wte.weight": rn(GPT_VOCAB, D, s=0.5), "wpe.weight": rn(GPT_CTX, D, s=1.0),
          "ln_f.weight": 1 + rn(D), "ln_f.bias": rn(D)}
    for i in range(N_LAYERS):
        p = f"h.{i}"
        sd |= {f"{p}.ln_1.weight": 1 + rn(D), f"{p}.ln_1.bias": rn(D),
               f"{p}.ln_2.weight": 1 + rn(D), f"{p}.ln_2.bias": rn(D),
               f"{p}.attn.c_attn.weight": rn(D, 3 * D, s=w), f"{p}.attn.c_attn.bias": rn(3 * D),
               f"{p}.attn.c_proj.weight": rn(D, D, s=w), f"{p}.attn.c_proj.bias": rn(D),
               f"{p}.mlp.c_fc.weight": rn(D, 4 * D, s=w), f"{p}.mlp.c_fc.bias": rn(4 * D),
               f"{p}.mlp.c_proj.weight": rn(4 * D, D, s=w), f"{p}.mlp.c_proj.bias": rn(D)}
    return sd


def _small_gpt2(cls, **kw):
    old = (cls.vocab_size, cls.max_seq_len)
    cls.vocab_size, cls.max_seq_len = GPT_VOCAB, GPT_CTX
    try:
        return cls(N_LAYERS, D, **kw)
    finally:
        cls.vocab_size, cls.max_seq_len = old


@pytest.fixture(scope="module")
def gpt2_pair():
    """(JAX GPT-2, the port's GPT-2 holding the same fp32 weights)."""
    ref = _small_gpt2(jax_text.GPT2)
    ref.load_hf_state_dict(_gpt2_state_dict())
    ours = _small_gpt2(GPT2, device="cpu")
    ours.params = from_jax_params(_np_tree(ref.params))
    return ref, ours


@pytest.mark.parametrize("order", ["fp32", "quantize_then_bf16", "bf16_then_quantize"])
def test_quantize_int8_matches_jax(gpt2_pair, order):
    """``quantize_int8()`` (int8 kernels + fp32 scales, per output channel,
    on the same projection keys) in either order with ``to_bf16()`` (which
    casts the scales too): the port quantizing its own weights gives the JAX
    package's tree bit for bit, and ``from_jax_params`` carries JAX's int8
    leaves across unchanged."""
    ref, ours = gpt2_pair
    jp, tp = ref.params, ours.params
    for step in {"fp32": ["q"], "quantize_then_bf16": ["q", "bf16"], "bf16_then_quantize": ["bf16", "q"]}[order]:
        if step == "q":
            jp, tp = jax_quantize_tree_int8(jp), quantize_tree_int8(tp)
        else:
            jp, tp = jax_cast_tree(jp, jnp.bfloat16), cast_tree(tp, torch.bfloat16)
    _assert_trees_equal(tp, from_jax_params(_np_tree(jp)))
    q = tp["decoder"]["layers"][0]["sa"]["q"]["w"]
    scale_dt = torch.bfloat16 if order == "quantize_then_bf16" else torch.float32
    assert q["w_q"].dtype == torch.int8 and q["w_s"].dtype == scale_dt and q["w_s"].shape == (1, D)
    assert isinstance(tp["token_embs"], torch.Tensor)  # embeddings keep their tensors


# ---------------------------------------------------------------------------
# K6: the int8 decode attention's plain version
# ---------------------------------------------------------------------------

H6, D6 = 4, 32
HD6 = H6 * D6


def _k6_setup(b, seed, pads=None, ends=None):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, 1, HD6)).astype(np.float32)
    k = r.standard_normal((b, L_MAX, HD6)).astype(np.float32)
    v = r.standard_normal((b, L_MAX, HD6)).astype(np.float32)
    cur = r.standard_normal((2, b, HD6)).astype(np.float32)
    jc = jax_i8.prefill_int8_kv(*jax_i8.make_int8_kv_cache(b, L_MAX, HD6), jnp.asarray(k), jnp.asarray(v))
    ours = int8_kv.int8_kv_from_jax(dict(zip(("k", "v", "ks", "vs"), map(np.asarray, jc))), b)
    pads = np.asarray(pads if pads is not None else [0] * b, np.int32)
    ends = np.asarray(ends if ends is not None else [L_MAX] * b, np.int32)
    return q, cur, jc, ours, pads, ends


# the cases of tests/ops/test_int8_kv.py's test_kernel_matches_quantized_oracle, against the JAX kernel in
# interpret mode (which that test pins to the exact-math oracle)
@pytest.mark.parametrize("b,pads,ends,cur", [
    (1, [0], [L_MAX], False),
    (1, [7], [200], True),
    (3, [0, 5, 130], [L_MAX, 190, 256], True),
    (8, None, [100] * 8, True),
    (16, [0] * 8 + [3] * 8, [L_MAX] * 8 + [140] * 8, True),
])
def test_int8_attention_plain_matches_jax(b, pads, ends, cur):
    q, cur_kv, jc, ours, pads, ends = _k6_setup(b, b, pads, ends)
    jkw = dict(cur_k=jnp.asarray(cur_kv[0]), cur_v=jnp.asarray(cur_kv[1])) if cur else {}
    kernel = jax_i8.int8_decode_attention(jnp.asarray(q), *jc, jnp.asarray(ends), H6, pad_lens=jnp.asarray(pads),
                                          interpret=True, **jkw)
    tkw = dict(cur_k=_t(cur_kv[0]), cur_v=_t(cur_kv[1])) if cur else {}
    launches = int8_kv.int8_decode_attention.launches
    got = int8_kv.int8_decode_attention(_t(q), ours["k"], ours["v"], ours["ks"], ours["vs"], _t(ends), H6, _t(pads),
                                        **tkw)
    assert int8_kv.int8_decode_attention.launches == launches  # a CPU tensor: the plain version, no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=0, atol=K6_TOL)


def test_int8_attention_plain_bias_matches_oracle():
    """The key-major (L, H) bias, at cached keys and (row ``ends[0]``) the
    current position; it moves the output far beyond the tolerance."""
    b = 2
    q, cur_kv, jc, ours, pads, _ = _k6_setup(b, 9)
    ends = np.full(b, 200, np.int32)
    bias = (2 * np.random.default_rng(10).standard_normal((L_MAX, H6))).astype(np.float32)
    oracle = jax_i8.int8_attention_oracle(jnp.asarray(q), *jc, jnp.asarray(ends), H6, pad_lens=jnp.asarray(pads),
                                          cur_k=jnp.asarray(cur_kv[0]), cur_v=jnp.asarray(cur_kv[1]),
                                          bias=jnp.asarray(bias))
    args = (_t(q), ours["k"], ours["v"], ours["ks"], ours["vs"], _t(ends), H6, _t(pads), _t(cur_kv[0]), _t(cur_kv[1]))
    got = int8_kv.int8_decode_attention_plain(*args, bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=0, atol=K6_TOL)
    assert np.abs(int8_kv.int8_decode_attention_plain(*args).numpy() - np.asarray(oracle)).max() > 1e4 * K6_TOL


def test_int8_attention_empty_row_gives_zeros():
    q, _, jc, ours, _, _ = _k6_setup(2, 5)
    got = int8_kv.int8_decode_attention_plain(_t(q), ours["k"], ours["v"], ours["ks"], ours["vs"],
                                              torch.tensor([64, 10]), H6, torch.tensor([0, 10]))
    assert torch.isfinite(got).all() and got[1].abs().max() == 0
    assert got[0].abs().max() > 0


# ---------------------------------------------------------------------------
# K6's cluster split (csrc/int8_kv.cu), modelled in plain torch
# ---------------------------------------------------------------------------


def _k6_cluster_model(q, k_q, v_q, k_s, v_s, ends, n_heads, pad_lens=None, cur_k=None, cur_v=None, bias=None,
                      cluster=8, share=1):
    """The CUDA kernel's split of one (row, head) over a cluster, in plain
    torch: each row's 128-key blocks ``[pad // 128, ceil(end / 128))`` are
    dealt in rounds of ``cluster * share`` blocks, ``share`` consecutive
    blocks per CTA. Every block's scores and max are taken on their own; a
    block's running max is the max of the running max carried from earlier
    rounds and an exclusive ``cummax`` over the round's earlier block maxima;
    each block quantizes its own probabilities against it and records
    ``(m_new, alpha, sum p, ps, pv)``; rank 0 folds the records in ascending
    order, then the current position. Blocks outside a row's range are never
    touched. Vectorized over rows, heads and a round's blocks."""
    b, _, hd = q.shape
    d = hd // n_heads
    bk = int8_kv.KV_BLOCK_INT8
    n_blk = k_q.shape[1] // bk
    ends_t = torch.as_tensor(ends).reshape(-1).expand(b).long()
    pads_t = torch.zeros(b, dtype=torch.long) if pad_lens is None else torch.as_tensor(pad_lens).long()
    q_i8, sq = int8_kv.quantize_rows((q[:, 0].float() * (1.0 / np.sqrt(d))).reshape(b, n_heads, d))
    qd = q_i8.double()
    # every block's scores and max, as each CTA computes them for its own blocks
    kb = k_q.reshape(b, n_blk, bk, n_heads, d).double()
    s = torch.einsum("bhd,bnjhd->bhnj", qd, kb).float()
    s = (s * k_s.reshape(b, 1, n_blk, bk).float()) * sq[..., None]
    if bias is not None:
        s = s + bias.float().t().reshape(1, n_heads, n_blk, bk)
    key = torch.arange(n_blk * bk).reshape(n_blk, bk)
    valid = (key >= pads_t[:, None, None]) & (key < ends_t[:, None, None])  # (B, NB, 128)
    s = torch.where(valid[:, None], s, torch.full_like(s, int8_kv.NEG_INF))
    bmax = s.amax(-1)  # (B, H, NB)
    first = pads_t.clamp_min(0) // bk
    n_row = ((ends_t.clamp(max=n_blk * bk) + bk - 1) // bk - first).clamp_min(0)
    per_round = cluster * share
    m = torch.full((b, n_heads), int8_kv.NEG_INF)
    l = torch.zeros((b, n_heads))
    acc = torch.zeros((b, n_heads, d))
    rows = torch.arange(b)[:, None]
    for r0 in range(0, int(n_row.max()), per_round):
        local = r0 + torch.arange(per_round)
        live = local[None, :] < n_row[:, None]  # (B, R)
        blk = (first[:, None] + local[None, :]).clamp(max=n_blk - 1)
        bm = torch.where(live[:, None], bmax[rows, :, blk].permute(0, 2, 1), torch.full((b, n_heads, per_round), int8_kv.NEG_INF))
        # barrier 1: each block's running max, the exclusive prefix over the round, after the carried max
        prefix = torch.cat([m[..., None], bm[..., :-1]], -1).cummax(-1).values
        m_new = torch.maximum(prefix, bm)
        m_safe = m_new.clamp_min(int8_kv.NEG_INF / 2)
        sb = s[rows, :, blk].permute(0, 2, 1, 3)  # (B, H, R, 128)
        p = torch.exp(sb - m_safe[..., None])
        alpha = torch.exp(prefix - m_safe)
        p_sum = p.sum(-1)
        vs_b = v_s.reshape(b, n_blk, bk)[rows, blk].float()  # (B, R, 128)
        p_i8, ps = int8_kv.quantize_rows(p * vs_b[:, None])
        vb = v_q.reshape(b, n_blk, bk, n_heads, d)[rows, blk].double()  # (B, R, 128, H, D)
        pv = torch.einsum("bhrj,brjhd->bhrd", p_i8.double(), vb).float()
        # barrier 2: rank 0 folds the round's records in ascending order
        for i in range(per_round):
            on = live[:, i][:, None]
            a_i = alpha[..., i]
            acc = torch.where(on[..., None], acc * a_i[..., None] + ps[:, :, i] * pv[:, :, i], acc)
            l = torch.where(on, a_i * l + p_sum[..., i], l)
            m = torch.where(on, m_new[..., i], m)
    if cur_k is not None:  # the current position, as the oracle
        kc_i8, kc_s = int8_kv.quantize_rows(cur_k.float())
        dot = torch.einsum("bhd,bhd->bh", qd, kc_i8.reshape(b, n_heads, d).double()).float()
        s_cur = (dot * kc_s) * sq[..., 0]
        if bias is not None:
            s_cur = s_cur + bias[int(ends_t[0])].float()[None]
        m_new = torch.maximum(m, s_cur)
        p_cur = torch.exp(s_cur - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p_cur
        acc = acc * alpha[..., None] + p_cur[..., None] * cur_v.float().reshape(b, n_heads, d)
    else:
        l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l[..., None]).reshape(b, 1, hd).to(q.dtype)


L_SPLIT = 8 * int8_kv.KV_BLOCK_INT8  # eight blocks
# (B, H) = (8, 4): every exp and reduction of the model and the oracle runs on whole CPU vectors, so the two
# take the same instruction paths and may be compared bit for bit
K6_SPLIT_CASES = {
    # ranges that start and end inside blocks, a range inside one block, an empty row, a full row
    "ranges": dict(pads=[0, 5, 130, 300, 700, 1000, 64, 0], ends=[1024, 200, 131, 1000, 700, 1023, 300, 77]),
    # a key of a later block scores far above every earlier one: the running max jumps mid-range
    "max_jump": dict(pads=[0, 3, 0, 100, 0, 260, 0, 10], ends=[1024, 900, 700, 1024, 520, 1000, 1024, 300],
                     jump=True),
    "cur": dict(pads=[0, 5, 130, 300, 700, 1000, 64, 0], ends=[1024, 200, 131, 1000, 700, 1023, 300, 77], cur=True),
    "bias_cur": dict(pads=None, ends=[700] * 8, cur=True, bias=True),
}


def _k6_split_inputs(case: dict, l_max: int, seed: int):
    r = np.random.default_rng(seed)
    b = 8
    q = r.standard_normal((b, 1, HD6)).astype(np.float32)
    k = r.standard_normal((b, l_max, HD6)).astype(np.float32)
    v = r.standard_normal((b, l_max, HD6)).astype(np.float32)
    if case.get("jump"):
        for row, j in enumerate([900, 600, 650, 1000, 515, 990, 1023, 290]):
            j = min(j, l_max - 1)
            k[row, j] = 40 * q[row, 0]  # each head's score at j dwarfs the rest
    caches = int8_kv.quantize_kv_caches({"k": _t(k), "v": _t(v)})
    kw = {}
    if case.get("cur"):
        cur = r.standard_normal((2, b, HD6)).astype(np.float32)
        kw.update(cur_k=_t(cur[0]), cur_v=_t(cur[1]))
    if case.get("bias"):
        kw["bias"] = _t((2 * r.standard_normal((l_max, H6))).astype(np.float32))
    pads = None if case["pads"] is None else torch.tensor(case["pads"], dtype=torch.int32)
    ends = torch.tensor(case["ends"], dtype=torch.int32).clamp(max=l_max)
    args = (_t(q), caches["k"], caches["v"], caches["ks"], caches["vs"], ends, H6)
    return args, dict(pad_lens=None if pads is None else pads.clamp(max=l_max), **kw)


@pytest.mark.parametrize("cluster,share", [(8, 1), (3, 1), (3, 3), (1, 8)],
                         ids=["share1-cluster8", "share1-cluster3-rounds", "share3", "share8"])
@pytest.mark.parametrize("case", list(K6_SPLIT_CASES))
def test_int8_attention_cluster_split_equals_oracle(case, cluster, share):
    """The split is exact: bit for bit the oracle's fp32 output (its block
    maxima, prefix maxima and levels are the sequential walk's own), at
    shares of 1, 3 and 8 blocks per CTA, over several rounds, where the
    running max jumps, on ranges inside blocks and on an empty row."""
    args, kw = _k6_split_inputs(K6_SPLIT_CASES[case], L_SPLIT, 40)
    got = _k6_cluster_model(*args, **kw, cluster=cluster, share=share)
    expected = int8_kv.int8_decode_attention_plain(*args, **kw)
    assert torch.equal(got, expected)
    assert torch.isfinite(got).all()
    if case == "ranges":
        assert not got[4].any()  # the empty row
    if case == "max_jump":  # the jump decides the output: without it the rows differ far beyond the noise
        flat = dict(K6_SPLIT_CASES[case], jump=False)
        assert (got - int8_kv.int8_decode_attention_plain(*_k6_split_inputs(flat, L_SPLIT, 40)[0], **kw)).abs().max() > 0.1


@pytest.mark.parametrize("share", [1, 3, 8])
def test_int8_attention_cluster_split_matches_jax(share):
    """The split model against the JAX kernel in interpret mode, on two
    blocks (interpret mode's safe size) with a jump into the second block,
    ranges inside blocks and the current position."""
    case = dict(pads=[0, 5, 130, 30, 0, 200, 64, 0], ends=[256, 200, 131, 250, 0, 255, 129, 77], jump=True, cur=True)
    args, kw = _k6_split_inputs(case, L_MAX, 41)
    got = _k6_cluster_model(*args, **kw, cluster=2, share=share)
    q, kq, vq, ks, vs, ends, h = args
    jc = tuple(jnp.asarray(a.numpy()) for a in (kq, vq, ks, vs))  # B = 8: no batch padding of the scale planes
    kernel = jax_i8.int8_decode_attention(jnp.asarray(q.numpy()), *jc, jnp.asarray(ends.numpy()), h,
                                          pad_lens=jnp.asarray(kw["pad_lens"].numpy()),
                                          cur_k=jnp.asarray(kw["cur_k"].numpy()), cur_v=jnp.asarray(kw["cur_v"].numpy()),
                                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=0, atol=K6_TOL)


# ---------------------------------------------------------------------------
# the per-op route: mha_apply over int8 caches
# ---------------------------------------------------------------------------


def test_mha_apply_int8_matches_jax():
    """Self-attention at pos 150 over a prefilled int8 cache with left pads
    (attend with the step's K/V unquantized, then write them quantized at
    pos), and cross-attention over a write-once int8 cache with a short and
    an empty row: outputs to fp32 noise, the caches written bit for bit."""
    b, pos = 3, 150
    r = np.random.default_rng(21)
    cfg = jax_tfm.LayerConfig.make(D, n_heads=2)
    jp = jax_tfm.mha_init(jax.random.PRNGKey(3), cfg)
    ours = from_jax_params(_np_tree(jp))
    h = r.standard_normal((b, 1, D)).astype(np.float32)
    kv = r.standard_normal((2, b, L_MAX, D)).astype(np.float32)
    pads = np.asarray([0, 4, 149], np.int32)
    jc = dict(zip(("k", "v", "ks", "vs"), jax_i8.prefill_int8_kv(*jax_i8.make_int8_kv_cache(b, L_MAX, D),
                                                                  jnp.asarray(kv[0]), jnp.asarray(kv[1]))))
    oc = int8_kv.int8_kv_from_jax(jax.tree.map(np.asarray, jc), b)
    lens = np.asarray([256, 30, 0], np.int32)
    jx = dict(zip(("k", "v", "ks", "vs"), jax_i8.prefill_int8_kv(*jax_i8.make_int8_kv_cache(b, L_MAX, D),
                                                                  jnp.asarray(kv[1]), jnp.asarray(kv[0]))))
    jx["len"] = jnp.asarray(lens)
    ox = int8_kv.int8_kv_from_jax(jax.tree.map(np.asarray, jx), b)
    with pltpu.force_tpu_interpret_mode():
        j_out, j_cache = jax_tfm.mha_apply(jp, cfg, jnp.asarray(h), cache=jc, cache_pos=pos,
                                           pad_lens=jnp.asarray(pads))
        j_cross = jax_tfm.mha_apply(jp, cfg, jnp.asarray(h), cache=jx)
    prefilled = {key: val.clone() for key, val in oc.items()}
    out, cache = tfm.mha_apply(ours, tfm.LayerConfig.make(D, n_heads=2), _t(h), cache=oc, cache_pos=pos,
                               pad_lens=_t(pads))
    assert cache is oc  # written in place
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=X_TOL)
    expected = int8_kv.int8_kv_from_jax(jax.tree.map(np.asarray, j_cache), b)
    # every slot but pos bit for bit
    keep = torch.arange(L_MAX) != pos
    _assert_trees_equal({key: val[:, keep] for key, val in oc.items()},
                        {key: val[:, keep] for key, val in expected.items()})
    # slot pos: the port's cache write fed JAX's own projected step K/V writes JAX's slot bit for bit
    from pytorch_models_tpu.ops.layers import linear as jax_linear

    jk, jv = (_t(np.asarray(jax_linear(jp[key], jnp.asarray(h)))) for key in ("k", "v"))
    int8_kv.write_int8_kv(*(prefilled[key] for key in ("k", "v", "ks", "vs")), jk, jv, pos)
    _assert_trees_equal({key: val[:, pos] for key, val in prefilled.items()},
                        {key: val[:, pos] for key, val in expected.items()})
    # and the port's own slot, from its own projection: scales within a few ulp, levels as they allow
    for key in ("k", "v"):
        _assert_levels_match(f"slot {pos} {key}", oc[key][:, pos], oc[key + "s"][:, pos], expected[key][:, pos],
                             expected[key + "s"][:, pos])
    cross = tfm.mha_apply(ours, tfm.LayerConfig.make(D, n_heads=2), _t(h), cache=ox)
    np.testing.assert_allclose(cross.numpy(), np.asarray(j_cross), rtol=0, atol=X_TOL)
    with pytest.raises(ValueError, match="no bias"):
        tfm.mha_apply(ours, tfm.LayerConfig.make(D, n_heads=2), _t(h), attn_bias=torch.zeros(2, 1, L_MAX), cache=oc,
                      cache_pos=pos + 1)


# ---------------------------------------------------------------------------
# K7: the fused step's plain twin with every int8 variant vs the JAX kernel
# ---------------------------------------------------------------------------

B7, POS7 = 4, 200


def _k7_layers(kind):
    """Layer-stacked JAX params (weight-only int8) and the port's per-layer
    conversion: GPT-2 (LayerNorm, GELU-tanh), Whisper (+ cross-attention,
    exact GELU) or T5 (RMSNorm, GEGLU, cross-attention)."""
    if kind == "t5":
        cfg = jax_t5.T5Config(vocab_size=64, dim=D, n_heads=2, n_layers=N_LAYERS, mlp_dim=256)
        layers = jax_t5.t5_stack_init(jax.random.PRNGKey(7), cfg, cross_attn=True)["layers"]
        act = "approximate_gelu"
    else:
        cfg = jax_tfm.LayerConfig.make(D, n_heads=2, cross_attn=kind == "whisper",
                                       act="gelu" if kind == "whisper" else "approximate_gelu")
        layers = jax_tfm.decoder_init(jax.random.PRNGKey(1), N_LAYERS, cfg)["layers"]
        act = cfg.act
    layers = jax_quantize_tree_int8({"layers": layers})["layers"]
    return layers, from_jax_params(_np_tree({"layers": layers}))["layers"], act


def _int8_caches(r, lk):
    k = r.standard_normal((N_LAYERS, B7, lk, D)).astype(np.float32)
    v = r.standard_normal((N_LAYERS, B7, lk, D)).astype(np.float32)
    jc = jax_quantize_kv_caches({"k": jnp.asarray(k), "v": jnp.asarray(v)})
    return jc, int8_kv.int8_kv_from_jax(jax.tree.map(np.asarray, jc), B7)


# (model, w8a8, int8 self-KV, int8 cross-KV, embed phase): the variants the generators serve
K7_VARIANTS = {
    "gpt2 w8a16 int8-kv": ("gpt2", False, True, False, False),
    "gpt2 w8a8 a8-head int8-kv": ("gpt2", True, True, False, False),
    "whisper int8 self+cross kv": ("whisper", False, True, True, False),
    "t5 w8a8 a8-head int8 self+cross kv, self bias": ("t5", True, True, True, False),
    "gpt2 embed phase": ("gpt2", False, False, False, True),
}


@pytest.mark.parametrize("variant", list(K7_VARIANTS))
def test_fused_step_int8_variants_match_jax(variant):
    kind, a8, kv, kvx, embed = K7_VARIANTS[variant]
    cross, t5 = kind != "gpt2", kind == "t5"
    r = np.random.default_rng(5)
    jl, ol, act = _k7_layers(kind)
    norm = "rms" if t5 else "ln"
    jpack = jax_ds.pack_decode_weights(jl, jnp.float32, gated=t5, cross=cross, norm=norm)
    opack = ds.pack_decode_weights(ol, torch.float32, cross=cross, gated=t5)
    assert opack.keys() == jpack.keys()
    for key, val in jpack.items():  # int8 kernels and their (L, N) scales, packed as JAX packs them
        np.testing.assert_array_equal(opack[key].numpy(), np.asarray(val), err_msg=key)
    x = r.standard_normal((B7, D)).astype(np.float32)
    pads = None if t5 else np.asarray([0, 3, 150, 201], np.int32)  # the last row: nothing cached before pos
    jkw, okw = {}, {}
    if kv:
        jc, oc = _int8_caches(r, L_MAX)
        jkw["kv_scales"], okw["kv_scales"] = ({"ks": c["ks"], "vs": c["vs"]} for c in (jc, oc))
    else:
        kvf = r.standard_normal((2, N_LAYERS, B7, L_MAX, D)).astype(np.float32)
        jc, oc = {"k": jnp.asarray(kvf[0]), "v": jnp.asarray(kvf[1])}, {"k": _t(kvf[0]), "v": _t(kvf[1])}
    fs = (1 + 0.1 * r.standard_normal(D)).astype(np.float32)
    if t5:  # the untied classifier, int8 (T5's quantize_int8 covers it): dequantized, then re-quantized per row
        w = jnp.asarray((0.3 * r.standard_normal((D, 300))).astype(np.float32))
        w = jax_quantize_tree_int8({"classifier": {"w": w}})["classifier"]["w"]
        jhead, head_v = jax_ds.pack_greedy_head(w, {"scale": jnp.asarray(fs)}, jnp.float32, tied=False, a8=a8)
        ohead = ds.pack_greedy_head({k: _t(v) for k, v in w.items()}, {"scale": _t(fs)}, torch.float32, tied=False,
                                    a8=a8)
    else:
        emb = r.standard_normal((300, D)).astype(np.float32)
        jhead, head_v = jax_ds.pack_greedy_head(jnp.asarray(emb), {"scale": jnp.asarray(fs)}, jnp.float32, a8=a8)
        ohead = ds.pack_greedy_head(_t(emb), {"scale": _t(fs)}, torch.float32, a8=a8)
    if a8:  # the per-row int8 table and its scales: JAX's, without its tile padding
        np.testing.assert_array_equal(ohead["emb"].numpy(), np.asarray(jhead["emb"])[:300])
        np.testing.assert_array_equal(ohead["emb_s"].numpy(), np.asarray(jhead["emb_s"]).reshape(-1)[:300])
    jkw.update(head=jhead, head_v=head_v)
    okw["head"] = ohead
    if t5:  # the key-major (L, H) self bias; JAX's grouped int8 kernel reads it tiled per row, lane-padded
        sb = (2 * r.standard_normal((L_MAX, 2))).astype(np.float32)
        jkw["sbias"] = jnp.pad(jnp.concatenate([jnp.asarray(sb)] * B7, -1), ((0, 0), (0, 128 - 2 * B7)))
        okw["sbias"] = _t(sb)
    if cross:
        lens = np.asarray([256, 100, 0, 130], np.int32)  # one empty row: zeros from cross-attention
        if kvx:
            jx, ox = _int8_caches(r, L_MAX)
            jkw["kv_scales_x"], okw["kv_scales_x"] = ({"ks": c["ks"], "vs": c["vs"]} for c in (jx, ox))
        else:
            xf = r.standard_normal((2, N_LAYERS, B7, L_MAX, D)).astype(np.float32)
            jx, ox = {"k": jnp.asarray(xf[0]), "v": jnp.asarray(xf[1])}, {"k": _t(xf[0]), "v": _t(xf[1])}
    jx_in, ox_in = jnp.asarray(x), _t(x)
    if embed:  # out-of-range ids clamp to the table
        tok_tab, pos_tab = (r.standard_normal((n, D)).astype(np.float32) for n in (300, 256))
        ids, prow = np.asarray([5, 299, 0, 17], np.int32), np.asarray([200, 197, 50, 0], np.int32)
        jkw.update(emb=jax_ds.pack_embed_tables(jnp.asarray(tok_tab), jnp.asarray(pos_tab), jnp.float32),
                   tok_ids=jnp.asarray(ids), pos_rows=jnp.asarray(prow))
        okw.update(emb=ds.pack_embed_tables(_t(tok_tab), _t(pos_tab), torch.float32), tok_ids=_t(ids),
                   pos_rows=_t(prow))
        jx_in = ox_in = None
    common = dict(n_heads=2, act=act, eps=1e-5)
    jpads = None if pads is None else jnp.asarray(pads)
    with pltpu.force_tpu_interpret_mode():
        if cross:
            out = jax_ds.fused_cross_decode_step(jx_in, jpack, jc["k"], jc["v"], jx["k"], jx["v"], jnp.asarray(lens),
                                                 POS7, jpads, norm=norm, gated=t5, a8=a8, **common, **jkw)
        else:
            out = jax_ds.fused_decode_step(jx_in, jpack, jc["k"], jc["v"], POS7, jpads, a8=a8, **common, **jkw)
    opads = None if pads is None else _t(pads)
    if cross:
        x_out, tok = ds.fused_cross_decode_step(ox_in, opack, oc["k"], oc["v"], ox["k"], ox["v"], _t(lens), POS7, opads,
                                                norm=norm, gated=t5, a8=a8, **common, **okw)
    else:
        x_out, tok = ds.fused_decode_step(ox_in, opack, oc["k"], oc["v"], POS7, opads, a8=a8, **common, **okw)
    np.testing.assert_allclose(x_out.numpy(), np.asarray(out[0]), rtol=X_TOL, atol=X_TOL)
    assert tok.tolist() == np.asarray(out[3]).tolist()
    # this step's K/V at pos: the JAX function returns them and its caller writes them (quantized, int8 caches)
    for i, key in ((1, "k"), (2, "v")):
        new = _t(out[i])
        if kv:
            q8, sc = int8_kv.quantize_rows(new)
            np.testing.assert_array_equal(oc[key][:, :, POS7].numpy(), q8.numpy())
            # a row's absmax / 127: the row is a projection, its sums ordered otherwise on the two sides
            np.testing.assert_allclose(oc[key + "s"][:, :, POS7].numpy(), sc[..., 0].numpy(), rtol=X_TOL, atol=0)
        else:
            np.testing.assert_allclose(oc[key][:, :, POS7].numpy(), new.numpy(), rtol=X_TOL, atol=X_TOL)


def test_fused_step_embed_equals_gathered_input():
    """The embed phase is bit-identical to gathering the rows and adding them
    outside in the compute dtype (bf16: one rounding of the fp32 sum)."""
    r = np.random.default_rng(8)
    _, layers, act = _k7_layers("gpt2")
    packed = ds.pack_decode_weights(layers, torch.bfloat16)
    tok_tab, pos_tab = (_t(r.standard_normal((n, D)).astype(np.float32)).to(torch.bfloat16) for n in (300, 128))
    ids, prow = torch.tensor([5, 299, 0, 17]), torch.tensor([100, 97, 50, 0])
    kc = torch.zeros(N_LAYERS, B7, 128, D, dtype=torch.bfloat16)
    x = (tok_tab[ids] + pos_tab[prow]).contiguous()
    ref, _ = ds.fused_decode_step(x, packed, kc.clone(), kc.clone(), 100, None, 2, act)
    got, _ = ds.fused_decode_step(None, packed, kc.clone(), kc.clone(), 100, None, 2, act,
                                  emb=ds.pack_embed_tables(tok_tab, pos_tab), tok_ids=ids, pos_rows=prow)
    assert torch.equal(got, ref)


def test_per_op_int8_linear_matches_jax():
    """The per-op int8 linear: ``w_q.bf16 * w_s.bf16`` then a bf16 matmul
    with the bias in bf16, bit for bit as the JAX function computes it op by
    op (under ``jit`` on the CPU XLA keeps its bf16 intermediates in fp32)."""
    from pytorch_models_tpu.ops.layers import linear as jax_linear
    from pytorch_models_tpu_torch.ops.layers import linear

    r = np.random.default_rng(31)
    p = jax_quantize_tree_int8({"q": {"w": jnp.asarray((0.3 * r.standard_normal((D, 384))).astype(np.float32)),
                                      "b": jnp.asarray((0.02 * r.standard_normal(384)).astype(np.float32))}})["q"]
    x = r.standard_normal((4, 16, D)).astype(np.float32)
    got = linear(from_jax_params(_np_tree(p)), _t(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jax_linear(p, jnp.asarray(x)).astype(jnp.float32)))
