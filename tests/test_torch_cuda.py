"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips. This file
imports neither JAX nor the JAX package, so on a machine without JAX it runs
with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import pytest
import torch

from pytorch_models_tpu_torch.ops import attention as _attn
from pytorch_models_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from pytorch_models_tpu_torch.ops.decode_step import (
    fused_cross_decode_step,
    fused_decode_step,
    fused_step_eligible,
    pack_decode_weights,
    pack_greedy_head,
)
from pytorch_models_tpu_torch.ops.encoder_attention import (
    K_TILE,
    SUPPORTED_HEAD_DIMS,
    encoder_attention,
    encoder_attention_plain,
)
from pytorch_models_tpu_torch.ops.gather import embed_add, embed_add_plain, gather_rows, gather_rows_plain
from pytorch_models_tpu_torch.ops.greedy_head import (
    greedy_argmax,
    greedy_argmax_plain,
    greedy_argmax_tied,
    greedy_argmax_tied_plain,
    greedy_head_fits,
    greedy_head_ranges,
)
from pytorch_models_tpu_torch.ops.mel import log_mel_spectrogram, log_mel_spectrogram_plain
from pytorch_models_tpu_torch.transformer import LayerConfig, layer_init, mha_apply, mha_init

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# K1 vs its plain twin, which walks the same key tiles: fp32 differs by
# summation order, exp and 3xTF32's 2^-21 per product; bf16 rounds p and the
# output at the same points, so an output may land one bf16 step apart. In
# bf16 a p that lies at a rounding boundary may round one way in the kernel
# and the other in the twin (their scores are summed in other orders): one
# step of p times |v| / l, which exceeds 2^-7 of an output near zero (an
# H100 reading: 20 of 384,000 outputs at D = 32, L = 1500, up to 1.1e-4).
# There each element is held to that rounding's bound instead:
# 2^-8 * (P @ |V|) / l + 2^-7 * |o| + 1e-6, P from the fp32 scores.
K1_TOL = [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-5, 2.0 ** -7)]


def _assert_k1_close(got, ref, q, k, v, n_heads, causal, atol, rtol):
    diff, allowed = (got.float() - ref.float()).abs(), atol + rtol * ref.float().abs()
    assert torch.isfinite(got.float()).all()
    if q.dtype == torch.bfloat16 and bool((diff > allowed).any()):
        unbatched = q.ndim == 2
        b, lq, hd = (1, *q.shape) if unbatched else q.shape
        lk, d = k.shape[-2], hd // n_heads
        qh, kh, vh = (t.float().reshape(b, -1, n_heads, d).transpose(1, 2) for t in (q, k, v))
        s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / d ** 0.5)
        if causal:
            s = s.masked_fill(torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril().logical_not(), -1e30)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        spread = (torch.matmul(p, vh.abs()) / p.sum(-1, keepdim=True)).transpose(1, 2).reshape(got.shape)
        allowed = torch.maximum(allowed, 2.0 ** -8 * spread + 2.0 ** -7 * ref.float().abs() + 1e-6)
    assert bool((diff <= allowed).all()), f"{int((diff > allowed).sum())} elements off, max diff {diff.max().item()}"


# kernel vs plain on the same inputs: fp32 differs by summation order only
# (readings on an H100: 2.98e-7 decode attention; the encoder attention, in
# 3xTF32, up to 9.24e-6); both bf16 paths keep fp32 inside and round once, so
# an output may land one bf16 step of its own value (2^-7 relative at most)
# apart (readings: 3.91e-3 encoder, 3.8e-6 decode attention); for the encoder
# attention's rounded p see K1_TOL
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-5, 2.0 ** -7)])
def test_kernels_match_plain(cuda, dtype, atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    q, k, v = rnd(2, 197, 768), rnd(2, 197, 768), rnd(2, 197, 768)
    for causal in (False, True):
        got, ref = encoder_attention(q, k, v, 12, causal), encoder_attention_plain(q, k, v, 12, causal)
        _assert_k1_close(got, ref, q, k, v, 12, causal, atol, rtol)

    q1, kc, vc = rnd(8, 1, 768), rnd(8, 1024, 768), rnd(8, 1024, 768)
    ends = torch.tensor([1024, 700, 5, 64, 1, 300, 1000, 512], dtype=torch.int32, device=cuda)
    pads = torch.tensor([0, 10, 5, 0, 0, 299, 3, 100], dtype=torch.int32, device=cuda)
    got = decode_attention(q1, kc, vc, ends, 12, pads)
    torch.testing.assert_close(got.float(), decode_attention_plain(q1, kc, vc, ends, 12, pads).float(),
                               rtol=rtol, atol=atol)
    assert not got[2].any()  # empty [pad, end) row

    table = rnd(1000, 768)
    idx = torch.tensor([0, 999, -4, 5000, 17], device=cuda)
    assert torch.equal(gather_rows(table, idx), gather_rows_plain(table, idx))

    x, emb = rnd(8, 768), rnd(5000, 768)
    emb[3] = emb[4999] = x[0] * 2
    assert greedy_argmax_tied(x, emb)[0].item() == 3  # forced tie: lowest index
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos_dtype", [torch.float32, torch.bfloat16])
def test_embed_add_matches_plain_exactly(cuda, dtype, pos_dtype):
    """One launch of K3's embedding kernel, bit for bit its plain version:
    GPT-2's ids per row (int32 and int64, out of range ones clamped, one
    (B, S) prefill chunk), Whisper's start position (a (B, S) chunk and a
    step, period S), T5's gather without a position table; an odd width
    and an offset view take the scalar path."""
    g = torch.Generator(device=cuda).manual_seed(3)
    tok = torch.randn(50257, 768, generator=g, device=cuda).mul_(3).to(dtype)
    pos = torch.randn(1024, 768, generator=g, device=cuda).to(pos_dtype)
    ids = torch.tensor([0, 50256, -5, 50300, 7, 7, 1000, 42], device=cuda)
    pids = torch.tensor([0, 1023, 5, -1, 1030, 99, 99, 512], device=cuda)
    before = embed_add.launches
    for it in (torch.int32, torch.int64):
        got = embed_add(tok, ids.to(it), pos, pids.to(it))
        assert torch.equal(got, embed_add_plain(tok, ids, pos, pids)), it
    chunk = torch.randint(0, 50257, (8 * 60,), generator=g, device=cuda)
    chunk_pos = torch.randint(0, 1024, (8 * 60,), generator=g, device=cuda)
    assert torch.equal(embed_add(tok, chunk, pos, chunk_pos), embed_add_plain(tok, chunk, pos, chunk_pos))
    for start, period in ((0, 60), (40, 1), (1020, 8)):  # past the table's end the position clamps
        assert torch.equal(embed_add(tok, chunk, pos, start=start, period=period),
                           embed_add_plain(tok, chunk, pos, start=start, period=period)), (start, period)
    assert torch.equal(embed_add(tok, ids), embed_add_plain(tok, ids))  # no position table: the gather
    odd_tok, odd_pos = tok[:, :765].contiguous(), pos[:, 1:766].contiguous()
    assert torch.equal(embed_add(odd_tok, ids, odd_pos, pids), embed_add_plain(odd_tok, ids, odd_pos, pids))
    view = tok.view(-1)[2:2 + 1000 * 768].view(1000, 768)  # 4-byte (bf16) or 8-byte (fp32) aligned: scalar path
    assert torch.equal(embed_add(view, ids, pos, pids), embed_add_plain(view, ids, pos, pids))
    torch.cuda.synchronize()
    assert embed_add.launches - before == 9
    with pytest.raises(ValueError):
        embed_add(tok, ids.float(), pos, pids)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-5, 2.0 ** -7)])
def test_attention_kernels_at_whisper_shapes(cuda, dtype, atol, rtol):
    """K1 with Lq != Lk (teacher-forced cross-attention) and at the
    encoder's L=1500; K2 over a 1536-slot cross cache with per-row ends."""
    g = torch.Generator(device=cuda).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    k, v = rnd(2, 1500, 512), rnd(2, 1500, 512)
    for q in (rnd(2, 448, 512), rnd(2, 1500, 512)):
        _assert_k1_close(encoder_attention(q, k, v, 8), encoder_attention_plain(q, k, v, 8), q, k, v, 8, False, atol,
                         rtol)
    q1, kc, vc = rnd(4, 1, 512), rnd(4, 1536, 512), rnd(4, 1536, 512)
    ends = torch.tensor([1500, 1500, 7, 1536], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(decode_attention(q1, kc, vc, ends, 8).float(),
                               decode_attention_plain(q1, kc, vc, ends, 8).float(), rtol=rtol, atol=atol)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-5, 2.0 ** -7)])
@pytest.mark.parametrize("l_max", [128, 1024])
def test_decode_attention_bias_matches_plain(cuda, dtype, atol, rtol, l_max):
    """K2-bias at T5's decode shape (B=8, H=12): a shared (1, L, H) bias and a
    per-row (B, L, H) one with left pads, at a scale where it matters."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q1, kc, vc = (torch.randn(*s, generator=g, device=cuda).to(dtype) for s in ((8, 1, 768), (8, l_max, 768),
                                                                                   (8, l_max, 768)))
    ends = torch.tensor([l_max, 41, 1, l_max - 3, 64, 7, 100, 2], dtype=torch.int32, device=cuda)
    pads = torch.tensor([0, 3, 0, 17, 63, 0, 99, 0], dtype=torch.int32, device=cuda)
    for rows, p in ((1, None), (8, pads)):
        bias = 3.0 * torch.randn(rows, l_max, 12, generator=g, device=cuda)
        got = decode_attention(q1, kc, vc, ends, 12, p, bias)
        ref = decode_attention_plain(q1, kc, vc, ends, 12, p, bias)
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
        assert (got.float() - decode_attention(q1, kc, vc, ends, 12, p).float()).abs().max() > 0.1
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [5001, 32128])  # 5001: bf16 rows not 4-byte aligned, the kernel's scalar loads
@pytest.mark.parametrize("b, d", [(8, 768), (16, 768), (40, 768), (5, 100)])  # 40: a second group of rows
def test_greedy_argmax_untied_matches_plain(cuda, dtype, v, b, d):
    """K4-untied over a (d, V) classifier: a forced tie goes to the lowest
    index; elsewhere the kernel's pick scores within summation noise (fp32)
    or one bf16 step (bf16) of the plain pick."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x, w = torch.randn(b, d, generator=g, device=cuda).to(dtype), torch.randn(d, v, generator=g, device=cuda)
    w = w.to(dtype)
    w[:, 3] = w[:, v - 2] = x[0] * 2
    got, ref = greedy_argmax(x, w), greedy_argmax_plain(x, w)
    assert got.dtype == torch.int64 and got.shape == (b,) and got[0].item() == 3
    s = torch.matmul(x.float(), w.float())
    if dtype == torch.bfloat16:
        s = s.to(dtype).float()
    rows = torch.arange(b, device=cuda)
    tol = 1e-3 if dtype == torch.float32 else 2.0 ** -7 * s.max(-1).values.abs()
    assert bool(((s[rows, ref] - s[rows, got]).abs() <= tol).all())
    torch.cuda.synchronize()


def test_greedy_head_gate_refuses_what_the_kernel_cannot_serve(cuda):
    """Auto takes the kernel only for a head it serves, and only where it
    beats the head matmul + argmax: every batch of a bfloat16 tied head, 200
    rows of 768 included; a float32 head up to 16 rows; an untied bfloat16
    head up to 32 (``GREEDY_HEAD_MAX_BATCH``). A float16 head is not served
    (no instantiation), nor is a batch under the JAX package's gate of 4
    rows."""
    emb, cls = torch.zeros(1000, 768, device=cuda), torch.zeros(768, 1000, device=cuda)
    assert _attn.use_greedy_head(8, emb, tied=True) and not _attn.use_greedy_head(200, emb, tied=True)
    assert _attn.use_greedy_head(200, emb.bfloat16(), tied=True)
    assert not _attn.use_greedy_head(200, cls, tied=False) and not _attn.use_greedy_head(2, cls, tied=False)
    assert _attn.use_greedy_head(32, cls.bfloat16(), tied=False)
    assert not _attn.use_greedy_head(8, emb.half(), tied=True) and not _attn.use_greedy_head(8, cls.half(), tied=False)
    with pytest.raises(ValueError):
        greedy_argmax_tied(torch.zeros(8, 768, device=cuda).half(), emb.half())
    with pytest.raises(ValueError):
        greedy_argmax(torch.zeros(8, 768, device=cuda).half(), cls.half())


@pytest.mark.parametrize("dtype,tied,crossover", [(torch.float32, True, 16), (torch.float32, False, 16),
                                                  (torch.bfloat16, False, 32), (torch.bfloat16, True, None)])
def test_greedy_head_gate_at_each_crossover(cuda, dtype, tied, crossover):
    """The gate's side at both sides of each measured crossover (kernel_ab.py
    --head-mel times both): the kernel up to it, the matmul above it; a tied
    bfloat16 head keeps the kernel at every batch. Each side's choice serves
    the same ids as the other (the greedy head's own checks)."""
    w = torch.randn((50257, 768) if tied else (768, 32128), device=cuda).to(dtype)
    for b in (4, 8) + ((crossover, crossover + 1) if crossover else (200,)):
        assert _attn.use_greedy_head(b, w, tied=tied) == (crossover is None or b <= crossover), b


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0), (torch.bfloat16, 0.05, 2.0 ** -6)])
@pytest.mark.parametrize("kind", ["gpt2", "whisper", "t5"])
def test_headless_fused_step_matches_plain(cuda, dtype, atol, rtol, kind):
    """K7 without the head (the sampled and beam decode loops): x_out and the
    K/V written at pos against the plain twin, 2 layers, d 128, B=4; no token;
    the headless launch counted under ``headless``."""
    from pytorch_models_tpu_torch.models.text.t5 import T5Config, t5_block_init
    from pytorch_models_tpu_torch.ops.decode_step import fused_decode_step_plain

    cross, pos = kind != "gpt2", 70
    if kind == "t5":
        gen = torch.Generator().manual_seed(9)
        layers = [t5_block_init(gen, T5Config(1000, 128, 2, 2, 256), True) for _ in range(2)]
        packed = {k: t.to(cuda) for k, t in pack_decode_weights(layers, dtype, cross=True, gated=True).items()}
        x = torch.randn(4, 128, generator=gen).to(cuda, dtype)
        kc, vc, xk, xv = (torch.randn(2, 4, 128, 128, generator=gen).to(cuda, dtype) for _ in range(4))
        variant = dict(norm="rms", gated=True, sbias=2.0 * torch.randn(128, 2, generator=gen).to(cuda))
        n_heads, act, eps, pads = 2, "approximate_gelu", 1e-5, None
    else:
        cfg, packed, _, x, (kc, vc), (xk, xv) = _step_inputs(cuda, dtype, cross)
        variant, n_heads, act, eps = {}, cfg.n_heads, cfg.act, cfg.norm_eps
        pads = torch.tensor([0, 5, 70, 3], dtype=torch.int32, device=cuda)
    lens = torch.tensor([96, 7, 0, 50], dtype=torch.int32, device=cuda)
    kw = dict(cross_k=xk, cross_v=xv, cross_lens=lens) if cross else {}
    kc2, vc2 = kc.clone(), vc.clone()
    ref_x, ref_tok = fused_decode_step_plain(x, packed, kc2, vc2, pos, pads, n_heads, act, eps, None, **kw, **variant)
    fn = fused_cross_decode_step if cross else fused_decode_step
    before = fn.variant_launches["headless"]
    if cross:
        got_x, got_tok = fn(x, packed, kc, vc, xk, xv, lens, pos, pads, n_heads, act, eps, **variant)
    else:
        got_x, got_tok = fn(x, packed, kc, vc, pos, pads, n_heads, act, eps)
    torch.cuda.synchronize()
    assert got_tok is None and ref_tok is None and fn.variant_launches["headless"] == before + 1
    torch.testing.assert_close(got_x.float(), ref_x.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(kc.float(), kc2.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(vc.float(), vc2.float(), atol=atol, rtol=rtol)


def test_beam_cache_reorder_on_the_card(cuda):
    """The beam loop's prefix gather into a strided view of the spare buffer
    (``index_select(..., out=)``) on CUDA tensors: row r is row idx[r] up to
    pos; the slots from pos on keep the spare's zeros."""
    from pytorch_models_tpu_torch.models.text import beam

    stacked = {k: torch.randn(3, 8, 256, 128, device=cuda) for k in ("k", "v")}
    idx = torch.tensor([7, 7, 0, 3, 3, 3, 1, 2], device=cuda)
    views, new, _ = beam.reorder_caches(beam.beam_caches(stacked), idx, 100)
    for k in ("k", "v"):
        assert torch.equal(new[k][:, :, :100], stacked[k][:, idx, :100]) and not new[k][:, :, 100:].any()
        assert views[2][k].data_ptr() == new[k][2].data_ptr()


def test_sampler_on_the_card(cuda):
    """The inverse-CDF pick on CUDA tensors equals the CPU's for the same
    uniforms; draws from a CUDA generator stay in the top-k / nucleus set."""
    from pytorch_models_tpu_torch.models.text import generator as gen_mod

    g = torch.Generator(device=cuda).manual_seed(0)
    logits = torch.randn(64, 50257, generator=g, device=cuda)
    vals, idx = gen_mod._top_k(logits / 0.8, 40)
    vals = gen_mod._nucleus_mask(vals, 0.9)
    u = torch.rand(64, generator=g, device=cuda)
    assert torch.equal(gen_mod._inverse_cdf(vals, u).cpu(), gen_mod._inverse_cdf(vals.cpu(), u.cpu()))
    draws = gen_mod._sample(logits, g, 40, 0.9, 0.8)
    allowed = idx.masked_fill(vals == torch.finfo(vals.dtype).min, -1)
    assert bool((draws[:, None] == allowed).any(-1).all())
    assert torch.equal(gen_mod._sample(logits, g, 1), logits.argmax(-1))


def _parent_greedy_fits(b: int, d: int, dtype: torch.dtype, tied: bool, cap: int) -> bool:
    """The planner this kernel replaced (two passes, B rows held in shared
    memory): its rules written out, to show that no shape it served is
    refused now. Tied: B x d fp32 rows plus 8 (value, index) slots per row.
    Untied: a 4-stage ring of 64 rows x 128 bytes plus the rows of a block
    (8, or 32 where they fit, as T) padded to 64, or the 8 warps' fp32 sums."""
    if tied:
        return (b * d + 2 * 8 * b) * 4 <= cap
    w_cols = 128 // (4 if dtype == torch.float32 else 2)

    def smem(nb):
        d_pad = -(-d // 64) * 64
        return max(4 * 64 * 128 + nb * d_pad * (128 // w_cols), 8 * nb * w_cols * 4)

    rows = 8 if b <= 8 else (32 if smem(32) <= cap else 8)
    return smem(min(rows, b)) <= cap


def test_greedy_head_planner_accepts_everything_the_parent_did(cuda):
    """For B <= 64 at d in {512, 768, 1024, 1280, 1600}, both layouts and
    dtypes: every shape the parent's planner accepted is accepted by the
    gate and served by the kernel (ids within summation noise, fp32, or one
    bf16 step of the top, bf16, of the plain pick)."""
    cap = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    g = torch.Generator(device=cuda).manual_seed(64)
    refused, served = [], 0
    for dtype in (torch.float32, torch.bfloat16):
        for tied in (True, False):
            fn, plain = (greedy_argmax_tied, greedy_argmax_tied_plain) if tied else (greedy_argmax, greedy_argmax_plain)
            for d in (512, 768, 1024, 1280, 1600):
                w = torch.randn((1000, d) if tied else (d, 1000), generator=g, device=cuda).to(dtype)
                xs = torch.randn(64, d, generator=g, device=cuda).to(dtype)
                s_all = torch.matmul(xs.float(), w.float().t() if tied else w.float())
                if dtype == torch.bfloat16:
                    s_all = s_all.to(dtype).float()
                for b in range(1, 65):
                    if not _parent_greedy_fits(b, d, dtype, tied, cap):
                        continue
                    if not greedy_head_fits(w):
                        refused.append((b, d, dtype, tied))
                        continue
                    x, s = xs[:b], s_all[:b]
                    got, ref = fn(x, w), plain(x, w)
                    rows = torch.arange(b, device=cuda)
                    tol = 1e-3 if dtype == torch.float32 else 2.0 ** -7 * s.max(-1).values.abs()
                    assert bool(((s[rows, ref] - s[rows, got]).abs() <= tol).all()), (b, d, dtype, tied)
                    served += 1
    assert not refused and served > 1000
    torch.cuda.synchronize()


def _greedy_case(cuda, dtype, tied, b, v, d, seed):
    """x (b, d) and a head whose rows (tied) or columns (untied) hold forced
    ties for the first batch rows: across an mma's 16-row tile edge (15/16),
    across two CTAs' vocab ranges, across a 64-row tile edge (63/64) and on
    the last row of a ragged vocab. Returns x, the head, {batch row: lowest
    tied index}."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, d, generator=g, device=cuda).to(dtype)
    rows = torch.randn(v, d, generator=g, device=cuda).to(dtype)
    starts = greedy_head_ranges(b, rows if tied else rows.t(), tied)
    edge = starts[len(starts) // 2] if len(starts) > 1 else 16
    pairs = [(15, 16), (edge - 1, edge), (63, 64), (v // 2, v - 1)]
    ties = {}
    for r, (lo, hi) in enumerate(pairs[:b]):
        rows[lo] = rows[hi] = x[r] * 2
        ties[r] = lo
    return x, (rows if tied else rows.t().contiguous()), ties


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("v", [1000, 32128, 50257, 51865])
@pytest.mark.parametrize("d", [512, 768])
def test_greedy_head_matches_plain_at_each_batch(cuda, dtype, tied, v, d):
    """K4 at B in {1, 4, 8, 9, 16, 32, 64}: forced ties go to the lowest
    index (across a 16-row tile edge, two CTAs' ranges, a 64-row tile edge,
    a ragged vocab's last row); elsewhere the kernel's pick scores within
    summation noise (fp32, 1e-3) or one bf16 step of the top (bf16) of the
    plain pick; one launch per call."""
    for b in (1, 4, 8, 9, 16, 32, 64):
        x, w, ties = _greedy_case(cuda, dtype, tied, b, v, d, seed=b)
        fn, plain = (greedy_argmax_tied, greedy_argmax_tied_plain) if tied else (greedy_argmax, greedy_argmax_plain)
        launches = fn.launches
        got, ref = fn(x, w), plain(x, w)
        assert fn.launches == launches + 1 and got.dtype == torch.int64 and got.shape == (b,)
        assert {r: got[r].item() for r in ties} == ties
        s = torch.matmul(x.float(), (w.float().t() if tied else w.float()))
        if dtype == torch.bfloat16:
            s = s.to(dtype).float()
        rows = torch.arange(b, device=cuda)
        tol = 1e-3 if dtype == torch.float32 else 2.0 ** -7 * s.max(-1).values.abs()
        assert bool(((s[rows, ref] - s[rows, got]).abs() <= tol).all()), (b, got.tolist(), ref.tolist())
    torch.cuda.synchronize()


def test_greedy_head_passes_above_256_rows(cuda):
    """A batch above 256 rows takes passes of 256 (one read of the head
    each): B = 300 against the plain version, both layouts."""
    for tied in (True, False):
        x, w, ties = _greedy_case(cuda, torch.bfloat16, tied, 300, 5000, 512, seed=300)
        got = (greedy_argmax_tied if tied else greedy_argmax)(x, w)
        ref = (greedy_argmax_tied_plain if tied else greedy_argmax_plain)(x, w)
        s = torch.matmul(x.float(), (w.float().t() if tied else w.float())).to(torch.bfloat16).float()
        rows = torch.arange(300, device=cuda)
        assert {r: got[r].item() for r in ties} == ties
        assert bool(((s[rows, ref] - s[rows, got]).abs() <= 2.0 ** -7 * s.max(-1).values.abs()).all())
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_kernel_matches_plain(cuda, n_mels):
    """fp32 log10 mel power: the -inf frames of a silent stretch match
    exactly, and values the Whisper frontend keeps (>= global max - 8)
    within 2e-3 (the plain version is itself ~2e-4 from float64 here)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = 0.3 * torch.randn(3, 5 * 16000, generator=g, device=cuda)
    x[:, 20000:36000] = 0.0
    got, ref = log_mel_spectrogram(x, n_mels=n_mels), log_mel_spectrogram_plain(x, n_mels=n_mels)
    assert got.shape == (3, n_mels, 501)
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref)) and bool(torch.isneginf(ref).any())
    assert not torch.isnan(got).any() and not torch.isposinf(got).any()
    fin = torch.isfinite(ref)
    keep = fin & (ref >= ref[fin].max() - 8)
    assert (got - ref).abs()[keep].max().item() <= 2e-3
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("b", [1, 8])
def test_log_mel_kernel_at_ragged_lengths(cuda, n_mels, b):
    """K5 at a length that is no multiple of the hop (frames past the last
    96-frame tile, samples past the waveform), a silent stretch and a tone,
    B = 1 and 8: the -inf pattern equals the plain version's, kept values
    within 2e-3, and the banded plain product agrees with the dense one."""
    g = torch.Generator(device=cuda).manual_seed(20 + b)
    n = 3 * 16000 + 77
    t = torch.arange(n, device=cuda) / 16000
    x = 0.3 * torch.randn(b, n, generator=g, device=cuda) + 0.2 * torch.sin(2 * torch.pi * 440 * t)
    x[:, 16000:24000] = 0.0
    launches = log_mel_spectrogram.launches
    got, ref = log_mel_spectrogram(x, n_mels=n_mels), log_mel_spectrogram_plain(x, n_mels=n_mels)
    assert log_mel_spectrogram.launches == launches + 1 and got.shape == (b, n_mels, n // 160 + 1)
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref)) and bool(torch.isneginf(ref).any())
    assert not torch.isnan(got).any() and not torch.isposinf(got).any()
    fin = torch.isfinite(ref)
    keep = fin & (ref >= ref[fin].max() - 8)
    assert (got - ref).abs()[keep].max().item() <= 2e-3
    banded = log_mel_spectrogram_plain(x, n_mels=n_mels, banded=True)
    assert torch.equal(torch.isneginf(banded), torch.isneginf(ref))
    assert (banded - ref).abs()[fin].max().item() <= 1e-4
    torch.cuda.synchronize()


@pytest.mark.parametrize("hop", [100, 150, 161, 162, 163])
def test_log_mel_kernel_at_any_hop(cuda, hop):
    """K5 at hops that are no multiple of 4 (150, 161, 162, 163: the frames'
    A fragments by scalar loads, the span's skew odd or even) and at another
    multiple (100): the -inf pattern of a silent stretch equals the plain
    version's, kept values within 2e-3."""
    g = torch.Generator(device=cuda).manual_seed(hop)
    x = 0.3 * torch.randn(2, 2 * 16000 + 33, generator=g, device=cuda)
    x[:, 8000:20000] = 0.0
    launches = log_mel_spectrogram.launches
    got = log_mel_spectrogram(x, hop_length=hop)
    ref = log_mel_spectrogram_plain(x, hop_length=hop)
    assert log_mel_spectrogram.launches == launches + 1 and got.shape == ref.shape == (2, 80, x.shape[1] // hop + 1)
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref)) and bool(torch.isneginf(ref).any())
    assert not torch.isnan(got).any() and not torch.isposinf(got).any()
    fin = torch.isfinite(ref)
    keep = fin & (ref >= ref[fin].max() - 8)
    assert (got - ref).abs()[keep].max().item() <= 2e-3
    torch.cuda.synchronize()


def test_kernel_wrappers_reject_unsupported_input(cuda):
    q = torch.zeros(1, 1, 144, device=cuda)  # head_dim 48 with 3 heads: no kernel instantiation
    with pytest.raises(ValueError):
        decode_attention(q, torch.zeros(1, 128, 144, device=cuda), torch.zeros(1, 128, 144, device=cuda), 5, 3)
    with pytest.raises(ValueError):
        encoder_attention(q, q, q, 3)
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(4, 8, device=cuda), torch.zeros(2, device=cuda))
    wav = torch.zeros(2, 16000, device=cuda)
    with pytest.raises(ValueError):  # not fp32
        log_mel_spectrogram(wav.bfloat16())
    with pytest.raises(ValueError):  # not contiguous
        log_mel_spectrogram(torch.zeros(16000, 2, device=cuda).t())


@pytest.mark.parametrize("cached", [False, True])
def test_dispatch_raises_for_unsupported_head_dim(cuda, cached, monkeypatch):
    """A head width no kernel serves (48 here): under the auto flags the call
    runs through sdpa, matches the plain route and launches nothing, as the
    JAX package falls back; with the kernel flag forced True the wrapper
    raises instead of falling back."""
    cfg = LayerConfig.make(96, n_heads=2)
    p = mha_init(torch.Generator().manual_seed(0), cfg)
    p = {name: {k: t.to(cuda) for k, t in lin.items()} for name, lin in p.items()}
    x = torch.randn(1, 1 if cached else 9, 96, device=cuda)

    def run():
        if cached:
            cache = {"k": torch.zeros(1, 128, 96, device=cuda), "v": torch.zeros(1, 128, 96, device=cuda)}
            return mha_apply(p, cfg, x, cache=cache, cache_pos=0)[0]
        return mha_apply(p, cfg, x, causal=True)

    flag = "USE_DECODE_KERNEL" if cached else "USE_ENCODER_KERNEL"
    launched = (decode_attention.launches, encoder_attention.launches)
    got = run()
    assert (decode_attention.launches, encoder_attention.launches) == launched
    monkeypatch.setattr(_attn, flag, False)
    torch.testing.assert_close(got, run(), rtol=0, atol=0)
    monkeypatch.setattr(_attn, flag, True)
    with pytest.raises(ValueError):
        run()


@pytest.mark.parametrize("dtype,atol,rtol", K1_TOL)
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
def test_encoder_attention_matches_plain_at_each_head_width(cuda, dtype, atol, rtol, d):
    """Ragged lengths (one key, under and over a tile, Whisper's 1500), dense
    and causal, cross Lq != Lk both ways, an unbatched call, no keys at all
    (zeros), the launch count."""
    g = torch.Generator(device=cuda).manual_seed(7)
    hd = 4 * d

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    def check(q, k, v, causal):
        launches = encoder_attention.launches
        got = encoder_attention(q, k, v, 4, causal)
        assert encoder_attention.launches == launches + 1 and got.shape == q.shape and got.dtype == dtype
        _assert_k1_close(got, encoder_attention_plain(q, k, v, 4, causal), q, k, v, 4, causal, atol, rtol)

    for L in (1, 7, 63, 65, 1500):
        q, k, v = rnd(2, L, hd), rnd(2, L, hd), rnd(2, L, hd)
        for causal in (False, True):
            check(q, k, v, causal)
    for lq, lk in ((65, 300), (300, 65)):
        q, k, v = rnd(2, lq, hd), rnd(2, lk, hd), rnd(2, lk, hd)
        for causal in (False, True):
            check(q, k, v, causal)
    check(rnd(63, hd), rnd(63, hd), rnd(63, hd), True)
    empty = rnd(2, 0, hd)
    assert not encoder_attention(rnd(2, 5, hd), empty, empty, 4).any()
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,atol,rtol", K1_TOL)
@pytest.mark.parametrize("d", [32, 64])
def test_encoder_attention_fills_the_card(cuda, dtype, atol, rtol, d):
    """B * H = 256 (head, row) pairs of 512 queries: 1,024 to 2,048 blocks,
    many waves over 132 SMs (bf16 takes two m-tiles per warp at this size),
    every block's output checked."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(16, 512, 16 * d, generator=g, device=cuda).to(dtype) for _ in range(3))
    for causal in (False, True):
        _assert_k1_close(encoder_attention(q, k, v, 16, causal), encoder_attention_plain(q, k, v, 16, causal),
                         q, k, v, 16, causal, atol, rtol)
    torch.cuda.synchronize()


def test_encoder_attention_k_tile_is_the_kernels(cuda):
    from pytorch_models_tpu_torch.ops import _build

    lib = _build.load_library()
    for dt, k_tile in K_TILE.items():
        assert lib.pmt_encoder_attention_k_tile(_build.dtype_code(torch.zeros(1, dtype=dt))) == k_tile


def _step_inputs(cuda, dtype, cross: bool, b=4, d=128, n_layers=2, l_max=128, lx=96, vocab=1000):
    cfg = LayerConfig.make(d, n_heads=d // 64, cross_attn=cross)
    gen = torch.Generator().manual_seed(3)
    layers = [layer_init(gen, cfg) for _ in range(n_layers)]
    packed = {k: t.to(cuda) for k, t in pack_decode_weights(layers, dtype, cross=cross).items()}
    head = {k: t.to(cuda) for k, t in pack_greedy_head(torch.randn(vocab, d, generator=gen),
                                                       {"scale": 1 + 0.1 * torch.randn(d, generator=gen)},
                                                       dtype).items()}
    x = torch.randn(b, d, generator=gen).to(cuda, dtype)
    caches = [torch.randn(n_layers, b, l_max, d, generator=gen).to(cuda, dtype) for _ in range(2)]
    xkv = [torch.randn(n_layers, b, lx, d, generator=gen).to(cuda, dtype) for _ in range(2)]
    return cfg, packed, head, x, caches, xkv


# K7 vs its plain version, 2 layers: fp32 differs by summation order only;
# bf16 rounds at the same points, but a value summed in another order can
# land one bf16 step apart and carry that through the later layers.
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0), (torch.bfloat16, 0.05, 2.0 ** -6)])
@pytest.mark.parametrize("cross", [False, True])
def test_fused_decode_step_matches_plain(cuda, dtype, atol, rtol, cross):
    from pytorch_models_tpu_torch.ops.decode_step import fused_decode_step_plain

    cfg, packed, head, x, (kc, vc), (xk, xv) = _step_inputs(cuda, dtype, cross)
    pos, pads = 70, torch.tensor([0, 5, 70, 3], dtype=torch.int32, device=cuda)  # row 2: only pos itself
    lens = torch.tensor([96, 7, 0, 50], dtype=torch.int32, device=cuda)  # row 2: empty cross range
    kw = dict(cross_k=xk, cross_v=xv, cross_lens=lens) if cross else {}
    kc2, vc2 = kc.clone(), vc.clone()
    ref_x, ref_tok = fused_decode_step_plain(x, packed, kc2, vc2, pos, pads, cfg.n_heads, cfg.act, cfg.norm_eps,
                                             head, **kw)
    if cross:
        got_x, got_tok = fused_cross_decode_step(x, packed, kc, vc, xk, xv, lens, pos, pads, cfg.n_heads, cfg.act,
                                                 cfg.norm_eps, head=head)
    else:
        got_x, got_tok = fused_decode_step(x, packed, kc, vc, pos, pads, cfg.n_heads, cfg.act, cfg.norm_eps,
                                           head=head)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_x.float(), ref_x.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(kc[:, :, pos].float(), kc2[:, :, pos].float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(vc.float(), vc2.float(), atol=atol, rtol=rtol)
    assert (got_tok == ref_tok).float().mean().item() >= 0.75


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0), (torch.bfloat16, 0.05, 2.0 ** -6)])
def test_fused_t5_step_matches_plain(cuda, dtype, atol, rtol):
    """K7-T5: RMSNorm, GEGLU, the key-major self bias, cross-attention and
    the untied head, 2 layers, against the plain twin."""
    from pytorch_models_tpu_torch.models.text.t5 import T5Config, t5_block_init
    from pytorch_models_tpu_torch.ops.decode_step import fused_decode_step_plain

    cfg = T5Config(vocab_size=1000, dim=128, n_heads=2, n_layers=2, mlp_dim=256)
    gen = torch.Generator().manual_seed(7)
    layers = [t5_block_init(gen, cfg, True) for _ in range(2)]
    for lp in layers:
        for name in ("sa_norm", "ca_norm", "mlp_norm"):
            lp[name]["scale"] = 1 + 0.1 * torch.randn(128, generator=gen)
    packed = {k: t.to(cuda) for k, t in pack_decode_weights(layers, dtype, cross=True, gated=True).items()}
    head = {k: t.to(cuda) for k, t in pack_greedy_head(torch.randn(128, 1000, generator=gen),
                                                       {"scale": 1 + 0.1 * torch.randn(128, generator=gen)}, dtype,
                                                       tied=False).items()}
    b, pos = 4, 70
    x = torch.randn(b, 128, generator=gen).to(cuda, dtype)
    kc, vc = (torch.randn(2, b, 128, 128, generator=gen).to(cuda, dtype) for _ in range(2))
    xk, xv = (torch.randn(2, b, 128, 128, generator=gen).to(cuda, dtype) for _ in range(2))
    lens = torch.tensor([64, 7, 0, 50], dtype=torch.int32, device=cuda)
    sbias = 2.0 * torch.randn(128, 2, generator=gen).to(cuda)
    kw = dict(norm="rms", gated=True, sbias=sbias)
    kc2, vc2 = kc.clone(), vc.clone()
    ref_x, ref_tok = fused_decode_step_plain(x, packed, kc2, vc2, pos, None, 2, "approximate_gelu", 1e-5, head,
                                             xk, xv, lens, **kw)
    got_x, got_tok = fused_cross_decode_step(x, packed, kc, vc, xk, xv, lens, pos, None, 2, "approximate_gelu", 1e-5,
                                             head=head, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_x.float(), ref_x.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(kc.float(), kc2.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(vc.float(), vc2.float(), atol=atol, rtol=rtol)
    assert (got_tok == ref_tok).float().mean().item() >= 0.75


def _greedy_regret(x, tok, head, eps):
    """The plain head's score regret of ``tok`` on the kernel's own x_out:
    the final LayerNorm in fp32 rounded to x's dtype, fp32 scores (rounded
    to bf16 for a bf16 head), max score minus the score of the chosen id."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps) * head["fn_s"] + head["fn_b"])
    s = torch.matmul(xn.to(x.dtype).float(), head["emb"].float().t())
    if x.dtype == torch.bfloat16:
        s = s.to(torch.bfloat16).float()
    return (s.max(-1).values - s.gather(1, tok[:, None])[:, 0]).max().item(), s.abs().max().item()


# K7 at every batch it serves (1 to 8 rows, d 128) and at served widths (B=8, d 512 and 768, where a block's
# share spans several column vectors and the lanes split rows at every ratio they have): mixed left pads and
# cross lengths (an empty cross row from B=3 on)
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0), (torch.bfloat16, 0.05, 2.0 ** -6)])
@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("b,d", [(b, 128) for b in range(1, 9)] + [(8, 512), (8, 768)])
def test_fused_decode_step_at_each_batch_and_width(cuda, dtype, atol, rtol, cross, b, d):
    from pytorch_models_tpu_torch.ops.decode_step import fused_decode_step_plain

    cfg, packed, head, x, (kc, vc), (xk, xv) = _step_inputs(cuda, dtype, cross, b=b, d=d)
    pos = 70
    pads = torch.tensor([0, 5, 70, 3, 0, 35, 1, 17][:b], dtype=torch.int32, device=cuda)
    lens = torch.tensor([96, 7, 0, 50, 96, 1, 30, 96][:b], dtype=torch.int32, device=cuda)
    kw = dict(cross_k=xk, cross_v=xv, cross_lens=lens) if cross else {}
    kc2, vc2 = kc.clone(), vc.clone()
    ref_x, _ = fused_decode_step_plain(x, packed, kc2, vc2, pos, pads, cfg.n_heads, cfg.act, cfg.norm_eps, head, **kw)
    if cross:
        got_x, got_tok = fused_cross_decode_step(x, packed, kc, vc, xk, xv, lens, pos, pads, cfg.n_heads, cfg.act,
                                                 cfg.norm_eps, head=head)
    else:
        got_x, got_tok = fused_decode_step(x, packed, kc, vc, pos, pads, cfg.n_heads, cfg.act, cfg.norm_eps,
                                           head=head)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_x.float(), ref_x.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(kc.float(), kc2.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(vc.float(), vc2.float(), atol=atol, rtol=rtol)
    # the token is the plain head's argmax on the kernel's own x_out, up to the head's summation order
    regret, top = _greedy_regret(got_x, got_tok, head, cfg.norm_eps)
    assert regret <= (1e-4 * top if dtype == torch.float32 else 2.0 ** -5 * top)


def test_fused_decode_step_streams_a_share_larger_than_the_ring(cuda):
    """d 1024, dff 4096, fp32, B=8: fc1's and fc2's share of a block (128 KB
    each) exceeds the ring beside a 128 KB phase input, so both stream
    through it, refilled while the matvec reads; the step still equals its
    plain version."""
    from pytorch_models_tpu_torch.ops.decode_step import _Args, fused_decode_step_plain, step_plan

    cfg, packed, head, x, (kc, vc), _ = _step_inputs(cuda, torch.float32, False, b=8, d=1024)
    plan = step_plan(_Args(b=8, d=1024, hd=1024, dff=4096, n_heads=16, dtype=0))
    for m in ("fc1", "fc2"):
        kc_rows, slots, steps = plan[m]
        assert steps > slots and kc_rows < (1024 if m == "fc1" else 4096), plan
    pos, pads = 70, torch.tensor([0, 5, 70, 3, 0, 35, 1, 17], dtype=torch.int32, device=cuda)
    kc2, vc2 = kc.clone(), vc.clone()
    ref_x, _ = fused_decode_step_plain(x, packed, kc2, vc2, pos, pads, cfg.n_heads, cfg.act, cfg.norm_eps, head)
    got_x, got_tok = fused_decode_step(x, packed, kc, vc, pos, pads, cfg.n_heads, cfg.act, cfg.norm_eps, head=head)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_x, ref_x, atol=1e-4, rtol=0.0)
    torch.testing.assert_close(kc, kc2, atol=1e-4, rtol=0.0)
    torch.testing.assert_close(vc, vc2, atol=1e-4, rtol=0.0)
    regret, top = _greedy_regret(got_x, got_tok, head, cfg.norm_eps)
    assert regret <= 1e-4 * top


# (d, dff, gated) of the models whose decoders K7 serves: GPT-2 small to xl, Whisper-base, T5-base (GEGLU)
SERVED_WIDTHS = {"gpt2": (768, 3072, False), "gpt2-medium": (1024, 4096, False), "gpt2-large": (1280, 5120, False),
                 "gpt2-xl": (1600, 6400, False), "whisper-base": (512, 2048, False), "t5-base": (768, 2048, True)}


def _parent_planner_accepts(b, d, dff, itemsize, wt_int8, head_a8):
    """What the planner accepted before the weights were staged: the phase
    input (B, max(d, dff)) fp32 beside its matvec reduction buffer."""
    vec = 8 if wt_int8 else 16 // itemsize
    extra = max(16 * 8 * 4 * vec * 4, 16 * 66 * 4, 16 * 4 * 8 * 8 + (b * d if head_a8 else 0), 5504)
    extra = (extra + 255) // 256 * 256
    return b * max(d, dff) * 4 + extra + 32 <= 232448


@pytest.mark.parametrize("model", SERVED_WIDTHS)
def test_fused_step_planner_accepts_every_served_width(cuda, model):
    """Every batch 1-8 of every served width, fp32 and bf16, in every staged
    weight variant (float weights; w8a16; w8a8 with the int8 head; int8 KV
    does not enter the plan) is planned, as it was before the staging."""
    from pytorch_models_tpu_torch.ops.decode_step import _Args, _plan, step_plan

    d, dff, gated = SERVED_WIDTHS[model]
    for dtype, itemsize in ((0, 4), (1, 2)):
        for wt_int8, head_a8 in ((0, 0), (1, 0), (1, 1)):
            for b in range(1, 9):
                args = _Args(b=b, d=d, hd=d, dff=dff, n_heads=d // 64, dtype=dtype, gated=int(gated),
                             wt_int8=wt_int8, head_a8=head_a8)
                assert _parent_planner_accepts(b, d, dff, itemsize, wt_int8, head_a8)
                assert _plan(args)[0] > 0, (model, dtype, wt_int8, head_a8, b)
                plan = step_plan(args)
                assert plan["grid"] == torch.cuda.get_device_properties(0).multi_processor_count
                assert all(plan[m][0] >= 1 and plan[m][1] >= 1 for m in ("qkv", "o", "qc", "fc1", "fc2")), plan


def test_fused_decode_step_refuses_unsupported_input(cuda):
    cfg, packed, head, x, (kc, vc), _ = _step_inputs(cuda, torch.float32, False)
    with pytest.raises(ValueError):  # 9 rows: more than the kernel serves
        fused_decode_step(x.repeat(3, 1)[:9].contiguous(), packed, kc, vc, 5, None, cfg.n_heads)
    with pytest.raises(ValueError):  # head_dim 32
        fused_decode_step(x, packed, kc, vc, 5, None, 4)
    with pytest.raises(ValueError):  # bf16 x against fp32 weights
        fused_decode_step(x.bfloat16(), packed, kc, vc, 5, None, cfg.n_heads)
    with pytest.raises(ValueError):  # pos outside the cache
        fused_decode_step(x, packed, kc, vc, 128, None, cfg.n_heads)


def test_fused_step_eligible_asks_the_kernels_planner(cuda):
    """A phase input larger than a block's shared memory is refused by the
    kernel's own planner (dff 8192: 8 rows x 8192 x 4 B > 227 KiB, 1 row
    fits), and the refusal does not fail the next launch."""
    cfg = LayerConfig.make(128, n_heads=2, mlp_ratio=64.0)
    gen = torch.Generator().manual_seed(4)
    wide = [{blk: {name: {k: t.to(cuda) for k, t in leaf.items()} for name, leaf in sub.items()}
             if blk in ("sa", "mlp") else {k: t.to(cuda) for k, t in sub.items()}
             for blk, sub in layer_init(gen, cfg).items()}]
    assert fused_step_eligible(wide, cfg, 1)
    assert not fused_step_eligible(wide, cfg, 8)
    small_cfg, packed, head, x, (kc, vc), _ = _step_inputs(cuda, torch.float32, False)
    _, tok = fused_decode_step(x, packed, kc, vc, 5, None, small_cfg.n_heads, head=head)
    torch.cuda.synchronize()
    assert tok.shape == (x.shape[0],)


# K6 (int8 decode attention) vs its plain version: the int8 levels depend on
# elementwise values only (the same IEEE operations on both sides), so the
# outputs differ by the fp32 order of the softmax denominator's sum; bf16
# outputs round once at the end (one bf16 step of their value apart at most)
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-5, 2.0 ** -7)])
def test_int8_attention_matches_plain(cuda, dtype, atol, rtol):
    from pytorch_models_tpu_torch.ops.int8_kv import (
        int8_decode_attention,
        int8_decode_attention_plain,
        quantize_kv_caches,
    )

    g = torch.Generator(device=cuda).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    c = quantize_kv_caches({"k": rnd(8, 1024, 768), "v": rnd(8, 1024, 768)})
    q, cur_k, cur_v = rnd(8, 1, 768).to(dtype), rnd(8, 768).to(dtype), rnd(8, 768).to(dtype)
    ends = torch.tensor([1024, 700, 5, 64, 1, 300, 1000, 512], dtype=torch.int32, device=cuda)
    pads = torch.tensor([0, 10, 5, 0, 0, 299, 3, 100], dtype=torch.int32, device=cuda)  # row 2 empty
    bias = 2 * rnd(1024, 12)
    args = (q, c["k"], c["v"], c["ks"], c["vs"])
    for kw in ({"pad_lens": pads}, {"pad_lens": pads, "cur_k": cur_k, "cur_v": cur_v},
               {"cur_k": cur_k, "cur_v": cur_v, "bias": bias}):
        e = 700 if "bias" in kw else ends
        got = int8_decode_attention(*args, e, 12, **kw)
        torch.testing.assert_close(got.float(), int8_decode_attention_plain(*args, e, 12, **kw).float(),
                                   atol=atol, rtol=rtol)
        if "cur_k" not in kw:
            assert not got[2].any()  # empty [pad, end) row


ATTN_TOL = [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-5, 2.0 ** -7)]


def _mixed_ranges(g, b, l_max, dev):
    """Per-row [pad, end): random, with a full row 0, an empty row 1 and a
    one-key row 2."""
    ends = torch.randint(1, l_max + 1, (b,), generator=g, device=dev, dtype=torch.int32)
    pads = (torch.rand(b, generator=g, device=dev) * ends).to(torch.int32)
    ends[:3] = torch.tensor([l_max, l_max // 2, l_max // 3 + 1], dtype=torch.int32)
    pads[:3] = torch.tensor([0, l_max // 2, l_max // 3], dtype=torch.int32)
    return ends, pads


def _jump(k, q, ends, scale=40.0):
    """Row 0's last key scores far above every other: the running max jumps in
    the row's last block, its last CTA."""
    k[0, int(ends[0]) - 1] = scale * q[0, 0].to(k.dtype)


# the cluster size the launch picks depends on the grid and the cache length only: B rows of one head at
# B = ceil(waves * 132 / size) make the rule pick each size from 1 to 8 (K6 fills four waves of the 132 SMs,
# K2 two)
@pytest.mark.parametrize("dtype,atol,rtol", ATTN_TOL)
@pytest.mark.parametrize("cs", range(1, 9))
def test_int8_attention_at_each_cluster_size(cuda, dtype, atol, rtol, cs):
    from pytorch_models_tpu_torch.ops.int8_kv import (
        int8_decode_attention,
        int8_decode_attention_cluster,
        int8_decode_attention_plain,
        quantize_kv_caches,
    )

    g = torch.Generator(device=cuda).manual_seed(cs)
    b, l_k = -(-528 // cs), 2 * 128 * cs  # two blocks per CTA
    assert int8_decode_attention_cluster(b, l_k, 1) == cs
    q = torch.randn(b, 1, 64, generator=g, device=cuda)
    k, v = torch.randn(b, l_k, 64, generator=g, device=cuda), torch.randn(b, l_k, 64, generator=g, device=cuda)
    ends, pads = _mixed_ranges(g, b, l_k, cuda)
    _jump(k, q, ends)
    c = quantize_kv_caches({"k": k, "v": v})
    cur_k, cur_v = (torch.randn(b, 64, generator=g, device=cuda).to(dtype) for _ in range(2))
    bias = 2 * torch.randn(l_k, 1, generator=g, device=cuda)
    args = (q.to(dtype), c["k"], c["v"], c["ks"], c["vs"])
    for e, kw in ((ends, {"pad_lens": pads}), (ends, {"pad_lens": pads, "cur_k": cur_k, "cur_v": cur_v}),
                  (l_k - 1, {"cur_k": cur_k, "cur_v": cur_v, "bias": bias})):
        got = int8_decode_attention(*args, e, 1, **kw)
        torch.testing.assert_close(got.float(), int8_decode_attention_plain(*args, e, 1, **kw).float(),
                                   atol=atol, rtol=rtol)
        if "cur_k" not in kw:
            assert not got[1].any()  # empty [pad, end) row
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,atol,rtol", ATTN_TOL)
def test_int8_attention_over_several_rounds(cuda, dtype, atol, rtol):
    """One (row, head) over 64 blocks: a cluster of 8 walks four rounds of 16
    blocks, rank 0 carrying the running max; a jump in the last round, and
    Whisper-base's cross shape (B=8, H=8, 1500 of 1536)."""
    from pytorch_models_tpu_torch.ops.int8_kv import (
        int8_decode_attention,
        int8_decode_attention_cluster,
        int8_decode_attention_plain,
        quantize_kv_caches,
    )

    g = torch.Generator(device=cuda).manual_seed(11)
    for b, n_heads, l_k, ends in ((2, 1, 8192, torch.tensor([8192, 8000], dtype=torch.int32, device=cuda)),
                                  (8, 8, 1536, torch.tensor([1500, 1500, 7, 1500, 1200, 0, 300, 1500],
                                                            dtype=torch.int32, device=cuda))):
        q = torch.randn(b, 1, n_heads * 64, generator=g, device=cuda)
        k = torch.randn(b, l_k, n_heads * 64, generator=g, device=cuda)
        v = torch.randn(b, l_k, n_heads * 64, generator=g, device=cuda)
        _jump(k, q, ends)
        c = quantize_kv_caches({"k": k, "v": v})
        args = (q.to(dtype), c["k"], c["v"], c["ks"], c["vs"], ends, n_heads)
        assert int8_decode_attention_cluster(b, l_k, n_heads) > 1
        torch.testing.assert_close(int8_decode_attention(*args).float(), int8_decode_attention_plain(*args).float(),
                                   atol=atol, rtol=rtol)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,atol,rtol", ATTN_TOL)
@pytest.mark.parametrize("cs", range(1, 9))
def test_decode_attention_at_each_cluster_size(cuda, dtype, atol, rtol, cs):
    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention_cluster

    g = torch.Generator(device=cuda).manual_seed(20 + cs)
    b, l_max = -(-264 // cs), 256 * cs + 100  # a cache length off the tile grid
    assert decode_attention_cluster(b, l_max, 1) == cs
    q, k, v = (torch.randn(b, n, 64, generator=g, device=cuda) for n in (1, l_max, l_max))
    ends, pads = _mixed_ranges(g, b, l_max, cuda)
    _jump(k, q, ends, scale=8.0)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    bias = 3.0 * torch.randn(b, l_max, 1, generator=g, device=cuda)
    for kw in ({}, {"bias": bias}):
        got = decode_attention(q, k, v, ends, 1, pads, **kw)
        torch.testing.assert_close(got.float(), decode_attention_plain(q, k, v, ends, 1, pads, **kw).float(),
                                   rtol=rtol, atol=atol)
        assert not got[1].any()  # empty [pad, end) row
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,atol,rtol", ATTN_TOL)
def test_decode_attention_at_batch_32(cuda, dtype, atol, rtol):
    """GPT-2's per-op decode at B=32 (H=12, cache 1024): one CTA per (row,
    head), with and without a per-row bias; and a max jump."""
    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention_cluster

    g = torch.Generator(device=cuda).manual_seed(32)
    q, k, v = (torch.randn(32, n, 768, generator=g, device=cuda) for n in (1, 1024, 1024))
    ends, pads = _mixed_ranges(g, 32, 1024, cuda)
    _jump(k, q, ends, scale=8.0)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    assert decode_attention_cluster(32, 1024, 12) == 1
    bias = 3.0 * torch.randn(32, 1024, 12, generator=g, device=cuda)
    for kw in ({}, {"bias": bias}):
        got = decode_attention(q, k, v, ends, 12, pads, **kw)
        torch.testing.assert_close(got.float(), decode_attention_plain(q, k, v, ends, 12, pads, **kw).float(),
                                   rtol=rtol, atol=atol)
        assert not got[1].any()
    torch.cuda.synchronize()


def _int8_step_inputs(dev, dtype, kind, a8):
    """2 layers at d 128 (2 heads of 64), int8 weights, B=4, int8 self caches
    of 256 keys (and int8 cross caches, Whisper / T5), for K7's variants."""
    from pytorch_models_tpu_torch.models.text.t5 import T5Config, t5_block_init
    from pytorch_models_tpu_torch.ops.int8_kv import quantize_kv_caches
    from pytorch_models_tpu_torch.utils import quantize_tree_int8

    gen = torch.Generator().manual_seed(11)
    t5 = kind == "t5"
    if t5:
        cfg = LayerConfig(128, 2, 64, bias=False, act="approximate_gelu")
        layers = [t5_block_init(gen, T5Config(1000, 128, 2, 2, 256), True) for _ in range(2)]
    else:
        cfg = LayerConfig.make(128, n_heads=2, cross_attn=kind == "whisper",
                               act="gelu" if kind == "whisper" else "approximate_gelu")
        layers = [layer_init(gen, cfg) for _ in range(2)]
    packed = pack_decode_weights(quantize_tree_int8(layers), dtype, cross=kind != "gpt2", gated=t5)
    w_head = torch.randn(128, 1000, generator=gen) if t5 else torch.randn(1000, 128, generator=gen)
    head = pack_greedy_head(w_head, {"scale": 1 + 0.1 * torch.randn(128, generator=gen)}, dtype, tied=not t5, a8=a8)
    b = 4
    x = torch.randn(b, 128, generator=gen).to(dtype)
    self_c = quantize_kv_caches({"k": torch.randn(2, b, 256, 128, generator=gen),
                                 "v": torch.randn(2, b, 256, 128, generator=gen)})
    cross_c = quantize_kv_caches({"k": torch.randn(2, b, 256, 128, generator=gen),
                                  "v": torch.randn(2, b, 256, 128, generator=gen)})
    sbias = 2.0 * torch.randn(256, 2, generator=gen) if t5 else None
    move = lambda d: {k: t.to(dev) for k, t in d.items()}  # noqa: E731
    sbias = None if sbias is None else sbias.to(dev)
    return cfg, move(packed), move(head), x.to(dev), move(self_c), move(cross_c), sbias


# K7's int8 variants vs the plain twin, 2 layers. fp32: the projections sum
# in other orders (1e-7 relative), which can move a value across an int8
# rounding boundary: a q or probability level may then differ by one step,
# moving a context value by about 1/127 of its head's scale; the K/V written
# at pos are held to one int8 level at most, on at least 99% of the values
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 5e-3, 5e-3), (torch.bfloat16, 0.05, 2.0 ** -6)])
@pytest.mark.parametrize("kind,a8", [("gpt2", False), ("gpt2", True), ("whisper", False), ("t5", True)])
def test_fused_step_int8_variants_match_plain(cuda, dtype, atol, rtol, kind, a8):
    from pytorch_models_tpu_torch.ops.decode_step import fused_decode_step_plain

    cfg, packed, head, x, sc, xc, sbias = _int8_step_inputs(cuda, dtype, kind, a8)
    pos = 200
    pads = None if kind == "t5" else torch.tensor([0, 5, 200, 130], dtype=torch.int32, device=cuda)
    lens = torch.tensor([256, 7, 0, 130], dtype=torch.int32, device=cuda)  # row 2: empty cross range
    kws = {"ks": sc["ks"], "vs": sc["vs"]}
    ref_c = {k: t.clone() for k, t in sc.items()}
    common = dict(a8=a8, kv_scales=kws)
    variant = {}
    if kind != "gpt2":
        variant = dict(cross_k=xc["k"], cross_v=xc["v"], cross_lens=lens, kv_scales_x={"ks": xc["ks"], "vs": xc["vs"]})
    if kind == "t5":
        variant.update(norm="rms", gated=True, sbias=sbias)
    ref_x, ref_tok = fused_decode_step_plain(x, packed, ref_c["k"], ref_c["v"], pos, pads, 2, cfg.act, 1e-5, head,
                                             **variant, a8=a8, kv_scales={"ks": ref_c["ks"], "vs": ref_c["vs"]})
    if kind == "gpt2":
        got_x, got_tok = fused_decode_step(x, packed, sc["k"], sc["v"], pos, pads, 2, cfg.act, 1e-5, head=head,
                                           **common)
    else:
        v = dict(variant)
        xk, xv, xl = v.pop("cross_k"), v.pop("cross_v"), v.pop("cross_lens")
        got_x, got_tok = fused_cross_decode_step(x, packed, sc["k"], sc["v"], xk, xv, xl, pos, pads, 2, cfg.act, 1e-5,
                                                 head=head, **v, **common)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_x.float(), ref_x.float(), atol=atol, rtol=rtol)
    for key in ("k", "v"):
        d = (sc[key][:, :, pos].int() - ref_c[key][:, :, pos].int()).abs()
        assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.99
        assert torch.equal(sc[key][:, :, :pos], ref_c[key][:, :, :pos])  # nothing else written
    assert (got_tok == ref_tok).float().mean().item() >= 0.75


def test_fused_step_embed_phase_equals_gathered_input(cuda):
    """The embed phase is bit-identical to taking x = tok[id] + pos[p] from
    outside (the same rounding of the fp32 sum), ids clamped."""
    cfg, packed, head, _, (kc, vc), _ = _step_inputs(cuda, torch.bfloat16, False)
    from pytorch_models_tpu_torch.ops.decode_step import pack_embed_tables

    g = torch.Generator(device=cuda).manual_seed(3)
    tok, pos_tab = (torch.randn(n, 128, generator=g, device=cuda).to(torch.bfloat16) for n in (1000, 128))
    ids = torch.tensor([3, 999, 5000, -2], device=cuda)
    prow = torch.tensor([70, 69, 0, 5], device=cuda)
    x = tok[ids.clamp(0, 999)] + pos_tab[prow]
    ref = fused_decode_step(x, packed, kc.clone(), vc.clone(), 70, None, cfg.n_heads, cfg.act, head=head)
    got = fused_decode_step(None, packed, kc.clone(), vc.clone(), 70, None, cfg.n_heads, cfg.act, head=head,
                            emb=pack_embed_tables(tok, pos_tab), tok_ids=ids, pos_rows=prow)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("pool,cls", [("cls_token", True), ("mha", False)])
def test_vit_k1_route_matches_sdpa_route(cuda, pool, cls):
    """ViT at ViT-B/16's width (2 layers) in fp32: the auto gate sends every
    self-attention (B, 197, 12 x 64) and the SigLIP probe (1 query over 196
    keys) to K1, whose features match the SDPA route's to fp32 noise over the
    stack (3xTF32 products, other summation orders: chip_smoke.py's DS_TOL)."""
    from pytorch_models_tpu_torch.image import ViT

    model = ViT(2, 768, 12, 16, cls_token=cls, pool_type=pool, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    for key in ("pe", "cls_token"):
        if key in model.params:
            model.params[key] = 0.02 * torch.randn(model.params[key].shape, generator=g, device=cuda)
    x = torch.randn(4, 3, 224, 224, generator=g, device=cuda)
    saved = _attn.USE_ENCODER_KERNEL
    try:
        _attn.USE_ENCODER_KERNEL = False
        ref = model(x)
        _attn.USE_ENCODER_KERNEL = None
        before = encoder_attention.launches
        got = model(x)
        torch.cuda.synchronize()
    finally:
        _attn.USE_ENCODER_KERNEL = saved
    assert encoder_attention.launches - before == 2 + (pool == "mha")
    assert got.shape == (4, 768)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
