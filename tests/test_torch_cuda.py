"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips. This file
imports neither JAX nor the JAX package, so on a machine without JAX it runs
with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import pytest
import torch

from pytorch_models_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from pytorch_models_tpu_torch.ops.decode_step import (
    fused_cross_decode_step,
    fused_decode_step,
    fused_step_eligible,
    pack_decode_weights,
    pack_greedy_head,
)
from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention, encoder_attention_plain
from pytorch_models_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax_tied
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


# kernel vs plain on the same inputs: fp32 differs by summation order only
# (readings on an H100: 5.96e-7 encoder, 2.98e-7 decode attention); both bf16
# paths keep fp32 inside and round once, so an output may land one bf16 step
# of its own value (2^-7 relative at most) apart (readings: 1.95e-3 encoder,
# 3.8e-6 decode attention)
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-5, 2.0 ** -7)])
def test_kernels_match_plain(cuda, dtype, atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    q, k, v = rnd(2, 197, 768), rnd(2, 197, 768), rnd(2, 197, 768)
    for causal in (False, True):
        got, ref = encoder_attention(q, k, v, 12, causal), encoder_attention_plain(q, k, v, 12, causal)
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)

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


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-5, 2.0 ** -7)])
def test_attention_kernels_at_whisper_shapes(cuda, dtype, atol, rtol):
    """K1 with Lq != Lk (teacher-forced cross-attention) and at the
    encoder's L=1500; K2 over a 1536-slot cross cache with per-row ends."""
    g = torch.Generator(device=cuda).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    k, v = rnd(2, 1500, 512), rnd(2, 1500, 512)
    for q in (rnd(2, 448, 512), rnd(2, 1500, 512)):
        torch.testing.assert_close(encoder_attention(q, k, v, 8).float(), encoder_attention_plain(q, k, v, 8).float(),
                                   rtol=rtol, atol=atol)
    q1, kc, vc = rnd(4, 1, 512), rnd(4, 1536, 512), rnd(4, 1536, 512)
    ends = torch.tensor([1500, 1500, 7, 1536], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(decode_attention(q1, kc, vc, ends, 8).float(),
                               decode_attention_plain(q1, kc, vc, ends, 8).float(), rtol=rtol, atol=atol)
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


def test_kernel_wrappers_reject_unsupported_input(cuda):
    q = torch.zeros(1, 1, 96, device=cuda)  # head_dim 32 with 3 heads: no kernel instantiation
    with pytest.raises(ValueError):
        decode_attention(q, torch.zeros(1, 128, 96, device=cuda), torch.zeros(1, 128, 96, device=cuda), 5, 3)
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(4, 8, device=cuda), torch.zeros(2, device=cuda))
    wav = torch.zeros(2, 16000, device=cuda)
    with pytest.raises(ValueError):  # not fp32
        log_mel_spectrogram(wav.bfloat16())
    with pytest.raises(ValueError):  # not contiguous
        log_mel_spectrogram(torch.zeros(16000, 2, device=cuda).t())


@pytest.mark.parametrize("cached", [False, True])
def test_dispatch_raises_for_unsupported_head_dim(cuda, cached):
    """Auto dispatch on a CUDA tensor never falls back to plain attention: a
    head dim the kernels do not serve (32 here) raises in the wrapper."""
    cfg = LayerConfig.make(64, n_heads=2)
    p = mha_init(torch.Generator().manual_seed(0), cfg)
    p = {name: {k: t.to(cuda) for k, t in lin.items()} for name, lin in p.items()}
    x = torch.randn(1, 1, 64, device=cuda)
    with pytest.raises(ValueError):
        if cached:
            cache = {"k": torch.zeros(1, 128, 64, device=cuda), "v": torch.zeros(1, 128, 64, device=cuda)}
            mha_apply(p, cfg, x, cache=cache, cache_pos=0)
        else:
            mha_apply(p, cfg, x, causal=True)


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
