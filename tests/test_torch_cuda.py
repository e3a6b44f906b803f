"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips. This file
imports neither JAX nor the JAX package, so on a machine without JAX it runs
with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import pytest
import torch

from pytorch_models_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention, encoder_attention_plain
from pytorch_models_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax_tied
from pytorch_models_tpu_torch.ops.mel import log_mel_spectrogram, log_mel_spectrogram_plain
from pytorch_models_tpu_torch.transformer import LayerConfig, mha_apply, mha_init

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
