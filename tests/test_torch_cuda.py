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


def test_kernel_wrappers_reject_unsupported_input(cuda):
    q = torch.zeros(1, 1, 96, device=cuda)  # head_dim 32 with 3 heads: no kernel instantiation
    with pytest.raises(ValueError):
        decode_attention(q, torch.zeros(1, 128, 96, device=cuda), torch.zeros(1, 128, 96, device=cuda), 5, 3)
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(4, 8, device=cuda), torch.zeros(2, device=cuda))


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
