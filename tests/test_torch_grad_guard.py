"""No kernel of the port has a backward (nor has the JAX package a backward
kernel), so no kernel may silently drop a gradient: every wrapper raises on
a CUDA input that autograd would differentiate, and the auto gates send
such inputs to the plain path, which autograd differentiates.

The gate rule runs here on the CPU with the device test forced true
(``attention._on_cuda``); the wrappers' refusal is marked ``cuda`` (a CUDA
kernel has no CPU mode) and skips without a GPU. The train step's leaves
all get gradients (``tests/test_torch_parallel_train.py``).
"""

import pytest
import torch

from pytorch_models_tpu_torch.ops import _build, gather
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.transformer import LayerConfig, mha_apply, mha_init


def test_needs_grad_is_grad_mode_and_a_float_input_that_requires_grad():
    w = torch.ones(3, requires_grad=True)
    assert _build.needs_grad(torch.ones(3), w, None)
    assert not _build.needs_grad(torch.ones(3), None, torch.arange(3))
    with torch.no_grad():
        assert not _build.needs_grad(w)
    with torch.inference_mode():
        assert not _build.needs_grad(torch.ones(3))


@pytest.fixture
def on_card(monkeypatch):
    """The gates' device test forced true: their shape and grad rules run on CPU tensors."""
    monkeypatch.setattr(attn, "_on_cuda", lambda t: True)


@pytest.mark.parametrize("grad", [False, True])
def test_auto_gates_refuse_inputs_that_require_grad(on_card, grad):
    q = torch.zeros(2, 5, 4 * 64, requires_grad=grad)
    kv = torch.zeros(2, 5, 4 * 64)
    assert attn.use_encoder_kernel(q, 4, None, kv, kv) is not grad
    assert attn.use_decode_kernel(kv, 4, q[:, :1], kv) is not grad
    assert attn.use_fused_step(q) is not grad
    head = torch.zeros(16, 64, requires_grad=grad)
    assert attn.use_greedy_head(8, head, tied=True) is not grad
    assert gather._plain(head) is grad
    with torch.no_grad():  # grad mode off: a parameter that requires grad takes the kernel
        assert attn.use_encoder_kernel(q, 4, None, kv, kv) and gather._plain(head) is False


def test_forced_flags_still_reach_the_wrapper(on_card, monkeypatch):
    q = torch.zeros(2, 5, 4 * 64, requires_grad=True)
    monkeypatch.setattr(attn, "USE_ENCODER_KERNEL", True)
    monkeypatch.setattr(attn, "USE_DECODE_KERNEL", True)
    monkeypatch.setattr(gather, "USE_GATHER_KERNEL", True)
    assert attn.use_encoder_kernel(q, 4) and attn.use_decode_kernel(q, 4, q)
    assert not gather._plain(q)


def test_attention_differentiates_under_autograd():
    """The training forward's attention (uncached, causal) gives q/k/v
    weights their gradients."""
    cfg = LayerConfig.make(64, n_heads=2)
    p = mha_init(torch.Generator().manual_seed(0), cfg)
    for lin in p.values():
        lin["w"].requires_grad_()
    mha_apply(p, cfg, torch.randn(2, 6, 64), causal=True).square().sum().backward()
    assert all(float(lin["w"].grad.abs().max()) > 0 for lin in p.values())


@pytest.mark.cuda
def test_every_kernel_wrapper_raises_on_an_input_that_requires_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from pytorch_models_tpu_torch.ops.decode_attention import decode_attention
    from pytorch_models_tpu_torch.ops.decode_step import fused_cross_decode_step, fused_decode_step
    from pytorch_models_tpu_torch.ops.encoder_attention import encoder_attention
    from pytorch_models_tpu_torch.ops.gather import embed_add, gather_rows
    from pytorch_models_tpu_torch.ops.greedy_head import greedy_argmax, greedy_argmax_tied
    from pytorch_models_tpu_torch.ops.int8_kv import int8_decode_attention
    from pytorch_models_tpu_torch.ops.mel import log_mel_spectrogram

    dev = "cuda"
    g = torch.zeros(2, 1, 128, device=dev, requires_grad=True)
    cache = torch.zeros(2, 128, 128, device=dev)
    i8 = torch.zeros(2, 128, 128, dtype=torch.int8, device=dev)
    sc = torch.zeros(2, 128, device=dev)
    ids = torch.zeros(2, dtype=torch.int64, device=dev)
    table = torch.zeros(16, 128, device=dev, requires_grad=True)
    layers = torch.zeros(1, 2, 128, 128, device=dev)
    kv = cache[:, :4].contiguous()
    calls = {
        "K1 encoder_attention": lambda: encoder_attention(g.expand(2, 4, 128).contiguous(), kv, kv, 2),
        "K2 decode_attention": lambda: decode_attention(g, cache, cache, 5, 2),
        "K3 gather_rows": lambda: gather_rows(table, ids),
        "K3 embed_add": lambda: embed_add(table, ids, table, ids),
        "K4 greedy_argmax_tied": lambda: greedy_argmax_tied(g[:, 0], table),
        "K4 greedy_argmax": lambda: greedy_argmax(g[:, 0], table.t()),
        "K5 log_mel_spectrogram": lambda: log_mel_spectrogram(torch.zeros(1, 16000, device=dev, requires_grad=True)),
        "K6 int8_decode_attention": lambda: int8_decode_attention(g, i8, i8, sc, sc, 5, 2),
        "K7 fused_decode_step": lambda: fused_decode_step(g[:, 0], {}, layers, layers, 5, None, 2),
        "K7 fused_cross_decode_step": lambda: fused_cross_decode_step(g[:, 0], {}, layers, layers, layers, layers,
                                                                      ids, 5, None, 2),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():  # the same call passes the guard (on to the wrapper's own checks or the kernel)
            try:
                call()
            except Exception as e:  # noqa: BLE001  (shape checks of these dummy inputs may refuse them)
                assert "no backward" not in str(e), name
