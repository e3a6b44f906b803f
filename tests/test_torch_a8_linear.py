"""w8a8 linears (``ops.layers.USE_A8_LINEAR``) in the PyTorch port vs the
JAX package, on the CPU.

The int8 x int8 -> int32 product is exact, and every other step (the
per-row absmax, the scale ``where(absmax == 0, 1, absmax) * (1 / 127)``,
round half to even, the fp32 rescale, the bf16 cast, the bf16 bias add) is
one elementwise IEEE operation in both packages: the port's ``linear`` must
equal JAX's bit for bit, on 2-D and 3-D inputs, with a zero row, with and
without a bias. The padded product the card takes (more than 16 rows, sizes
a multiple of 8) is held to the plain one here. Model level: a small ViT
and a small wav2vec2 under w8a8 stay within the JAX package's bounds of
their own bf16 forward (``tests/ops/test_a8_linear.py``: max relative 8e-2,
row cosine > 0.99).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_models_tpu.ops import layers as jax_layers
from pytorch_models_tpu.utils.params import quantize_tree_int8 as jax_quantize_tree_int8
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.ops import layers
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)


@pytest.fixture()
def a8():
    assert layers.USE_A8_LINEAR is False and jax_layers.USE_A8_LINEAR is False  # off by default
    layers.USE_A8_LINEAR = jax_layers.USE_A8_LINEAR = True
    yield
    layers.USE_A8_LINEAR = jax_layers.USE_A8_LINEAR = False


def _quantized(r, d: int, out: int, bias: bool) -> dict:
    p = {"w": jnp.asarray(r.standard_normal((d, out)) / np.sqrt(d), jnp.float32)}
    if bias:
        p["b"] = jnp.asarray(0.1 * r.standard_normal(out), jnp.float32)
    return jax_quantize_tree_int8({"fc1": p})["fc1"]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(8, 128), (2, 5, 128), (3, 24)])
def test_linear_matches_jax_bit_for_bit(a8, shape, dtype, bias):
    r = np.random.default_rng(251)
    d = shape[-1]
    qp = _quantized(r, d, 40, bias)
    x = r.standard_normal(shape).astype(np.float32)
    x[(0,) * (len(shape) - 1)] = 0.0  # a zero row: its scale is 1 / 127, its output the bias
    xj = jnp.asarray(x, dtype)
    expected = np.asarray(jax_layers.linear(qp, xj), np.float32)
    got = layers.linear(from_jax_params(jax.tree.map(to_np, qp)), torch.from_numpy(np.array(xj, np.float32))
                        .to(getattr(torch, dtype)))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == expected.shape
    np.testing.assert_array_equal(got.float().numpy(), expected)


def test_linear_writes_out(a8):
    r = np.random.default_rng(252)
    qp = from_jax_params(jax.tree.map(to_np, _quantized(r, 64, 32, True)))
    x = torch.from_numpy(r.standard_normal((4, 64)).astype(np.float32))
    out = torch.empty(4, 32, dtype=torch.bfloat16)
    assert layers.linear(qp, x, out=out) is out
    assert torch.equal(out, layers.linear(qp, x))


def test_off_by_default_dequantizes():
    """Flag off: an int8 linear multiplies by ``w_q.bf16 * w_s.bf16`` in
    bf16 (w8a16), which the flag changes."""
    r = np.random.default_rng(253)
    qp = from_jax_params(jax.tree.map(to_np, _quantized(r, 64, 32, True)))
    x = torch.from_numpy(r.standard_normal((4, 64)).astype(np.float32))
    assert layers.USE_A8_LINEAR is False
    w16 = layers.linear(qp, x)
    dense = {"w": qp["w"]["w_q"].to(torch.bfloat16) * qp["w"]["w_s"].to(torch.bfloat16), "b": qp["b"]}
    assert torch.equal(w16, layers.linear(dense, x))
    layers.USE_A8_LINEAR = True
    try:
        assert not torch.equal(layers.linear(qp, x), w16)
    finally:
        layers.USE_A8_LINEAR = False


@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (16, 64, 32), (17, 64, 32), (40, 768, 3072), (5, 12, 20),
                                   (3, 7, 9)])
def test_padded_product_equals_plain(m, k, n):
    """The card's operand layout: rows padded to 17 and more, K and N to
    multiples of 8, the right operand column-major; the plain product here."""
    g = torch.Generator().manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    got = layers._int_mm_padded(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, a.int() @ b.int())


def _within_bounds(a8_out: torch.Tensor, base: torch.Tensor) -> None:
    a, b = a8_out.float().reshape(-1, a8_out.shape[-1]), base.float().reshape(-1, base.shape[-1])
    rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1.0)
    assert rel < 8e-2, rel
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    assert cos.min().item() > 0.99, cos.min().item()


def test_vit_end_to_end_within_bounds():
    """ViT-Ti/16 at 224, bf16 params, every projection, MLP and the head
    through the int8 product."""
    from pytorch_models_tpu_torch.image import ViT

    model = ViT.from_google("Ti/16_augreg", device="cpu").to_bf16()
    x = torch.from_numpy(np.random.default_rng(254).standard_normal((2, 3, 224, 224)).astype(np.float32) * 0.5)
    base = model(x.to(torch.bfloat16))
    model.quantize_int8()
    layers.USE_A8_LINEAR = True
    try:
        got = model(x.to(torch.bfloat16))
    finally:
        layers.USE_A8_LINEAR = False
    _within_bounds(got, base)


def test_wav2vec2_end_to_end_within_bounds():
    """A 2-layer wav2vec2 (d 64) in bf16: the projection, attention and MLP
    linears through the int8 product (the stem and PE convs keep bf16)."""
    from pytorch_models_tpu_torch.audio import Wav2Vec2

    model = Wav2Vec2(2, 64, device="cpu").to_bf16()
    x = torch.from_numpy(np.random.default_rng(255).standard_normal((2, 4000)).astype(np.float32))
    base = model(x)
    model.quantize_int8()
    assert layers.linear_dtype(model.params["encoder"]["layers"][0]["sa"]["q"]) == torch.bfloat16
    layers.USE_A8_LINEAR = True
    try:
        got = model(x)
    finally:
        layers.USE_A8_LINEAR = False
    assert got.shape == base.shape
    _within_bounds(got, base)
