"""EnCodec through the PyTorch port vs the JAX package, on the CPU.

Both variants are built from ONE synthetic facebookresearch/encodec
checkpoint (made by the JAX package's own test helper) through both
converters: the port's params equal the JAX params carried across by
``from_jax_params`` bit for bit (weight norm reversed in numpy on both
sides, transposed-conv kernels pre-flipped), the codes of every quantizer
level are identical to JAX's and the reconstruction is within PARITY.md's
row 27, 1e-4 (fp32 on both sides, summed in other orders). Also: the
``n_quantizers`` truncation, the residual LSTM, ``group_norm`` and the
transposed conv alone, the JAX init carried across, and reflect padding
where a pad reaches past the signal (``jnp.pad`` reflects again; torch's
``F.pad`` would refuse), alone and through a whole encode of a short clip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.audio.encodec as jax_encodec
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.models.audio import encodec
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.audio.test_encodec import _make_fb_encodec_sd
from tests.test_torch_audio import _shapes
from tests.test_torch_image_families import _assert_trees_equal

torch.set_num_threads(1)

RECON_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(to_np, tree)


def _pair(variant: str, seed: int = 91):
    sd = _make_fb_encodec_sd(np.random.default_rng(seed), variant)
    ref = jax_encodec.EnCodec.from_facebook(variant)
    ref.load_facebook_state_dict({k: v.copy() for k, v in sd.items()})
    ours = encodec.EnCodec.from_facebook(variant, device="cpu")
    ours.load_facebook_state_dict({k: v.copy() for k, v in sd.items()})
    return ref, ours


def _clip(variant: str, b: int, n: int, seed: int) -> np.ndarray:
    ch = 1 if variant == "24khz" else 2
    return (0.5 * np.random.default_rng(seed).standard_normal((b, ch, n))).astype(np.float32)


def _roundtrip(ref, ours, x, n_quantizers=None):
    ref_codes, ref_scale = ref.encode(x, n_quantizers)
    codes, scale = ours.encode(x, n_quantizers)
    assert codes.dtype == torch.int64 and tuple(codes.shape) == np.asarray(ref_codes).shape
    assert np.array_equal(codes.numpy(), np.asarray(ref_codes)), "codes must match exactly"
    assert (scale is None) == (ref_scale is None)
    if scale is not None:
        np.testing.assert_allclose(scale.numpy(), np.asarray(ref_scale), rtol=1e-6)
    expected = np.asarray(ref.decode(ref_codes, ref_scale))
    got = ours.decode(codes, scale)
    assert tuple(got.shape) == expected.shape
    assert np.abs(got.numpy() - expected).max() < RECON_TOL
    return codes


@pytest.mark.parametrize("variant", ["24khz", "48khz"])
def test_roundtrip_matches_jax(variant):
    ref, ours = _pair(variant)
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    _assert_trees_equal(ours.params, from_jax_params(_np_tree(ref.params)))
    codes = _roundtrip(ref, ours, _clip(variant, 2, 2400, 93))
    assert codes.shape[1] == ref.cfg.n_quantizers


def test_n_quantizers_truncates():
    ref, ours = _pair("24khz", 92)
    codes = _roundtrip(ref, ours, _clip("24khz", 1, 2400, 94), n_quantizers=4)
    assert codes.shape[:2] == (1, 4)
    full, _ = ours.encode(_clip("24khz", 1, 2400, 94))
    assert torch.equal(full[:, :4], codes)  # the first levels do not depend on how many follow


@pytest.mark.parametrize("variant", ["24khz", "48khz"])
def test_clip_short_enough_to_reflect_past_its_length(variant):
    """320 samples leave 8 frames before the last downsample (stride 8,
    kernel 16), whose reflect pad of 8 reaches past them: jnp.pad reflects
    again, and so does the port."""
    ref, ours = _pair(variant, 95)
    _roundtrip(ref, ours, _clip(variant, 2, 320, 96))


@pytest.mark.parametrize("length,kernel,stride,causal", [(5, 16, 8, True), (3, 7, 1, False), (1, 4, 2, True),
                                                        (8, 16, 8, False), (40, 10, 5, True)])
def test_pad1d_matches_jax_past_the_signal(length, kernel, stride, causal):
    x = np.random.default_rng(97).standard_normal((2, length, 3)).astype(np.float32)
    expected = np.asarray(jax_encodec.pad1d(jnp.asarray(x), kernel, stride, causal))
    got = encodec.pad1d(torch.from_numpy(x), kernel, stride, causal)
    np.testing.assert_array_equal(got.numpy(), expected)


def test_lstm_matches_jax():
    r = np.random.default_rng(98)
    dim = 64
    layers = [{"w_ih": (0.2 * r.standard_normal((dim, 4 * dim))).astype(np.float32),
               "w_hh": (0.2 * r.standard_normal((dim, 4 * dim))).astype(np.float32),
               "b": (0.2 * r.standard_normal(4 * dim)).astype(np.float32)} for _ in range(2)]
    x = r.standard_normal((2, 17, dim)).astype(np.float32)
    expected = np.asarray(jax_encodec.lstm_apply(jax.tree.map(jnp.asarray, layers), jnp.asarray(x)))
    got = encodec.lstm_apply(from_jax_params(layers), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expected, atol=2e-6, rtol=0)


def test_group_norm_matches_jax():
    r = np.random.default_rng(99)
    x = (2 + 3 * r.standard_normal((2, 30, 16))).astype(np.float32)
    p = {"scale": (1 + 0.1 * r.standard_normal(16)).astype(np.float32),
         "bias": (0.1 * r.standard_normal(16)).astype(np.float32)}
    expected = np.asarray(jax_encodec.group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = encodec.group_norm(from_jax_params(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expected, atol=2e-6, rtol=0)


@pytest.mark.parametrize("variant", ["24khz", "48khz"])
@pytest.mark.parametrize("stride", [2, 8])
def test_conv_transpose_matches_jax(variant, stride):
    """The pre-flipped ``(k, in, out)`` kernel, the bias, the 48 kHz variant's
    group norm and the unpad (causal for 24 kHz, centred for 48 kHz)."""
    r = np.random.default_rng(100)
    cfg = jax_encodec.EnCodec.from_facebook(variant).cfg
    k, cin, cout = 2 * stride, 24, 12
    p = {"w": (0.2 * r.standard_normal((k, cin, cout))).astype(np.float32),
         "b": (0.1 * r.standard_normal(cout)).astype(np.float32)}
    if variant == "48khz":
        p["norm"] = {"scale": (1 + 0.1 * r.standard_normal(cout)).astype(np.float32),
                     "bias": (0.1 * r.standard_normal(cout)).astype(np.float32)}
    x = r.standard_normal((2, 11, cin)).astype(np.float32)
    expected = np.asarray(jax_encodec.ec_conv_transpose(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x), k, stride))
    got = encodec.ec_conv_transpose(from_jax_params(p), encodec.EnCodecConfig(**cfg.__dict__), torch.from_numpy(x),
                                    k, stride)
    assert tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, atol=2e-6, rtol=0)


@pytest.mark.parametrize("variant", ["24khz", "48khz"])
def test_jax_init_carries_across(variant):
    """The JAX init's tree (the ``stages`` and ``lstm`` lists, the
    ``(nq, 1024, 128)`` codebooks) has the port's own init's keys and
    shapes and, carried across, gives JAX's codes and reconstruction."""
    ref = jax_encodec.EnCodec.from_facebook(variant)
    ours = encodec.EnCodec.from_facebook(variant, device="cpu")
    carried = from_jax_params(_np_tree(ref.params))
    assert _shapes(carried) == _shapes(ours.params)
    ours.params = carried
    _roundtrip(ref, ours, _clip(variant, 1, 1600, 101))
