"""The wav2vec2 family (Wav2Vec2 / HuBERT, SEW, Data2Vec-Audio) through the
PyTorch port vs the JAX package, on the CPU.

Each model is built from ONE synthetic HF-format checkpoint (made by the JAX
package's own test helper) through both converters: the port's params must
equal the JAX params carried across by ``from_jax_params`` bit for bit, and
the encoders' outputs on the same 4000-sample clips (2 layers, d 64, 1 head
of 64) agree within PARITY.md's rows 24-26: max abs 2e-5, mean 2e-6 (fp32
on both sides, summed in other orders). They do so through ``ops.sdpa`` and,
with ``USE_ENCODER_KERNEL = True``, through the encoder-attention kernel's
plain twin behind its wrapper (the route the card takes). The JAX init
carried across gives the same forward too, so both trees have one layout.

The ops the family adds: ``conv1d`` with groups, dilation, ``(lo, hi)``
padding, int8 weights and no bias; ``instance_norm_1d``; and the
spectrogram classes on a numpy waveform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.audio as jax_audio
from pytorch_models_tpu.models.audio.wav2vec2 import instance_norm_1d as jax_instance_norm_1d
from pytorch_models_tpu.ops.layers import conv1d as jax_conv1d
from pytorch_models_tpu.utils.params import quantize_tree_int8 as jax_quantize_tree_int8
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch import audio
from pytorch_models_tpu_torch.models.audio.wav2vec2 import instance_norm_1d
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops.layers import conv1d
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.audio.test_wav2vec2 import _make_w2v2_sd
from tests.test_torch_image_families import _assert_trees_equal

torch.set_num_threads(1)

MAX_TOL, MEAN_TOL = 2e-5, 2e-6
N_LAYERS, D = 2, 64
# family -> (constructor kwargs, checkpoint kwargs)
FAMILIES = {
    "wav2vec2": ("Wav2Vec2", dict(stem_legacy=False, pre_norm=True), dict(legacy=False)),
    "wav2vec2-legacy-postnorm": ("Wav2Vec2", dict(stem_legacy=True, pre_norm=False), dict(legacy=True)),
    "sew": ("SEW", {}, dict(legacy=True, proj_key="sew")),
    "data2vec-audio": ("Data2VecAudio", {}, dict(stem_bias=False)),
}


@pytest.fixture()
def kernel_route():
    saved = attn.USE_ENCODER_KERNEL
    attn.USE_ENCODER_KERNEL = True
    yield
    attn.USE_ENCODER_KERNEL = saved


def _np_tree(tree):
    return jax.tree.map(to_np, tree)


def _clips(seed: int, b: int = 2, n: int = 4000) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _assert_close(got: torch.Tensor, expected: np.ndarray) -> None:
    assert tuple(got.shape) == expected.shape and got.dtype == torch.float32
    diff = np.abs(got.numpy() - expected)
    assert diff.max() < MAX_TOL and diff.mean() < MEAN_TOL, (diff.max(), diff.mean())


@pytest.mark.parametrize("route", ["sdpa", "encoder_attention"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_checkpoint_matches_jax(family, route, request):
    if route == "encoder_attention":
        request.getfixturevalue("kernel_route")
    name, kw, ckpt_kw = FAMILIES[family]
    sd = _make_w2v2_sd(np.random.default_rng(81), getattr(jax_audio, name), N_LAYERS, D, **ckpt_kw)
    ref = getattr(jax_audio, name)(N_LAYERS, D, **kw)
    ref.load_hf_state_dict(dict(sd))
    ours = getattr(audio, name)(N_LAYERS, D, **kw, device="cpu")
    ours.load_hf_state_dict(dict(sd))
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    _assert_trees_equal(ours.params, from_jax_params(_np_tree(ref.params)))
    x = _clips(82)
    _assert_close(ours(x), np.asarray(ref(x)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_init_carries_across(family):
    """The JAX init's tree (stem and PE-conv lists, the stacked encoder
    ``"layers"``, SEW's ``upsample``) through ``from_jax_params`` has the
    port's own init's keys and shapes, and gives JAX's forward."""
    name, kw, _ = FAMILIES[family]
    ref = getattr(jax_audio, name)(N_LAYERS, D, **kw)
    ours = getattr(audio, name)(N_LAYERS, D, **kw, device="cpu")
    carried = from_jax_params(_np_tree(ref.params))
    assert _shapes(carried) == _shapes(ours.params)
    ours.params = carried
    x = _clips(83)
    _assert_close(ours(x), np.asarray(ref(x)))


def test_weight_norm_in_either_torch_naming():
    """The PE conv's weight norm under torch's newer ``parametrizations``
    names converts to the same kernel as under ``weight_g`` / ``weight_v``."""
    sd = _make_w2v2_sd(np.random.default_rng(84), jax_audio.Wav2Vec2, N_LAYERS, D)
    renamed = dict(sd)
    pfx = "encoder.pos_conv_embed.conv"
    renamed[f"{pfx}.parametrizations.weight.original0"] = renamed.pop(f"{pfx}.weight_g")
    renamed[f"{pfx}.parametrizations.weight.original1"] = renamed.pop(f"{pfx}.weight_v")
    a, b = audio.Wav2Vec2(N_LAYERS, D, device="cpu"), audio.Wav2Vec2(N_LAYERS, D, device="cpu")
    a.load_hf_state_dict(sd)
    b.load_hf_state_dict(renamed)
    _assert_trees_equal(b.params, a.params)


@pytest.mark.parametrize("config", [
    {"num_hidden_layers": 1, "hidden_size": 64, "num_attention_heads": 1, "conv_bias": False,
     "feat_extract_norm": "group", "do_stable_layer_norm": False},
    {"num_hidden_layers": 1, "hidden_size": 128, "num_attention_heads": 2, "conv_bias": True,
     "feat_extract_norm": "layer", "do_stable_layer_norm": True},
])
@pytest.mark.parametrize("name", ["Wav2Vec2", "SEW", "Data2VecAudio"])
def test_from_hf_config_matches_jax(name, config):
    """``from_hf`` with the config passed in (the JAX package would fetch it
    when none is given; the port raises then)."""
    if name == "SEW" and config["feat_extract_norm"] == "layer":
        config = dict(config, feat_extract_norm="group")  # SEW's stem is the legacy stem
    ours = getattr(audio, name).from_hf("facebook/wav2vec2-base", config=config, device="cpu")
    ref = getattr(jax_audio, name).from_hf("facebook/wav2vec2-base", config=config)
    assert type(ours).__name__ == name and ours.cfg.__dict__ == ref.cfg.__dict__
    with pytest.raises(NotImplementedError, match="config"):
        getattr(audio, name).from_hf("facebook/wav2vec2-base", device="cpu")
    with pytest.raises(ValueError, match="64"):
        getattr(audio, name).from_hf("x", config=dict(config, num_attention_heads=2, hidden_size=64), device="cpu")


# (in, out, k, stride, padding, groups, dilation, bias, int8)
CONVS = [
    (1, 32, 10, 5, 0, 1, 1, False, False),  # the stem's first conv, no bias
    (64, 64, 128, 1, (64, 63), 16, 1, True, False),  # the PE conv: grouped, asymmetric pad
    (64, 64, 31, 2, (15, 14), 16, 1, True, False),  # SEW's stride-2 PE conv
    (64, 64, 19, 1, 9, 16, 1, True, False),  # data2vec-audio's PE blocks
    (16, 24, 3, 1, 2, 1, 2, True, False),  # dilated
    (32, 48, 5, 2, (3, 1), 4, 2, False, True),  # int8, grouped, dilated, strided, no bias
    (32, 48, 3, 1, 1, 1, 1, True, True),  # int8 with a bias
]


@pytest.mark.parametrize("cin,cout,k,stride,padding,groups,dilation,bias,int8", CONVS)
def test_conv1d_matches_jax(cin, cout, k, stride, padding, groups, dilation, bias, int8):
    r = np.random.default_rng(85)
    p = {"w": (0.1 * r.standard_normal((k, cin // groups, cout))).astype(np.float32)}
    if bias:
        p["b"] = (0.1 * r.standard_normal(cout)).astype(np.float32)
    x = r.standard_normal((2, 57, cin)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    if int8:  # a conv kernel under a projection key quantizes like a linear's
        jp = jax_quantize_tree_int8({"proj": jp})["proj"]
        assert jp["w"]["w_q"].dtype == jnp.int8
    expected = np.asarray(jax_conv1d(jp, jnp.asarray(x), stride, padding, groups, dilation), np.float32)
    got = conv1d(from_jax_params(_np_tree(jp)), torch.from_numpy(x), stride, padding, groups, dilation)
    assert got.dtype == (torch.bfloat16 if int8 else torch.float32) and tuple(got.shape) == expected.shape
    atol, rtol = (1e-5, 0.0) if not int8 else (1e-2, 2.0 ** -7)  # bf16: one bf16 step of the output
    np.testing.assert_allclose(got.float().numpy(), expected, atol=atol, rtol=rtol)


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_1d_matches_jax(affine):
    r = np.random.default_rng(86)
    x = (3 + 2 * r.standard_normal((2, 40, 8))).astype(np.float32)
    p = ({"scale": (1 + 0.1 * r.standard_normal(8)).astype(np.float32),
          "bias": (0.1 * r.standard_normal(8)).astype(np.float32)} if affine else None)
    expected = np.asarray(jax_instance_norm_1d(None if p is None else jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    tp = None if p is None else from_jax_params(p)
    got = instance_norm_1d(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expected, atol=2e-6, rtol=0)
    assert instance_norm_1d(tp, torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("mel", [False, True])
def test_spectrograms_take_a_numpy_waveform(mel):
    """A numpy waveform, as the JAX classes take it (``jnp.asarray``); the
    port puts it on ``device`` (the card by default)."""
    x = np.random.default_rng(87).standard_normal((2, 4000)).astype(np.float32)
    if mel:
        ref, ours = jax_audio.MelSpectrogram(400, 160, 80, 16000), audio.MelSpectrogram(400, 160, 80, 16000,
                                                                                        device="cpu")
    else:
        ref, ours = jax_audio.Spectrogram(400, 160), audio.Spectrogram(400, 160, device="cpu")
    expected = np.asarray(ref(x))
    for inp in (x, x.tolist()):
        got = ours(inp)
        assert got.device.type == "cpu" and tuple(got.shape) == expected.shape
        # fp32 FFTs of two libraries: about 1e-6 of the largest bin apart
        np.testing.assert_allclose(got.numpy(), expected, atol=1e-5 * np.abs(expected).max(), rtol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            audio.Spectrogram(400, 160)(x)
