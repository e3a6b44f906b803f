"""MLP-Mixer, ConvNeXt, MaxViT, MobileViT and DETR through the PyTorch port
vs the JAX package, on the CPU, and the pooling / BatchNorm helpers.

The JAX package is the oracle. Forward tests: JAX's own init (its zero or
unit leaves -- BatchNorm statistics, layer-scale gammas, relative-bias
tables, query embeddings -- redrawn from a numpy seed so that every path
is exercised), carried across with ``from_jax_params``, and the same images
from ``numpy.random.default_rng``. Converter tests: one synthetic checkpoint
in its source format (made by the JAX package's own test helpers) goes to
the JAX loader and to the port's; the port's params must equal the JAX
params carried across, bit for bit, and the outputs must agree.

Tolerances are PARITY.md's bounds: max abs < 2e-5 for Mixer, ConvNeXt,
MaxViT and MobileViT; DETR logits < 5e-5 and boxes < 2e-5. The two sides
sum convolutions, projections, norms and softmaxes in other orders (about
1e-7 relative per op). DETR runs twice: through ``ops.sdpa`` and, with
``USE_ENCODER_KERNEL = True``, through the encoder-attention kernel's plain
twin behind its wrapper, the route the card takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_models_tpu.models import image as jax_image
from pytorch_models_tpu.ops import layers as jax_layers
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch import image
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import layers
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.image.test_convnext import _make_fb_state_dict
from tests.image.test_detr import _make_fb_detr_sd
from tests.image.test_maxvit import FakeTFReader, _make_tf_vars
from tests.image.test_mlp_mixer import _make_flax_mixer_dict
from tests.image.test_mobile_vit import _make_apple_sd

torch.set_num_threads(1)

TOL = 2e-5
DETR_TOL = (5e-5, 2e-5)  # logits, boxes

# family -> (constructor kwargs, image size)
FAMILIES = {
    "MLPMixer": (dict(n_layers=2, d_model=64, patch_size=16, img_size=64), 64),
    "ConvNeXt": (dict(d_model=16, depths=(2, 2)), 64),
    "MaxViT": (dict(stem_dim=32, n_blocks=[1, 1], dims=[32, 64]), 56),
    "MobileViT": (dict(channels=[8, 16, 24, 32, 40], d_models=[32, 48, 64], out_dim=64, expansion=2), 64),
    "DETR": (dict(backbone_layers=[1, 1], d_model=64, n_classes=5, n_queries=10), 64),
}


def _images(seed, n, size):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(to_np, tree)


def _redraw(tree, r):
    """The JAX init's degenerate leaves redrawn: BatchNorm statistics, the
    layer-scale gammas, relative-bias tables and query embeddings."""
    draws = {"mean": lambda s: 0.1 * r.standard_normal(s), "var": lambda s: 0.5 + np.abs(r.standard_normal(s)),
             "gamma": lambda s: 0.5 * r.standard_normal(s), "attn_bias": lambda s: 0.5 * r.standard_normal(s),
             "query_embed": lambda s: r.standard_normal(s)}

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return draws[key](t.shape).astype(np.float32) if key in draws else t

    return walk(tree)


def _pair(family, seed=0):
    """(JAX model, the port's model on the CPU) holding the same fp32 params."""
    kw, _ = FAMILIES[family]
    ref = getattr(jax_image, family)(**kw)
    tree = _redraw(_np_tree(ref.params), np.random.default_rng(seed))
    ref.params = jax.tree.map(jnp.asarray, tree)
    ours = getattr(image, family)(**kw, device="cpu")
    ours.params = from_jax_params(tree)
    return ref, ours


def _assert_outputs_match(family, ref, ours, x):
    expected, got = ref(x), ours(x)
    if family == "DETR":
        for e, g, tol in zip(expected, got, DETR_TOL):
            assert g.shape == e.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=tol)
    else:
        assert got.shape == expected.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=TOL)


@pytest.fixture()
def kernel_route():
    """Force the encoder-attention wrapper: on CPU tensors it runs the
    kernel's plain twin, the route the auto gate takes on the card."""
    saved = attn.USE_ENCODER_KERNEL
    attn.USE_ENCODER_KERNEL = True
    yield
    attn.USE_ENCODER_KERNEL = saved


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_matches_jax(family):
    ref, ours = _pair(family, seed=1)
    _assert_outputs_match(family, ref, ours, _images(2, 2, FAMILIES[family][1]))


def test_detr_kernel_route_matches_jax(kernel_route):
    from pytorch_models_tpu_torch.ops import encoder_attention as k1

    ref, ours = _pair("DETR", seed=2)
    calls = []
    orig = k1.encoder_attention_plain
    k1.encoder_attention_plain = lambda *a, **kw: calls.append(a[0].shape) or orig(*a, **kw)
    try:
        _assert_outputs_match("DETR", ref, ours, _images(3, 2, 64))
    finally:
        k1.encoder_attention_plain = orig
    # 6 encoder self, 6 decoder self and 6 cross-attentions, each through the wrapper
    assert len(calls) == 18


# the converters: (make the synthetic checkpoint from a numpy generator, the loader's name, how to wrap it)
CONVERTERS = {
    "MLPMixer": (lambda r: _make_flax_mixer_dict(r, 2, 64, 16), "load_jax_weights", dict),
    "ConvNeXt": (lambda r: _make_fb_state_dict(r, 16, (2, 2)), "load_facebook_state_dict", dict),
    "MaxViT": (lambda r: _make_tf_vars(r, 32, [1, 1], [32, 64]), "load_google_state_dict", FakeTFReader),
    "MobileViT": (lambda r: _make_apple_sd(r, **FAMILIES["MobileViT"][0]), "load_apple_state_dict", dict),
    "DETR": (lambda r: _make_fb_detr_sd(r, **FAMILIES["DETR"][0]), "load_facebook_state_dict", dict),
}


def _assert_trees_equal(got, expected, path="params"):
    if isinstance(expected, dict):
        assert isinstance(got, dict) and set(got) == set(expected), f"{path}: keys {set(got)} != {set(expected)}"
        for k in expected:
            _assert_trees_equal(got[k], expected[k], f"{path}/{k}")
    elif isinstance(expected, list):
        assert isinstance(got, list) and len(got) == len(expected), f"{path}: length"
        for i, (g, e) in enumerate(zip(got, expected)):
            _assert_trees_equal(g, e, f"{path}/{i}")
    else:
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(expected.shape), path
        assert torch.equal(got, expected), f"{path}: values differ"


@pytest.mark.parametrize("family", list(CONVERTERS))
def test_converter_matches_jax(family):
    make, loader, wrap = CONVERTERS[family]
    kw, size = FAMILIES[family]
    ckpt = make(np.random.default_rng(41))
    ref = getattr(jax_image, family)(**kw)
    getattr(ref, loader)(wrap(ckpt))
    ours = getattr(image, family)(**kw, device="cpu")
    getattr(ours, loader)(wrap(ckpt))
    _assert_trees_equal(ours.params, from_jax_params(_np_tree(ref.params)))
    _assert_outputs_match(family, ref, ours, _images(5, 2, size))


def test_maxvit_loader_takes_a_reader_without_a_shape_map():
    class GetOnly:
        def __init__(self, variables):
            self.get_tensor = variables.__getitem__

    variables = _make_tf_vars(np.random.default_rng(42), 32, [1, 1], [32, 64])
    a, b = (image.MaxViT(**FAMILIES["MaxViT"][0], device="cpu") for _ in range(2))
    a.load_google_state_dict(FakeTFReader(variables))
    b.load_google_state_dict(GetOnly(variables))
    _assert_trees_equal(b.params, a.params)
    variables["maxvit/extra/ExponentialMovingAverage"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        a.load_google_state_dict(FakeTFReader(variables))


def test_detr_pipeline_matches_jax():
    """The same padded batch through both pipelines: the class lists equal,
    boxes (pixels) and probabilities at the DETR bounds."""
    make, loader, _ = CONVERTERS["DETR"]
    ckpt = make(np.random.default_rng(43))
    ref = jax_image.DETR(**FAMILIES["DETR"][0])
    ref.load_facebook_state_dict(ckpt)
    ours = image.DETR(**FAMILIES["DETR"][0], device="cpu")
    ours.load_facebook_state_dict(ckpt)
    r = np.random.default_rng(44)
    imgs = [np.clip(0.5 + 0.25 * r.standard_normal(s), 0, 1).astype(np.float32) for s in ((3, 48, 64), (3, 64, 40))]
    expected = jax_image.DETRPipeline(ref, threshold=0.1)(imgs)
    got = image.DETRPipeline(ours, threshold=0.1)(imgs)
    assert sum(len(e[0]) for e in expected) > 0
    for (e_cls, e_box, e_p), (g_cls, g_box, g_p) in zip(expected, got, strict=True):
        assert list(g_cls) == list(e_cls)
        np.testing.assert_allclose(g_box, e_box, rtol=0, atol=2e-3)  # pixel units: 64 x the boxes' 2e-5
        np.testing.assert_allclose(g_p, e_p, rtol=0, atol=2e-5)
    assert image.DETRPipeline.COCO_CLASSES == jax_image.DETRPipeline.COCO_CLASSES
    boxes = r.random((3, 4)).astype(np.float32)
    np.testing.assert_array_equal(image.DETRPipeline.cxcywh_to_xyxy(boxes),
                                  jax_image.DETRPipeline.cxcywh_to_xyxy(boxes))


@pytest.mark.parametrize("h,w", [(25, 34), (7, 7)])
def test_sinusoidal_pe_matches_jax(h, w):
    from pytorch_models_tpu.models.image.detr import sinusoidal_pe_2d as jax_pe
    from pytorch_models_tpu_torch.models.image.detr import sinusoidal_pe_2d

    np.testing.assert_array_equal(sinusoidal_pe_2d(h, w, 256), np.asarray(jax_pe(h, w, 256)))


def test_maxvit_windows_and_relative_bias_match_jax():
    from pytorch_models_tpu.models.image import maxvit as jm
    from pytorch_models_tpu_torch.models.image import maxvit as pm

    x = np.random.default_rng(45).standard_normal((2, 14, 21, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    for part, unpart in (("window_block", "window_unblock"), ("window_grid", "window_ungrid")):
        got, nh, nw = getattr(pm, part)(xt, 7)
        expected, enh, enw = getattr(jm, part)(jnp.asarray(x), 7)
        assert (nh, nw) == (enh, enw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
        assert torch.equal(getattr(pm, unpart)(got, nh, nw, 7), xt)
    table = np.random.default_rng(46).standard_normal((2, 13, 13)).astype(np.float32)
    np.testing.assert_array_equal(pm._relative_bias(torch.from_numpy(table), 7).numpy(),
                                  np.asarray(jm._relative_bias(jnp.asarray(table), 7)))


# helpers: (window, stride, padding) of max_pool2d, ResNet's stem pool among them
@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, 2, 0), (3, 1, 1), (3, 3, 0)])
def test_max_pool2d_matches_jax(window, stride, padding):
    x = np.random.default_rng(47).standard_normal((2, 11, 9, 5)).astype(np.float32) - 2.0  # the pads never win
    got = layers.max_pool2d(torch.from_numpy(x), window, stride, padding)
    expected = np.asarray(jax_layers.max_pool2d(jnp.asarray(x), window, stride, padding))
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("window,stride", [(2, None), (3, 2), (2, 1)])
def test_avg_pool2d_matches_jax(window, stride):
    x = np.random.default_rng(48).standard_normal((2, 10, 7, 5)).astype(np.float32)
    got = layers.avg_pool2d(torch.from_numpy(x), window, stride)
    expected = np.asarray(jax_layers.avg_pool2d(jnp.asarray(x), window, stride))
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_matches_jax(dtype):
    r = np.random.default_rng(49)
    c = 6
    p = {"scale": 1 + 0.1 * r.standard_normal(c), "bias": 0.1 * r.standard_normal(c),
         "mean": r.standard_normal(c), "var": 0.5 + np.abs(r.standard_normal(c))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 4, 3, c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    expected = np.asarray(jax_layers.batch_norm({k: jnp.asarray(v) for k, v in p.items()},
                                                jnp.asarray(x, jdt), 1e-3).astype(jnp.float32))
    got = layers.batch_norm(from_jax_params(p), torch.from_numpy(x).to(dtype), 1e-3)
    assert got.dtype == dtype
    # fp32: the same fold in the same order; bf16: scale and bias rounded once each, then x * scale + bias
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -6 * np.abs(expected).max()
    np.testing.assert_allclose(got.float().numpy(), expected, rtol=0, atol=tol)
    ours = layers.bn_init(c)
    for k, v in jax_layers.bn_init(c).items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v))
