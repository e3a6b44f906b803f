"""ViT through the PyTorch port vs the JAX package, on the CPU.

The JAX package is the oracle: the same parameters (JAX's init, made
non-trivial from a seed, carried across with ``from_jax_params``) or the
same synthetic checkpoint (made by the functions of tests/image/test_vit.py) go to
both, with the same images from ``numpy.random.default_rng``.

Tolerances, fp32: the two sides sum the patch embedding (JAX's conv, the
port's patch matmul), the projections, LayerNorm and the softmax in other
orders: about 1e-7 relative per op, 2e-5 on the pooled features after two
layers (CPU readings: at most 1.3e-6; the resampled PE 8.9e-8); loaders
carry the checkpoint across bit for bit. bf16 rounds at other places in the
two libraries (XLA keeps some bf16 intermediates in fp32): the pooled
features are held to a few bf16 steps of their size (CPU reading: 0.023 at
|x| up to 2.9, where one step is 0.016).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_models_tpu.models.image import ViT as JaxViT
from pytorch_models_tpu.ops import layers as jax_layers
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.image import ViT
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import layers
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.image.test_vit import _make_flax_augreg_dict, _make_flax_bigvision_dict, _make_timm_state_dict

torch.set_num_threads(1)

TINY = dict(n_layers=2, d_model=64, n_heads=2, patch_size=16, img_size=64)
TOL = 2e-5
BF16_TOL = (0.05, 2.0 ** -5)  # atol, rtol: a few bf16 steps after two layers


def _np_tree(tree):
    return jax.tree.map(to_np, tree)


def _images(seed, n, size):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


def _pair(seed=0, **kw):
    """(JAX ViT, the port's ViT on the CPU) holding the same fp32 params: JAX's
    init with the zero-initialised PE, cls token and probe drawn from a seed."""
    cfg = {**TINY, **kw}
    ref = JaxViT(**cfg)
    r = np.random.default_rng(seed)
    for key in ("pe", "cls_token"):
        if key in ref.params:
            ref.params[key] = jnp.asarray(0.1 * r.standard_normal(ref.params[key].shape).astype(np.float32))
    if "pooler" in ref.params:
        ref.params["pooler"]["probe"] = jnp.asarray(r.standard_normal((1, 1, cfg["d_model"])).astype(np.float32))
    ours = ViT(**cfg, device="cpu")
    ours.params = from_jax_params(_np_tree(ref.params))
    return ref, ours


@pytest.fixture()
def kernel_route():
    """Force the encoder-attention wrapper: on CPU tensors it runs the
    kernel's plain twin, the route the auto gate takes on the card."""
    saved = attn.USE_ENCODER_KERNEL
    attn.USE_ENCODER_KERNEL = True
    yield
    attn.USE_ENCODER_KERNEL = saved


@pytest.mark.parametrize("route", ["sdpa", "encoder_attention"])
@pytest.mark.parametrize("pool,cls", [("cls_token", True), ("gap", True), ("mha", False)])
def test_forward_matches_jax(pool, cls, route, request):
    if route == "encoder_attention":
        request.getfixturevalue("kernel_route")
    ref, ours = _pair(seed=1, pool_type=pool, cls_token=cls)
    x = _images(2, 2, 64)
    expected = np.asarray(ref(x))
    got = ours(x)
    assert got.shape == (2, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=TOL)


@pytest.mark.parametrize("new_size", [384, 112])  # the 14 x 14 grid grown to 24 x 24, shrunk to 7 x 7
def test_resize_pe_matches_jax(new_size):
    """``jax.image.resize`` bicubic (Keys a = -0.5, antialiased when it
    shrinks) against the port's resampling, then a forward at the new size."""
    ref, ours = _pair(seed=3, n_layers=1, d_model=32, img_size=224)
    ref.resize_pe(new_size)
    ours.resize_pe(new_size)
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    np.testing.assert_allclose(ours.params["pe"].numpy(), np.asarray(ref.params["pe"]), rtol=0, atol=1e-6)
    x = _images(4, 1, new_size)
    np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="interpolation_mode"):
        ours.resize_pe(224, "lanczos3")


# (stride, padding, groups, dilation): the patch embedding's matmul, a 3x3 same-size conv, XLA's "SAME" with a
# stride, groups with an (h, w) pair, dilation, and (lo, hi) pairs per axis
CONV_CASES = {
    "patch": (4, 0, 1, 1, 4),
    "pad1": (1, 1, 1, 1, 3),
    "same_stride2": (2, "SAME", 1, 1, 3),
    "groups_pair": (1, (2, 1), 4, 1, 3),
    "same_dilated_groups": (1, "SAME", 2, 2, 3),
    "pairs_stride2": (2, ((1, 2), (0, 1)), 1, 1, 3),
    "valid": (3, "VALID", 1, 1, 5),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case):
    stride, padding, groups, dilation, k = CONV_CASES[case]
    r = np.random.default_rng(11)
    x = r.standard_normal((2, 16, 12, 8)).astype(np.float32)
    jp = jax_layers.conv2d_init(jax.random.PRNGKey(5), k, k, 8, 12, groups=groups)
    expected = np.asarray(jax_layers.conv2d(jp, jnp.asarray(x), stride=stride, padding=padding, groups=groups,
                                            dilation=dilation))
    got = layers.conv2d(from_jax_params(_np_tree(jp)), torch.from_numpy(x), stride=stride, padding=padding,
                        groups=groups, dilation=dilation)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-5)
    # the port's init draws the JAX init's shapes and bounds
    ours = layers.conv2d_init(torch.Generator().manual_seed(0), k, k, 8, 12, groups=groups)
    assert ours["w"].shape == jp["w"].shape and ours["b"].shape == jp["b"].shape
    bound = 1.0 / np.sqrt(k * k * 8 // groups)
    assert float(ours["w"].abs().max()) <= bound and float(ours["b"].abs().max()) <= bound


def _dinov2_keys(sd):
    """The deit3 checkpoint under dinov2's LayerScale names, with its mask token."""
    sd = {k.replace(".gamma_1", ".ls1.gamma").replace(".gamma_2", ".ls2.gamma"): v for k, v in sd.items()}
    sd["mask_token"] = np.zeros((1, 64), np.float32)
    return sd


# loader -> (the function making its checkpoint, how both models load it, its extra load kwargs)
LOADERS = {
    "facebook_deit3": (lambda r: _make_timm_state_dict(r, 2, 64, 16, 16), "load_facebook_state_dict", {}),
    "facebook_dinov2": (lambda r: _dinov2_keys(_make_timm_state_dict(r, 2, 64, 16, 16)),
                        "load_facebook_state_dict", {}),
    "flax_augreg": (lambda r: _make_flax_augreg_dict(r, 2, 64, 2, 16, 16), "load_flax_ckpt", {}),
    "flax_bigvision": (lambda r: _make_flax_bigvision_dict(r, 2, 64, 2, 16, 16), "load_flax_ckpt",
                       {"big_vision": True}),
}


@pytest.mark.parametrize("loader", list(LOADERS))
def test_loaders_match_jax(loader):
    """One synthetic checkpoint fed to both loaders: the params equal bit for
    bit (the port's per-layer list against JAX's stacked layers), then the
    forward."""
    build, method, load_kw = LOADERS[loader]
    ckpt = build(np.random.default_rng(42))
    model_kw = {"cls_token": False, "pool_type": "mha"} if loader == "flax_bigvision" else {}
    ref, ours = JaxViT(**TINY, **model_kw), ViT(**TINY, **model_kw, device="cpu")
    getattr(ref, method)(dict(ckpt), **load_kw)
    getattr(ours, method)(dict(ckpt), **load_kw)
    expected = from_jax_params(_np_tree(ref.params))
    got = ours.params
    flat_e = dict(jax.tree_util.tree_leaves_with_path(expected))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_g.keys() == flat_e.keys()
    for path, leaf in flat_e.items():
        assert flat_g[path].dtype == torch.float32, path
        assert torch.equal(flat_g[path], leaf), path
    x = _images(6, 2, 64)
    np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)), rtol=0, atol=TOL)


@pytest.mark.parametrize("loader", list(LOADERS))
def test_strict_consumption(loader):
    build, method, load_kw = LOADERS[loader]
    ckpt = build(np.random.default_rng(5))
    ckpt["unexpected.key"] = np.zeros(3, np.float32)
    model_kw = {"cls_token": False, "pool_type": "mha"} if loader == "flax_bigvision" else {}
    with pytest.raises(ValueError, match="unconsumed"):
        getattr(ViT(**TINY, **model_kw, device="cpu"), method)(ckpt, **load_kw)


def test_bf16_serving_mode_matches_jax():
    ref, ours = _pair(seed=7)
    ref.to_bf16()
    ours.to_bf16()
    assert ours.params["encoder"]["layers"][0]["sa"]["q"]["w"].dtype == torch.bfloat16
    x = _images(8, 2, 64)
    expected = np.asarray(ref(x).astype(jnp.float32))
    got = ours(x)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(got.float().numpy(), expected, rtol=BF16_TOL[1], atol=BF16_TOL[0])
    ours.to_fp32()
    assert ours.params["pe"].dtype == torch.float32


def test_default_device_needs_cuda(monkeypatch):
    """The port's models run on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViT(**TINY)
    assert ViT(**TINY, device="cpu").params["pe"].device.type == "cpu"


def test_constructors_and_pretrained_raise():
    siglip = ViT.from_google("Ti/16_siglip", device="cpu")
    assert (siglip.cfg.n_layers, siglip.cfg.d_model, siglip.cfg.n_heads, siglip.cfg.patch_size) == (12, 192, 3, 16)
    assert not siglip.cfg.cls_token and siglip.cfg.pool_type == "mha" and "pooler" in siglip.params
    assert ViT.from_facebook("S/14_dinov2", device="cpu").cfg.img_size == 518
    with pytest.raises(NotImplementedError):
        ViT.from_google("B/16", pretrained=True, device="cpu")
    with pytest.raises(NotImplementedError):
        ViT.from_facebook("B/16_deit3", pretrained=True, device="cpu")
    with pytest.raises(ValueError):
        ViT.from_facebook("B/16_mae", device="cpu")
