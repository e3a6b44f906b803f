"""``pretrained=True`` of ViT (AugReg, SigLIP, DeiT-3, DINO, DINOv2) in the
PyTorch port vs the JAX package, on the CPU.

One cache (``$PYTORCH_MODELS_TPU_CACHE``, a temporary directory) is filled
once for the module with synthetic checkpoints in each source's format,
under the file names both packages give them: Flax ``.npz`` (AugReg;
SigLIP's image tower under ``params/img/``) and ``torch.save`` files (DeiT-3
under ``"model"``, DINO and DINOv2 bare). The same ``from_*(tag,
pretrained=True)`` of both packages reads the same file: the port's
parameters must equal ``from_jax_params`` of JAX's bit for bit. ViT-Ti/16
loads at its published size and runs one forward within
tests/test_torch_vit.py's bound; the other tags keep their file names and
take a smaller width (``SIZES`` patched in both packages). Nothing is
fetched.
"""

import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.image.vit as jax_vit
import pytorch_models_tpu_torch.models.image.vit as vit
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.image.test_vit import _make_flax_augreg_dict, _make_flax_bigvision_dict, _make_timm_state_dict
from tests.torch_pretrained_cache import assert_trees_equal, cache_file, np_tree, offline, write_torch

torch.set_num_threads(1)

TOL = 2e-5  # fp32, tests/test_torch_vit.py
SMALL = (2, 64, 2)  # (layers, width, heads) for the SIZES patched below
AUGREG_TI16 = "Ti_16-i21k-300ep-lr_0.001-aug_none-wd_0.03-do_0.0-sd_0.0.npz"

# tag -> (constructor, its kwargs beyond the tag, the SIZES entry patched to SMALL or None)
VIT_TAGS = {
    "Ti/16": ("from_google", {}, None),
    "B/16_siglip": ("from_google", {}, "B"),
    "S/16_deit3": ("from_facebook", {}, "S"),
    "S/8_dino": ("from_facebook", {"img_size": 64}, "S"),
    "S/14_dinov2": ("from_facebook", {}, "S"),
}


def _dinov2(sd):
    sd = {k.replace(".gamma_1", ".ls1.gamma").replace(".gamma_2", ".ls2.gamma"): v for k, v in sd.items()}
    sd["mask_token"] = np.zeros((1, SMALL[1]), np.float32)
    return sd


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("vit_cache")
    r = np.random.default_rng(29)
    n, d, h = jax_vit.SIZES["Ti"]
    np.savez(cache_file(root, AUGREG_TI16), **_make_flax_augreg_dict(r, n, d, h, 16, 196))
    siglip = {f"params/img/{k}": v for k, v in _make_flax_bigvision_dict(r, *SMALL, 16, 196).items()}
    siglip["params/txt/Embed_0/embedding"] = np.zeros((4, 8), np.float32)  # the text tower, not read
    np.savez(cache_file(root, "webli_en_b16_224_63724782.npz"), **siglip)
    write_torch(cache_file(root, "deit_3_small_224_21k.pth"),
                {"model": _make_timm_state_dict(r, SMALL[0], SMALL[1], 16, 196), "epoch": 799})
    write_torch(cache_file(root, "dino_deitsmall8_pretrain.pth"),
                _make_timm_state_dict(r, SMALL[0], SMALL[1], 8, 64, layer_scale=False))
    write_torch(cache_file(root, "dinov2_vits14_pretrain.pth"),
                _dinov2(_make_timm_state_dict(r, SMALL[0], SMALL[1], 14, 37 * 37)))
    return root


@pytest.mark.parametrize("tag", list(VIT_TAGS))
def test_vit_pretrained_matches_jax(tag, cache, monkeypatch):
    offline(monkeypatch, cache)
    method, kw, patched = VIT_TAGS[tag]
    if patched:
        for mod in (vit, jax_vit):
            monkeypatch.setitem(mod.SIZES, patched, SMALL)
    ours = getattr(vit.ViT, method)(tag, pretrained=True, device="cpu", **kw)
    ref = getattr(jax_vit.ViT, method)(tag, pretrained=True, **kw)
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    if tag == "Ti/16":  # the published size: one forward
        x = np.random.default_rng(31).standard_normal((1, 3, 224, 224)).astype(np.float32)
        np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)), rtol=0, atol=TOL)


def test_vit_patch_sizes_without_checkpoints_are_refused(cache, monkeypatch):
    offline(monkeypatch, cache)
    for mod in (vit, jax_vit):
        monkeypatch.setitem(mod.SIZES, "S", SMALL)
    for cls, kw in ((vit.ViT, {"device": "cpu"}), (jax_vit.ViT, {})):
        with pytest.raises(AssertionError, match="patch_size"):
            cls.from_facebook("S/32_deit3", pretrained=True, **kw)
        with pytest.raises(ValueError, match="weights"):
            cls.from_google("S/16_in21k", pretrained=True, **kw)
