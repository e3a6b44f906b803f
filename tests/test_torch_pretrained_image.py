"""``pretrained=True`` of MLP-Mixer, ConvNeXt and MobileViT in the PyTorch
port vs the JAX package, on the CPU.

One cache (``$PYTORCH_MODELS_TPU_CACHE``, a temporary directory) is filled
once for the module with synthetic checkpoints in each source's format,
under the file names both packages give them: Mixer's Flax ``.npz``,
ConvNeXt's ``torch.save`` file (under ``"model"``) and Apple's MobileViT
``.pt``. The same ``from_*(tag, pretrained=True)`` of both packages reads
the same file: the port's parameters must equal ``from_jax_params`` of
JAX's bit for bit. MobileViT-xxs loads at its published size and runs one
forward within tests/test_torch_image_families.py's bound; the Mixer and
ConvNeXt tags keep their file names and take smaller widths (the variant
tables patched in both packages). Nothing is fetched.
"""

import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.image as jax_image
import pytorch_models_tpu.models.image.convnext as jax_convnext
import pytorch_models_tpu.models.image.mlp_mixer as jax_mlp_mixer
import pytorch_models_tpu_torch.models.image.convnext as convnext
import pytorch_models_tpu_torch.models.image.mlp_mixer as mlp_mixer
from pytorch_models_tpu_torch import image
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.image.test_convnext import _make_fb_state_dict
from tests.image.test_mlp_mixer import _make_flax_mixer_dict
from tests.image.test_mobile_vit import TINY as MOBILEVIT_XXS
from tests.image.test_mobile_vit import _make_apple_sd
from tests.torch_pretrained_cache import assert_trees_equal, cache_file, np_tree, offline, write_torch

torch.set_num_threads(1)

TOL = 2e-5  # fp32, tests/test_torch_image_families.py


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("image_cache")
    r = np.random.default_rng(29)
    np.savez(cache_file(root, "Mixer-B_16.npz"), **_make_flax_mixer_dict(r, 2, 64, 196))
    write_torch(cache_file(root, "convnext_tiny_22k_224.pth"), {"model": _make_fb_state_dict(r, 16, (1, 1))})
    write_torch(cache_file(root, "mobilevit_xxs.pt"), _make_apple_sd(r, **MOBILEVIT_XXS))
    return root


def _both(name, method, tag):
    ours = getattr(getattr(image, name), method)(tag, pretrained=True, device="cpu")
    ref = getattr(getattr(jax_image, name), method)(tag, pretrained=True)
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    return ours, ref


def test_mlp_mixer_pretrained_matches_jax(cache, monkeypatch):
    offline(monkeypatch, cache)
    for mod in (mlp_mixer, jax_mlp_mixer):
        monkeypatch.setitem(mod.SIZES, "B", (2, 64))
    _both("MLPMixer", "from_google", "B/16")


def test_convnext_pretrained_matches_jax(cache, monkeypatch):
    offline(monkeypatch, cache)
    for mod in (convnext, jax_convnext):
        monkeypatch.setitem(mod.VARIANTS, "tiny", (16, (1, 1)))
    _both("ConvNeXt", "from_facebook", "tiny")


def test_mobile_vit_pretrained_matches_jax(cache, monkeypatch):
    offline(monkeypatch, cache)
    ours, ref = _both("MobileViT", "from_apple", "xxs")
    x = np.random.default_rng(33).standard_normal((1, 3, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)), rtol=0, atol=TOL)
