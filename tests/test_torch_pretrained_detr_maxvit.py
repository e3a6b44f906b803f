"""``pretrained=True`` of DETR and MaxViT in the PyTorch port vs the JAX
package, on the CPU.

One cache (``$PYTORCH_MODELS_TPU_CACHE``, a temporary directory) is filled
once for the module with synthetic checkpoints under the file names both
packages give them: DETR-R50's ``.pth`` at its published size, whose
``"model"`` sits beside ``argparse.Namespace`` args as in the official
file, and MaxViT's TF bundle (``.index`` + one data shard in
``maxvit_tiny/``, written by numpy; the tag at a smaller width, ``VARIANTS``
patched in both packages). The same ``from_*(tag, pretrained=True)`` of
both packages reads the same file: the port's parameters must equal
``from_jax_params`` of JAX's bit for bit; MaxViT also runs one forward
within tests/test_torch_image_families.py's bound. Nothing is fetched.
"""

import argparse

import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.image as jax_image
import pytorch_models_tpu.models.image.maxvit as jax_maxvit
import pytorch_models_tpu_torch.models.image.maxvit as maxvit
from pytorch_models_tpu_torch import image
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.image.test_detr import _make_fb_detr_sd
from tests.image.test_maxvit import TINY as MAXVIT_TINY
from tests.image.test_maxvit import _make_tf_vars
from tests.torch_pretrained_cache import (assert_trees_equal, cache_file, np_tree, offline, write_tf_bundle,
                                          write_torch)

torch.set_num_threads(1)

TOL = 2e-5  # fp32, tests/test_torch_image_families.py


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("detr_cache")
    r = np.random.default_rng(37)
    write_tf_bundle(str(cache_file(root, "model.ckpt-92002", "maxvit_tiny")), _make_tf_vars(r, **MAXVIT_TINY))
    args = argparse.Namespace(backbone="resnet50", lr=1e-4, dilation=False)
    write_torch(cache_file(root, "detr-r50-e632da11.pth"),
                {"model": _make_fb_detr_sd(r, [3, 4, 6, 3], 256, 91, 100), "args": args, "epoch": 499})
    return root


def test_detr_pretrained_matches_jax(cache, monkeypatch):
    offline(monkeypatch, cache)
    ours = image.DETR.from_facebook("resnet50", pretrained=True, device="cpu")
    ref = jax_image.DETR.from_facebook("resnet50", pretrained=True)
    assert ours.cfg.__dict__ == ref.cfg.__dict__
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))


def test_maxvit_pretrained_matches_jax(cache, monkeypatch):
    """The TF bundle, cached in ``maxvit_tiny/``, read by each package's own
    numpy reader."""
    offline(monkeypatch, cache)
    tiny = (MAXVIT_TINY["stem_dim"], MAXVIT_TINY["n_blocks"], MAXVIT_TINY["dims"])
    for mod in (maxvit, jax_maxvit):
        monkeypatch.setitem(mod.VARIANTS, "tiny", tiny)
    ours = image.MaxViT.from_google("tiny", pretrained=True, device="cpu")
    ref = jax_image.MaxViT.from_google("tiny", pretrained=True)
    assert_trees_equal(ours.params, from_jax_params(np_tree(ref.params)))
    x = np.random.default_rng(32).standard_normal((1, 3, 56, 56)).astype(np.float32)
    np.testing.assert_allclose(ours(x).numpy(), np.asarray(ref(x)), rtol=0, atol=TOL)
