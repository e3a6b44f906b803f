"""ViT image classification on the PyTorch port: from_google converter + bf16 serving cast.

Runs on the CUDA card (--cpu: on the CPU). The port's counterpart of
image_classify.py: the same model, inputs and printed lines.
"""

import sys

import numpy as np

sys.path.insert(0, ".")
from examples._torch_common import require_cached, setup, shape_dtype  # noqa: E402

AUGREG_B16 = "B_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0.npz"


def main(argv=None, **models) -> dict:
    """``models``: ``model``, a ViT to use in place of the one built here."""
    args = setup(__doc__, argv)

    from pytorch_models_tpu_torch.image import ViT

    if args.pretrained:
        require_cached(AUGREG_B16)
    # AugReg B/16: features (N, 768). Other loaders: from_google("B/16_siglip"),
    # from_facebook_deit3 / _dino / _dinov2 — see models/image/vit.py.
    model = models.get("model") or ViT.from_google("B/16_augreg", pretrained=args.pretrained, device=args.device)
    model = model.to_bf16()

    imgs = np.random.default_rng(0).standard_normal((8, 3, 224, 224)).astype(np.float32)
    feats = model(imgs)
    print("features:", shape_dtype(feats))

    model.resize_pe(448)  # bicubic position-embedding resize, like the reference
    big = np.random.default_rng(1).standard_normal((2, 3, 448, 448)).astype(np.float32)
    big_feats = model(big)
    print("448px features:", tuple(big_feats.shape))
    return {"features": feats, "features_448": big_feats}


if __name__ == "__main__":
    main()
