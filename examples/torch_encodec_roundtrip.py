"""EnCodec 24 kHz on the PyTorch port: waveform -> RVQ codes -> waveform.

Runs on the CUDA card (--cpu: on the CPU). The port's counterpart of
encodec_roundtrip.py: the same model, input and printed lines.
"""

import sys

import numpy as np

sys.path.insert(0, ".")
from examples._torch_common import require_cached, setup, shape_dtype  # noqa: E402


def main(argv=None, **models) -> dict:
    """``models``: ``model``, an EnCodec to use in place of the one built here."""
    args = setup(__doc__, argv)

    from pytorch_models_tpu_torch.audio import EnCodec

    if args.pretrained:
        require_cached("encodec_24khz-d7cc33bc.th")
    model = models.get("model") or EnCodec.from_facebook("24khz", pretrained=args.pretrained, device=args.device)
    audio = (np.random.default_rng(0).standard_normal((1, 1, 24000 * 2)) * 0.1).astype(np.float32)

    codes, scale = model.encode(audio)
    print("codes:", shape_dtype(codes))  # (1, n_q, frames) int
    out = model.decode(codes, scale)
    print("reconstruction:", tuple(out.shape))
    return {"codes": codes, "scale": scale, "reconstruction": out}


if __name__ == "__main__":
    main()
