"""Whisper transcription on the PyTorch port: single segment, long-form,
speculative.

Runs on the CUDA card (--cpu: on the CPU). The port's counterpart of
transcribe.py: the same models, audio and printed lines. With --pretrained
this reads whisper-tiny and its multilingual BPE rank table from the
checkpoint cache (``tiny.pt``, ``whisper_tokenizer/multilingual.tiktoken``)
and prints text; otherwise random weights demonstrate the API on synthetic
audio.
"""

import sys

import numpy as np

sys.path.insert(0, ".")
from examples._torch_common import require_cached, setup  # noqa: E402


def main(argv=None, **models) -> dict:
    """``models``: ``model`` and ``draft``, Whispers to use in place of the
    ones built here (random weights only)."""
    args = setup(__doc__, argv)

    from pytorch_models_tpu_torch.audio2text import SpeculativeWhisperGenerator, Whisper, WhisperGenerator

    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(16000 * 45) * 0.1).astype(np.float32)  # 45 s
    out = {}

    if args.pretrained:
        from pytorch_models_tpu_torch.models.audio2text.tokenizer import WhisperTokenizer

        require_cached("tiny.pt", "whisper_tokenizer/multilingual.tiktoken")
        model = Whisper.from_openai("tiny", pretrained=True, device=args.device).to_bf16()
        gen = WhisperGenerator(model, WhisperTokenizer.from_openai())  # tiny's table: the multilingual one
        out["single"] = gen.transcribe(audio[: 16000 * 30])
        print("single segment:", out["single"])
        out["long"] = gen.transcribe_long(audio)
        print("long-form:     ", out["long"])
    else:
        model = models.get("model") or Whisper(vocab_size=100, n_layers=2, d_model=64, n_mels=80, device=args.device)
        gen = WhisperGenerator(model)
        INIT, EOT = [50, 51, 52], 99
        seg = audio[: 16000 * 30]
        out["single"] = gen.transcribe_tokens(seg, INIT, EOT, max_tokens=16)
        print("single segment tokens:", out["single"])
        out["long"] = gen.transcribe_long_tokens(audio, INIT, EOT, max_tokens=16)
        print("long-form windows:    ", [len(t) for t in out["long"]])

        # speculative: a smaller whisper drafts, the target verifies — exact
        draft = models.get("draft") or Whisper(vocab_size=100, n_layers=1, d_model=64, n_mels=80, rng=3,
                                                device=args.device)
        spec = SpeculativeWhisperGenerator(model, draft, k=4)
        out["speculative"] = spec.transcribe_tokens(seg, INIT, EOT, max_tokens=16)
        print("speculative tokens:   ", out["speculative"])
    return out


if __name__ == "__main__":
    main()
