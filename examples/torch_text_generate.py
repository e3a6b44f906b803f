"""GPT-2 text generation on the PyTorch port: greedy, nucleus sampling,
batching, best-of-n parallel sampling, beam search, speculative decoding,
and scoring.

Runs on the CUDA card (--cpu: on the CPU). The port's counterpart of
text_generate.py: the same models, prompts and printed lines. With
--pretrained this reads the real GPT-2 weights and its BPE rank table from
the checkpoint cache (``gpt2.bin``, ``gpt2_tokenizer/gpt2.tiktoken``) and
prints text; otherwise random weights + a toy tokenizer show the API shape.
"""

import sys

sys.path.insert(0, ".")
from examples._torch_common import require_cached, setup  # noqa: E402


class ToyTokenizer:  # toy tokenizer: bytes in, token ids out
    eos_token_id = None
    encode = staticmethod(lambda s: [b % 200 for b in s.encode()])
    decode = staticmethod(lambda ids: " ".join(map(str, ids)))


def main(argv=None, **models) -> dict:
    """``models``: ``model`` and ``draft``, GPT-2s to use in place of the
    ones built here (random weights only)."""
    args = setup(__doc__, argv)

    from pytorch_models_tpu_torch.text import GPT2, DecoderGenerator, SpeculativeDecoderGenerator

    if args.pretrained:
        from pytorch_models_tpu_torch.models.text.tokenizer import GPT2Tokenizer

        require_cached("gpt2.bin", "gpt2_tokenizer/gpt2.tiktoken")
        model = GPT2.from_hf("gpt2", pretrained=True, device=args.device).to_bf16()
        tok = GPT2Tokenizer.from_openai()
    else:
        tok = ToyTokenizer
        model = models.get("model") or GPT2(n_layers=4, d_model=256, device=args.device)

    gen = DecoderGenerator(model, tok)
    prompt = "The Pallas kernel"
    out = {}

    out["greedy"] = gen.generate(prompt, max_tokens=24)
    print("greedy:      ", out["greedy"])
    out["nucleus"] = gen.generate(prompt, max_tokens=24, topk=50, top_p=0.9, temperature=0.8, seed=1)
    print("nucleus:     ", out["nucleus"])
    out["batched"] = gen.generate_batch([prompt, "TPUs are"], max_tokens=16)
    print("batched:     ", out["batched"])
    # best-of-n: ONE prefill, KV cache fanned out to n sample rows
    out["best-of-3"] = gen.generate_samples(prompt, n=3, max_tokens=16, topk=40, seed=2)
    print("best-of-3:   ", out["best-of-3"])
    out["beam"] = gen.beam_search(prompt, max_tokens=24, beam_width=4)
    print("beam (w=4):  ", out["beam"])

    # speculative decoding: a small draft proposes k tokens, the target verifies
    # them in one chunked forward — token-identical to plain greedy for ANY draft
    if args.pretrained:
        draft = GPT2.from_hf("gpt2", pretrained=True, device=args.device).to_bf16()  # stand-in draft
    else:
        draft = models.get("draft") or GPT2(n_layers=2, d_model=256, device=args.device)
    spec = SpeculativeDecoderGenerator(model, draft, tok, k=4)
    out["speculative"] = spec.generate(prompt, max_tokens=24)
    print("speculative: ", out["speculative"])

    out["perplexity"] = gen.perplexity(prompt)
    print("perplexity:  ", out["perplexity"])
    return out


if __name__ == "__main__":
    main()
