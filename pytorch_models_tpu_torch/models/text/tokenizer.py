"""GPT-2 byte-level BPE tokenizer (the port's own copy of
``pytorch_models_tpu/models/text/tokenizer.py``; no ``transformers``).

The rank table is GPT-2's base vocabulary (50256 ranks) plus
``<|endoftext|>`` = id 50256: openai's ``gpt2.tiktoken`` file
(:func:`load_tiktoken_ranks`) or an HF-format ``vocab.json``
(:meth:`GPT2Tokenizer.from_hf_files`), both read from local files. The BPE
engine is ``tiktoken``, imported at the first encode or decode.
"""

from __future__ import annotations

import json
from functools import cached_property

from ..audio2text.tokenizer import _encoding, load_tiktoken_ranks

__all__ = ["EOT", "GPT2Tokenizer", "load_tiktoken_ranks"]

EOT = "<|endoftext|>"


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's printable-unicode byte escaping (HF vocab.json key format)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class GPT2Tokenizer:
    """Encode/decode with GPT-2's byte-level BPE.

    ``ranks``: byte-sequence -> rank table (the 50256-entry base
    vocabulary); ``<|endoftext|>`` is appended as the single special token,
    GPT-2's id layout (50256). Satisfies the generators' tokenizer protocol
    (``encode``/``decode``/``eos_token_id``).
    """

    def __init__(self, ranks: dict[bytes, int]):
        self.ranks = ranks
        self.special_tokens = {EOT: len(ranks)}
        self.n_vocab = len(ranks) + 1
        self.eot = self.special_tokens[EOT]

    @staticmethod
    def from_openai() -> "GPT2Tokenizer":
        """The public rank table needs a download, which the port does not
        do: use ``GPT2Tokenizer(load_tiktoken_ranks(path))`` on a local copy,
        or :meth:`from_hf_files`."""
        raise NotImplementedError("the gpt2.tiktoken rank table needs a download; pass "
                                  "GPT2Tokenizer(load_tiktoken_ranks(path)) a local copy, or use from_hf_files")

    @staticmethod
    def from_hf_files(vocab_path: str, merges_path: str | None = None) -> "GPT2Tokenizer":
        """The rank table from an HF-format ``vocab.json``: it maps
        byte-escaped token strings to ids, which are exactly the BPE ranks;
        ``merges.txt`` carries nothing more (accepted, unused)."""
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        u2b = {c: bytes([b]) for b, c in _bytes_to_unicode().items()}
        return GPT2Tokenizer({b"".join(u2b[c] for c in tok): idx for tok, idx in vocab.items() if tok != EOT})

    @cached_property
    def _encoding(self):
        return _encoding(f"gpt2_{len(self.ranks)}", self.ranks, self.special_tokens, self.n_vocab)

    def encode(self, text: str, allow_special: bool = False) -> list[int]:
        return self._encoding.encode(text, allowed_special=set(self.special_tokens) if allow_special else set())

    def decode(self, tokens, skip_special: bool = True) -> str:
        tokens = [int(t) for t in tokens]
        if skip_special:
            tokens = [t for t in tokens if t < len(self.ranks)]
        return self._encoding.decode(tokens)

    @property
    def eos_token_id(self) -> int:
        return self.eot
