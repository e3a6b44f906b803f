"""Whisper text tokenizer: byte-level BPE with Whisper's special-token
layout (the port's own copy of
``pytorch_models_tpu/models/audio2text/tokenizer.py``).

The BPE engine is ``tiktoken``, imported when a tokenizer first encodes or
decodes, so importing this module needs nothing beyond the standard
library. Rank tables are openai-whisper's ``gpt2.tiktoken`` /
``multilingual.tiktoken`` assets: :meth:`WhisperTokenizer.from_openai` reads
them from the local cache (``whisper_tokenizer/``; a miss downloads them),
and :func:`load_tiktoken_ranks` reads any local copy.

Special tokens follow openai-whisper's layout exactly (appended after the
base ranks, in this order): <|endoftext|>, <|startoftranscript|>, one token
per language, <|translate|>, <|transcribe|>, <|startoflm|>, <|startofprev|>,
<|nospeech|>, <|notimestamps|>, then 1501 timestamp tokens <|0.00|>..<|30.00|>.
For the multilingual table (50257 ranks, 99 languages) this gives
<|startoftranscript|> = 50258 and n_vocab = 51865; large-v3 adds "yue"
(num_languages=100, n_vocab 51866).
"""

from __future__ import annotations

import base64
from functools import cached_property

# openai-whisper's language registry order: token ids depend on it
LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca", "nl",
    "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms", "cs", "ro",
    "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la", "mi", "ml", "cy",
    "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn", "et", "mk", "br", "eu",
    "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km",
    "sn", "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi", "lo",
    "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my", "bo", "tl", "mg",
    "as", "tt", "haw", "ln", "ha", "ba", "jw", "su", "yue",
)

_ASSET_URL = "https://raw.githubusercontent.com/openai/whisper/main/whisper/assets"

# the GPT-2 text-splitting pattern openai-whisper uses
_PAT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


def _encoding(name: str, ranks: dict[bytes, int], special_tokens: dict[str, int], n_vocab: int):
    """A ``tiktoken`` BPE encoding over ``ranks`` (imported here: the
    package does not need ``tiktoken`` to load)."""
    import tiktoken

    return tiktoken.Encoding(name=name, explicit_n_vocab=n_vocab, pat_str=_PAT, mergeable_ranks=ranks,
                             special_tokens=special_tokens)


class WhisperTokenizer:
    """Encode/decode with Whisper's special-token id layout.

    ``ranks``: byte-sequence -> BPE rank table (the base text vocabulary).
    ``num_languages``: 99 (all models up to large-v2) or 100 (large-v3).
    """

    def __init__(self, ranks: dict[bytes, int], num_languages: int = 99):
        self.ranks = ranks
        self.num_languages = num_languages
        n = len(ranks)
        specials = ["<|endoftext|>", "<|startoftranscript|>"]
        specials += [f"<|{lang}|>" for lang in LANGUAGES[:num_languages]]
        specials += ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                     "<|nospeech|>", "<|notimestamps|>"]
        specials += [f"<|{i * 0.02:.2f}|>" for i in range(1501)]
        self.special_tokens = {tok: n + i for i, tok in enumerate(specials)}
        self.n_vocab = n + len(specials)

        self.eot = self.special_tokens["<|endoftext|>"]
        self.sot = self.special_tokens["<|startoftranscript|>"]
        self.translate = self.special_tokens["<|translate|>"]
        self.transcribe = self.special_tokens["<|transcribe|>"]
        self.no_speech = self.special_tokens["<|nospeech|>"]
        self.no_timestamps = self.special_tokens["<|notimestamps|>"]
        self.timestamp_begin = self.special_tokens["<|0.00|>"]

    @staticmethod
    def from_openai(multilingual: bool = True, num_languages: int = 99) -> "WhisperTokenizer":
        """The official rank table (gpt2 or multilingual), through the cache."""
        from ...utils.download import hub_download

        name = "multilingual" if multilingual else "gpt2"
        path = hub_download(f"{_ASSET_URL}/{name}.tiktoken", "whisper_tokenizer")
        return WhisperTokenizer(load_tiktoken_ranks(path), num_languages=num_languages)

    @cached_property
    def _encoding(self):
        return _encoding(f"whisper_{len(self.ranks)}", self.ranks, self.special_tokens, self.n_vocab)

    def language_token(self, language: str) -> int:
        if language not in LANGUAGES[: self.num_languages]:
            raise ValueError(f"unknown language {language!r}")
        return self.special_tokens[f"<|{language}|>"]

    def sot_sequence(self, language: str = "en", task: str = "transcribe", timestamps: bool = False) -> list[int]:
        """Initial decoder tokens: <|startoftranscript|><|lang|><|task|>[<|notimestamps|>]."""
        seq = [self.sot, self.language_token(language), self.transcribe if task == "transcribe" else self.translate]
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq

    def encode(self, text: str, allow_special: bool = False) -> list[int]:
        return self._encoding.encode(text, allowed_special=set(self.special_tokens) if allow_special else set())

    def decode(self, tokens, skip_special: bool = True) -> str:
        tokens = [int(t) for t in tokens]
        if skip_special:
            tokens = [t for t in tokens if t < len(self.ranks)]
        return self._encoding.decode(tokens)

    @property
    def eos_token_id(self) -> int:
        """The generators' tokenizer protocol."""
        return self.eot


def load_tiktoken_ranks(path: str) -> dict[bytes, int]:
    """Parse a .tiktoken file: one ``base64(token) rank`` pair per line."""
    ranks = {}
    with open(path, "rb") as f:
        for line in f:
            if not line.strip():
                continue
            tok, rank = line.split()
            ranks[base64.b64decode(tok)] = int(rank)
    return ranks
