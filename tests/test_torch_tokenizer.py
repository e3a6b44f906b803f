"""The port's tokenizers and string-level generation vs the JAX package, on the CPU.

``GPT2Tokenizer`` and ``WhisperTokenizer`` are the port's own copies; both
packages build them from the same synthetic tables: the 256-entry byte rank
table of tests/audio2text/test_tokenizer.py (plus three merges) and an HF
``vocab.json``/``merges.txt`` pair written from it. Ids must be identical
for ASCII, Unicode and special-token text, decoding must round-trip, and
``sot_sequence`` must agree for several languages and tasks. The BPE engine
is ``tiktoken``: the tests that encode skip without it (the GPU machine has
none). Then the string methods (``generate``, ``generate_batch``,
``generate_samples``, ``beam_search{,_batch}``, Whisper's ``transcribe`` and
``transcribe_beam``, T5's ``generate_beam`` with a sentencepiece-style
tokenizer) against JAX's on the same small models.
"""

import json

import jax
import numpy as np
import pytest
import torch

import pytorch_models_tpu.models.audio2text as jax_a2t
import pytorch_models_tpu.models.text as jax_text
from pytorch_models_tpu.models.audio2text import tokenizer as jax_wtok
from pytorch_models_tpu.models.text import t5 as jax_t5
from pytorch_models_tpu.models.text import tokenizer as jax_gtok
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator, WhisperTokenizer
from pytorch_models_tpu_torch.models.audio2text import tokenizer as wtok
from pytorch_models_tpu_torch.models.text import tokenizer as gtok
from pytorch_models_tpu_torch.text import DecoderGenerator, GPT2Tokenizer, T5Generator
from pytorch_models_tpu_torch.utils import from_jax_params
from tests.test_torch_beam import t5
from tests.test_torch_sampling import small_gpt2_pair

torch.set_num_threads(1)

TEXTS = ["hello", "hello world, hell's bells!", "  leading and trailing  ", "café 東京! naïve – ünïcödé 🙂",
         "tabs\tand\nnewlines", "123 4567 89"]


def _ranks():
    """tests/audio2text/test_tokenizer.py's synthetic table."""
    ranks = {bytes([i]): i for i in range(256)}
    ranks[b"he"] = 256
    ranks[b"ll"] = 257
    ranks[b"hell"] = 258
    return ranks


@pytest.fixture(scope="module")
def hf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpt2_tok")
    b2u = jax_gtok._bytes_to_unicode()
    vocab = {"".join(b2u[b] for b in tok): rank for tok, rank in _ranks().items()}
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\nh e\nl l\nhe ll\n", encoding="utf-8")
    return str(d / "vocab.json"), str(d / "merges.txt")


def test_from_openai_raises():
    """The rank tables need a download, which the port does not do."""
    with pytest.raises(NotImplementedError):
        GPT2Tokenizer.from_openai()
    with pytest.raises(NotImplementedError):
        WhisperTokenizer.from_openai()
    with pytest.raises(NotImplementedError):
        WhisperTokenizer.from_openai(multilingual=False)


def test_bytes_to_unicode_and_tables_match_jax(hf_files):
    assert gtok._bytes_to_unicode() == jax_gtok._bytes_to_unicode()
    assert wtok.LANGUAGES == jax_wtok.LANGUAGES and wtok._PAT == jax_wtok._PAT
    ours, theirs = GPT2Tokenizer.from_hf_files(*hf_files), jax_gtok.GPT2Tokenizer.from_hf_files(*hf_files)
    assert ours.ranks == theirs.ranks == _ranks()
    assert (ours.special_tokens, ours.n_vocab, ours.eos_token_id) == \
        (theirs.special_tokens, theirs.n_vocab, theirs.eos_token_id)


def test_load_tiktoken_ranks_matches_jax(tmp_path):
    import base64

    path = tmp_path / "t.tiktoken"
    path.write_bytes(b"".join(base64.b64encode(tok) + b" %d\n" % rank for tok, rank in _ranks().items()) + b"\n")
    assert wtok.load_tiktoken_ranks(str(path)) == jax_wtok.load_tiktoken_ranks(str(path)) == _ranks()


@pytest.mark.parametrize("num_languages", [99, 100])
def test_whisper_special_layout_matches_jax(num_languages):
    ours, theirs = WhisperTokenizer(_ranks(), num_languages), jax_wtok.WhisperTokenizer(_ranks(), num_languages)
    assert ours.special_tokens == theirs.special_tokens and ours.n_vocab == theirs.n_vocab
    for name in ("eot", "sot", "translate", "transcribe", "no_speech", "no_timestamps", "timestamp_begin"):
        assert getattr(ours, name) == getattr(theirs, name)
    for lang in ("en", "de", "ja", "su") + (("yue",) if num_languages == 100 else ()):
        for task in ("transcribe", "translate"):
            for ts in (False, True):
                assert ours.sot_sequence(lang, task, ts) == theirs.sot_sequence(lang, task, ts)
    with pytest.raises(ValueError):
        ours.language_token("xx")


@pytest.mark.parametrize("kind", ["gpt2", "whisper"])
def test_ids_match_jax_and_decode_round_trips(kind, hf_files):
    pytest.importorskip("tiktoken")
    if kind == "gpt2":
        ours, theirs = GPT2Tokenizer.from_hf_files(*hf_files), jax_gtok.GPT2Tokenizer.from_hf_files(*hf_files)
    else:
        ours, theirs = WhisperTokenizer(_ranks()), jax_wtok.WhisperTokenizer(_ranks())
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == theirs.encode(text)
        assert ours.decode(ids) == theirs.decode(ids) == text
    assert 258 in ours.encode("hello")  # the "hell" merge, in rank order
    special = "<|endoftext|>hello" + ("<|startoftranscript|><|en|>" if kind == "whisper" else "")
    ids = ours.encode(special, allow_special=True)
    assert ids == theirs.encode(special, allow_special=True) and ids[0] == ours.eos_token_id
    assert ours.decode(ids) == "hello"
    assert ours.decode(ids, skip_special=False) == theirs.decode(ids, skip_special=False) == special
    with pytest.raises(ValueError):
        ours.encode(special)  # special tokens in plain text are refused unless allowed


def test_gpt2_string_methods_match_jax(hf_files):
    pytest.importorskip("tiktoken")
    ref, ours = small_gpt2_pair()
    tok, jtok = GPT2Tokenizer.from_hf_files(*hf_files), jax_gtok.GPT2Tokenizer.from_hf_files(*hf_files)
    gen, jgen = DecoderGenerator(ours, tok), jax_text.DecoderGenerator(ref, jtok)
    prompts = ["hello world", "café"]
    assert gen.generate(prompts[0], max_tokens=8) == jgen.generate(prompts[0], max_tokens=8)
    assert gen.generate_batch(prompts, max_tokens=8) == jgen.generate_batch(prompts, max_tokens=8)
    assert gen.beam_search(prompts[0], max_tokens=8, beam_width=3) == jgen.beam_search(prompts[0], max_tokens=8,
                                                                                       beam_width=3)
    assert gen.beam_search_batch(prompts, max_tokens=8, beam_width=2) == jgen.beam_search_batch(prompts,
                                                                                                max_tokens=8,
                                                                                                beam_width=2)
    # sampled: the port's own stream (JAX's PRNG is another), decoded
    kw = dict(max_tokens=8, topk=40, top_p=0.9, temperature=0.8, seed=3)
    ids = gen.generate_tokens_samples(tok.encode(prompts[1]), 3, **kw)
    assert gen.generate_samples(prompts[1], 3, **kw) == [tok.decode(row) for row in ids]
    assert gen.generate(prompts[1], **kw) == tok.decode(gen.generate_tokens(tok.encode(prompts[1]), **kw))


def test_whisper_text_methods_match_jax():
    """A one-layer Whisper over the tokenizer's whole vocabulary (random
    init, bridged from JAX): greedy and beam transcription to text."""
    pytest.importorskip("tiktoken")
    tok, jtok = WhisperTokenizer(_ranks()), jax_wtok.WhisperTokenizer(_ranks())
    ref = jax_a2t.Whisper(vocab_size=tok.n_vocab, n_layers=1, d_model=64)
    ours = Whisper(vocab_size=tok.n_vocab, n_layers=1, d_model=64, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    audio = (np.random.default_rng(5).standard_normal(16000 * 2) * 0.1).astype(np.float32)
    gen, jgen = WhisperGenerator(ours, tok), jax_a2t.WhisperGenerator(ref, jtok)
    assert gen.transcribe(audio, max_tokens=10) == jgen.transcribe(audio, max_tokens=10)
    assert gen.transcribe_beam(audio, beam_width=3, max_tokens=10) == jgen.transcribe_beam(audio, beam_width=3,
                                                                                            max_tokens=10)
    with pytest.raises(ValueError, match="tokenizer"):
        WhisperGenerator(ours).transcribe_beam(audio)


class SentencePieceLike:
    """The sentencepiece calls T5Generator makes, over a 100-id vocabulary
    (0 pad, 1 EOS, bytes folded onto 2..99)."""

    def Encode(self, text, add_eos=False):
        return [b % 98 + 2 for b in text.encode()] + ([1] if add_eos else [])

    def Decode(self, ids):
        return "".join(chr(ord("a") + i % 26) for i in ids if i >= 2)

    def pad_id(self):
        return 0

    def eos_id(self):
        return 1


def test_t5_generate_beam_matches_jax():
    ref, ours = t5()
    text = "T5 beam"
    got = T5Generator(model=ours, tokenizer=SentencePieceLike()).generate_beam(text, max_tokens=10, beam_width=3)
    want = jax_t5.T5Generator(model=ref, tokenizer=SentencePieceLike()).generate_beam(text, max_tokens=10,
                                                                                       beam_width=3)
    assert got == want
    with pytest.raises(ValueError, match="tokenizer"):
        T5Generator(model=ours).generate_beam(text)
