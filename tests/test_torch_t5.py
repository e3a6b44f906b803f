"""The T5 generation slice of the PyTorch port vs the JAX package, on the CPU.

A small T5 (vocab 100, d 128, 2 heads of 64, 2 + 2 layers, mlp 256) is
loaded in both packages from one synthetic flat t5x checkpoint made with
``numpy.random.default_rng``: matrices at 0.05 (tests/text/test_t5.py's
scale; the greedy streams move) and rel-pos tables at 2.0, forty times that,
so that the bias visibly changes every output: a bias path that dropped the
bias would fail here (``test_rel_pos_bias_matters``). On the CPU the JAX
side runs its XLA paths, and with ``USE_FUSED_STEP`` its fused-step kernel in
interpret mode; the port runs its plain path, the kernel wrappers (plain
versions on CPU tensors) and the fused step's plain twin.

fp32 throughout: the two sides sum in other orders, so logits are held to
1e-4 and log-probs to 1e-5 (reading: logits 8.3e-7 apart, each side 9e-7
from a float64 run of the port), tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pytorch_models_tpu.ops.attention as jax_attn
from pytorch_models_tpu.models.text import t5 as jax_t5
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.models.text import t5
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step, gather, greedy_head
from pytorch_models_tpu_torch.ops.decode_attention import decode_attention
from pytorch_models_tpu_torch.text import T5Generator, T5Model
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

DIMS = dict(vocab_size=100, dim=128, n_heads=2, n_layers=2, mlp_dim=256)
PROMPTS = [[5, 9, 13, 2, 77, 31, 64], [40, 41, 3], [88, 12, 19, 6, 50, 7, 22, 91, 33, 15, 4]]
PAD, MAX_TOKENS = 0, 12
LOGIT_TOL = 1e-4
SCORE_TOL = 1e-5


def _t5x_flat(seed=61, s=0.05, bias_scale=2.0):
    """Synthetic flattened t5x checkpoint ({dotted key: (in, out) kernels})."""
    r = np.random.default_rng(seed)
    v, d, h, n, mlp = (DIMS[k] for k in ("vocab_size", "dim", "n_heads", "n_layers", "mlp_dim"))

    def rn(*shape, scale=s):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    flat = {"token_embedder.embedding": rn(v, d, scale=1.0), "decoder.logits_dense.kernel": rn(d, v),
            "encoder.relpos_bias.rel_embedding": rn(h, 32, scale=bias_scale),
            "decoder.relpos_bias.rel_embedding": rn(h, 32, scale=bias_scale),
            "encoder.encoder_norm.scale": 1 + rn(d, scale=0.1), "decoder.decoder_norm.scale": 1 + rn(d, scale=0.1)}
    attn_shapes = [("query", (d, h * 64)), ("key", (d, h * 64)), ("value", (d, h * 64)), ("out", (h * 64, d))]
    for side in ("encoder", "decoder"):
        for i in range(n):
            b = f"{side}.layers_{i}"
            kinds = [("self_attention", "pre_self_attention_layer_norm"),
                     ("encoder_decoder_attention", "pre_cross_attention_layer_norm")] if side == "decoder" else \
                [("attention", "pre_attention_layer_norm")]
            for kind, norm in kinds:
                flat[f"{b}.{norm}.scale"] = 1 + rn(d, scale=0.1)
                for proj, shape in attn_shapes:
                    flat[f"{b}.{kind}.{proj}.kernel"] = rn(*shape)
            flat[f"{b}.pre_mlp_layer_norm.scale"] = 1 + rn(d, scale=0.1)
            flat |= {f"{b}.mlp.wi_0.kernel": rn(d, mlp), f"{b}.mlp.wi_1.kernel": rn(d, mlp),
                     f"{b}.mlp.wo.kernel": rn(mlp, d)}
    return flat


@pytest.fixture(scope="module")
def models():
    flat = _t5x_flat()
    ref = jax_t5.T5Model(**DIMS)
    ref.load_t5x_state_dict(flat)
    ours = T5Model(**DIMS, device="cpu")
    ours.load_t5x_state_dict(flat)
    return ref, ours, flat


def _pick_eos(rows):
    """A token row 0 generates after >= 3 other tokens, first seen at another
    step (or never) in the other rows, so the rows stop at different steps."""
    g0 = rows[0][1:]
    for i, tok in enumerate(g0[3:], start=3):
        if tok not in g0[:i] and all(tok not in r[1:] or r[1:].index(tok) != i for r in rows[1:]):
            return tok
    raise AssertionError(f"no usable EOS in {rows}")


@pytest.fixture(scope="module")
def jax_outputs(models):
    ref, _, _ = models
    gen = jax_t5.T5Generator(model=ref, tokenizer=object())
    no_eos = gen.generate_tokens_batch(PROMPTS, MAX_TOKENS, PAD, -1)
    eos = _pick_eos(no_eos)
    r = np.random.default_rng(3)
    x, tgt = r.integers(0, 100, (2, 12)), r.integers(0, 100, (2, 7))
    targets = [r.integers(1, 100, n).tolist() for n in (6, 9, 2)]
    return {
        "no_eos": no_eos, "eos": eos, "x": x, "tgt": tgt, "logits": np.asarray(ref(x, tgt)),
        "batch": gen.generate_tokens_batch(PROMPTS, MAX_TOKENS, PAD, eos),
        "single": [gen.generate_tokens(p, MAX_TOKENS, PAD, eos) for p in PROMPTS],
        "targets": targets, "scores": gen.score_tokens_batch(PROMPTS, targets, PAD),
    }


@pytest.fixture(params=["plain", "kernel_wrappers", "fused"])
def route(request, monkeypatch):
    """"plain": every dispatch flag False (the JAX package's XLA route);
    "kernel_wrappers": every kernel flag True (on CPU tensors the wrappers
    run their kernels' plain versions) with the fused step off; "fused":
    USE_FUSED_STEP True (the fused step's plain twin)."""
    on = request.param == "kernel_wrappers"
    for mod, name in ((attn, "USE_DECODE_KERNEL"), (attn, "USE_ENCODER_KERNEL"), (attn, "USE_GREEDY_HEAD"),
                      (gather, "USE_GATHER_KERNEL")):
        monkeypatch.setattr(mod, name, on)
    monkeypatch.setattr(attn, "USE_FUSED_STEP", request.param == "fused")
    return request.param


def test_load_t5x_state_dict_matches_jax(models):
    ref, ours, _ = models
    expected = from_jax_params(jax.tree.map(to_np, ref.params))
    flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda a: a.numpy(), ours.params))
    flat_exp = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda a: a.numpy(), expected)))
    assert len(flat_got) == len(flat_exp)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_exp[path])


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_buckets_match_jax(bidirectional):
    rel = np.arange(-300, 301)
    expected = np.asarray(jax_t5.relative_position_buckets(jnp.asarray(rel, jnp.int32), bidirectional, 32, 128))
    got = t5.relative_position_buckets(torch.from_numpy(rel), bidirectional, 32, 128)
    np.testing.assert_array_equal(got.numpy(), expected)
    # all 32 buckets are hit, but for bucket 16 when bidirectional (rel > 0 starts at distance 1)
    assert len(np.unique(expected)) == (31 if bidirectional else 32)


def test_forward_matches_jax(models, jax_outputs, route):
    _, ours, _ = models
    got = ours(jax_outputs["x"], jax_outputs["tgt"])
    assert got.shape == (2, 7, 100)
    np.testing.assert_allclose(got.numpy(), jax_outputs["logits"], atol=LOGIT_TOL, rtol=0)
    unbatched = ours(jax_outputs["x"][0], jax_outputs["tgt"][0])
    np.testing.assert_allclose(unbatched.numpy(), jax_outputs["logits"][0], atol=LOGIT_TOL, rtol=0)


def test_rel_pos_bias_matters(models, jax_outputs):
    """Zeroing the decoder's rel-pos table moves the logits far beyond the
    tolerance (and the encoder's too): the bias paths are really exercised."""
    _, ours, flat = models
    for side in ("encoder", "decoder"):
        no_bias = T5Model(**DIMS, device="cpu")
        no_bias.load_t5x_state_dict(flat | {f"{side}.relpos_bias.rel_embedding": np.zeros((2, 32), np.float32)})
        diff = np.abs(no_bias(jax_outputs["x"], jax_outputs["tgt"]).numpy() - jax_outputs["logits"]).max()
        assert diff > 1000 * LOGIT_TOL, side


def test_generate_tokens_match_jax(models, jax_outputs, route):
    _, ours, _ = models
    gen = T5Generator(model=ours)
    counts = {f: f.launches for f in (decode_step.fused_cross_decode_step, greedy_head.greedy_argmax)}
    bias_launches = decode_attention.bias_launches
    eos = jax_outputs["eos"]
    assert gen.generate_tokens_batch(PROMPTS, MAX_TOKENS, PAD, eos) == jax_outputs["batch"]
    assert [gen.generate_tokens(p, MAX_TOKENS, PAD, eos) for p in PROMPTS] == jax_outputs["single"]
    assert gen.generate_tokens_batch(PROMPTS, MAX_TOKENS, PAD, -1) == jax_outputs["no_eos"]
    # on CPU tensors the wrappers run plain versions and count no launch
    assert {f: f.launches for f in counts} == counts and decode_attention.bias_launches == bias_launches


def test_generate_tokens_fused_match_jax_fused(models, jax_outputs, monkeypatch):
    """Both packages' fused routes: the JAX kernel in interpret mode (its
    flag is read at trace time, so jit caches are cleared around it)."""
    ref, ours, _ = models
    jax.clear_caches()
    monkeypatch.setattr(jax_attn, "USE_FUSED_STEP", True)
    monkeypatch.setattr(attn, "USE_FUSED_STEP", True)
    try:
        with pltpu.force_tpu_interpret_mode():
            expected = jax_t5.T5Generator(model=ref, tokenizer=object()).generate_tokens_batch(
                PROMPTS, MAX_TOKENS, PAD, jax_outputs["eos"])
    finally:
        jax.clear_caches()
    assert expected == jax_outputs["batch"]
    assert T5Generator(model=ours).generate_tokens_batch(PROMPTS, MAX_TOKENS, PAD, jax_outputs["eos"]) == expected


def test_greedy_streams_are_not_trivial(jax_outputs):
    rows = jax_outputs["no_eos"]
    assert all(len(set(r[1:])) >= 3 for r in rows) and len({tuple(r) for r in rows}) == len(rows)
    batch = jax_outputs["batch"]
    assert batch[0][-1] == jax_outputs["eos"] and len({len(r) for r in batch}) > 1


def test_score_tokens_match_jax(models, jax_outputs, route):
    _, ours, _ = models
    gen = T5Generator(model=ours)
    got = gen.score_tokens_batch(PROMPTS, jax_outputs["targets"], PAD)
    for g, e in zip(got, jax_outputs["scores"]):
        np.testing.assert_allclose(g, e, atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(gen.score_tokens(PROMPTS[1], jax_outputs["targets"][1], PAD),
                               jax_outputs["scores"][1], atol=SCORE_TOL, rtol=0)


def test_entry_points(models, jax_outputs):
    m = T5Model.from_t5x("flan_t5-base", device="cpu")
    assert (m.cfg.dim, m.cfg.n_heads, m.cfg.n_layers, m.cfg.mlp_dim, m.cfg.vocab_size) == (768, 12, 12, 2048, 32128)
    with pytest.raises(NotImplementedError):
        T5Model.from_t5x("flan_t5-small", pretrained=True)
    _, ours, _ = models
    gen = T5Generator(model=ours)
    with pytest.raises(ValueError):
        gen.generate("hello")
    with pytest.raises(ValueError):
        gen.generate_tokens_batch([], MAX_TOKENS, PAD, 1)

    class Tok:  # a sentencepiece-style tokenizer over space-separated ids
        def Encode(self, text, add_eos=False):
            return [int(t) for t in text.split()]

        def Decode(self, ids):
            return " ".join(map(str, ids))

        def pad_id(self):
            return PAD

        def eos_id(self):
            return jax_outputs["eos"]

    gen.tokenizer = Tok()
    assert gen.generate(Tok().Decode(PROMPTS[0]), MAX_TOKENS) == Tok().Decode(jax_outputs["single"][0])
    assert gen.generate_batch([Tok().Decode(p) for p in PROMPTS], MAX_TOKENS) == [Tok().Decode(r) for r in
                                                                                   jax_outputs["batch"]]
    np.testing.assert_allclose(gen.score(Tok().Decode(PROMPTS[0]), Tok().Decode(jax_outputs["targets"][0])),
                               jax_outputs["scores"][0], atol=SCORE_TOL, rtol=0)
