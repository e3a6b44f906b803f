"""int8 serving of the PyTorch port vs the JAX package, on the CPU: GPT-2,
Whisper and T5 generation through their entry points, with the fused step
forced on (the port's runs its plain twin on CPU tensors, JAX's its kernel
in interpret mode).

The models, prompts and helpers are tests/test_torch_int8.py's (small
GPT-2, Whisper and T5 at d 128, 2 layers, 2 heads of 64). fp32 throughout;
tokens are held identical to JAX's (w8a8 from one prefilled state, for the
reason stated below).
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pytorch_models_tpu.models.audio2text as jax_a2t
import pytorch_models_tpu.models.text as jax_text
import pytorch_models_tpu.ops.attention as jax_attn
from pytorch_models_tpu.models.text import t5 as jax_t5
from pytorch_models_tpu.utils.params import quantize_tree_int8 as jax_quantize_tree_int8
from pytorch_models_tpu_torch.audio2text import Whisper, WhisperGenerator
from pytorch_models_tpu_torch.models.text import GPT2, DecoderGenerator
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step as ds
from pytorch_models_tpu_torch.text import T5Generator, T5Model
from pytorch_models_tpu_torch.utils import from_jax_params, quantize_tree_int8
from tests.test_torch_int8 import (  # noqa: F401  (gpt2_pair is a fixture)
    D,
    GPT_PROMPTS,
    N_LAYERS,
    Tok,
    _assert_trees_equal,
    _np_tree,
    _small_gpt2,
    gpt2_pair,
)

torch.set_num_threads(1)


@pytest.fixture()
def int8_serving(monkeypatch):
    """Both packages: the fused step forced on (the port's runs its plain
    twin on CPU tensors, JAX's its kernel in interpret mode) with int8
    self- and cross-KV; returns a setter for more flags on both sides. jit
    caches are cleared around the changes, since the JAX flags are read at
    trace time."""

    def flags(**kw):
        jax.clear_caches()
        for mod in (attn, jax_attn):
            for name, val in kw.items():
                monkeypatch.setattr(mod, name, val)

    flags(USE_FUSED_STEP=True, USE_INT8_KV=True, USE_INT8_KV_CROSS=True)
    yield flags
    jax.clear_caches()


def _int8_gpt2_pair(gpt2_pair):
    """The GPT-2 pair after quantize_int8(), each package quantizing its own."""
    ref, ours = gpt2_pair
    jq = jax_text.GPT2.__new__(jax_text.GPT2)
    jq.__dict__.update(ref.__dict__, params=jax_quantize_tree_int8(ref.params))
    oq = _small_gpt2(GPT2, device="cpu")
    oq.params = quantize_tree_int8(ours.params)
    return jq, oq


def test_gpt2_int8_generation_matches_jax(gpt2_pair, int8_serving):
    """quantize_int8() (w8a16) + int8 self-KV, batched over left pads; then
    single prompts (a batch of one) with the embed phase on."""
    jq, oq = _int8_gpt2_pair(gpt2_pair)
    with pltpu.force_tpu_interpret_mode():
        expected = jax_text.DecoderGenerator(jq, Tok()).generate_tokens_batch(GPT_PROMPTS, max_tokens=8)
    launches = ds.fused_decode_step.launches
    assert DecoderGenerator(oq, Tok()).generate_tokens_batch(GPT_PROMPTS, max_tokens=8) == expected
    assert ds.fused_decode_step.launches == launches  # CPU tensors: the twin, no launch
    assert all(len(set(row[len(p):])) >= 3 for row, p in zip(expected, GPT_PROMPTS))

    int8_serving(USE_FUSED_EMBED=True)
    with pltpu.force_tpu_interpret_mode():
        expected = jax_text.DecoderGenerator(jq, Tok()).generate_tokens(GPT_PROMPTS[3], max_tokens=8)
    assert DecoderGenerator(oq, Tok()).generate_tokens(GPT_PROMPTS[3], max_tokens=8) == expected


W_VOCAB, W_INIT, W_MAX = 100, [1, 2], 9


def _whisper_state_dict(seed=101, s=0.3):
    """Synthetic OpenAI-layout weights at d_model 128 (2 heads of 64), larger
    than a checkpoint's so the greedy streams move."""
    r = np.random.default_rng(seed)

    def rn(*shape, scale=s):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    sd = {"encoder.conv1.weight": rn(D, 80, 3), "encoder.conv1.bias": rn(D),
          "encoder.conv2.weight": rn(D, D, 3), "encoder.conv2.bias": rn(D),
          "encoder.positional_embedding": rn(1500, D),
          "decoder.token_embedding.weight": rn(W_VOCAB, D, scale=1.0),
          "decoder.positional_embedding": rn(448, D, scale=3.0),
          "encoder.ln_post.weight": 1 + rn(D, scale=0.02), "encoder.ln_post.bias": rn(D, scale=0.02),
          "decoder.ln.weight": 1 + rn(D, scale=0.02), "decoder.ln.bias": rn(D, scale=0.02)}
    for side in ("encoder", "decoder"):
        for i in range(N_LAYERS):
            pfx = f"{side}.blocks.{i}"
            for kind in ("attn", "cross_attn") if side == "decoder" else ("attn",):
                a = f"{pfx}.{kind}"
                sd |= {f"{a}.query.weight": rn(D, D), f"{a}.query.bias": rn(D), f"{a}.key.weight": rn(D, D),
                       f"{a}.value.weight": rn(D, D), f"{a}.value.bias": rn(D),
                       f"{a}.out.weight": rn(D, D), f"{a}.out.bias": rn(D),
                       f"{a}_ln.weight": 1 + rn(D, scale=0.02), f"{a}_ln.bias": rn(D, scale=0.02)}
            sd |= {f"{pfx}.mlp.0.weight": rn(4 * D, D), f"{pfx}.mlp.0.bias": rn(4 * D),
                   f"{pfx}.mlp.2.weight": rn(D, 4 * D), f"{pfx}.mlp.2.bias": rn(D),
                   f"{pfx}.mlp_ln.weight": 1 + rn(D, scale=0.02), f"{pfx}.mlp_ln.bias": rn(D, scale=0.02)}
    return sd


def test_whisper_int8_kv_transcription_matches_jax(int8_serving):
    """int8 self-KV (quantized after the initial tokens' prefill) and int8
    cross-KV (the decode loop's copy of the encoder caches), fp32 weights."""
    dims = dict(vocab_size=W_VOCAB, n_layers=N_LAYERS, d_model=D, n_mels=80)
    ref = jax_a2t.Whisper(**dims)
    ref.load_openai_state_dict(_whisper_state_dict())
    ours = Whisper(**dims, device="cpu")
    ours.params = from_jax_params(_np_tree(ref.params))
    r = np.random.default_rng(7)
    t = np.arange(5 * 16000) / 16000
    audios = [(0.5 * np.sin(2 * np.pi * 440 * t[:3 * 16000]) + 0.05 * r.standard_normal(3 * 16000)).astype(np.float32),
              (0.3 * r.standard_normal(5 * 16000) * np.sin(2 * np.pi * 3 * t)).astype(np.float32)]
    with pltpu.force_tpu_interpret_mode():
        expected = jax_a2t.WhisperGenerator(ref).transcribe_tokens_batch(audios, W_INIT, -1, W_MAX)
    assert WhisperGenerator(ours).transcribe_tokens_batch(audios, W_INIT, -1, W_MAX) == expected
    assert expected[0] != expected[1] and all(len(set(row[len(W_INIT):])) >= 3 for row in expected)


T5_DIMS = dict(vocab_size=100, dim=D, n_heads=2, n_layers=N_LAYERS, mlp_dim=256)
T5_PROMPTS = [[5, 9, 13, 2, 77, 31, 64], [40, 41, 3], [88, 12, 19, 6, 50, 7, 22, 91, 33, 15, 4]]
T5_MAX = 9


def _t5x_flat(seed=61, s=0.05, bias_scale=2.0):
    """Synthetic flattened t5x checkpoint (tests/test_torch_t5.py's)."""
    r = np.random.default_rng(seed)
    v, d, h, n, mlp = (T5_DIMS[k] for k in ("vocab_size", "dim", "n_heads", "n_layers", "mlp_dim"))

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


def _t5_pair(quantize: bool):
    flat = _t5x_flat()
    ref = jax_t5.T5Model(**T5_DIMS)
    ref.load_t5x_state_dict(flat)
    ours = T5Model(**T5_DIMS, device="cpu")
    ours.load_t5x_state_dict(flat)
    if quantize:
        ref.quantize_int8()
        ours.quantize_int8()
        _assert_trees_equal(ours.params, from_jax_params(_np_tree(ref.params)))
    return ref, ours


def test_t5_int8_generation_matches_jax(int8_serving):
    """quantize_int8() (w8a16; the classifier too, dequantized for the head)
    + int8 self-KV with the rel-pos self bias + int8 cross-KV."""
    ref, ours = _t5_pair(quantize=True)
    with pltpu.force_tpu_interpret_mode():
        expected = jax_t5.T5Generator(model=ref, tokenizer=object()).generate_tokens_batch(T5_PROMPTS, T5_MAX, 0, -1)
    assert T5Generator(model=ours).generate_tokens_batch(T5_PROMPTS, T5_MAX, 0, -1) == expected
    assert all(len(set(r[1:])) >= 3 for r in expected) and len({tuple(r) for r in expected}) == len(expected)


# w8a8 end to end, from one state: the fused loops start from the port's per-op prefill (GPT-2's prefilled
# caches and logits, T5's cross caches), fed to the JAX generator in place of its own. The per-op steps run in
# bf16 for int8 weights, and each package's own prefill lies a bf16 rounding from the other's: fp32 sums taken
# in another order (LayerNorm's reductions, the bf16 matmul's accumulation; under jit XLA's fusion as well)
# land on the other side of a bf16 rounding boundary, as the next test pins op by op. w8a8 quantizes every
# phase's input to 8 bits, where such a difference can move a level; the w8a16 tests above are exact without
# this. The per-op prefill itself is held to JAX's by tests/test_torch_gpt2.py and tests/test_torch_t5.py.


def test_gpt2_int8_prefill_parts_from_jax_only_by_summation_order(gpt2_pair, monkeypatch):
    """Why the two prefills part, pinned op by op: every LayerNorm and linear
    of GPT-2's int8-weight prefill, run by the port on the very input JAX's op
    got (JAX eager, jit off), gives JAX's output up to the order of an fp32
    sum. LayerNorm's mean and variance are fp32 reductions (reading 4.8e-7
    apart); the bf16 linear accumulates in fp32 in another order, so an
    output whose exact value lies within that accumulation's error of a bf16
    rounding midpoint may round the other way (reading: 1 of 32,768, 6e-8
    above the midpoint). Neither package rounds where the other does not.
    Under jit XLA fuses LayerNorm into the int8 linear and moves most
    outputs by up to one bf16 step again; a later bf16 cast turns such fp32
    noise into a bf16 step, which is what the w8a8 tests below avoid."""
    import jax.numpy as jnp

    import pytorch_models_tpu.models.text._decoder_lm as jax_dl
    import pytorch_models_tpu.transformer as jax_tfm
    from pytorch_models_tpu_torch.ops.layers import layer_norm, linear

    jq, _ = _int8_gpt2_pair(gpt2_pair)
    calls = []

    def record(mod, name):
        fn = getattr(mod, name)

        def wrapped(p, x, *args, **kw):
            out = fn(p, x, *args, **kw)
            calls.append((name, p, np.asarray(x.astype(jnp.float32)), np.asarray(out.astype(jnp.float32)), args, kw))
            return out

        monkeypatch.setattr(mod, name, wrapped)

    for name in ("layer_norm", "linear"):
        record(jax_tfm, name)
    record(jax_dl, "layer_norm")
    b, p_len = len(GPT_PROMPTS), 64
    buf, pads = np.zeros((b, p_len), np.int32), np.zeros(b, np.int32)
    for i, p in enumerate(GPT_PROMPTS):
        buf[i, p_len - len(p):], pads[i] = p, p_len - len(p)
    pos_ids = np.clip(np.arange(p_len)[None] - pads[:, None], 0, None).astype(np.int32)
    caches = jax_dl.decoder_lm_make_cache(jq.cfg, (b,), dtype=jnp.float32, stacked=False)
    with jax.disable_jit():
        jax_dl.decoder_lm_forward_cached_batch(jq.params, jq.cfg, jnp.asarray(buf), jnp.asarray(pos_ids), caches, 0,
                                               jnp.asarray(pads))
    kinds = [c[0] for c in calls]
    assert kinds.count("layer_norm") == 2 * N_LAYERS + 1 and kinds.count("linear") == 6 * N_LAYERS
    flipped = 0
    for name, p, x, expected, args, kw in calls:
        tp = from_jax_params(_np_tree(p))
        if name == "layer_norm":
            got = layer_norm(tp, torch.from_numpy(x.copy()), *args, **kw).numpy()
            np.testing.assert_allclose(got, expected, rtol=0, atol=2e-6)
            continue
        got = linear(tp, torch.from_numpy(x.copy()))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        off = got != expected
        if not off.any():
            continue
        # the exact product of the bf16 operands, its distance from a bf16 rounding midpoint, and the error
        # bound of an fp32 sum over the inner dimension
        w = tp["w"]["w_q"].to(torch.bfloat16).double() * tp["w"]["w_s"].to(torch.bfloat16).double()
        w = w.to(torch.bfloat16).double()
        xb = torch.from_numpy(x.copy()).to(torch.bfloat16).double()
        exact = (xb @ w).numpy()
        acc_err = xb.shape[-1] * 2.0 ** -24 * (xb.abs() @ w.abs()).numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(exact[off]))) - 7)
        to_mid = np.abs(np.abs(exact[off]) / ulp % 1 - 0.5) * ulp
        assert (to_mid <= acc_err[off]).all(), "a linear output apart from JAX's away from a rounding boundary"
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got[off]), np.abs(expected[off])))) - 7)
        assert (np.abs(got[off] - expected[off]) <= 2 * step).all()
        flipped += int(off.sum())
    assert flipped <= 1e-3 * sum(c[3].size for c in calls if c[0] == "linear")


def _shared_state(monkeypatch, ours_mod, jax_mod, name: str, pick):
    """Record the first output of the port's ``ours_mod.<name>`` and make
    ``jax_mod.<name>`` return it (the leaves ``pick`` takes, as JAX constants
    of their dtype; bf16 passes through fp32 exactly) in place of its own."""
    rec = {}
    ours_fn, jax_fn = getattr(ours_mod, name), getattr(jax_mod, name)

    def record(*args, **kw):
        out = ours_fn(*args, **kw)
        if not rec:
            rec.update({k: (v.float().numpy().copy(), str(v.dtype).removeprefix("torch.")) for k, v in pick(out).items()})
        return out

    def replay(*args, **kw):
        out = jax_fn(*args, **kw)
        assert rec, "the port's run must come first"
        return pick(out, {k: jax.numpy.asarray(v, dtype=dt) for k, (v, dt) in rec.items()})

    monkeypatch.setattr(ours_mod, name, record)
    monkeypatch.setattr(jax_mod, name, replay)


def _prefill_pick(out, new=None):
    """GPT-2's prefill ``(logits, caches)``: the logits and stacked K/V (the
    port's caches are per-layer views of them)."""
    logits, caches = out
    if new is None:
        return {"logits": logits, "k": torch.stack([c["k"] for c in caches]),
                "v": torch.stack([c["v"] for c in caches])}
    return new["logits"], dict(caches, k=new["k"], v=new["v"])


def _cross_pick(out, new=None):
    """T5's cross caches: the port's ``(per-layer, stacked)``, JAX's stacked."""
    if new is None:
        return {"k": out[1]["k"], "v": out[1]["v"]}
    return dict(out, k=new["k"], v=new["v"])


def test_gpt2_a8_generation_matches_jax(gpt2_pair, int8_serving, monkeypatch):
    """w8a8 + the int8 head + int8 self-KV from the port's prefilled state:
    tokens identical to JAX's."""
    import pytorch_models_tpu.models.text.generator as jax_gen
    import pytorch_models_tpu_torch.models.text.generator as gen

    jq, oq = _int8_gpt2_pair(gpt2_pair)
    int8_serving(USE_A8_DECODE=True)
    _shared_state(monkeypatch, gen, jax_gen, "decoder_lm_forward_cached_batch", _prefill_pick)
    got = DecoderGenerator(oq, Tok()).generate_tokens_batch(GPT_PROMPTS, max_tokens=8)
    with pltpu.force_tpu_interpret_mode():
        expected = jax_text.DecoderGenerator(jq, Tok()).generate_tokens_batch(GPT_PROMPTS, max_tokens=8)
    assert got == expected
    assert all(len(set(row[len(p):])) >= 3 for row, p in zip(expected, GPT_PROMPTS))


def test_t5_a8_generation_matches_jax(int8_serving, monkeypatch):
    """w8a8 + the int8 head over the dequantized classifier + int8 self- and
    cross-KV from the port's cross caches: tokens identical to JAX's."""
    import pytorch_models_tpu.transformer as jax_tfm
    import pytorch_models_tpu_torch.transformer as tfm

    ref, ours = _t5_pair(quantize=True)
    int8_serving(USE_A8_DECODE=True)
    _shared_state(monkeypatch, tfm, jax_tfm, "precompute_cross_caches", _cross_pick)
    got = T5Generator(model=ours).generate_tokens_batch(T5_PROMPTS, T5_MAX, 0, -1)
    with pltpu.force_tpu_interpret_mode():
        expected = jax_t5.T5Generator(model=ref, tokenizer=object()).generate_tokens_batch(T5_PROMPTS, T5_MAX, 0, -1)
    assert got == expected
    assert all(len(set(r[1:])) >= 3 for r in expected) and len({tuple(r) for r in expected}) == len(expected)
