"""Whisper continuous batching (``WhisperContinuousBatchingGenerator``) of
the PyTorch port vs the JAX package's engine and the port's plain
generator, on the CPU.

A tiny Whisper (vocab 100, 2 layers, d_model 64, one head of 64, 80 mels)
loaded in the JAX package from a synthetic OpenAI state dict made with
``numpy.random.default_rng`` (weights at 0.3, decoder position embeddings at
3.0, so that the greedy streams move), bridged into the port by
``from_jax_params``. Two routes on the port's side: per-op (the CPU
default) and fused (``USE_FUSED_STEP = True``: on CPU tensors the fused
step's wrapper runs its plain twin, with per-row pads and positions; a spy
counts its calls and their rows). fp32 throughout. Tolerance: token
identity, per segment, with the JAX engine, with the port's
``WhisperGenerator.transcribe_tokens`` and across routes, pools of 1, 3 and
32 slots, mid-flight admissions over stale self and cross caches.

Sampling: the port draws transcript token g of segment r by the
counter-based uniform of (seed, r, g), JAX by ``fold_in`` keys; the streams
cannot match. Exactly: a segment's stream does not depend on the pool size,
``check_every`` or the route. By distribution: the first sampled token of
many segments of one audio, drawn by both engines, passes a chi-square test
against the top-k renormalised probabilities computed here in float64.

The int8 pools (``USE_INT8_KV`` and ``USE_INT8_KV_CROSS`` on the fused
route) are held token-identical to the JAX package's int8 pool, its kernel
in interpret mode (d_model 128, which its fused step needs), and to the
port's plain generator under the same flags.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy import stats

import pytorch_models_tpu.models.audio2text as jax_a2t
import pytorch_models_tpu.ops.attention as jax_attn
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.audio2text import Whisper, WhisperContinuousBatchingGenerator, WhisperGenerator
from pytorch_models_tpu_torch.models.audio2text import whisper as wmod
from pytorch_models_tpu_torch.models.text.continuous import _bucket_pow2
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import decode_step as ds
from pytorch_models_tpu_torch.utils import from_jax_params

torch.set_num_threads(1)

TINY = dict(vocab_size=100, n_layers=2, d_model=64, n_mels=80)
INIT = [1, 2, 3]
SR = 16000
MAX_TOKENS = 16
P_MIN = 1e-3  # chi-square p-value floor


def _openai_state_dict(cfg: dict, seed=103, s=0.3):
    r = np.random.default_rng(seed)
    d, nm, v = cfg["d_model"], cfg["n_mels"], cfg["vocab_size"]

    def rn(*shape, scale=s):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    sd = {
        "encoder.conv1.weight": rn(d, nm, 3), "encoder.conv1.bias": rn(d),
        "encoder.conv2.weight": rn(d, d, 3), "encoder.conv2.bias": rn(d),
        "encoder.positional_embedding": rn(1500, d),
        "decoder.token_embedding.weight": rn(v, d, scale=1.0),
        "decoder.positional_embedding": rn(448, d, scale=3.0),
    }
    for pfx in ("encoder.ln_post", "decoder.ln"):
        sd.update({f"{pfx}.weight": 1 + rn(d, scale=0.02), f"{pfx}.bias": rn(d, scale=0.02)})
    for side in ("encoder", "decoder"):
        for i in range(cfg["n_layers"]):
            pfx = f"{side}.blocks.{i}"
            for blk in ("attn", "cross_attn") if side == "decoder" else ("attn",):
                sd.update({f"{pfx}.{blk}.query.weight": rn(d, d), f"{pfx}.{blk}.query.bias": rn(d),
                           f"{pfx}.{blk}.key.weight": rn(d, d), f"{pfx}.{blk}.value.weight": rn(d, d),
                           f"{pfx}.{blk}.value.bias": rn(d), f"{pfx}.{blk}.out.weight": rn(d, d),
                           f"{pfx}.{blk}.out.bias": rn(d)})
            for ln in ("attn_ln", "mlp_ln") + (("cross_attn_ln",) if side == "decoder" else ()):
                sd.update({f"{pfx}.{ln}.weight": 1 + rn(d, scale=0.02), f"{pfx}.{ln}.bias": rn(d, scale=0.02)})
            sd.update({f"{pfx}.mlp.0.weight": rn(4 * d, d), f"{pfx}.mlp.0.bias": rn(4 * d),
                       f"{pfx}.mlp.2.weight": rn(d, 4 * d), f"{pfx}.mlp.2.bias": rn(d)})
    return sd


def _pair(cfg: dict):
    """(JAX model, port model) over the same weights."""
    ref = jax_a2t.Whisper(**cfg)
    ref.load_openai_state_dict(_openai_state_dict(cfg))
    ours = Whisper(**cfg, device="cpu")
    ours.params = from_jax_params(jax.tree.map(to_np, ref.params))
    return ref, ours


def _audios(n, seed=7):
    """Segments of 1-7 s: tones in noise, rows that decode apart."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = np.arange(int(SR * (1 + i % 7))) / SR
        out.append((0.3 * np.sin(2 * np.pi * (200 + 90 * i) * t) * (1 + np.sin(2 * np.pi * (i + 1) * t))
                    + 0.1 * r.standard_normal(len(t))).astype(np.float32))
    return out


AUDIOS = _audios(7)


@pytest.fixture(scope="module")
def pair():
    return _pair(TINY)


def _plain(om, audios, eot, max_tokens=MAX_TOKENS, init=INIT):
    """The oracle: the port's transcribe_tokens per segment on the per-op
    route, whatever route the test set."""
    gen = WhisperGenerator(om)
    flag, attn.USE_FUSED_STEP = attn.USE_FUSED_STEP, False
    try:
        return [gen.transcribe_tokens(a, init, eot, max_tokens) for a in audios]
    finally:
        attn.USE_FUSED_STEP = flag


@pytest.fixture(scope="module")
def refs(pair):
    """An EOT that the streams emit at spread steps (so that segments end at
    different times), the plain generator's outputs with it, and the JAX
    engine's at a pool of 2."""
    jm, om = pair
    free = [row[len(INIT):] for row in _plain(om, AUDIOS, -1)]

    def ends(t):  # where each stream would stop with EOT t (None: it emits t before its 3rd token)
        firsts = [row.index(t) if t in row else len(row) for row in free]
        return None if min(firsts) < 2 else firsts

    eot = max((t for row in free for t in row if ends(t)), key=lambda t: (len(set(ends(t))), t))
    plain = _plain(om, AUDIOS, eot)
    jax_out = jax_a2t.WhisperContinuousBatchingGenerator(jm, batch_size=2, check_every=4, pool_ctx=128) \
        .transcribe_tokens_many(AUDIOS, INIT, eot, max_tokens=MAX_TOKENS)
    assert jax_out == plain
    lengths = {len(o) for o in plain}
    assert len(lengths) >= 3 and sum(len(set(o[len(INIT):])) for o in plain) >= 2 * len(AUDIOS)
    return eot, plain


ROUTES = ("per-op", "fused")


@pytest.fixture()
def route(request, monkeypatch):
    """``fused`` forces USE_FUSED_STEP (the twin on CPU tensors); returns the
    rows of every fused cross step called."""
    rows = []
    monkeypatch.setattr(attn, "USE_FUSED_STEP", request.param == "fused")
    real = ds.fused_cross_decode_step

    def spy(*args, **kw):
        rows.append(args[2].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(ds, "fused_cross_decode_step", spy)
    return request.param, rows


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("pool", [1, 3, 32])
def test_greedy_pool_matches_jax_and_plain(pair, refs, route, pool):
    """Seven segments, EOT at spread steps: mid-flight admissions into slots
    holding a previous transcript's self and cross K/V; every segment
    token-identical to the JAX engine's (which equals the plain generator's)
    and to the port's plain generator. On the fused route every step is one
    call of the fused step over the whole pool."""
    name, rows = route
    _, om = pair
    eot, plain = refs
    cb = WhisperContinuousBatchingGenerator(om, batch_size=pool, check_every=4, pool_ctx=128)
    assert cb.transcribe_tokens_many(AUDIOS, INIT, eot, max_tokens=MAX_TOKENS) == plain
    st = cb.last_stats
    assert st.admissions == len(AUDIOS)
    if name == "fused":
        assert len(rows) == st.decode_steps and set(rows) == {pool}
    else:
        assert rows == []


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_epoch_reset(pair, refs, route):
    """A pool context so small that the position budget runs out mid-queue:
    the pool drains, rewinds and readmits, still exact."""
    _, om = pair
    eot, _ = refs
    cb = WhisperContinuousBatchingGenerator(om, batch_size=2, check_every=8, pool_ctx=40)
    outs = cb.transcribe_tokens_many(AUDIOS[:5], INIT, eot, max_tokens=18)
    assert outs == _plain(om, AUDIOS[:5], eot, 18)
    assert cb.last_stats.epoch_resets >= 1


def test_empty_queue_and_limits(pair):
    _, om = pair
    cb = WhisperContinuousBatchingGenerator(om, batch_size=2)
    assert cb.transcribe_tokens_many([], INIT, 0) == []
    with pytest.raises(ValueError, match="position table"):
        cb.transcribe_tokens_many(AUDIOS[:1], INIT, 0, max_tokens=449)
    with pytest.raises(ValueError, match="pool context"):
        WhisperContinuousBatchingGenerator(om, pool_ctx=16).transcribe_tokens_many(AUDIOS[:1], INIT, 0, max_tokens=20)
    with pytest.raises(ValueError, match="tokenizer"):
        cb.transcribe_many(AUDIOS[:1])


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_streaming_callback_delivers_every_token_once(pair, refs, route):
    """on_tokens: each transcript token once, in order, at scheduling-point
    granularity; with sampling too."""
    _, om = pair
    eot, plain = refs
    streams, calls = {i: [] for i in range(len(AUDIOS))}, []
    cb = WhisperContinuousBatchingGenerator(om, batch_size=2, check_every=4, pool_ctx=128)
    outs = cb.transcribe_tokens_many(AUDIOS, INIT, eot, MAX_TOKENS,
                                     on_tokens=lambda r, ts: (streams[r].extend(ts), calls.append(len(ts))))
    assert outs == plain
    assert all(streams[i] == o[len(INIT):] for i, o in enumerate(outs))
    assert all(1 <= n <= 4 for n in calls)
    streams = {i: [] for i in range(3)}
    outs = cb.transcribe_tokens_many(AUDIOS[:3], INIT, eot, 12, topk=4, seed=9,
                                     on_tokens=lambda r, ts: streams[r].extend(ts))
    assert all(streams[i] == o[len(INIT):] for i, o in enumerate(outs))


def test_serving_stats(pair, refs):
    _, om = pair
    eot, _ = refs
    cb = WhisperContinuousBatchingGenerator(om, batch_size=2, check_every=4, pool_ctx=40)
    outs = cb.transcribe_tokens_many(AUDIOS[:5], INIT, eot, max_tokens=18)
    st = cb.last_stats
    assert st.requests == st.admissions == 5
    assert st.tokens_generated == sum(len(o) - len(INIT) for o in outs)
    assert 0.0 < st.occupancy <= 1.0 and st.slot_steps == 2 * st.decode_steps
    assert st.live_slot_steps <= st.slot_steps and st.decode_steps >= max(len(o) for o in outs) - len(INIT)
    assert st.scheduling_points >= 1 and st.epoch_resets >= 1 and st.wall_time_s > 0 and st.tokens_per_s > 0


def test_long_form_windows_match_plain(pair, refs):
    """> 30 s audios: every 30 s window schedules through the pool as its own
    segment, equal window by window to the plain generator's
    independent-window long form; and the text methods through a tokenizer."""
    _, om = pair
    eot, _ = refs
    r = np.random.default_rng(13)
    longs = [(0.1 * r.standard_normal(SR * 70)).astype(np.float32), AUDIOS[3]]
    cb = WhisperContinuousBatchingGenerator(om, batch_size=2, check_every=4, pool_ctx=128)
    got = cb.transcribe_long_tokens_many(longs, INIT, eot, max_tokens=12)
    plain = WhisperGenerator(om)
    assert got == [plain.transcribe_long_tokens(a, INIT, eot, max_tokens=12, batch_size=2) for a in longs]
    assert [len(w) for w in got] == [3, 1]

    class Tok:
        def __init__(self):
            self.eot = eot

        def sot_sequence(self, language, task):
            return INIT

        def decode(self, ids):
            return " ".join(map(str, ids)) + ";"

    cb.tokenizer = Tok()
    assert cb.transcribe_long_many(longs, max_tokens=12) == ["".join(Tok().decode(w) for w in wins) for wins in got]
    assert cb.transcribe_many(AUDIOS[:2], max_tokens=12) == [
        Tok().decode(o) for o in _plain(om, AUDIOS[:2], eot, 12)]


def test_batched_admission_encodes_equal_per_segment(pair, refs):
    """One scheduling point admits four segments through ONE encoder call
    (a bucket of 4; three segments go in a bucket of 4 too, the tail
    repeating the last): each row equals the segment's own encode, and the
    pool's transcripts the plain generator's."""
    _, om = pair
    eot, plain = refs
    assert [_bucket_pow2(m) for m in (1, 2, 3, 4, 5, 17, 32)] == [1, 2, 4, 4, 8, 32, 32]
    cb = WhisperContinuousBatchingGenerator(om, batch_size=4, check_every=4, pool_ctx=128)
    with torch.inference_mode():
        batched = cb._encode(AUDIOS[:3])
        assert batched.shape[0] == 4
        for i in range(3):
            single = wmod.whisper_encode(om.params, om.cfg, cb.preprocessor(
                wmod.stage_segments([AUDIOS[i]], cb.N_SAMPLES, om.device)))
            torch.testing.assert_close(batched[i:i + 1], single, atol=1e-5, rtol=0)
    assert cb.transcribe_tokens_many(AUDIOS, INIT, eot, MAX_TOKENS) == plain
    assert cb.last_stats.admissions == len(AUDIOS)


SAMPLE_KW = dict(topk=5, temperature=0.9, seed=3)


def test_sampling_schedule_invariant(pair, refs, monkeypatch):
    """A segment's sample stream depends on (seed, r) alone: equal across
    pools of 1 and 3, check_every 1 and 16, and the two routes."""
    _, om = pair
    eot, _ = refs

    def run(pool, every, fused):
        monkeypatch.setattr(attn, "USE_FUSED_STEP", fused)
        cb = WhisperContinuousBatchingGenerator(om, batch_size=pool, check_every=every, pool_ctx=128)
        return cb.transcribe_tokens_many(AUDIOS[:4], INIT, eot, 14, **SAMPLE_KW)

    ref = run(3, 16, False)
    assert run(1, 1, False) == ref
    assert run(3, 1, True) == ref
    assert run(1, 16, True) == ref
    assert sum(len(set(o[len(INIT):])) for o in ref) >= 3 * 4


def test_per_request_sampling_params(pair, refs):
    """Per-segment temperature / top-p lists: each segment's stream equals a
    one-slot pool's with that segment's scalar parameters at the same
    index."""
    _, om = pair
    eot, _ = refs
    temps, tps = [0.8, 1.1, 0.95], [0.85, 0.6, 0.9]
    cb = WhisperContinuousBatchingGenerator(om, batch_size=2, check_every=3, pool_ctx=128)
    mixed = cb.transcribe_tokens_many(AUDIOS[:3], INIT, eot, 12, topk=6, top_p=tps, temperature=temps, seed=5)
    for r in range(3):
        solo = WhisperContinuousBatchingGenerator(om, batch_size=1, check_every=1, pool_ctx=128)
        assert solo.transcribe_tokens_many(AUDIOS[:r + 1], INIT, eot, 12, topk=6, top_p=tps[r],
                                           temperature=temps[r], seed=5)[r] == mixed[r]


N_DRAWS = 192


def test_sampling_distribution_matches_jax(pair):
    """The first sampled token of N_DRAWS segments of one audio (top-k 5,
    temperature 0.9): the port's draws (pool of 32, fused twin) and the JAX
    engine's each pass a chi-square test against the float64 top-k
    probabilities of the port's logits, and against each other's counts."""
    jm, om = pair
    audios = [AUDIOS[2]] * N_DRAWS
    attn.USE_FUSED_STEP = True
    try:
        ours = WhisperContinuousBatchingGenerator(om, batch_size=32, check_every=1, pool_ctx=64) \
            .transcribe_tokens_many(audios, INIT, -1, len(INIT) + 1, **SAMPLE_KW)
    finally:
        attn.USE_FUSED_STEP = None
    theirs = jax_a2t.WhisperContinuousBatchingGenerator(jm, batch_size=32, check_every=1, pool_ctx=64) \
        .transcribe_tokens_many(audios, INIT, -1, len(INIT) + 1, **SAMPLE_KW)
    gen = WhisperGenerator(om)
    with torch.inference_mode():
        mel = gen.preprocessor(gen._stage_batch([AUDIOS[2]]))
        logits = om(mel, [INIT])[0, -1].double().numpy()
    z = logits / SAMPLE_KW["temperature"]
    keep = np.argsort(-z, kind="stable")[:SAMPLE_KW["topk"]]
    p = np.zeros_like(z)
    p[keep] = np.exp(z[keep] - z[keep].max())
    p /= p.sum()
    for draws in ([o[-1] for o in ours], [o[-1] for o in theirs]):
        counts = np.bincount(draws, minlength=len(p))
        assert counts[p == 0].sum() == 0
        assert stats.chisquare(counts[p > 0], p[p > 0] * N_DRAWS).pvalue > P_MIN
    ca, cb = (np.bincount([o[-1] for o in x], minlength=len(p)) for x in (ours, theirs))
    live = (ca + cb) > 0
    assert stats.chi2_contingency(np.stack([ca[live], cb[live]])).pvalue > P_MIN


@pytest.fixture(scope="module")
def pair128():
    """d_model 128: the JAX package's fused step (and so its int8 pool) needs it."""
    return _pair(dict(TINY, d_model=128))


def _int8(monkeypatch, kv: bool, kv_cross: bool):
    jax.clear_caches()
    for mod in (attn, jax_attn):
        monkeypatch.setattr(mod, "USE_FUSED_STEP", True)
        monkeypatch.setattr(mod, "USE_INT8_KV", kv)
        monkeypatch.setattr(mod, "USE_INT8_KV_CROSS", kv_cross)


def test_int8_pool_matches_jax(pair128, monkeypatch):
    """The int8 pool (self caches per key in int8, each admission prefilled
    in full precision on a scratch row and committed quantized; each
    segment's cross K/V quantized once at admission), mid-flight admissions
    over stale quantized state: token-identical to the JAX package's int8
    pool and to the port's plain generator under the same flags."""
    jm, om = pair128
    _int8(monkeypatch, True, True)
    calls = []
    real = ds.fused_cross_decode_step

    def spy(*args, **kw):
        calls.append((args[2].dtype, args[4].dtype, args[2].shape[1]))
        return real(*args, **kw)

    monkeypatch.setattr(ds, "fused_cross_decode_step", spy)
    outs = WhisperContinuousBatchingGenerator(om, batch_size=2, check_every=4, pool_ctx=64) \
        .transcribe_tokens_many(AUDIOS[:4], INIT, -1, max_tokens=14)
    assert calls and set(calls) == {(torch.int8, torch.int8, 2)}
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = jax_a2t.WhisperContinuousBatchingGenerator(jm, batch_size=2, check_every=4, pool_ctx=64) \
                .transcribe_tokens_many(AUDIOS[:4], INIT, -1, max_tokens=14)
    finally:
        jax.clear_caches()
    assert outs == ref
    assert outs == [WhisperGenerator(om).transcribe_tokens(a, INIT, -1, 14) for a in AUDIOS[:4]]


@pytest.mark.parametrize("kv", [False, True], ids=["cross_only", "self_only"])
def test_int8_single_stream_pools_match_plain(pair128, monkeypatch, kv):
    """int8 cross only (full-precision self pool) and int8 self only: each
    stream's gate on its own, token-identical to the plain generator under
    the same flags."""
    _, om = pair128
    _int8(monkeypatch, kv, not kv)
    outs = WhisperContinuousBatchingGenerator(om, batch_size=3, check_every=5, pool_ctx=64) \
        .transcribe_tokens_many(AUDIOS[:4], INIT, -1, max_tokens=12)
    assert outs == [WhisperGenerator(om).transcribe_tokens(a, INIT, -1, 12) for a in AUDIOS[:4]]
