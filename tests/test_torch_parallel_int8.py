"""int8 KV in the port's TENSOR-PARALLEL serving, on the CPU.

The tp pools run the per-op int8 decode path (``transformer``'s
``_int8_self_decode_apply`` / ``_int8_cross_decode_apply`` over K6): the
int8 K/V shard on the head width while the per-key fp32 scale planes are
whole on every rank, because every scale is the full-width row's
(``quantize_rows(group=)`` all-reduces the absmax by max over the tp group,
and K6 scores the current key with that scale, ``cur_ks``). Outputs must
equal the single-device port's int8 pool under the same flags (its fused
step's plain twin on the CPU, which tests/test_torch_continuous.py and its
Whisper and T5 siblings hold against the JAX package's int8 pools): the
cases of the JAX package's ``tests/parallel/test_cb_serving_int8.py``, at
its sizes. The ranks run over gloo (``tests/torch_parallel_ranks.py``).

K6's ``cur_ks``: the plain version against the JAX kernel in interpret mode
(and, with the key-major bias the JAX kernel lacks, against its exact-math
oracle) with a scale taken from a full row twice the shard's width, so that
it is not the shard's own; held to K6's CPU limit of tests/test_torch_int8.py.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_models_tpu.ops.int8_kv as jax_i8
from pytorch_models_tpu.models.audio2text.whisper import Whisper as JaxWhisper
from pytorch_models_tpu.models.text import GPT2 as JaxGPT2
from pytorch_models_tpu.models.text import T5Model as JaxT5
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.audio2text import WhisperContinuousBatchingGenerator
from pytorch_models_tpu_torch.ops import attention as attn
from pytorch_models_tpu_torch.ops import int8_kv
from pytorch_models_tpu_torch.text import ContinuousBatchingGenerator, T5ContinuousBatchingGenerator
from tests.torch_parallel_ranks import Tok, build, run_ranks

torch.set_num_threads(1)

K6_TOL = 1e-6  # tests/test_torch_int8.py's limit for K6's plain version against the JAX kernel


def _tree(m):
    return jax.tree.map(to_np, m.params)


def _gpt2():
    JaxGPT2.vocab_size, JaxGPT2.max_seq_len = 128, 128
    try:
        m = JaxGPT2(2, 256)  # 4 heads; 256 / tp=2 keeps each rank's width a multiple of 128
    finally:
        JaxGPT2.vocab_size, JaxGPT2.max_seq_len = 50257, 1024
    tree = _tree(m)
    tree["pos_embs"] = (3 * np.random.default_rng(0).standard_normal(tree["pos_embs"].shape)).astype(np.float32)
    return ("gpt2", dict(n_layers=2, d_model=256, rng=0, vocab_size=128, max_seq_len=128), tree)


def _t5():
    kw = dict(vocab_size=96, dim=256, n_heads=4, n_layers=2, mlp_dim=256)
    tree = _tree(JaxT5(**kw))
    r = np.random.default_rng(1)
    for stack in ("encoder", "decoder"):
        tree[stack]["attn_bias"] = (2 * r.standard_normal(tree[stack]["attn_bias"].shape)).astype(np.float32)
    return ("t5", kw, tree)


def _whisper():
    kw = dict(vocab_size=100, n_layers=2, d_model=256, n_mels=80)  # 4 heads
    return ("whisper", kw, _tree(JaxWhisper(**kw)))


MODELS = {"gpt2_256": _gpt2(), "t5_256": _t5(), "whisper_256": _whisper()}
_R = np.random.default_rng(11)
_ROWS = np.random.default_rng(3).standard_normal((4, 7, 384)).astype(np.float32)
_ROWS[1, 2] = 0.0  # an all-zero row: scale 1/127
_ROWS[2, :, 200] = 9.0  # the absmax on rank 1's half
CASES = {
    "requests": [[5, 6, 7], [9] * 12, [11, 12], [3] * 7, [8, 1, 2, 6]],
    "budgets": [8, 5, 11, 8, 3],
    "audios": [(_R.standard_normal(16000) * 0.1).astype(np.float32) for _ in range(3)],
    "init": [50, 51, 52],
    "eot": 99,
    "t5_requests": [np.random.default_rng(13).integers(2, 96, size=n).tolist() for n in (5, 17, 11)],
    "rows": _ROWS,
}


def _single_device_int8(fn, self_kv=True, cross_kv=True):
    """A single-device pool's int8 run: the fused step (its plain twin on the
    CPU) carries the int8 caches."""
    attn.USE_FUSED_STEP, attn.USE_INT8_KV, attn.USE_INT8_KV_CROSS = True, self_kv, cross_kv
    try:
        return fn()
    finally:
        attn.USE_FUSED_STEP, attn.USE_INT8_KV, attn.USE_INT8_KV_CROSS = None, False, False


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    (tp2,) = run_ranks([(2, "int8_tp2", (MODELS, CASES))], tmp_path_factory.mktemp("tp_int8"))
    for r, res in enumerate(tp2):
        for key in ("gpt", "whisper", "t5", "calls"):
            assert res[key] == tp2[0][key], f"rank {r} parts from rank 0 on {key}"
    return SimpleNamespace(tp2=tp2, r0=tp2[0])


def test_tp_int8_gpt_pool_matches_single_device_int8(ranks):
    m = build(MODELS["gpt2_256"])
    sd = ContinuousBatchingGenerator(m, Tok(), batch_size=2, prompt_bucket=16, check_every=4)
    ref = _single_device_int8(lambda: sd.generate_tokens_many(CASES["requests"], CASES["budgets"]), cross_kv=False)
    assert ranks.r0["gpt_gate"]  # non-vacuous: the tp pool engaged the int8 path
    assert ranks.r0["gpt_calls"]["cur_ks"] > 0  # every self-attention step scored with the full-width scale
    assert ranks.r0["gpt"] == ref


def test_tp_int8_whisper_pool_matches_single_device_int8(ranks):
    m = build(MODELS["whisper_256"])
    sd = WhisperContinuousBatchingGenerator(m, batch_size=2, check_every=4, pool_ctx=64)
    ref = _single_device_int8(lambda: sd.transcribe_tokens_many(CASES["audios"], CASES["init"], CASES["eot"],
                                                                max_tokens=12))
    assert ranks.r0["whisper_modes"] == (True, True)
    assert ranks.r0["whisper"] == ref


def test_tp_int8_t5_cross_pool_matches_single_device_int8(ranks):
    """T5 under tp: int8 CROSS only (the per-op int8 kernel path carries no
    rel-pos self bias in the JAX package), so the self pool stays full
    precision."""
    m = build(MODELS["t5_256"])
    sd = T5ContinuousBatchingGenerator(m, batch_size=2, check_every=4, pool_ctx=64)
    ref = _single_device_int8(lambda: sd.generate_tokens_many(CASES["t5_requests"], 12, 0, 1), self_kv=False)
    assert ranks.r0["t5_modes"] == (False, True)
    assert ranks.r0["calls"]["cross"] > ranks.r0["gpt_calls"]["cross"]  # the int8 cross caches were read
    assert ranks.r0["t5"] == ref


def test_tp_int8_cache_sharding(tmp_path):
    """int8 pool layout at tp=4: K/V shard on the head width, the scale
    planes whole (B rows: the port keeps no 8-row padding); and at tp=4
    GPT-2's 256 / 4 = 64-wide ranks get a full-precision pool, the JAX
    package's rule kept for parity."""
    (w4,) = run_ranks([(4, "int8_cache_tp4", (MODELS["gpt2_256"],))], tmp_path)
    for res in w4:
        assert res["shapes"]["k"] == res["shapes"]["v"] == ((2, 2, 128, 64), "torch.int8")
        assert res["shapes"]["ks"] == res["shapes"]["vs"] == ((2, 2, 128), "torch.float32")
        assert not res["int8_pool"]


def test_quantize_rows_over_tp_group_equals_full_row(ranks):
    """Two ranks, each with half of every row: ``quantize_rows(group=)`` gives
    each the full row's scales and the full row's levels, bit for bit, the
    port's and the JAX package's."""
    rows = CASES["rows"]
    ours_q, ours_s = int8_kv.quantize_rows(torch.from_numpy(rows))
    jax_q, jax_s = jax_i8.quantize_rows(jnp.asarray(rows))
    np.testing.assert_array_equal(ours_q.numpy(), np.asarray(jax_q))
    np.testing.assert_array_equal(ours_s.numpy(), np.asarray(jax_s))
    half = rows.shape[-1] // 2
    for rank, res in enumerate(ranks.tp2):
        np.testing.assert_array_equal(res["scales"], np.asarray(jax_s))
        np.testing.assert_array_equal(res["levels"], np.asarray(jax_q)[..., rank * half:(rank + 1) * half])
    own = int8_kv.quantize_rows(torch.from_numpy(rows[..., :half]))[1].numpy()
    assert (own != res["scales"]).any()  # the shard's own absmax is not the row's


# ---- K6 with the full-width scale (cur_ks) ---------------------------------

B, L, H, D = 3, 256, 2, 64  # a tp=2 rank's shard of GPT-2 2 x 256: 2 of 4 heads, two 128-key blocks


def _k6_case(seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, 1, H * D)).astype(np.float32)
    k, v = (r.standard_normal((B, L, H * D)).astype(np.float32) for _ in range(2))
    full_k = r.standard_normal((B, 2 * H * D)).astype(np.float32)
    full_k[:, H * D:] *= 3.0  # the other rank's half holds each row's absmax
    cur_k, cur_v = full_k[:, : H * D].copy(), r.standard_normal((B, H * D)).astype(np.float32)
    cur_ks = np.asarray(jax_i8.quantize_rows(jnp.asarray(full_k))[1])  # (B, 1): the full row's scale
    assert (cur_ks != np.asarray(jax_i8.quantize_rows(jnp.asarray(cur_k))[1])).all()
    jc = jax_i8.prefill_int8_kv(*jax_i8.make_int8_kv_cache(B, L, H * D), jnp.asarray(k), jnp.asarray(v))
    ours = int8_kv.int8_kv_from_jax(dict(zip(("k", "v", "ks", "vs"), map(np.asarray, jc))), B)
    pads, ends = np.asarray([0, 5, 130], np.int32), np.asarray([L, 190, 140], np.int32)
    return q, jc, ours, pads, ends, cur_k, cur_v, cur_ks


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", ["gpt2", "t5_bias"])
def test_int8_attention_cur_ks_plain_matches_jax(shape):
    q, jc, ours, pads, ends, cur_k, cur_v, cur_ks = _k6_case(17)
    if shape == "t5_bias":  # T5's self step: every row at one position, whose bias row the current key takes
        ends, pads = np.full(B, 200, np.int32), np.asarray([0, 5, 190], np.int32)
    args = (_t(q), ours["k"], ours["v"], ours["ks"], ours["vs"], _t(ends), H, _t(pads), _t(cur_k), _t(cur_v))
    jkw = dict(pad_lens=jnp.asarray(pads), cur_k=jnp.asarray(cur_k), cur_v=jnp.asarray(cur_v),
               cur_ks=jnp.asarray(cur_ks))
    if shape == "gpt2":
        ref = jax_i8.int8_decode_attention(jnp.asarray(q), *jc, jnp.asarray(ends), H, interpret=True, **jkw)
        bias = None
    else:  # T5's key-major (L, H) rel-pos bias, which only the JAX oracle takes
        bias = (2 * np.random.default_rng(10).standard_normal((L, H))).astype(np.float32)
        ref = jax_i8.int8_attention_oracle(jnp.asarray(q), *jc, jnp.asarray(ends), H, bias=jnp.asarray(bias), **jkw)
        bias = _t(bias)
    launches = int8_kv.int8_decode_attention.cur_ks_launches
    got = int8_kv.int8_decode_attention(*args, bias=bias, cur_ks=_t(cur_ks))
    assert int8_kv.int8_decode_attention.cur_ks_launches == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=K6_TOL)
    own = int8_kv.int8_decode_attention_plain(*args, bias=bias)  # the shard's own absmax instead
    assert np.abs(own.numpy() - np.asarray(ref)).max() > 1e3 * K6_TOL
