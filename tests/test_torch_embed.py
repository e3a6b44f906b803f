"""The decoders' embedding in one launch (K3's ``embed_add``) vs the JAX package, on the CPU.

The JAX decode loops build a step's input as two row gathers and an add:
``embed_rows(tok, ids) + embed_rows(pos, pos_ids).astype(dtype)`` (on its
TPU both gathers are the Pallas kernel, ``ops/gather.py`` ``gather_rows``,
run here in interpret mode). The port's :func:`embed_add_plain`, the plain
version of the one-launch CUDA kernel, must equal it bit for bit in fp32
and bf16: a gather is a copy, and both adds round the fp32 sum once. Ids
out of range clamp to the table, as the JAX kernel clamps them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytorch_models_tpu.ops.gather import gather_rows as jax_gather_rows
from pytorch_models_tpu_torch.ops import gather
from pytorch_models_tpu_torch.ops.gather import embed_add, embed_add_plain, embed_tokens

V, VP, D = 300, 64, 128


def _tables(dtype, pos_dtype, seed=3):
    r = np.random.default_rng(seed)
    tok = (3 * r.standard_normal((V, D))).astype(np.float32)
    pos = r.standard_normal((VP, D)).astype(np.float32)
    return (tok, pos, torch.from_numpy(tok).to(getattr(torch, dtype)),
            torch.from_numpy(pos).to(getattr(torch, pos_dtype)))


def _jax_embed(tok, pos, ids, pids, dtype, pos_dtype):
    """The JAX decode loop's two gathers and add, the gathers in interpret mode."""
    jt, jp = jnp.asarray(tok, jnp.dtype(dtype)), jnp.asarray(pos, jnp.dtype(pos_dtype))
    with pltpu.force_tpu_interpret_mode():
        x = jax_gather_rows(jt, jnp.asarray(ids, jnp.int32))
        x = x + jax_gather_rows(jp, jnp.asarray(pids, jnp.int32)).astype(x.dtype)
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype,pos_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_embed_add_plain_matches_jax_gathers(dtype, pos_dtype, id_dtype):
    """Ids per row, out-of-range ones included (-4 and V + 3 clamp), in either id dtype."""
    tok, pos, tt, tp = _tables(dtype, pos_dtype)
    ids = np.asarray([0, V - 1, -4, V + 3, 17, 17, 250, 5], np.int64)
    pids = np.asarray([0, 63, 7, 1, -2, VP + 9, 40, 40], np.int64)
    expected = _jax_embed(tok, pos, ids, pids, dtype, pos_dtype)
    got = embed_add_plain(tt, torch.from_numpy(ids).to(id_dtype), tp, torch.from_numpy(pids).to(id_dtype))
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(got.float().numpy(), expected)
    # the wrapper on CPU tensors is the plain version; without a position table, the gather
    np.testing.assert_array_equal(embed_add(tt, torch.from_numpy(ids).to(id_dtype), tp,
                                            torch.from_numpy(pids).to(id_dtype)).float().numpy(), expected)
    with pltpu.force_tpu_interpret_mode():
        rows = np.asarray(jax_gather_rows(jnp.asarray(tok, jnp.dtype(dtype)), jnp.asarray(ids, jnp.int32))
                          .astype(jnp.float32))
    np.testing.assert_array_equal(embed_add_plain(tt, torch.from_numpy(ids).to(id_dtype)).float().numpy(), rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", [0, 37, VP - 2])
def test_embed_tokens_start_position_matches_jax(dtype, start):
    """A (B, S) chunk at positions ``[start, start + S)`` (Whisper's prefill
    slice; past the table's end the position clamps), and a (B, 1) step at
    ``start``: row r of the flat ids takes position ``start + r % S``."""
    tok, pos, tt, tp = _tables(dtype, dtype, seed=4)
    r = np.random.default_rng(5)
    chunk = r.integers(-3, V + 3, (3, 5))
    pids = np.minimum(start + np.arange(5), VP - 1)
    expected = _jax_embed(tok, pos, chunk.reshape(-1), np.tile(pids, 3), dtype, dtype).reshape(3, 5, D)
    got = embed_tokens(tt, torch.from_numpy(chunk).to(torch.int32), tp, start=start)
    assert got.shape == (3, 5, D)
    np.testing.assert_array_equal(got.float().numpy(), expected)
    step = embed_tokens(tt, torch.from_numpy(chunk[:, :1]), tp, start=start)[:, 0]
    np.testing.assert_array_equal(step.float().numpy(), expected[:, 0])
    # per-row position ids of the chunk's shape (GPT-2's pos_ids), and the forced plain path
    pos_ids = torch.from_numpy(np.tile(pids, (3, 1)))
    np.testing.assert_array_equal(embed_tokens(tt, torch.from_numpy(chunk), tp, pos_ids).float().numpy(), expected)
    saved = gather.USE_GATHER_KERNEL
    gather.USE_GATHER_KERNEL = False
    try:
        np.testing.assert_array_equal(embed_tokens(tt, torch.from_numpy(chunk), tp, start=start).float().numpy(),
                                      expected)
    finally:
        gather.USE_GATHER_KERNEL = saved
