"""The port's dp/pp/tp/sp/ep MoE training step (``parallel/train.py``) and
its GPipe schedule (``parallel/pipeline.py``) on the CPU, against the JAX
package's ``make_train_step`` on the 8 virtual CPU devices.

The ranks are processes over gloo (``tests/torch_parallel_ranks.py``,
spawned once: 8 ranks on ("dp", "pp", "tp") = (2, 2, 2) and 4 on (1, 2, 2)).
The cases of the JAX package's ``tests/parallel/test_multichip.py`` at its
sizes (``MoELMConfig()``: 2 stages of 2 layers, d 128, 4 experts): the step
runs and the loss falls; at (2, 2, 2) with the default capacity factor 2.0
(tokens drop) the two steps' losses agree with JAX's within 1e-5 relative
and every stepped parameter within (2e-5, 2e-5); the pipelined forward
equals the sequential stages; sparse and EP dispatch equal the dense one at
high capacity; every parameter leaf gets a finite, non-zero gradient. The
single-device trainer is the same step on a one-rank mesh.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_models_tpu.parallel import make_mesh as jax_make_mesh
from pytorch_models_tpu.parallel import train as jt
from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.parallel import train as pt
from pytorch_models_tpu_torch.parallel.sharding import shard_params, tree_map_with_path
from tests.torch_parallel_ranks import OneRank, run_ranks

torch.set_num_threads(1)

CFG = jt.MoELMConfig()
HIGH = dataclasses.replace(CFG, capacity_factor=float(CFG.n_experts))


def _init(seed, cfg=CFG):
    return jax.tree.map(to_np, jt.moe_lm_init(jax.random.PRNGKey(seed), cfg))


PARAMS = {"default": _init(0), "high": _init(2, HIGH), "forward": _init(1), "forward_high": _init(1, HIGH),
          "ep": _init(4, HIGH)}
TOKENS = {"default": np.random.default_rng(0).integers(0, CFG.vocab_size, (8, CFG.max_seq_len)),
          "high": np.random.default_rng(2).integers(0, CFG.vocab_size, (8, CFG.max_seq_len)),
          "forward": np.random.default_rng(1).integers(0, CFG.vocab_size, (4, 16))}
EP_X = np.random.default_rng(4).standard_normal((2, 16, CFG.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: ``(world8, world4)``, each a list over the ranks."""
    base = {"params": PARAMS, "tokens": TOKENS, "shapes": {8: (2, 2, 2), 4: (1, 2, 2)}}
    c8 = dict(base, train={"default": {}}, ep_x=EP_X)
    c4 = dict(base, train={"high": {"capacity_factor": HIGH.capacity_factor}}, collectives=True,
              params={k: v for k, v in PARAMS.items() if not k.startswith("forward")})
    w8, w4 = run_ranks([(8, "train_ranks", (c8,)), (4, "train_ranks", (c4,))], tmp_path_factory.mktemp("train"))
    return SimpleNamespace(w8=w8, w4=w4)


def _jax_steps(name, cfg, n=2):
    mesh = jax_make_mesh(8)
    step, shardings = jt.make_train_step(cfg, mesh, n_micro=2)
    params = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s), PARAMS[name], shardings)
    losses = []
    for _ in range(n):
        params, loss = step(params, jnp.asarray(TOKENS[name]))
        losses.append(float(loss))
    return losses, jax.tree.map(to_np, params)


def _expected_shard(tree, index, shape):
    """A rank's shard of the whole port tree ``tree`` at mesh coordinates ``index``."""
    mesh = SimpleNamespace(shape=dict(zip(("dp", "pp", "tp"), shape)), device=torch.device("cpu"),
                           index=lambda a: index[("dp", "pp", "tp").index(a)])
    return shard_params(tree, pt.param_pspecs(pt.MoELMConfig()), mesh)


def test_train_step_matches_jax_at_2x2x2(ranks):
    """Two SGD steps at (2, 2, 2), capacity factor 2.0 (tokens drop: the
    capacity groups must be JAX's): the losses within 1e-5 relative, every
    rank's stepped shard within (2e-5, 2e-5) of JAX's stepped parameters."""
    losses, params = _jax_steps("default", CFG)
    port_tree = pt.moe_lm_from_jax(params)
    for res in ranks.w8:
        np.testing.assert_allclose(res["default"]["losses"], losses, rtol=1e-5)
        want = tree_map_with_path(lambda p, t: t.numpy(), _expected_shard(port_tree, res["index"], (2, 2, 2)))
        got = res["default"]["params"]
        tree_map_with_path(lambda p, w: np.testing.assert_allclose(_at(got, p), w, rtol=2e-5, atol=2e-5,
                                                                     err_msg=p), want)


def _at(tree, path):
    for part in path[1:-1].split("]["):
        tree = tree[part.strip("'")] if part.startswith("'") else tree[int(part)]
    return tree


def test_train_step_runs_and_loss_falls(ranks):
    for res in ranks.w8 + ranks.w4:
        name = "default" if "default" in res else "high"
        l0, l1 = res[name]["losses"]
        assert np.isfinite(l0) and np.isfinite(l1) and l1 < l0


def test_every_leaf_gets_a_finite_nonzero_gradient(ranks):
    for res in ranks.w8 + ranks.w4:
        name = "default" if "default" in res else "high"
        assert res[name]["grads_loss"] == res[name]["losses"][0]  # _loss_and_grads is the step's first half
        for path, finite, amax in res[name]["grads"]:
            assert finite and amax > 0, (res["index"], path, amax)


def test_train_step_matches_one_rank_at_high_capacity(ranks):
    """(1, 2, 2) against the same trainer on one rank, capacity factor
    n_experts (nothing drops, so the groups do not matter): losses within
    1e-5 relative, shards within (2e-5, 2e-5)."""
    step, specs = pt.make_train_step(pt.MoELMConfig(capacity_factor=HIGH.capacity_factor), OneRank(), n_micro=2)
    params = pt.moe_lm_from_jax(PARAMS["high"])
    tokens = torch.from_numpy(TOKENS["high"])
    losses = []
    for _ in range(2):
        params, loss = step(params, tokens)
        losses.append(float(loss))
    for res in ranks.w4:
        np.testing.assert_allclose(res["high"]["losses"], losses, rtol=1e-5)
        want = tree_map_with_path(lambda p, t: t.numpy(), _expected_shard(params, res["index"], (1, 2, 2)))
        tree_map_with_path(lambda p, w: np.testing.assert_allclose(_at(res["high"]["params"], p), w, rtol=2e-5,
                                                                     atol=2e-5, err_msg=p), want)


def _assemble(results, key):
    """The ranks' (M, mb/dp, L/tp, ...) blocks of ``key`` as the (M, mb, L, ...) whole."""
    got = [(res["index"], res[key]) for res in results]
    _, one = got[0]
    full = np.zeros((one.shape[0], one.shape[1] * 2, one.shape[2] * 2, *one.shape[3:]), np.float32)
    for (dp, _, tp), block in got:
        full[:, dp * one.shape[1]:(dp + 1) * one.shape[1], tp * one.shape[2]:(tp + 1) * one.shape[2]] = block
    return full


def test_pipeline_matches_sequential_stages(ranks):
    """GPipe over pp at (2, 2, 2): every pp rank's logits equal (the outputs
    are broadcast); at high capacity they equal the stages run one after
    the other per microbatch on one rank (the token grouping does not
    matter there), and at the default capacity JAX's pipelined forward on
    the (2, 2, 2) mesh (the same groups)."""
    for key in ("forward", "forward_high"):
        by_pp = [_assemble([r for r in ranks.w8 if r["index"][1] == pp], key) for pp in (0, 1)]
        np.testing.assert_array_equal(by_pp[0], by_pp[1])
    with torch.no_grad():
        seq = pt.moe_lm_forward(pt.moe_lm_from_jax(PARAMS["forward_high"]), pt.MoELMConfig(
            capacity_factor=HIGH.capacity_factor), torch.from_numpy(TOKENS["forward"]), OneRank(), 2)
    np.testing.assert_allclose(_assemble(ranks.w8, "forward_high"), seq.numpy(), rtol=2e-5, atol=2e-5)
    jax_logits = jax.jit(lambda p, t: jt.moe_lm_forward(p, CFG, t, jax_make_mesh(8), n_micro=2))(
        PARAMS["forward"], jnp.asarray(TOKENS["forward"]))
    full = _assemble(ranks.w8, "forward")
    np.testing.assert_allclose(full.reshape(np.asarray(jax_logits).shape), np.asarray(jax_logits), rtol=2e-5,
                               atol=2e-5)


def _block_params(name):
    return pt.moe_lm_from_jax(PARAMS[name])["stages"][0][0]


def test_sparse_moe_matches_dense_at_high_capacity():
    lp = _block_params("ep")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, CFG.d_model)).astype(np.float32))
    dense = pt._moe_mlp(lp, HIGH, x)
    np.testing.assert_allclose(pt._moe_mlp_sparse(lp, HIGH, x).numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)
    jlp = jax.tree.map(lambda a: a[0, 0], PARAMS["ep"]["stages"])
    np.testing.assert_allclose(dense.numpy(), np.asarray(jt._moe_mlp(jlp, HIGH, jnp.asarray(x.numpy()))),
                               rtol=1e-5, atol=1e-5)


def test_ep_moe_matches_dense_at_high_capacity(ranks):
    """The all_to_all dispatch at (2, 2, 2) (experts over tp, rows over dp,
    each pp rank on the first block of its stage) equals the dense dispatch
    when nothing drops."""
    for pp in (0, 1):
        lp = pt.moe_lm_from_jax(PARAMS["ep"])["stages"][pp][0]
        dense = pt._moe_mlp(lp, HIGH, torch.from_numpy(EP_X)).numpy()
        got = _assemble([{"index": r["index"], "ep": r["ep_out"][None]} for r in ranks.w8 if r["index"][1] == pp],
                        "ep")
        np.testing.assert_allclose(got[0], dense, rtol=1e-5, atol=1e-5)


def test_carriers_round_trip():
    tree = PARAMS["default"]
    back = pt.moe_lm_to_jax(pt.moe_lm_from_jax(tree))
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_collectives_and_their_autograd_conjugates(ranks):
    """On a line of 4 ranks: all-gather (backward reduce-scatter),
    reduce-scatter (backward all-gather), all_to_all (backward the reverse
    all_to_all), Megatron's f (identity, backward all-reduce) and g
    (all-reduce, backward identity), broadcast and a send / recv ring."""
    n = 4
    w = np.arange(n * n, dtype=np.float32).reshape(n, n)
    for r, res in enumerate(ranks.w4):
        c = res["collectives"]
        assert c["gathered"] == [[k + 10 * q for k in range(n)] for q in range(n)]
        assert c["x.grad"] == (n * w[r]).tolist()
        assert c["scattered"] == [n * r + sum(range(n))]
        assert c["y.grad"] == [q + 1.0 for q in range(n)]
        assert c["exchanged"] == [100.0 * q + r for q in range(n)]
        assert c["t.grad"] == [float(r)] * n
        assert c["v.grad"] == [float(sum(range(1, n + 1)))] * 2
        assert c["summed"] == [float(sum(range(n)))] * 2 and c["u.grad"] == [1.0, 1.0]
        assert c["broadcast"] == [2.0]
        assert c["ring"] == [k + 10 * ((r - 1) % n) + 1.0 for k in range(n)]


def test_mesh_refuses_an_absent_axis(ranks):
    """A collective over an axis the mesh lacks would return its input: the
    mesh's ``group`` and ``index`` raise for one, ``size`` is 1."""
    for res in ranks.w4:
        assert res["collectives"]["absent axis"] == (["group", "index"], 1)


def test_moe_lm_init_defaults_to_the_card():
    """``moe_lm_init`` puts the parameters on the CUDA card unless asked for
    the CPU (without one it raises), as the port's models do."""
    gen = torch.Generator().manual_seed(0)
    cpu = pt.moe_lm_init(gen, pt.MoELMConfig(), device="cpu")
    assert cpu["stages"][1][1]["w1"].device == torch.device("cpu")
    if torch.cuda.is_available():
        assert pt.moe_lm_init(gen, pt.MoELMConfig())["token_embs"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.moe_lm_init(gen, pt.MoELMConfig())
