"""The port's sharded serving example (``examples/torch_serve_sharded.py``)
against the JAX package's ``serve_sharded.py``, on the CPU.

The JAX script runs as a script on the 8 virtual CPU devices of
tests/conftest.py; the port's ``main(["--cpu"], model=..., draft=...)``
spawns its 8 gloo ranks (then a world of the first 4) over the same
parameters. Both print the same lines; the port's single-device rows equal
the JAX script's, every rank returned every run's rows (each checked by
``main`` against the single device), and the sampled pool's rows are held
to their lengths (the PRNG streams differ).
"""

import torch

from pytorch_models_tpu.text import GPT2 as JaxGPT2
from pytorch_models_tpu_torch.text import GPT2
from tests.torch_examples_run import port_params, run_jax, run_port

torch.set_num_threads(1)

RUNS_8 = {"dp x tp", "dp x pp x tp", "launches"}
RUNS_4 = RUNS_8 | {"pp", "tp speculative", "tp continuous batch", "tp prefix caching", "tp sampled serving",
                   "solo sampled"}


def _shape(cls, monkeypatch):
    """serve_sharded.py's GPT-2 class attributes (vocab 512, context 256),
    restored after the test: the JAX script sets them on the class."""
    monkeypatch.setattr(cls, "vocab_size", 512)
    monkeypatch.setattr(cls, "max_seq_len", 256)


def test_serve_sharded_matches_jax(monkeypatch):
    _shape(JaxGPT2, monkeypatch)
    g, lines = run_jax("serve_sharded", monkeypatch)
    _shape(GPT2, monkeypatch)
    models = {}
    for key, ref in (("model", JaxGPT2(n_layers=4, d_model=256)), ("draft", JaxGPT2(n_layers=2, d_model=256, rng=7))):
        models[key] = GPT2(n_layers=ref.cfg.n_layers, d_model=256, device="cpu")
        models[key].params = port_params(ref)
    out, got = run_port("serve_sharded", **models)
    assert got == lines
    assert out["ref"] == g["ref"]
    ranks = out["ranks"]
    assert sorted(ranks) == list(range(8))
    for rank, res in ranks.items():
        assert set(res) == (RUNS_4 if rank < 4 else RUNS_8)
        if rank < 4:
            assert [len(r) for r in res["tp sampled serving"]] == [len(r) for r in g["samp"]]
