"""The port's text and speech examples (``examples/torch_text_generate.py``,
``torch_transcribe.py``) against the JAX package's, on the CPU.

Each JAX script runs as a script (``tests/torch_examples_run.py``) and
builds its own random models; the test builds the same ones and hands their
parameters to the port's ``main(["--cpu"], ...)``. Greedy, batched, beam and
speculative tokens must be equal, the perplexity within 1e-4 relative (fp32
log-probabilities summed in another order); sampled lines differ by design
(the two PRNG streams) and are held to their lengths. Whisper's single
segment, long-form windows and speculative tokens must be equal. Also: every
script's ``--pretrained`` reads only the checkpoint cache, failing with the
missing file's name; and no module of the port, no port example and
``chip_smoke.py`` imports ``jax`` or the JAX package.
"""

import ast
from pathlib import Path

import pytest
import torch

from pytorch_models_tpu.audio2text import Whisper as JaxWhisper
from pytorch_models_tpu.text import GPT2 as JaxGPT2
from pytorch_models_tpu_torch.audio2text import Whisper
from pytorch_models_tpu_torch.text import GPT2
from tests.torch_examples_run import port_params, printed, run_jax, run_port

torch.set_num_threads(1)

PPL_RTOL = 1e-4


def _port_gpt2(ref, n_layers: int):
    m = GPT2(n_layers=n_layers, d_model=256, device="cpu")
    m.params = port_params(ref)
    return m


def _ids(line: str) -> int:
    """The number of ids the toy tokenizer decoded into a printed string."""
    return len(line.strip("'").split())


def test_text_generate_matches_jax(monkeypatch):
    _, lines = run_jax("text_generate", monkeypatch)
    model, draft = _port_gpt2(JaxGPT2(n_layers=4, d_model=256), 4), _port_gpt2(JaxGPT2(n_layers=2, d_model=256), 2)
    out, got = run_port("text_generate", model=model, draft=draft)
    for label in ("greedy:", "batched:", "beam (w=4):", "speculative:"):
        assert printed(got, label) == printed(lines, label), label
    assert _ids(out["nucleus"]) == _ids(printed(lines, "nucleus:"))
    assert [_ids(s) for s in out["best-of-3"]] == [_ids(s) for s in ast.literal_eval(printed(lines, "best-of-3:"))]
    assert out["perplexity"] == pytest.approx(float(printed(lines, "perplexity:")), rel=PPL_RTOL)
    assert [ln.split(":")[0] for ln in got] == [ln.split(":")[0] for ln in lines]


def test_transcribe_matches_jax(monkeypatch):
    _, lines = run_jax("transcribe", monkeypatch)
    models = {}
    for key, kw in (("model", {}), ("draft", {"n_layers": 1, "rng": 3})):
        dims = {"vocab_size": 100, "n_layers": 2, "d_model": 64, "n_mels": 80} | kw
        models[key] = Whisper(**dims, device="cpu")
        models[key].params = port_params(JaxWhisper(**dims))
    out, got = run_port("transcribe", **models)
    assert got == lines
    assert out["single"] == out["speculative"] and len(out["long"]) == 2


@pytest.mark.parametrize("name,missing", [("text_generate", "gpt2.bin"), ("transcribe", "tiny.pt"),
                                          ("image_classify", "B_16-i21k-300ep"),
                                          ("encodec_roundtrip", "encodec_24khz-d7cc33bc.th")])
def test_pretrained_reads_only_the_cache(name, missing, monkeypatch, tmp_path):
    """``--pretrained`` with an empty cache names the file it lacks and
    never reaches the network (``requests`` is not importable here)."""
    monkeypatch.setenv("PYTORCH_MODELS_TPU_CACHE", str(tmp_path))
    monkeypatch.setitem(__import__("sys").modules, "requests", None)
    with pytest.raises(FileNotFoundError, match=missing):
        run_port(name, argv=("--cpu", "--pretrained"))


def _imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_port_examples_and_chip_smoke_import_no_jax():
    root = Path(__file__).resolve().parents[1]
    files = (sorted((root / "pytorch_models_tpu_torch").rglob("*.py")) + sorted((root / "examples").glob("torch_*.py"))
             + [root / "examples" / "_torch_common.py", root / "chip_smoke.py"])
    assert len(files) > 40
    for path in files:
        bad = _imported(path) & {"jax", "jaxlib", "pytorch_models_tpu", "flax"}
        assert not bad, f"{path.relative_to(root)} imports {sorted(bad)}"
