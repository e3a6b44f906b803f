"""Running the JAX package's examples and the port's (``examples/torch_*.py``)
in the test process, for the tests that hold one against the other.

The JAX scripts run through ``runpy`` as ``python examples/<name>.py``
would, with their standard output captured; they build their own random
models, and the tests build the same ones (the same constructor calls and
seeds) to hand the port's ``main`` through ``from_jax_params``. The port's
scripts run through ``main(["--cpu"], **models)``."""

import contextlib
import importlib
import io
import runpy
import sys

import jax

from pytorch_models_tpu.utils.params import to_np
from pytorch_models_tpu_torch.utils import from_jax_params


def port_params(jax_model):
    """A JAX model's parameter tree as the port's (CPU tensors)."""
    return from_jax_params(jax.tree.map(to_np, jax_model.params))


def run_jax(name: str, monkeypatch) -> tuple[dict, list[str]]:
    """``examples/<name>.py`` run as a script: its globals and printed lines."""
    monkeypatch.setattr(sys, "argv", [f"examples/{name}.py"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(f"examples/{name}.py", run_name="__main__")
    return g, buf.getvalue().splitlines()


def run_port(name: str, argv=("--cpu",), **models) -> tuple[dict, list[str]]:
    """``examples/torch_<name>.py``'s ``main(argv, **models)``: its result
    and printed lines."""
    mod = importlib.import_module(f"examples.torch_{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(list(argv), **models)
    return out, buf.getvalue().splitlines()


def printed(lines: list[str], label: str) -> str:
    """The rest of the printed line that starts with ``label``."""
    hits = [ln[len(label):].strip() for ln in lines if ln.startswith(label)]
    assert len(hits) == 1, f"{label!r}: {hits}"
    return hits[0]
