"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names, and the reference loads nothing of the port."""

import os
import subprocess
import sys

from perfbench.spec import ROOT

_ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                   str(ROOT / "src")]))


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], env=_ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_what_run_py_loads_holds_no_jax():
    code = """
import runpy, sys
sys.argv = ["run.py", "--help"]
try:
    runpy.run_path("perfbench/run.py", run_name="__main__")
except SystemExit:
    pass
from perfbench import check, devtrace, e2e, harness, readers, roofline
from perfbench.spec import load_benchmark, metric_reader
for m in load_benchmark()["per_layer"]:
    metric_reader(m["name"])
from repro_torch.kernels import _build
from repro_torch.models import Ctx, build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Request
from repro_torch import obs
print(",".join(harness.forbidden_modules()) or "none")
"""
    assert _run(code).splitlines()[-1] == "none"


def test_forbidden_names_are_compared_whole():
    code = """
import sys, types
from perfbench import harness
sys.modules["repro_torch_like"] = types.ModuleType("repro_torch_like")
sys.modules["jaxtyping"] = types.ModuleType("jaxtyping")
assert harness.forbidden_modules() == []
sys.modules["repro"] = types.ModuleType("repro")
print(harness.forbidden_modules())
"""
    assert _run(code) == "['repro']"


def test_the_reference_loads_nothing_of_the_port():
    code = """
import sys, torch
from perfbench import check
from perfbench.reference import model
from perfbench.spec import model_spec
spec = model_spec({"hidden_size": 32, "intermediate_size": 32,
                   "num_hidden_layers": 1, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "vocab_size": 64,
                   "rms_norm_eps": 1e-5, "rope_theta": 1e4})
model.forward(spec, 1, [torch.tensor([[1, 2, 3]])], "cpu")
tops = {m.split(".")[0] for m in sys.modules}
print(sorted(tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}))
"""
    assert _run(code) == "[]"
