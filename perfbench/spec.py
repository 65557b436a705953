"""The benchmark's data, found by name: cells, configurations, traffic mixes
and per-layer metric readers.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, and this module finds it by
the name ``BENCHMARK.json`` gives:

* a cell (``workloads``) names a configuration and a traffic mix;
* a configuration is ``configs/<name>.json`` (the path is the ``file`` of
  its entry in ``BENCHMARK.json``);
* a traffic mix is ``traffic/<name>.json``;
* a per-layer metric is ``metrics/<name>.py``, whose ``read(run)``
  returns the number, or None where the run holds nothing to read.

So a later change adds a configuration, a mix, a metric or a cell by adding
files and entries, never by editing one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["HERE", "ROOT", "ModelSpec", "Cell", "load_benchmark", "load_cell",
           "load_traffic", "metric_reader", "model_spec", "percentile"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The sizes of a configuration as it runs, read from its file: what
    the weights, the reference and the operation counts need."""
    name: str
    family: str             # "dense" | "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    norm_eps: float
    rope_theta: float
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 0.0
    norm_topk_prob: bool = True

    def capacity(self, tokens: int) -> int:
        """Expert capacity of a routing call over ``tokens`` tokens: the
        port's rule, ``max(1, int(cf * k * tokens / E))``."""
        return max(1, int(self.capacity_factor * self.experts_per_token
                          * tokens / self.n_experts))

    def matmul_params(self) -> int:
        """Parameters that take part in a token's products: every
        projection, the router, the ``k`` experts a token uses and the
        head; not the embedding table, which is a lookup."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * d
        mlp = 3 * d * self.d_ff
        if self.family == "moe":
            mlp = self.experts_per_token * mlp + d * self.n_experts
        return self.n_layers * (attn + mlp) + d * self.vocab

    def token_flops(self, context: int) -> float:
        """Model FLOPs of one token that attends over ``context``
        positions (itself included): two a multiply-add of every product,
        and the score and value products of attention."""
        attn = 4.0 * self.n_layers * self.n_heads * self.head_dim * context
        return 2.0 * self.matmul_params() + attn

    def prefill_flops(self, n: int) -> float:
        """Model FLOPs of a prefill of ``n`` prompt tokens: every token's
        products and causal attention, and the head on the last token."""
        head = self.d_model * self.vocab
        attn = 4.0 * self.n_layers * self.n_heads * self.head_dim \
            * n * (n + 1) / 2
        return 2.0 * (self.matmul_params() - head) * n + 2.0 * head + attn


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple        # the names this cell reports with --trace 0
    per_layer: tuple         # the names this cell reports with --trace 1
    units: dict


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found: run from a checkout")
    return json.loads(path.read_text())


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / HERE.name / "traffic" / f"{name}.json")
                      .read_text())


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration,
    its traffic mix and the metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / cfg_entry["file"]).read_text()),
        traffic=load_traffic(w["traffic"], root),
        end_to_end=tuple(m["name"] for m in bench["end_to_end"]
                         if _in_cell(m, name)),
        per_layer=tuple(m["name"] for m in bench["per_layer"]
                        if _in_cell(m, name)),
        units=units)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_spec(config: dict) -> ModelSpec:
    """A configuration file's sizes under the port's names.  The file
    holds the published ``config.json`` keys as published or cut
    (``reduced``); ``port`` holds the settings of the port that the
    published config has no key for, and where the port departs from a
    published key (``departures``), what the port runs, which the
    reference follows."""
    c, port = config, config.get("port", {})
    heads = c["num_attention_heads"]
    moe = "num_experts" in c
    return ModelSpec(
        name=c.get("registry", "unregistered"), family="moe" if moe else "dense",
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=heads, n_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        norm_eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]),
        n_experts=c.get("num_experts", 0),
        experts_per_token=c.get("num_experts_per_tok", 0),
        capacity_factor=float(port.get("capacity_factor", 0.0)),
        norm_topk_prob=bool(port.get("norm_topk_prob",
                                     c.get("norm_topk_prob", True))))


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
