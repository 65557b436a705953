"""BENCHMARK.json against the benchmark's contract, and the harness
finding every configuration, mix and metric by name."""

import json
import re
import shutil

import pytest

from perfbench.spec import ROOT, load_benchmark, load_cell, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_and_cells():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        # a width is never cut
        assert not any(k.endswith(("_dim", "_rank", "_size")) or "expert"
                       in k or "head" in k for k in c["reduced"])
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())[
            "reduced"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    assert {w["config"] for w in BENCH["workloads"]} == set(names)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    per = {m["name"]: m for m in BENCH["per_layer"]}
    assert len(e2e) == len(BENCH["end_to_end"]) and "setup_s" in e2e
    assert len(per) == len(BENCH["per_layer"])
    assert not set(e2e) & set(per)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        mover = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in mover.get("workloads", CELLS)
        assert callable(metric_reader(m["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    c = load_cell(cell)
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    for name in c.per_layer:
        metric_reader(name)


def test_a_new_mix_file_adds_a_cell_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    mix = json.loads((tmp_path / "perfbench/traffic/decode_heavy.json")
                     .read_text())
    mix.update(clients=8, engine=dict(mix["engine"], num_slots=8))
    (tmp_path / "perfbench/traffic/decode_light.json").write_text(
        json.dumps(mix))
    bench["workloads"].append({"name": "olmoe.decode_light",
                               "config": "olmoe-1b-7b",
                               "traffic": "decode_light", "chips": 1,
                               "why": "eight clients"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = load_cell("olmoe.decode_light", tmp_path)
    assert c.traffic["clients"] == 8 and c.config["num_experts"] == 64
    after = {p: p.read_bytes() for p in before}
    assert after == before
