"""The control on the card: the plain reference computed in float8, put in
the program's place, fails each cell's output limit, while the program at
the cell's own size and load passes it.  One seed a cell, a short window
at the cell's own load; ``readings.py`` reads a dozen seeds for the
limit."""

import pytest

from perfbench.spec import load_benchmark, load_cell

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit_the_program_passes(card, cell,
                                                         tmp_path,
                                                         monkeypatch):
    from perfbench import harness
    from perfbench.readings import read_seed
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    c = load_cell(cell)
    spec, eng, _, _ = harness.build(c.config, c.traffic, 2 ** 31 + 101)
    r = read_seed(eng, spec, c.traffic, 2 ** 31 + 101, 8.0)
    assert r["tokens"] > 0
    limits = c.config["check"]
    assert limits
    for name, limit in limits.items():
        assert r["program"][name] <= limit < r["control"][name], (name, r)
