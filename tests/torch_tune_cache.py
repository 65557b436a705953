"""A fixture the port's test modules import: the port's tune cache on a
temporary file for the module, so that no test reads or writes the
cache under the home directory (``Ctx(plan="auto")`` tunes through it
on the CPU as on the card)."""

import pytest

from repro_torch import tune


@pytest.fixture(autouse=True, scope="module")
def port_tune_cache(tmp_path_factory):
    tune.set_cache(tune.TuneCache(tmp_path_factory.mktemp("tune")
                                  / "tune.json"))
    yield tune.get_cache()
    tune.set_cache(None)
