"""A fixture the port's test modules import: the port's tune cache on a
temporary file for the module, so that no test reads or writes the
cache under the home directory (``Ctx(plan="auto")`` tunes through it
on the CPU as on the card).

Importing this module also pins torch's intra-op threads to this
process's share of the cores: under pytest-xdist every worker would
otherwise run as many threads as the machine has cores, and six such
workers oversubscribe it many times over.  The port's test modules that
take no tune cache import it for the pin alone."""

import os

import pytest
import torch

from repro_torch import tune

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


@pytest.fixture(autouse=True, scope="module")
def port_tune_cache(tmp_path_factory):
    tune.set_cache(tune.TuneCache(tmp_path_factory.mktemp("tune")
                                  / "tune.json"))
    yield tune.get_cache()
    tune.set_cache(None)
