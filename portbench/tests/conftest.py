"""Fixtures of the benchmark's CPU tests: the port's merge engine (its
plain twins, which stand for the kernels that the windowed configuration
runs on the card) and a checkout of the benchmark at tiny sizes."""

import pytest

from .cells import TINY, checkout


@pytest.fixture
def merge_engine():
    import xsdba_tpu_torch as xt

    with xt.set_options(selection_backend=False):
        yield


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("tiny"), TINY)
