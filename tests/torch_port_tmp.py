"""Temp directories that a port test module removes once it is done with them.

pytest keeps every temp directory of its last three runs. The port's test
modules write tiny-preset model directories (about 130 MB each), trainer run
directories and their checkpoints: about 5 GB a run in all. So each of them
imports these two fixtures and removes what it wrote: a test's ``tmp_path``
when the test ends, the directories that ``tmp_path_factory.mktemp`` made
for the module's fixtures when the module ends.

    from torch_port_tmp import tmp_path, tmp_path_factory  # noqa: F401
"""

import shutil

import pytest


class _Removing:
    """pytest's ``tmp_path_factory``, recording the directories it makes."""

    def __init__(self, factory):
        self._factory, self.made = factory, []

    def __getattr__(self, name):
        return getattr(self._factory, name)

    def mktemp(self, basename, numbered=True):
        path = self._factory.mktemp(basename, numbered=numbered)
        self.made.append(path)
        return path


@pytest.fixture(scope="module")
def tmp_path_factory(tmp_path_factory):
    factory = _Removing(tmp_path_factory)
    yield factory
    for path in factory.made:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
