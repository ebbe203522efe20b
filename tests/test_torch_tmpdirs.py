"""Temporary directories of the port's tests that go once they are read.

The port's tests write checkpoints (~56 MB each at the small configs'
full-width RPN), exported programs and datasets, and pytest keeps the
temporary directories of its last three runs: left in place they fill a
disk run after run. A module takes this `tmp_path`, which removes each
test's directory after the test, with

    from test_torch_tmpdirs import tmp_path  # noqa: F401

and a module-scoped fixture removes its own `tmp_path_factory.mktemp`
directory at teardown (`removed`). No JAX here: spawned ranks import the
modules that import this one.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest


def _removed_after(path: Path):
    """Yield `path`, then remove it."""
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def tmp_path(tmp_path: Path):
    """pytest's `tmp_path`, removed after the test."""
    yield from _removed_after(tmp_path)


def removed(path: Path) -> None:
    """Remove a module fixture's directory at its teardown."""
    shutil.rmtree(path, ignore_errors=True)


def test_tmp_path_holds_what_the_test_writes(tmp_path):
    (tmp_path / "checkpoint.pth").write_bytes(b"\0" * 1024)
    assert (tmp_path / "checkpoint.pth").stat().st_size == 1024


def test_tmp_path_is_gone_after_its_test(tmp_path_factory):
    """The fixture's body, driven by hand: the directory holds what was
    written until the test ends, then it is gone."""
    steps = _removed_after(tmp_path_factory.mktemp("checkpoints"))
    path = next(steps)
    (path / "checkpoint.pth").write_bytes(b"\0" * 1024)
    assert (path / "checkpoint.pth").exists()
    with pytest.raises(StopIteration):
        next(steps)
    assert not path.exists()
