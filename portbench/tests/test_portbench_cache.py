"""The spec cache's key follows the configuration file and the port's
sources that build a spec, and nothing else."""

from __future__ import annotations

import shutil

import pytest

from portbench.lib import cache
from portbench.lib.cell import ROOT


@pytest.fixture
def tree(tmp_path):
    for pat in cache.SPEC_SOURCES + ("gpvecchia_torch/plan.py",):
        for f in ROOT.glob(pat):
            dst = tmp_path / f.relative_to(ROOT)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(f, dst)
    return tmp_path


@pytest.mark.parametrize("source", ["gpvecchia_torch/spec.py",
                                    "gpvecchia_torch/geometry/ordering.py",
                                    "gpvecchia_torch/csrc/hostops.cpp",
                                    "gpvecchia_torch/csrc/host.py"])
def test_key_follows_spec_sources(tree, source):
    k0 = cache.key(b"{}", cache.SPEC_SOURCES, tree)
    with open(tree / source, "a") as f:
        f.write("\n")
    assert cache.key(b"{}", cache.SPEC_SOURCES, tree) != k0


def test_key_follows_config_not_other_sources(tree):
    k0 = cache.key(b"{}", cache.SPEC_SOURCES, tree)
    assert cache.key(b'{"n": 1}', cache.SPEC_SOURCES, tree) != k0
    with open(tree / "gpvecchia_torch/plan.py", "a") as f:
        f.write("\n")
    assert cache.key(b"{}", cache.SPEC_SOURCES, tree) == k0


def test_reference_key_follows_its_sources(tmp_path):
    for pat in cache.REF_SOURCES:
        for f in ROOT.glob(pat):
            dst = tmp_path / f.relative_to(ROOT)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(f, dst)
    k0 = cache.key(b"{}", cache.REF_SOURCES, tmp_path)
    with open(tmp_path / "portbench/reference/spec.py", "a") as f:
        f.write("\n")
    assert cache.key(b"{}", cache.REF_SOURCES, tmp_path) != k0
