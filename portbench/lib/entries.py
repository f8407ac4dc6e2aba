"""The port's side of the harness: the dtypes, the spec a configuration
asks for, what the yardstick reads of a run's plan, and the loader of a
traffic's kind (``portbench/kinds/<entry>.py``, found by the traffic
file's ``entry``).  The modules that import the port are this one, the
kind modules (each one's ``Entry`` is the system under test) and the spec
cache (``cache.py``, through the port's ``save_spec`` / ``load_spec``)."""

from __future__ import annotations

import importlib

import numpy as np
import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}
KIND_NAMES = ("Entry", "inputs", "points", "check", "passes")


def build_spec(locs, config):
    from gpvecchia_torch.spec import vecchia_specify
    return vecchia_specify(locs, **config["specify"])


def load_kind(traffic):
    """The module of ``traffic``'s kind, ``portbench.kinds.<entry>``: it
    gives ``KIND_NAMES`` (see ``portbench/kinds/__init__.py``)."""
    return importlib.import_module(f"portbench.kinds.{traffic['entry']}")


def plan_shapes(spec):
    """What the yardstick reads of the run's plan: the multifrontal plan
    and the U rows' shapes."""
    from gpvecchia_torch.plan import get_mf_plan, get_plan
    plan = get_plan(spec)
    mf, _ = get_mf_plan(plan)
    return mf, np.asarray(plan.locs), np.asarray(plan.NN)
