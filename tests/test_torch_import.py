"""The port stands alone: importing every ``repro_torch`` module pulls in
neither jax nor the JAX package, and a kernel asked for on the CPU
raises instead of falling back."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.config import AlignOptions, EngineOptions
from repro_torch.core.splitnn import SplitNNConfig
from repro_torch.core.treecss import run_pipeline
from repro_torch.data.vertical import partition_features
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
from repro_torch.kernels.kmeans_update.ops import kmeans_update
from repro_torch.kernels.psi_prf.ops import prf_tags
from repro_torch.kernels.sorted_intersect.ops import sorted_intersect

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 25
    assert bad.strip() == "[]", bad


def _cpu_operands():
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 2 ** 40, (2, 16), generator=g)
    keys = torch.sort(ids * 2, dim=1).values
    pts = torch.randn(2, 20, 3, generator=g)
    return ids, keys, pts


@pytest.mark.parametrize("op", ["psi_prf", "sorted_intersect",
                                "kmeans_update", "kmeans_assign"])
def test_kernel_impl_on_cpu_raises(op):
    ids, keys, pts = _cpu_operands()
    call = {
        "psi_prf": lambda: prf_tags(ids, torch.zeros(2, 2, dtype=torch.int64),
                                    impl="kernel"),
        "sorted_intersect": lambda: sorted_intersect(keys, keys + 1,
                                                     impl="kernel"),
        "kmeans_update": lambda: kmeans_update(pts, pts[:, :4].contiguous(),
                                               impl="kernel"),
        "kmeans_assign": lambda: kmeans_assign(pts, pts[:, :4].contiguous(),
                                               impl="kernel"),
    }[op]
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_unknown_impl_raises():
    ids, _, _ = _cpu_operands()
    with pytest.raises(ValueError, match="impl"):
        prf_tags(ids, torch.zeros(2, 2, dtype=torch.int64), impl="pallas")


@pytest.mark.parametrize("model", ["lr", "mlp", "linreg"])
def test_splitnn_models_wait_for_the_training_slice(model):
    x = np.random.default_rng(0).normal(size=(30, 6)).astype(np.float32)
    part = partition_features(x, np.arange(30) % 2, 3)
    with pytest.raises(NotImplementedError, match="training slice"):
        run_pipeline(part, part, SplitNNConfig(model=model, n_classes=2),
                     options=EngineOptions(device="cpu"),
                     align=AlignOptions(protocol="oprf"))
