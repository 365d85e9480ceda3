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
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.splitnn_bottom.ops import splitnn_bottom
from repro_torch.kernels.ssd_scan.ops import ssd_scan

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


def test_slice_modules_stand_alone():
    """The YP slice's modules (minibatch Cluster-Coreset, V-coreset,
    delta-PSI) import neither jax nor the JAX package on their own."""
    probe = ("import sys\n"
             "import repro_torch.psi, repro_torch.psi.delta\n"
             "import repro_torch.core.vcoreset, repro_torch.core.coreset\n"
             "from repro_torch.core.kmeans import kmeans_minibatch_fit\n"
             "print(sorted(m for m in sys.modules\n"
             "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_llm_slice_modules_stand_alone():
    """The LLM serving slice's modules (configs, models, serve.engine,
    K11's and K12's triplets) import neither jax nor the JAX package on
    their own."""
    probe = ("import sys\n"
             "import repro_torch.configs, repro_torch.models.api\n"
             "import repro_torch.models.transformer, repro_torch.models.ssm\n"
             "import repro_torch.serve.engine\n"
             "import repro_torch.kernels.flash_attention.ops\n"
             "import repro_torch.kernels.ssd_scan.ops\n"
             "print(sorted(m for m in sys.modules\n"
             "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("op", ["psi_prf", "sorted_intersect",
                                "kmeans_update", "kmeans_assign",
                                "splitnn_bottom", "splitnn_bottom_gather",
                                "kmeans_update_gather", "flash_attention",
                                "ssd_scan"])
def test_kernel_impl_on_cpu_raises(op):
    ids, keys, pts = _cpu_operands()
    w, b = torch.ones(2, 3, 4), torch.zeros(2, 4)
    idx = torch.tensor([0, 3, 3], dtype=torch.int32)
    call = {
        "psi_prf": lambda: prf_tags(ids, torch.zeros(2, 2, dtype=torch.int64),
                                    impl="kernel"),
        "sorted_intersect": lambda: sorted_intersect(keys, keys + 1,
                                                     impl="kernel"),
        "kmeans_update": lambda: kmeans_update(pts, pts[:, :4].contiguous(),
                                               impl="kernel"),
        "kmeans_assign": lambda: kmeans_assign(pts, pts[:, :4].contiguous(),
                                               impl="kernel"),
        "splitnn_bottom": lambda: splitnn_bottom(pts, w, b, True, "kernel"),
        "splitnn_bottom_gather": lambda: splitnn_bottom(
            pts, w, b, True, "kernel", idx),
        "kmeans_update_gather": lambda: kmeans_update(
            pts, pts[:, :4].contiguous(), impl="kernel",
            idx=torch.zeros((2, 3), dtype=torch.int32)),
        "flash_attention": lambda: flash_attention(
            pts[:, :, None], pts[:, :, None], pts[:, :, None],
            impl="kernel"),
        "ssd_scan": lambda: ssd_scan(
            pts[:, :, None], pts[:, :, :1], torch.ones(1), pts, pts,
            chunk=4, impl="kernel"),
    }[op]
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_unknown_impl_raises():
    ids, _, _ = _cpu_operands()
    with pytest.raises(ValueError, match="impl"):
        prf_tags(ids, torch.zeros(2, 2, dtype=torch.int64), impl="pallas")


@pytest.mark.parametrize("model", ["lr", "mlp", "linreg"])
def test_splitnn_models_wait_for_the_training_slice(model):
    """The training and quant slices have come: every SplitNN model runs
    the pipeline on the CPU, in f32 and with the int8 wire; an unknown
    wire dtype raises."""
    x = np.random.default_rng(0).normal(size=(30, 6)).astype(np.float32)
    n_classes = 0 if model == "linreg" else 2
    y = x[:, 0] if model == "linreg" else np.arange(30) % 2
    part = partition_features(x, y, 3)
    cfg = SplitNNConfig(model=model, n_classes=n_classes, max_epochs=2)
    rep = run_pipeline(part, part, cfg, options=EngineOptions(device="cpu"),
                       align=AlignOptions(protocol="oprf"))
    assert rep.train.epochs == 2 and rep.train.steps > 0
    assert np.isfinite(rep.metric)
    rep = run_pipeline(part, part, cfg, options=EngineOptions(
        device="cpu", quant="int8"), align=AlignOptions(protocol="oprf"))
    assert rep.train.engine_stats.quant == "int8" and np.isfinite(rep.metric)
    with pytest.raises(ValueError, match="quant"):
        run_pipeline(part, part, cfg, options=EngineOptions(
            device="cpu", quant="int4"), align=AlignOptions(protocol="oprf"))
