"""The port's examples (``examples/torch_*.py``) run to their end on the
CPU (``--device cpu``).  ``torch_quickstart.py`` prints what the
reference's ``examples/quickstart.py`` prints on this CPU: the same
coreset sizes and the same accuracies within one test row of 900."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

#: ``examples/quickstart.py``'s printout: variant -> (acc, n_train)
REFERENCE_QUICKSTART = {"starall": (0.937, 1470), "treeall": (0.937, 1470),
                        "starcss": (0.911, 143), "treecss": (0.911, 143)}


def run_example(name, *args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, str(REPO / "examples" / name),
                        "--device", "cpu", *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_torch_quickstart_matches_reference_printout():
    rows = {}
    for line in run_example("torch_quickstart.py").splitlines()[1:]:
        variant, acc, n_train = line.split()[:3]
        rows[variant] = (float(acc), int(n_train))
    assert set(rows) == set(REFERENCE_QUICKSTART)
    for variant, (acc, n_train) in REFERENCE_QUICKSTART.items():
        assert rows[variant][1] == n_train, variant
        # one test row of 900, plus the printout's rounding
        assert abs(rows[variant][0] - acc) <= 1 / 900 + 5e-4, variant


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-large-v3"])
def test_torch_serve_decode_runs(arch):
    out = run_example("torch_serve_decode.py", "--arch", arch,
                      "--requests", "2", "--new-tokens", "4")
    lines = out.splitlines()
    assert lines[0].startswith(f"arch={arch}-reduced batch=2 decoded 4")
    assert [ln.split(":")[0] for ln in lines[1:]] == ["req0", "req1"]


def test_torch_coreset_lm_runs():
    out = run_example("torch_coreset_lm.py", "--steps", "3", "--pool",
                      "128")
    lines = out.splitlines()
    assert lines[0].startswith("coreset: ") and "/128 sequences" in lines[0]
    losses = [float(ln.split()[-1]) for ln in lines[1:]]
    assert len(losses) == 2 and all(0 < x < 20 for x in losses)


def _vfl_train_lines(out):
    """``vfl_train.py``'s printout as {label: value text}."""
    return {k.strip(): v.strip() for k, v in (
        ln.split(":", 1) for ln in out.splitlines() if ":" in ln)}


@pytest.mark.parametrize("dataset,model", [("BP", "mlp"), ("RI", "knn")])
def test_torch_vfl_train_matches_reference(dataset, model):
    """``torch_vfl_train.py`` at the quick sizes against the reference's
    ``run_pipeline`` on ``examples/vfl_train.py``'s arguments: the same
    aligned samples, MPSI rounds and MB, training set and CT-groups, and
    the accuracy within one test row (plus the printout's rounding)."""
    from benchmarks.common import dataset_partitions
    from repro.config import AlignOptions
    from repro.core import SplitNNConfig, run_pipeline

    out = run_example("torch_vfl_train.py", "--dataset", dataset,
                      "--model", model)
    got = _vfl_train_lines(out)
    assert f"=== TREECSS on {dataset} ({model}) ===" in out
    tr, te = dataset_partitions(dataset)
    n_classes = {"BP": 4, "RI": 2}[dataset]
    rep = run_pipeline(tr, te, SplitNNConfig(
        model=model, n_classes=n_classes,
        lr=0.05 if model != "mlp" else 0.01,
        batch_size=max(8, tr.n_samples // 100), max_epochs=200, seed=0),
        variant="treecss", clusters_per_client=12, seed=0,
        align=AlignOptions(protocol="oprf"))
    assert got["aligned samples"] == str(rep.mpsi.intersection.size)
    assert got["MPSI rounds"] == (f"{rep.mpsi.rounds} "
                                  f"({rep.mpsi.total_bytes/1e6:.2f} MB)")
    assert got["training set"] == (f"{rep.n_train} (coreset, "
                                   f"{rep.coreset.n_groups} CT-groups)")
    assert ("train epochs" in got) == bool(rep.train.epochs)
    acc = float(got["test accuracy"])
    assert abs(acc - rep.metric) <= 1 / te.n_samples + 5e-5
