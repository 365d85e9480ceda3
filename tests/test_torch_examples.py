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
