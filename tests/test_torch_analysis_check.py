"""End-to-end tests of the port's engine-contract gate
(``python -m repro_torch.analysis.check``), the counterpart of
``tests/test_analysis_check.py``: exit codes against the real tree (one
full gate run, its 8-rank world spawned once for the file and shared by
the xdist workers), a planted ``.item()`` in each engine's step body, a
doctored contract (diffed against that run's census), a missing
contract, ``--write`` over a failing lint; the census CSV; the census on
a planted sync, a float64 cast and a collective in a loop (a 2-rank
world); and the per-step collectives of the train programs against the
reference's pinned rows (``experiments/bench/static_contract.json``)."""
import fcntl
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import check
from repro_torch.analysis.census import ProgramCensus, census_program

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
#: the reference's own contract, the rows its gate pinned
REFERENCE_CONTRACT = REPO / "experiments" / "bench" / "static_contract.json"


def run_check(*args, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.check", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _shared(tmp_path_factory, name, build):
    """``build(root)``'s result, computed by the first test worker to ask
    and read from the run's temp dir by the others."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"torch_analysis_{name}.pkl"
    with open(root / f"torch_analysis_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            out = build(root)
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, path)
        with open(path, "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """One full gate run on the CPU: (returncode, stdout, report path,
    census CSV path)."""
    def build(root):
        report, csv = root / "gate_report.json", root / "gate_census.csv"
        r = run_check("--device", "cpu", "--report", str(report),
                      "--census-csv", str(csv))
        return r.returncode, r.stdout + r.stderr, str(report), str(csv)
    return _shared(tmp_path_factory, "gate", build)


@pytest.fixture(scope="module")
def census(gate):
    with open(gate[2]) as f:
        return {tuple(k.split("@")): c
                for k, c in json.load(f)["census"].items()}


# ------------------------------------------------------------ exit codes


def test_check_passes_on_repo(gate):
    rc, out, _, _ = gate
    assert rc == 0, out[-4000:]
    assert "engine contract OK" in out
    assert "census: 34 program(s)" in out


# each engine's step body, with a line of it to plant a sync after
PLANTS = {
    "splitnn-step": ("train/vfl.py", "        out = step_out(ib)\n"),
    "lloyd-step": ("core/kmeans.py",
                   "    pad_c = assign[:, n - 1].to(torch.int64)\n"),
    "score-step": ("train/vfl.py",
                   "        with torch.no_grad():\n"
                   "            return forward_slab_eval("),
    "lm-loss": ("train/steps.py", "    labels = batch[\"labels\"][:, 1:]\n"),
}


@pytest.mark.parametrize("where", sorted(PLANTS))
def test_check_fails_on_planted_item(tmp_path, where):
    """A ``.item()`` in a step body breaks the one-sync-per-epoch
    contract: the lint names it; the epoch's own sync
    (``train/vfl.py``'s ``float(acc / steps_per_epoch)``) is not named."""
    path, anchor = PLANTS[where]
    tree = tmp_path / "repro_torch"
    shutil.copytree(PORT, tree, ignore=shutil.ignore_patterns(
        "__pycache__"))
    src = (tree / path).read_text()
    assert src.count(anchor) == 1
    indent = anchor[:len(anchor) - len(anchor.lstrip())]
    plant = f"{indent}_planted = float(torch.zeros(()).item())\n"
    (tree / path).write_text(src.replace(anchor, plant + anchor))
    r = run_check("--lint-only", "--src", str(tree))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "host-sync" in r.stdout and path in r.stdout
    assert r.stdout.count("host-sync") == 2          # float() and .item()
    clean = run_check("--lint-only")
    assert clean.returncode == 0, clean.stdout


def test_check_fails_on_doctored_contract(census, tmp_path, monkeypatch,
                                          capsys):
    """The gate against a doctored contract exits 1, against the real one
    0; its census is the gate run's (``run_census`` stubbed), not taken
    again."""
    monkeypatch.setattr(check, "run_census", lambda device: (census, []))
    doc = json.loads((PORT / "analysis" / "static_contract.json")
                     .read_text())
    row = next(r for r in doc["rows"]
               if r["engine"] == "kmeans.fit+ref" and r["mesh"] == "1")
    row["counters"]["all_gather"] = 3          # the engine has none
    doctored = tmp_path / "doctored.json"
    doctored.write_text(json.dumps(doc))
    rc = check.main(["--census-only", "--device", "cpu", "--contract",
                     str(doctored)])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert "contract pins 3" in out
    rc = check.main(["--census-only", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "engine contract OK" in out


def test_check_missing_contract_exits_2_and_writes_nothing(tmp_path):
    missing = tmp_path / "nope.json"
    r = run_check("--census-only", "--contract", str(missing), timeout=60)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "generate it with --write" in r.stdout
    assert "census:" not in r.stdout
    assert not missing.exists()


def test_write_refuses_while_lint_fails(tmp_path):
    """--write must not regenerate the contract over a dirty tree."""
    (tmp_path / "bad.py").write_text(
        "import torch\n"
        "def f(x):\n"
        "    return torch.compile(lambda y: y)(x)\n")
    target = tmp_path / "contract.json"
    r = run_check("--write", "--contract", str(target),
                  "--src", str(tmp_path),
                  "--baseline", str(tmp_path / "empty_baseline.json"),
                  timeout=60)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "call-time-compile" in r.stdout
    assert not target.exists()


# ---------------------------------------------------------- census CSV


def test_write_census_csv_roundtrip(gate, census, tmp_path):
    header, first = Path(gate[3]).read_text().split("\n")[:2]
    assert header.startswith("engine,mesh,all_gather,all_gather_in_loop,")
    assert first.startswith("kmeans.fit+kernel,1,")
    assert check.read_census_csv(gate[3]) == census
    c = ProgramCensus(kernel_launches={"psi_prf": 2, "sorted_intersect": 1},
                      steps=4)
    path = tmp_path / "census.csv"
    rows = {("psi.single", "1"): c.counters()}
    check.write_census_csv(rows, str(path))
    assert "psi_prf=2;sorted_intersect=1" in path.read_text()
    assert check.read_census_csv(str(path)) == rows


# ------------------------------------------------- census unit behavior


def test_census_counts_host_syncs_and_f64():
    def fn(x):
        y = x * 2
        float(y.sum())                               # a sync
        y.sum().item()                               # another
        y.tolist()                                   # and another
        return y.to(torch.float64) + 1.0

    c = census_program(fn, torch.ones(4))
    assert c.host_syncs == 3 and c.host_syncs_in_loop == 0
    assert c.f64_widenings == 1 and c.f64_values == 2
    assert c.total_collectives() == 0 and c.kernel_launches == {}


def test_census_loop_program_per_step():
    def loop(rounds):
        x = torch.ones(3)
        for _ in range(rounds):
            for _ in range(4):
                x = x + 1
            float(x.sum())                           # one sync a round

    c = census_program(loop, steps=4)
    assert c.steps == 4 and c.host_syncs == 1 and c.round_syncs == 1
    assert c.host_syncs_in_loop == 0


def test_census_collective_inside_loop_2_ranks(tmp_path_factory):
    from repro_torch.launch.mesh import run_ranks

    def build(root):
        import _torch_analysis_ranks as ranks
        return run_ranks(ranks.loop_census, 2, device="cpu", timeout=120)
    (c0, why0), (c1, why1) = _shared(tmp_path_factory, "loop", build)
    assert c0 == c1                       # every rank took the same census
    assert c0["collectives"] == {"all_gather": 1, "psum": 1}
    assert c0["collectives_in_loop"] == {"psum": 1}
    # bytes: the all-gather's output (2 ranks × 2 f32) once, an
    # all-reduce of 8 f32 a step
    assert c0["collective_bytes"] == {"all_gather": 16, "psum": 32}
    assert c0["collective_bytes_in_loop"] == {"psum": 32}
    assert c0["steps"] == 3
    assert "not a whole number a step" in why0


# ----------------------------------- the train programs' collectives a step

TRAIN_VARIANTS = ("lr+ref", "lr-int8+ref", "lr-fp8+ref", "mlp+kernel",
                  "mlp-int8+kernel")


@pytest.fixture(scope="module")
def reference():
    """The reference's pinned rows, {(engine, mesh): counters}, its
    ``+pallas`` programs under the port's ``+kernel`` names."""
    doc = json.loads(REFERENCE_CONTRACT.read_text())
    return {(r["engine"].replace("+pallas", "+kernel"), r["mesh"]):
            r["counters"] for r in doc["rows"]}


def _psum_a_step(mesh, model):
    """The port's all-reduces a step (``train/vfl._sharded_step_grads``):
    one flat buffer over ``data`` (a rank's bottom block, the top, S and
    W), then, with a model axis, the top, S and W over
    ``model``.  (The reference psums S, W, the bottom and the top apart,
    the top over both axes in one psum; ROADMAP R13.)"""
    data, n_model = check.MESH_SHAPES[mesh]
    m_loc = -(-3 // max(n_model, 1))                    # clients a rank
    d_max, o = max(check.FEATURE_DIMS), 8 if model == "mlp" else 1
    bottom = m_loc * d_max * o + (m_loc * o if model == "mlp" else 0)
    top = (3 * o * 64 + 64 + 64 * 1 + 1) if model == "mlp" else 1
    calls = int(data > 1) + int(n_model > 1)
    nbytes = 4 * (bottom + top + 2) + (4 * (top + 2) if n_model > 1 else 0)
    return calls, nbytes


@pytest.mark.parametrize("mesh", ["1", "8", "2x4", "4x2"])
@pytest.mark.parametrize("variant", TRAIN_VARIANTS)
def test_train_step_collectives(census, reference, variant, mesh):
    """A step's all-gather and reduce-scatter, their counts and output
    bytes, equal the reference's pinned row (each of its collectives sits
    in its scan's body, so its row's bytes are a step's); the
    all-reduces are the port's own (``_psum_a_step``)."""
    engine = f"train.epoch.{variant}"
    c, ref = census[engine, mesh], reference[engine, mesh]
    model = variant.split("-")[0].split("+")[0]
    assert c["steps"] == 4 and c["host_syncs_in_loop"] == 0
    assert c["round_syncs"] == 1
    want = int(mesh in ("2x4", "4x2"))
    for kind in ("all_gather", "reduce_scatter"):
        assert ref[kind] == ref[f"{kind}_in_loop"] == want
        assert c[f"{kind}_in_loop"] == want
        assert c[f"{kind}_bytes_in_loop"] == ref[f"{kind}_bytes"]
    if mesh == "1":
        assert c["psum_in_loop"] == c["psum_bytes_in_loop"] == 0
    else:
        calls, nbytes = _psum_a_step(mesh, model)
        assert c["psum_in_loop"] == calls
        assert c["psum_bytes_in_loop"] == nbytes
    assert c["f64_values"] == c["f64_widenings"] == 0


@pytest.mark.parametrize("engine", ["psi.prf", "psi.merge", "psi.single",
                                    "psi.union"])
@pytest.mark.parametrize("mesh", ["1", "8"])
def test_psi_programs_have_no_collective(census, engine, mesh):
    c = census[engine, mesh]
    assert all(c[k] == 0 for k in ("all_gather", "psum", "reduce_scatter",
                                   "ppermute", "all_to_all"))
    assert c["host_syncs"] == 0 and c["f64_values"] == 0


def test_quantized_gather_narrows(census):
    for mesh in ("2x4", "4x2"):
        for model in ("lr", "mlp"):
            impl = "ref" if model == "lr" else "kernel"
            f32 = census[f"train.epoch.{model}+{impl}", mesh][
                "all_gather_bytes_in_loop"]
            for quant in ("int8", "fp8"):
                key = (f"train.epoch.{model}-{quant}+{impl}", mesh)
                if key in census:
                    assert census[key]["all_gather_bytes_in_loop"] <= \
                        0.3 * f32


def _train(**kw):
    base = dict(collectives_in_loop={"all_gather": 1, "reduce_scatter": 1},
                collective_bytes_in_loop={"all_gather": 512},
                round_syncs=1, steps=4)
    return ProgramCensus(**{**base, **kw})


@pytest.mark.parametrize("rows,want", [
    ({("train.epoch.lr+ref", "2x4"): _train()}, []),
    ({("train.epoch.lr+ref", "2x4"): _train(collectives_in_loop={
        "all_gather": 1})}, ["0 reduce_scatter(s) a train step"]),
    ({("train.epoch.lr+ref", "8"): _train()},
     ["1 all_gather(s) a train step", "1 reduce_scatter(s) a train step"]),
    ({("train.epoch.lr+ref", "2x4"): _train(host_syncs_in_loop=1)},
     ["host sync(s) inside a train step"]),
    ({("train.epoch.lr+ref", "2x4"): _train(round_syncs=2)},
     ["2 host sync(s) an epoch outside the steps"]),
    ({("train.epoch.lr+ref", "2x4"): _train(),
      ("train.epoch.lr-int8+ref", "2x4"): _train(
          collective_bytes_in_loop={"all_gather": 200})},
     ["quant=int8 all_gather payload 200B > 0.3x f32 twin (512B)"]),
    ({("psi.prf", "8"): ProgramCensus(collectives={"all_gather": 1})},
     ["program contains collectives"]),
    ({("kmeans.fit+ref", "1"): ProgramCensus(f64_values=2)},
     ["f64 in the program"]),
    ({("serve.score.lr+ref", "1"): ProgramCensus(host_syncs=1)},
     ["1 host sync(s) in the program"]),
], ids=["clean", "no-transpose", "gather-without-model", "sync-in-step",
        "two-epoch-syncs", "wire-not-narrow", "psi-collective", "f64",
        "serve-sync"])
def test_hard_invariants(rows, want):
    got = check.hard_invariants(rows)
    assert len(got) == len(want), got
    for line, part in zip(got, want):
        assert part in line
