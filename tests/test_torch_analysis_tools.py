"""The port's static-analysis toolbox against the reference's
(``tests/test_analysis_tools.py``): the contract plumbing byte for byte,
the lint's mechanics and its two unchanged rules finding for finding on
the same sources, the three translated rules in torch spelling, the op
table and its two CLIs, and the shared-memory rows (``analysis.blocks``)
against the kernel modules and the CUDA sources.  No device, no world."""
import json
import re
from pathlib import Path

import pytest
import torch

from repro.analysis import contracts as ref_contracts
from repro.analysis import lint as ref_lint
from repro_torch.analysis import blocks, breakdown, contracts, lint, op_cost

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")

# ------------------------------------------------------------- contracts

ROWS = {("kmeans.fit+ref", "1"): {"all_gather": 0, "steps": 5},
        ("psi.prf", "8"): {"all_gather": 0, "kernel_launches": {}},
        ("train.epoch.lr+ref", "2x4"): {"all_gather": 1, "psum": 2}}


def _drift(mod):
    got = {k: dict(v) for k, v in ROWS.items()}
    got[("train.epoch.lr+ref", "2x4")]["all_gather"] = 3
    del got[("psi.prf", "8")]
    got[("serve.score.lr+ref", "1")] = {"all_gather": 0}
    failures = []
    mod.diff_rows(ROWS, got, "the census", failures)
    return failures


def test_contracts_failure_lines_identical():
    port = _drift(contracts)
    assert port == _drift(ref_contracts)
    assert len(port) == 3
    assert any("all_gather = 3, contract pins 1" in f for f in port)


def test_contracts_doc_and_file_byte_identical(tmp_path):
    key = ("engine", "mesh")
    assert contracts.rows_to_doc(ROWS, key) == \
        ref_contracts.rows_to_doc(ROWS, key)
    doc = {"source": "x", "rows": contracts.rows_to_doc(ROWS, key)}
    contracts.write_contract(tmp_path / "port.json", doc)
    ref_contracts.write_contract(tmp_path / "ref.json", doc)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert contracts.load_contract(tmp_path / "port.json", key) == \
        ref_contracts.load_contract(tmp_path / "ref.json", key) == ROWS


# ----------------------------------------- lint: mechanics, unchanged rules


def _same_findings(src, path="mod.py"):
    """The port's findings, each as the reference's would read: the
    config-sprawl message names the port's config module."""
    port = [f.as_dict() for f in lint.lint_source(src, path)]
    for f in port:
        f["message"] = f["message"].replace("repro_torch.config",
                                            "repro.config")
    want = [f.as_dict() for f in ref_lint.lint_source(src, path)]
    assert port == want
    return [f["rule"] for f in port]


def _kwonly_fn(name, n, extra=""):
    kws = ", ".join(f"k{i}=0" for i in range(n))
    return f"def {name}(x, *, {kws}{extra}):\n    return x\n"


UNBOUNDED = ("import functools\n"
             "@functools.lru_cache(maxsize=None)\n"
             "def a(k):\n"
             "    return k\n"
             "@functools.cache\n"
             "def b(k):\n"
             "    return k\n"
             "@functools.lru_cache(maxsize=32)\n"
             "def c(k):\n"
             "    return k\n"
             "@functools.lru_cache(None)\n"
             "def d(k):\n"
             "    return k\n")


def test_lint_unbounded_cache_same_as_reference():
    assert _same_findings(UNBOUNDED) == ["unbounded-cache"] * 3


@pytest.mark.parametrize("src,want", [
    (_kwonly_fn("run", 9), ["config-sprawl"]),
    (_kwonly_fn("run", 8), []),                      # at the limit: ok
    (_kwonly_fn("run", 9, ", options=None"), []),
    (_kwonly_fn("run", 9, ", align=None"), []),
    (_kwonly_fn("_run", 9), []),
    ("def outer():\n    " + _kwonly_fn("inner", 9).replace(
        "\n    ", "\n        "), []),
    ("# lint-ok: config-sprawl (test)\n" + _kwonly_fn("run", 9), []),
], ids=["over", "at-limit", "options", "align", "private", "nested",
        "suppressed"])
def test_lint_config_sprawl_same_as_reference(src, want):
    assert _same_findings(src) == want


def test_lint_suppression_same_as_reference():
    src = ("import functools\n"
           "# lint-ok: unbounded-cache (test)\n"
           "@functools.lru_cache(maxsize=None)\n"
           "def a(k):\n"
           "    return k\n")
    assert _same_findings(src) == []
    wrong = src.replace("unbounded-cache (test)", "host-sync (test)")
    assert _same_findings(wrong) == ["unbounded-cache"]


def test_lint_baseline_matching_same_as_reference(tmp_path):
    src = _kwonly_fn("run", 9) + _kwonly_fn("run2", 9)
    src_path = "src/repro_torch/mod.py"
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps([{"rule": "config-sprawl",
                               "path": "repro_torch/mod.py",
                               "symbol": "run"}]))
    for mod in (lint, ref_lint):
        found = mod.lint_source(src, src_path)
        new, accepted = mod.split_baselined(found, mod.load_baseline(bl))
        assert [f.symbol for f in accepted] == ["run"]
        assert [f.symbol for f in new] == ["run2"]
        new, accepted = mod.split_baselined(
            found, [{"rule": "config-sprawl", "path": "repro_torch/mod.py",
                     "symbol": "zz"}])
        assert len(new) == 2 and accepted == []
    assert lint.load_baseline(tmp_path / "missing.json") == []


def test_lint_syntax_error_same_as_reference():
    assert _same_findings("def f(:\n") == ["syntax-error"]


def test_lint_paths_and_iter_source_files(tmp_path):
    (tmp_path / "a.py").write_text(UNBOUNDED)
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "b.py").write_text(UNBOUNDED)
    files = lint.iter_source_files(tmp_path)
    assert files == ref_lint.iter_source_files(tmp_path) == \
        [tmp_path / "a.py"]
    assert [f.as_dict() for f in lint.lint_paths(files)] == \
        [f.as_dict() for f in ref_lint.lint_paths(files)]


# ------------------------------------------ lint: the translated rules


def _rules(src, path="mod.py"):
    return [f.rule for f in lint.lint_source(src, path)]


def test_lint_call_time_compile_in_body():
    src = ("import torch\n"
           "def f(x):\n"
           "    g = torch.compile(lambda y: y + 1)\n"
           "    return g(x)\n")
    (f,) = lint.lint_source(src, "mod.py")
    assert f.rule == "call-time-compile" and f.symbol == "f" and f.line == 3
    script = src.replace("torch.compile", "torch.jit.script")
    assert _rules(script) == ["call-time-compile"]


def test_lint_call_time_compile_decorator_form():
    src = ("import torch\n"
           "def outer(n):\n"
           "    @torch.compile\n"
           "    def inner(x):\n"
           "        return x * n\n"
           "    return inner\n")
    assert "call-time-compile" in _rules(src)
    called = src.replace("@torch.compile", "@torch.compile(dynamic=False)")
    assert _rules(called) == ["call-time-compile"]


def test_lint_cached_factory_exempt():
    src = ("import functools, torch\n"
           "@functools.lru_cache(maxsize=8)\n"
           "def make(n):\n"
           "    @torch.compile\n"
           "    def inner(x):\n"
           "        return x * n\n"
           "    return torch.jit.script(inner)\n")
    assert _rules(src) == []


def test_lint_module_level_compile_ok():
    assert _rules("import torch\nstep = torch.compile(lambda x: x + 1)\n") \
        == []


def test_lint_host_sync_only_in_step_bodies():
    compiled = ("import torch\n"
                "@torch.compile\n"
                "def step(x):\n"
                "    return float(x) + 1.0\n")
    assert _rules(compiled) == ["host-sync"]
    untraced = ("def report(x):\n"
                "    return float(x) + 1.0\n")
    assert _rules(untraced) == []
    constant = compiled.replace("float(x)", "float(2)")
    assert _rules(constant) == []


@pytest.mark.parametrize("call", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", "np.asarray(x)",
    "np.array(x)", "torch.cuda.synchronize()", "int(x)", "bool(x)"])
def test_lint_host_sync_calls(call):
    src = ("import numpy as np\nimport torch\n"
           "class F(torch.autograd.Function):\n"
           "    @staticmethod\n"
           "    def forward(ctx, x):\n"
           f"        return {call}\n")
    assert _rules(src) == ["host-sync"]


def test_lint_host_sync_step_seeds():
    module = ("import torch\n"
              "class M(torch.nn.Module):\n"
              "    def forward(self, x):\n"
              "        return x.item()\n"
              "    def report(self, x):\n"
              "        return x.item()\n")
    assert [f.symbol for f in lint.lint_source(module, "m.py")] == \
        ["M.forward"]
    ckpt = ("from torch.utils.checkpoint import checkpoint\n"
            "def layer(x):\n"
            "    return x.item()\n"
            "def run(x):\n"
            "    return checkpoint(layer, x, use_reentrant=False)\n")
    assert [f.symbol for f in lint.lint_source(ckpt, "m.py")] == ["layer"]
    vmapped = ckpt.replace("from torch.utils.checkpoint import checkpoint",
                           "import torch").replace(
        "checkpoint(layer, x, use_reentrant=False)", "torch.vmap(layer)(x)")
    assert _rules(vmapped) == ["host-sync"]


def test_lint_host_sync_propagates_to_callee():
    src = ("import torch\n"
           "def helper(x):\n"
           "    return x.item()\n"
           "@torch.compile\n"
           "def step(x):\n"
           "    return helper(x)\n")
    assert "host-sync" in _rules(src)


def test_lint_step_bodies_table():
    """A function of ``STEP_BODIES`` is a step body in its file only."""
    src = ("def train_scan(x):\n"
           "    def step_grads(i):\n"
           "        return x.item()\n"
           "    return float(step_grads(0))\n")
    found = lint.lint_source(src, "src/repro_torch/train/vfl.py")
    assert [(f.symbol, f.line) for f in found] == \
        [("train_scan.step_grads", 3)]
    assert _rules(src, "src/repro_torch/other.py") == []


def test_lint_bitwise_reassoc():
    stacked = ("import torch\n"
               "z = torch.sum(torch.stack([a, b, c]))\n"
               "y = torch.stack([a, b]).sum(0)\n"
               "w = torch.sum([a, b])\n")
    assert _rules(stacked) == ["bitwise-reassoc"] * 3
    contract = ("import torch\n"
                "def fold(xs):\n"
                "    \"\"\"Bitwise-identical partial sums.\"\"\"\n"
                "    return torch.sum(xs) + xs.sum(0)\n")
    assert _rules(contract) == ["bitwise-reassoc"] * 2
    plain = ("import torch\n"
             "def fold(xs):\n"
             "    return torch.sum(xs) + xs.sum(0) + sum([1, 2])\n")
    assert _rules(plain) == []


def test_lint_inline_suppression():
    src = ("import torch\n"
           "def f(x):\n"
           "    # lint-ok: call-time-compile (test)\n"
           "    g = torch.compile(lambda y: y + 1)\n"
           "    return g(x)\n")
    assert _rules(src) == []
    wrong = src.replace("call-time-compile (test)", "host-sync (test)")
    assert _rules(wrong) == ["call-time-compile"]


def test_lint_port_tree_is_clean():
    root = Path(lint.__file__).resolve().parents[1]
    assert [f.render() for f in
            lint.lint_paths(lint.iter_source_files(root))] == []


# --------------------------------------------------- op_cost / breakdown

# one mm: flops = 2·|out|·K = 2·(8·32)·16 = 8,192 (DOT_HLO's); bytes =
# out 1,024 + operands 512 + 2,048 = 3,584
MM_RECORD = {"op": "mm", "inputs": [[8, 16], [16, 32]], "outputs": [[8, 32]],
             "dtype": "f32", "flops": 8192, "bytes": 3584, "count": 1}


def test_op_costs_one_mm_golden():
    recs = op_cost.op_costs(torch.mm, torch.ones(8, 16), torch.ones(16, 32))
    assert recs == [MM_RECORD]
    assert op_cost.totals(recs) == {"flops": 8192.0, "bytes": 3584.0}


def test_op_costs_two_layer_mlp_hand_counts():
    w1, w2 = torch.ones(16, 32), torch.ones(32, 4)

    def mlp(x):
        return torch.relu(x @ w1) @ w2
    recs = op_cost.op_costs(mlp, torch.ones(8, 16))
    assert [r["op"] for r in recs] == ["mm", "relu", "mm"]
    assert [r["flops"] for r in recs] == [2 * 8 * 32 * 16, 0, 2 * 8 * 4 * 32]
    assert [r["bytes"] for r in recs] == [
        4 * (8 * 16 + 16 * 32 + 8 * 32), 4 * 2 * 8 * 32,
        4 * (8 * 32 + 32 * 4 + 8 * 4)]
    # a loop's trips are counted, views move nothing
    recs = op_cost.op_costs(lambda x: [x.view(-1) * 2 for _ in range(3)],
                            torch.ones(8, 16))
    assert [(r["op"], r["bytes"], r["count"]) for r in recs] == [
        ("view", 0, 3), ("mul", 2 * 4 * 128, 3)]


def test_op_cost_cli(tmp_path, capsys):
    good = tmp_path / "ops.jsonl"
    op_cost.write_ops(good, [MM_RECORD])
    assert op_cost.main([str(good)]) == 0
    out = capsys.readouterr().out
    assert "flops 8192" in out and "bytes 3584" in out
    assert op_cost.main([str(tmp_path / "missing.jsonl")]) == 2
    bad = tmp_path / "notes.txt"
    bad.write_text("not an op table\n")
    assert op_cost.main([str(bad)]) == 1
    partial = tmp_path / "partial.jsonl"
    partial.write_text(json.dumps({"op": "mm"}) + "\n")
    assert op_cost.main([str(partial)]) == 1


def test_breakdown_cli_and_tables(tmp_path, capsys):
    good = tmp_path / "ops.jsonl"
    op_cost.write_ops(good, [MM_RECORD])
    assert breakdown.main([str(good), "5"]) == 0
    out = capsys.readouterr().out
    assert "mm -> f32[8,32]" in out
    assert "== top byte movers" in out and "== top flop ops" in out
    by_bytes, by_flops = breakdown.breakdown([MM_RECORD])
    (key, b), = by_bytes.items()
    assert key == "mm -> f32[8,32]" and b == 3584
    assert by_flops[key] == 8192
    assert breakdown.main([str(tmp_path / "missing.jsonl")]) == 2
    bad = tmp_path / "notes.txt"
    bad.write_text("not an op table\n")
    assert breakdown.main([str(bad)]) == 1


# ------------------------------------------------------------- smem rows


def test_blocks_default_matrix_all_ok():
    rows = [r.as_row() for r in blocks.smem_report()]
    assert len(rows) >= 30
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
    kernels = {r["kernel"] for r in rows}
    assert kernels == {
        "splitnn_bottom", "splitnn_bottom_int8", "splitnn_bottom_gather",
        "splitnn_bottom_int8_gather", "kmeans_update",
        "kmeans_update_gather", "kmeans_assign", "psi_prf",
        "sorted_intersect", "sorted_intersect_tiled", "flash_attention",
        "flash_attention_bwd", "ssd_scan"}


def test_blocks_splitnn_past_cap_refused():
    from repro_torch.kernels.splitnn_bottom import kernel
    ok = blocks.splitnn_bottom_blocks(512, 128, 8)
    bad = blocks.splitnn_bottom_blocks(512, 128, 128)
    assert ok.ok and not bad.ok and bad.limit == kernel.SMEM_CAP
    kernel._smem_check("splitnn_bottom", 128, 8, ok.smem_bytes)
    with pytest.raises(ValueError, match="shared memory"):
        kernel._smem_check("splitnn_bottom", 128, 128, bad.smem_bytes)


def test_blocks_gather_rows_have_no_fallback():
    rows = blocks.GATHER_VMEM_BUDGET // (4 * 128)
    at = blocks.splitnn_bottom_gather_blocks(rows, 128, 8, 512)
    over = blocks.splitnn_bottom_gather_blocks(rows + 1, 128, 8, 512)
    assert at.ok and over.ok and at.smem_bytes == over.smem_bytes
    i8 = blocks.GATHER_VMEM_BUDGET // 128
    at8 = blocks.splitnn_bottom_gather_blocks(i8, 128, 8, 512, quant="int8")
    over8 = blocks.splitnn_bottom_gather_blocks(i8 + 1, 128, 8, 512,
                                                quant="int8")
    assert at8.ok and over8.ok and at8.smem_bytes == over8.smem_bytes
    k4 = [blocks.kmeans_update_gather_blocks(n, 16, 10, 1024)
          for n in (rows, 4 * rows)]
    assert all(r.ok for r in k4) and k4[0].smem_bytes == k4[1].smem_bytes


def test_blocks_bytes_are_the_kernel_modules():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.kmeans_assign import kernel as ka
    from repro_torch.kernels.kmeans_update import kernel as ku
    from repro_torch.kernels.psi_prf import kernel as prf
    from repro_torch.kernels.sorted_intersect import kernel as si
    from repro_torch.kernels.splitnn_bottom import kernel as sb
    from repro_torch.kernels.ssd_scan import kernel as ssd
    for r in blocks.smem_report():
        p, k = r.params, r.kernel
        if k.startswith("splitnn_bottom"):
            rows = sb.rows_per_cta(p["o"])
            fn = sb.int8_smem_bytes if p["quant"] else sb.f32_smem_bytes
            want = fn(p["d"], p["o"], rows, "b" in p, p["quant"] is not None)
        elif k in ("kmeans_update", "kmeans_update_gather"):
            want = ku.smem_bytes(ku.geometry(p["m"], p.get("b", p["n"]),
                                             p["k"], p["d"]).tile,
                                 p["k"], p["d"])
        elif k == "kmeans_assign":
            want = ka.geometry(p["m"], p["n"], p["k"], p["d"]).smem_bytes
        elif k == "psi_prf":
            want = prf.smem_bytes()
        elif k.startswith("sorted_intersect"):
            want = si.merge_smem_bytes(
                si.merge_geometry(p["pairs"], p["p"]).threads)
        elif k == "flash_attention":
            dt = torch.float32 if p["dtype"] == "f32" else torch.bfloat16
            want = fa.smem_bytes(p["dh"], dt)
        elif k == "flash_attention_bwd":
            dt = torch.float32 if p["dtype"] == "f32" else torch.bfloat16
            want = max(fa.bwd_smem_bytes(p["dh"], dt))
        else:
            want = max(ssd.smem_bytes(p["p"], p["n"], p["chunk"]))
        assert r.smem_bytes == want, r


def _consts(src, names):
    """The integer constexprs ``names`` of a CUDA source."""
    out = {}
    for n in names:
        m = re.search(rf"constexpr int {n} = ([^;]+);", src)
        out[n] = eval(m.group(1).split("//")[0], {}, dict(out))
    return out


def _expr(src, name, env):
    """A ``constexpr size_t`` or ``int`` expression of a source,
    evaluated with ``env`` (casts dropped)."""
    m = re.search(rf"constexpr (?:size_t|int) {name} =\s*([^;]+);", src)
    return eval(m.group(1).replace("(size_t)", ""), {}, env)


def test_new_smem_functions_equal_the_sources():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    src = (CSRC / "ssd_scan.cu").read_text()
    c = _consts(src, ["P_MAX", "N_MAX", "L_MAX", "RS", "XS"])
    cb, chunk = _expr(src, "CB_SMEM", c), _expr(src, "CHUNK_SMEM", c)
    assert "__shared__ int item_s;" in src        # the chunk CTA's ticket
    assert ssd.smem_bytes(64, 128, 128) == (cb, chunk + 4)
    assert ssd.smem_bytes(1, 1, 1) == (cb, chunk + 4)
    with pytest.raises(ValueError):
        ssd.smem_bytes(65, 16, 128)
    fwd = (CSRC / "flash_attention.cu").read_text()
    tc = _consts(fwd, ["TC_WARPS", "TC_THREADS", "TC_ROWS", "TILE_FLOATS"])
    for dh in (16, 32, 64, 100, 128, 160, 200, 256):
        dp = next(d for d in (32, 64, 128, 160, 256) if dh <= d)
        env = dict(tc, DP=dp, BK=64 if dp <= 128 else 32, LD=dp + 8)
        assert fa.smem_bytes(dh) == _expr(fwd, "SMEM", env)
        # the f32 instance: K and V tiles of TILE_FLOATS floats
        assert fa.smem_bytes(dh, torch.float32) == 2 * tc["TILE_FLOATS"] * 4
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    tc = _consts(bwd, ["TC_WARPS", "TC_THREADS", "TC_ROWS"])
    for dh in (32, 64, 128, 160, 256):
        t = fa.bwd_tiles(dh)
        env = dict(tc, DP=t.dp, BK=t.bk, BN=t.bn, BM=t.bm, LD=t.dp + 8)
        assert fa.bwd_smem_bytes(dh) == (_expr(bwd, "DQ_SMEM", env),
                                         _expr(bwd, "DKDV_SMEM", env))
        bm = 64 if t.dp <= 160 else 32
        bn = 64 if t.dp <= 128 else 32
        env = dict(BM=bm, BN=bn, LD=t.dp + 1, LDP=bn + 1)
        assert fa.bwd_smem_bytes(dh, torch.float32) == (
            4 * _expr(bwd, "DQ_FLOATS", env),
            4 * _expr(bwd, "DKDV_FLOATS", env))
    prf = (CSRC / "psi_prf.cu").read_text()
    assert "__shared__" not in prf
