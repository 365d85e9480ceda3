"""Repo-specific AST lint for the port's engine modules (the port of
``repro.analysis.lint``).

Pure ``ast``, importable without torch.  The mechanics are the
reference's letter for letter (``Finding``, the suppression, the
baseline, ``lint_paths``, ``iter_source_files``, ``split_baselined``, a
syntax error as a finding); two rules carry over unchanged and three
are the JAX rules in PyTorch terms:

``host-sync``
    ``float()`` / ``int()`` / ``bool()`` on a value, ``.item()`` /
    ``.tolist()`` / ``.cpu()`` / ``.numpy()``, ``np.asarray()`` /
    ``np.array()`` or ``torch.cuda.synchronize()`` inside a *step body*.
    Each one blocks the host on the device; inside a step it breaks the
    engines' one-host-sync-per-epoch contract.  Eager PyTorch has no
    traced code, so step bodies are found so: the functions of
    ``STEP_BODIES`` (the engines' step functions, by path and qualified
    name), the ``forward``/``backward`` of ``torch.autograd.Function``
    and ``nn.Module`` subclasses, functions passed to
    ``torch.utils.checkpoint.checkpoint``, ``torch.func.*``,
    ``torch.vmap`` or ``torch.compile``/``torch.jit.*`` (or decorated
    with them), defs nested inside those, and same-module functions
    they call by bare name.

``call-time-compile``
    ``torch.compile(...)`` / ``torch.jit.script(...)`` /
    ``torch.jit.trace(...)`` evaluated inside a function body: a fresh
    compiled wrapper (and compile) per call.  Module-level wrappers and
    ``lru_cache``-decorated factories are exempt.

``unbounded-cache``
    ``lru_cache(maxsize=None)`` / ``functools.cache``.  Unbounded
    caches keyed on meshes pin process groups (and their buffers) for
    process lifetime across tests.

``bitwise-reassoc``
    ``torch.sum`` / ``.sum()`` over ``torch.stack(<list>)`` or a Python
    list, or any ``torch.sum`` / ``.sum(`` inside a function whose
    docstring declares a bitwise contract.  Python's builtin ``sum()``
    is a deterministic left fold; a tensor sum over stacked values
    re-associates (its order is the kernel's) and breaks bitwise claims.

``config-sprawl``
    A public top-level function growing more than 8 keyword-only
    parameters without accepting a config object (a parameter named
    ``options`` or ``align``): engine knobs go on
    ``EngineOptions``/``AlignOptions`` fields, not on signatures.

Suppression: a finding on line L is suppressed by ``# lint-ok: <rule>``
(with an optional ``(reason)``) on line L or L-1.  Findings may also be
accepted via a JSON baseline: a list of ``{"rule", "path", "symbol"}``
entries (line numbers deliberately excluded — they drift).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES = ("host-sync", "call-time-compile", "unbounded-cache",
         "bitwise-reassoc", "config-sprawl")

MAX_ENGINE_KWARGS = 8      # config-sprawl threshold (strictly more fails)
_OPTIONS_PARAMS = {"options", "align"}

_SUPPRESS_RE = re.compile(r"#\s*lint-ok:\s*([a-z-]+)")

#: the engines' step bodies, by path under ``repro_torch/`` and qualified
#: name (a nested def is ``outer.inner``): the SplitNN train step, the
#: scoring step, a Lloyd iteration, the LLM train and eval steps.  The
#: census reads the same table to class a host sync as inside a step.
STEP_BODIES: Dict[str, Tuple[str, ...]] = {
    "train/vfl.py": ("train_scan.step_grads", "train_scan.step_out",
                     "make_score_step.score_step"),
    "core/kmeans.py": ("lloyd_step",),
    "train/steps.py": ("lm_loss", "loss_and_grads",
                       "make_train_step.train_step",
                       "make_eval_step.eval_step"),
}

# entry points whose function-valued arguments become step bodies
# (``checkpoint``'s recompute, ``torch.func``'s transforms, ``vmap``, the
# compilers)
_TRACING_ENTRY_POINTS = {
    "checkpoint", "vmap", "grad", "grad_and_value", "vjp", "jvp",
    "jacrev", "jacfwd", "hessian", "functional_call", "compile", "script",
    "trace",
}
# classes whose ``forward``/``backward`` are step bodies
_STEP_BASES = {"Function", "Module"}
_STEP_METHODS = {"forward", "backward"}

_HOST_SYNC_CALLS = {"float", "int", "bool"}
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_HOST_SYNC_QUALIFIED = {("np", "asarray"), ("numpy", "asarray"),
                        ("np", "array"), ("numpy", "array"),
                        ("torch", "synchronize")}
_COMPILE_CALLS = {("torch", "compile"), ("torch", "jit", "script"),
                  ("torch", "jit", "trace"), ("jit", "script"),
                  ("jit", "trace")}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    symbol: str          # enclosing function qualname ('' at module level)
    message: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.rule}{sym}: {self.message}"


def _attr_chain(node: ast.AST) -> Tuple[str, ...]:
    """('torch','cuda','synchronize') for torch.cuda.synchronize; () if
    not a pure chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _call_name(node: ast.Call) -> Tuple[str, ...]:
    return _attr_chain(node.func)


def _is_compile_call(chain: Tuple[str, ...]) -> bool:
    return chain in _COMPILE_CALLS


_NOT_A_SUM = object()


def _is_listish(node: Optional[ast.AST]) -> bool:
    """A Python list, or ``torch.stack`` of one."""
    if isinstance(node, (ast.List, ast.ListComp)):
        return True
    return (isinstance(node, ast.Call)
            and _attr_chain(node.func) in (("torch", "stack"),)
            and bool(node.args)
            and isinstance(node.args[0], (ast.List, ast.ListComp)))


def _is_cache_decorator(dec: ast.AST) -> bool:
    chain = _attr_chain(dec.func if isinstance(dec, ast.Call) else dec)
    return bool(chain) and chain[-1] in ("lru_cache", "cache")


class _FunctionIndex(ast.NodeVisitor):
    """Collects every def with its qualname, parent, decorators, and the
    bare names it is referenced by (for traced-propagation)."""

    def __init__(self) -> None:
        self.funcs: Dict[str, ast.FunctionDef] = {}
        self.parents: Dict[str, Optional[str]] = {}
        self.by_name: Dict[str, List[str]] = {}
        self.step_methods: Set[str] = set()
        self._stack: List[str] = []

    def _visit_def(self, node) -> None:
        qual = ".".join(self._stack + [node.name])
        self.funcs[qual] = node
        self.parents[qual] = ".".join(self._stack) or None
        self.by_name.setdefault(node.name, []).append(qual)
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ClassDef(self, node) -> None:
        bases = {(_attr_chain(b) or ("",))[-1] for b in node.bases}
        if bases & _STEP_BASES:
            prefix = ".".join(self._stack + [node.name])
            self.step_methods.update(
                f"{prefix}.{f.name}" for f in node.body
                if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                and f.name in _STEP_METHODS)
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()


def _traced_seeds(tree: ast.Module, index: _FunctionIndex,
                  path: str = "") -> Set[str]:
    """Step-body qualnames: the ``STEP_BODIES`` entries of ``path``, the
    ``forward``/``backward`` of autograd Functions and Modules, defs
    decorated with a tracing entry point, plus any function whose bare
    name is passed to one."""
    norm = path.replace("\\", "/")
    seeds: Set[str] = {
        name for suffix, names in STEP_BODIES.items()
        if norm.endswith("repro_torch/" + suffix)
        for name in names if name in index.funcs}
    seeds |= index.step_methods
    for qual, fn in index.funcs.items():
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            chain = _attr_chain(target)
            if chain and chain[-1] in _TRACING_ENTRY_POINTS:
                seeds.add(qual)
            if isinstance(dec, ast.Call):
                for arg in list(dec.args) + [k.value for k in dec.keywords]:
                    achain = _attr_chain(arg)
                    if achain and achain[-1] in _TRACING_ENTRY_POINTS:
                        seeds.add(qual)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _call_name(node)
        if not chain or chain[-1] not in _TRACING_ENTRY_POINTS:
            continue
        for arg in list(node.args) + [k.value for k in node.keywords]:
            if isinstance(arg, ast.Name) and arg.id in index.by_name:
                seeds.update(index.by_name[arg.id])
    return seeds


def _propagate_traced(index: _FunctionIndex, seeds: Set[str]) -> Set[str]:
    """Close the traced set over (a) defs nested inside traced defs and
    (b) same-module functions a traced function calls by bare name."""
    traced = set(seeds)
    changed = True
    while changed:
        changed = False
        for qual in list(index.funcs):
            if qual in traced:
                continue
            parent = index.parents.get(qual)
            if parent in traced:
                traced.add(qual)
                changed = True
        for qual in list(traced):
            fn = index.funcs.get(qual)
            if fn is None:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name):
                    for callee in index.by_name.get(node.func.id, ()):
                        if callee not in traced:
                            traced.add(callee)
                            changed = True
    return traced


def _enclosing(index: _FunctionIndex, lineno: int) -> str:
    """Qualname of the innermost def spanning ``lineno`` ('' if none)."""
    best, best_span = "", None
    for qual, fn in index.funcs.items():
        end = getattr(fn, "end_lineno", fn.lineno)
        if fn.lineno <= lineno <= end:
            span = end - fn.lineno
            if best_span is None or span < best_span:
                best, best_span = qual, span
    return best


def _suppressed(lines: Sequence[str], lineno: int, rule: str) -> bool:
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _SUPPRESS_RE.search(lines[ln - 1])
            if m and m.group(1) == rule:
                return True
    return False


def lint_source(source: str, path: str) -> List[Finding]:
    """All unsuppressed findings in one module's source text."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("syntax-error", path, e.lineno or 0, "",
                        f"cannot parse: {e.msg}")]
    lines = source.splitlines()
    index = _FunctionIndex()
    index.visit(tree)
    traced = _propagate_traced(index, _traced_seeds(tree, index, path))
    findings: List[Finding] = []

    def add(rule: str, lineno: int, msg: str) -> None:
        if not _suppressed(lines, lineno, rule):
            findings.append(
                Finding(rule, path, lineno, _enclosing(index, lineno), msg))

    decorator_calls = {id(d) for fn in index.funcs.values()
                       for d in fn.decorator_list if isinstance(d, ast.Call)}
    bitwise_funcs = {
        qual for qual, fn in index.funcs.items()
        if "bitwise" in (ast.get_docstring(fn) or "").lower()}

    def _ancestors(ix: _FunctionIndex, qual: str):
        parent = ix.parents.get(qual)
        while parent:
            yield parent
            parent = ix.parents.get(parent)

    def _under_cached_factory(qual: str) -> bool:
        return any(
            p in index.funcs and any(
                _is_cache_decorator(d)
                for d in index.funcs[p].decorator_list)
            for p in _ancestors(index, qual))

    for qual, fn in index.funcs.items():
        for dec in fn.decorator_list:
            chain = _attr_chain(dec)
            # unbounded-cache, bare-decorator form: @functools.cache (an
            # Attribute, so only visible on decorator lists — the Call
            # form is caught in the general walk below)
            if chain == ("functools", "cache"):
                add("unbounded-cache", dec.lineno,
                    "functools.cache has no maxsize bound — pins every "
                    "key (incl. Mesh objects) for process lifetime")
            # call-time-compile, decorator form: @torch.compile on a def
            # nested inside a plain function — a fresh wrapper (and
            # compile) per enclosing call
            nested_in_fn = any(
                p in index.funcs
                for p in _ancestors(index, qual))
            target = _attr_chain(dec.func) if isinstance(dec, ast.Call) \
                else chain
            if _is_compile_call(target) and nested_in_fn \
                    and not _under_cached_factory(qual):
                add("call-time-compile", dec.lineno,
                    f"@{'.'.join(target)} on nested def '{qual}' rebuilds "
                    "the wrapper (and recompiles) on every enclosing call; "
                    "hoist to module level or an lru_cache'd factory")

    # config-sprawl: public top-level defs accreting engine kwargs
    # instead of taking an options object (repro.config)
    for qual, fn in index.funcs.items():
        if index.parents.get(qual) is not None:        # methods/nested: skip
            continue
        if fn.name.startswith("_"):
            continue
        n_kwonly = len(fn.args.kwonlyargs)
        names = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        if n_kwonly > MAX_ENGINE_KWARGS and not (names & _OPTIONS_PARAMS):
            add("config-sprawl", fn.lineno,
                f"public function '{qual}' takes {n_kwonly} keyword-only "
                f"parameters (> {MAX_ENGINE_KWARGS}) and no "
                "options/align config object — move engine knobs onto "
                "repro_torch.config.EngineOptions/AlignOptions")

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _call_name(node)

        # unbounded-cache, call form: lru_cache(maxsize=None) /
        # lru_cache(None) (decorator expressions are Calls too)
        if chain and chain[-1] == "lru_cache":
            unbounded = any(
                k.arg == "maxsize" and isinstance(k.value, ast.Constant)
                and k.value.value is None for k in node.keywords) or any(
                isinstance(a, ast.Constant) and a.value is None
                for a in node.args)
            if unbounded:
                add("unbounded-cache", node.lineno,
                    f"{'.'.join(chain)}(maxsize=None) — pins every key "
                    "(incl. Mesh objects) for process lifetime")

        # call-time-compile: torch.compile / torch.jit.* evaluated inside
        # a function body that is not an lru_cache'd factory (a decorator
        # is evaluated where its def is: the form above)
        if _is_compile_call(chain) and id(node) not in decorator_calls:
            encl = _enclosing(index, node.lineno)
            if encl:
                fn = index.funcs[encl]
                cached_factory = any(
                    _is_cache_decorator(d) for d in fn.decorator_list
                ) or _under_cached_factory(encl)
                if not cached_factory:
                    add("call-time-compile", node.lineno,
                        f"{'.'.join(chain)} created at call time — every "
                        "invocation builds a fresh wrapper and recompiles; "
                        "hoist to module level or an lru_cache'd factory")

        # host-sync: only inside step bodies
        encl = _enclosing(index, node.lineno)
        if encl in traced:
            hit = None
            if len(chain) == 1 and chain[0] in _HOST_SYNC_CALLS \
                    and node.args and not isinstance(
                        node.args[0], ast.Constant):
                hit = chain[0]
            elif len(chain) >= 2 and (chain[0], chain[-1]) in \
                    _HOST_SYNC_QUALIFIED:
                hit = ".".join(chain)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _HOST_SYNC_ATTRS:
                hit = f".{node.func.attr}()"
            if hit:
                add("host-sync", node.lineno,
                    f"{hit} inside step body '{encl}' blocks the host on "
                    "the device every step")

        # bitwise-reassoc: a tensor sum over a list or a stacked list, or
        # any tensor sum in a function whose docstring declares a bitwise
        # contract
        if chain == ("torch", "sum"):
            summed = node.args[0] if node.args else None
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "sum" and chain[:1] not in (
                    ("np",), ("numpy",)):
            summed = node.func.value
        else:
            summed = _NOT_A_SUM
        if summed is not _NOT_A_SUM:
            over_list = _is_listish(summed)
            in_bitwise = _enclosing(index, node.lineno) in bitwise_funcs
            if over_list or in_bitwise:
                why = ("over a Python list" if over_list
                       else "inside a bitwise-contract function")
                add("bitwise-reassoc", node.lineno,
                    f"tensor sum {why} re-associates; use the builtin "
                    "sum() left fold to keep bitwise claims")

    return findings


def lint_paths(paths: Iterable[Path]) -> List[Finding]:
    findings: List[Finding] = []
    for p in sorted(paths):
        findings.extend(
            lint_source(p.read_text(), str(p)))
    return findings


def iter_source_files(root: Path) -> List[Path]:
    return [p for p in sorted(root.rglob("*.py"))
            if "__pycache__" not in p.parts]


def load_baseline(path: Path) -> List[Dict[str, str]]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    if not isinstance(data, list):
        raise ValueError(f"baseline {path} must be a JSON list")
    return data


def split_baselined(findings: Sequence[Finding],
                    baseline: Sequence[Dict[str, str]]
                    ) -> Tuple[List[Finding], List[Finding]]:
    """(new, accepted): a finding is accepted if some baseline entry
    matches its (rule, path-suffix, symbol)."""
    def matches(f: Finding, b: Dict[str, str]) -> bool:
        return (f.rule == b.get("rule")
                and f.path.endswith(b.get("path", ""))
                and f.symbol == b.get("symbol", f.symbol))

    new, accepted = [], []
    for f in findings:
        (accepted if any(matches(f, b) for b in baseline)
         else new).append(f)
    return new, accepted
