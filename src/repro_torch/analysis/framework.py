"""Shared visitor framework: parsed source tree, annotations/suppressions,
structured findings, and the committed-baseline protocol.

Port of ``repro/analysis/framework.py``.  Everything here is plain
``ast``: the analyzer never imports the code it checks (so it runs before
any torch or CUDA initialization, and a syntax error in the tree is a
finding, not a crash).  Beside the findings it reports, the ``Reporter``
keeps the findings a used suppression sanctioned (``sanctioned``), with
the lines their construct spans, so that a run on the card can hold the
syncs it observes against them."""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path

# pass ids, in report order
PASS_IDS = ("boundary", "lifecycle", "phase", "launch", "cache-key")

# suppression key (in `# apack: allow-<key>(reason)`) -> pass id
SUPPRESS_KEYS = {
    "transfer": "boundary",
    "transition": "lifecycle",
    "phase": "phase",
    "launch": "launch",
    "cache-key": "cache-key",
}

# the reason may wrap onto continuation comment lines: capture to the
# closing paren or end of line, whichever comes first
_ALLOW_RE = re.compile(r"#\s*apack:\s*allow-([a-z\-]+)\(([^)]*)(?:\)|$)")
_ROOT_RE = re.compile(r"#\s*apack:\s*hot-path-root(?:\((traced|host)\))?")

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location.

    ``fingerprint`` deliberately omits the line number so the committed
    baseline survives unrelated edits above a grandfathered site; the
    enclosing symbol + message pin it tightly enough in practice."""
    pass_id: str
    code: str
    path: str            # tree-relative posix path
    line: int
    symbol: str          # enclosing qualname ("Cls.meth", "fn", "<module>")
    message: str
    severity: str = "error"

    @property
    def fingerprint(self) -> str:
        return "|".join((self.pass_id, self.code, self.path, self.symbol,
                         self.message))

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.pass_id}/{self.code}] "
                f"{self.message}  ({self.symbol})")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    path: str
    line: int
    key: str             # e.g. "transfer"
    reason: str
    used: bool = False


@dataclasses.dataclass
class ModuleInfo:
    path: Path
    rel: str             # tree-relative posix path
    source: str
    lines: list[str]
    tree: ast.Module
    suppressions: list[Suppression]
    root_lines: dict[int, str]     # line -> "traced" | "host"


@dataclasses.dataclass(eq=False)      # identity hash: used in graph sets
class FunctionInfo:
    module: ModuleInfo
    node: ast.FunctionDef | ast.AsyncFunctionDef
    qualname: str
    cls: str | None                # enclosing class name, if a method
    root_kind: str | None = None   # "traced" | "host" | None

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def head_lines(self) -> set[int]:
        """Lines where a function-level suppression/annotation may sit:
        the def line, each decorator line, and the line above the first
        of those."""
        first = min([d.lineno for d in self.node.decorator_list]
                    + [self.node.lineno])
        lines = {self.node.lineno, first, first - 1}
        lines.update(d.lineno for d in self.node.decorator_list)
        return lines


class SourceTree:
    """All ``*.py`` files under a root, parsed once, with per-module
    suppressions/annotations extracted and a flat function index."""

    # the analyzer never analyzes itself: its helper names (`run`, `scan`,
    # `emit`) would cross-link into product code through the conservative
    # name-resolution call graph
    EXCLUDE_DIRS = ("analysis",)

    def __init__(self, root: Path):
        self.root = Path(root).resolve()
        self.modules: list[ModuleInfo] = []
        self.parse_failures: list[Finding] = []
        self.functions: list[FunctionInfo] = []
        self.by_def_name: dict[str, list[FunctionInfo]] = {}
        self.by_qualname: dict[str, list[FunctionInfo]] = {}
        for path in sorted(self.root.rglob("*.py")):
            rel = path.relative_to(self.root).as_posix()
            if any(part in self.EXCLUDE_DIRS
                   for part in Path(rel).parts[:-1]):
                continue
            source = path.read_text()
            try:
                tree = ast.parse(source, filename=str(path))
            except SyntaxError as e:
                self.parse_failures.append(Finding(
                    "framework", "syntax-error", rel, e.lineno or 0,
                    "<module>", f"cannot parse: {e.msg}"))
                continue
            mod = ModuleInfo(path, rel, source, source.splitlines(), tree,
                             _scan_suppressions(rel, source),
                             _scan_roots(source))
            self.modules.append(mod)
            self._index(mod)

    def _index(self, mod: ModuleInfo) -> None:
        def visit(node, prefix: str, cls: str | None):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    fi = FunctionInfo(mod, child, qual, cls)
                    for ln in fi.head_lines:
                        if ln in mod.root_lines:
                            fi.root_kind = mod.root_lines[ln]
                    self.functions.append(fi)
                    self.by_def_name.setdefault(child.name, []).append(fi)
                    self.by_qualname.setdefault(qual, []).append(fi)
                    visit(child, qual + ".", cls)
                elif isinstance(child, ast.ClassDef):
                    visit(child, child.name + ".", child.name)
                else:
                    visit(child, prefix, cls)
        visit(mod.tree, "", None)

    # ------------------------------------------------------------ lookups
    def module(self, rel: str) -> ModuleInfo | None:
        for m in self.modules:
            if m.rel == rel or m.rel.endswith("/" + rel):
                return m
        return None

    def function_at(self, mod: ModuleInfo, line: int) -> FunctionInfo | None:
        """Innermost function containing ``line`` (for symbol attribution)."""
        best = None
        for fi in self.functions:
            if fi.module is not mod:
                continue
            end = getattr(fi.node, "end_lineno", fi.node.lineno)
            if fi.node.lineno <= line <= end:
                if best is None or fi.node.lineno >= best.node.lineno:
                    best = fi
        return best

    def roots(self, kind: str | None = None) -> list[FunctionInfo]:
        return [f for f in self.functions
                if f.root_kind and (kind is None or f.root_kind == kind)]


def _scan_suppressions(rel: str, source: str) -> list[Suppression]:
    out = []
    for i, line in enumerate(source.splitlines(), 1):
        for m in _ALLOW_RE.finditer(line):
            out.append(Suppression(rel, i, m.group(1), m.group(2).strip()))
    return out


def _scan_roots(source: str) -> dict[int, str]:
    out = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _ROOT_RE.search(line)
        if m:
            out[i] = m.group(1) or "host"
    return out


def _adjacent(mod: ModuleInfo, supp_line: int, target: int) -> bool:
    """A suppression covers ``target`` if it sits on that line, or above
    it separated only by comment lines (so a wrapped reason block stays
    attached to the construct directly below it)."""
    if supp_line == target:
        return True
    if supp_line > target or target - supp_line > 8:
        return False
    for ln in range(supp_line + 1, target):
        if ln - 1 >= len(mod.lines):
            return False
        if not mod.lines[ln - 1].lstrip().startswith("#"):
            return False
    return True


class Reporter:
    """Collects findings, resolving suppressions at emit time.

    A finding at line L of function F is suppressed by an
    ``# apack: allow-<key>(reason)`` whose key maps to the finding's pass
    and whose line is L, L-1, or one of F's head lines (def/decorator
    lines or the line above them — i.e. a def-level suppression covers
    the whole body).  A matching suppression with an empty reason is
    converted into a ``missing-reason`` finding: the reason string is the
    reviewable artifact, not a formality."""

    def __init__(self, tree: SourceTree):
        self.tree = tree
        self.findings: list[Finding] = list(tree.parse_failures)
        # (finding, last line of its construct) that a suppression with a
        # reason took
        self.sanctioned: list[tuple[Finding, int]] = []

    def emit(self, pass_id: str, code: str, mod: ModuleInfo, line: int,
             message: str, *, fn: FunctionInfo | None = None,
             severity: str = "error", end_line: int | None = None) -> None:
        if fn is None:
            fn = self.tree.function_at(mod, line)
        symbol = fn.qualname if fn else "<module>"
        cand = {line}
        if fn is not None:
            cand |= fn.head_lines
        for s in mod.suppressions:
            if SUPPRESS_KEYS.get(s.key) == pass_id and any(
                    _adjacent(mod, s.line, c) for c in cand):
                s.used = True
                if not s.reason:
                    self.findings.append(Finding(
                        pass_id, "missing-reason", mod.rel, s.line, symbol,
                        f"suppression allow-{s.key} has no reason (was "
                        f"suppressing: {message})"))
                else:
                    self.sanctioned.append((Finding(
                        pass_id, code, mod.rel, line, symbol, message,
                        severity), end_line or line))
                return
        self.findings.append(Finding(pass_id, code, mod.rel, line, symbol,
                                     message, severity))

    def check_suppression_keys(self) -> None:
        """Unknown `allow-*` keys are typos that silently suppress
        nothing — surface them as findings."""
        for mod in self.tree.modules:
            for s in mod.suppressions:
                if s.key not in SUPPRESS_KEYS:
                    self.findings.append(Finding(
                        "framework", "unknown-suppression-key", mod.rel,
                        s.line, "<module>",
                        f"unknown suppression key allow-{s.key} "
                        f"(known: {', '.join(sorted(SUPPRESS_KEYS))})"))


# ---------------------------------------------------------------- baseline
def load_baseline(path: Path) -> set[str]:
    if not Path(path).exists():
        return set()
    data = json.loads(Path(path).read_text())
    return {e["fingerprint"] for e in data.get("findings", [])}


def write_baseline(path: Path, findings: list[Finding]) -> None:
    entries = sorted(
        ({"fingerprint": f.fingerprint, "pass": f.pass_id, "path": f.path,
          "symbol": f.symbol, "message": f.message} for f in findings),
        key=lambda e: e["fingerprint"])
    Path(path).write_text(json.dumps({"findings": entries}, indent=2) + "\n")


# ------------------------------------------------------------ ast helpers
def attr_chain(node: ast.AST) -> list[str] | None:
    """``a.b.c`` -> ["a", "b", "c"]; None if not a pure name/attr chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def call_name(call: ast.Call) -> str | None:
    """Terminal name of the callee: ``f(...)`` and ``a.b.f(...)`` -> "f"."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def const_int(node: ast.AST) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None
