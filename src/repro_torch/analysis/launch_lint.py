"""Pass ``launch``: the ``ctypes`` launch layer against the CUDA sources.

The port's kernels reach PyTorch through ``ctypes``: each wrapper loads
its library (``_build.load("<kernel>")``), takes an ``extern "C"`` entry
point from it, sets ``fn.argtypes`` / ``fn.restype`` by hand and calls it
(``_build.launch(fn, *args, on=t)``, which appends the stream).  A list
that does not match its C signature hands the kernel garbage and nothing
raises; this pass takes the place of the JAX package's ``pallas`` lint
(``repro/analysis/pallas_lint.py``), whose BlockSpec and scratch checks
have no counterpart here.  It reads the C side with a small parser of the
``extern "C"`` definitions in ``kernels/csrc/*.cu`` (no C frontend) and
flags:

* ``argtypes-mismatch`` — a binding's ``argtypes`` differ from its entry
  point's parameters in count, or in kind at some position (``void*``
  against ``c_void_p``, ``int`` against ``c_int``, ``float`` against
  ``c_float``), or its ``restype`` from the C return type;
* ``launch-arity``      — a call of a bound function passes another
  number of arguments than its ``argtypes`` list (``_build.launch``
  counts the stream it appends);
* ``unbound-entry``     — an ``extern "C"`` entry point no wrapper binds;
* ``missing-entry``     — a binding names an entry point its library's
  source does not define;
* ``launch-count``      — a wrapper that launches a kernel does not add
  to ``_build.LAUNCHES`` exactly once, under that kernel's name, or a
  function adds to it without launching (``kernels/_build.py``: each
  wrapper adds one where it launches its kernel and nowhere else).

An argument list the pass cannot size statically (a starred value whose
length is not a literal, a comprehension over one, or a function's fixed
tuple) is skipped, not guessed."""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .framework import (Finding, FunctionInfo, ModuleInfo, Reporter,
                        SourceTree, attr_chain, call_name, const_int)

PASS_ID = "launch"

_CTYPES = {"c_void_p": "void*", "c_char_p": "void*", "c_int": "int",
           "c_int32": "int", "c_uint": "unsigned", "c_uint32": "unsigned",
           "c_float": "float", "c_double": "double", "c_long": "long",
           "c_int64": "long", "c_longlong": "long", "c_size_t": "size_t",
           "c_bool": "bool"}
_C_SCALARS = {"int": "int", "int32_t": "int", "unsigned": "unsigned",
              "unsigned int": "unsigned", "uint32_t": "unsigned",
              "float": "float", "double": "double", "long": "long",
              "long long": "long", "int64_t": "long", "size_t": "size_t",
              "bool": "bool", "void": None}
_EXTERN = re.compile(r'extern\s+"C"\s+([A-Za-z_][\w\s\*]*?)\s*\b'
                     r'([A-Za-z_]\w*)\s*\(([^)]*)\)\s*\{')


# ----------------------------------------------------------------- C side
def _strip_comments(src: str) -> str:
    """Comments blanked out, newlines kept (line numbers stay right)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, src, flags=re.S)


def _c_kind(decl: str) -> str | None:
    """The kind of a C parameter or return type: ``void*`` for any
    pointer, else the scalar's name (``int``, ``float``, ...)."""
    if "*" in decl:
        return "void*"
    words = [w for w in decl.split() if w not in ("const", "volatile",
                                                  "__restrict__")]
    for n in (2, 1):
        key = " ".join(words[:n])
        if key in _C_SCALARS and len(words) in (n, n + 1):
            return _C_SCALARS[key]
    return "?" + " ".join(words)


def c_entries(root: Path) -> dict[str, dict]:
    """``{entry: {"lib", "path", "line", "ret", "params"}}`` of every
    ``extern "C"`` definition in the ``.cu`` files under ``root``."""
    out: dict[str, dict] = {}
    for path in sorted(Path(root).rglob("*.cu")):
        text = _strip_comments(path.read_text())
        for m in _EXTERN.finditer(text):
            params = [p.strip() for p in m.group(3).split(",") if p.strip()]
            if params == ["void"]:
                params = []
            out[m.group(2)] = {
                "lib": path.stem,
                "path": path.relative_to(root).as_posix(),
                "line": text.count("\n", 0, m.start()) + 1,
                "ret": _c_kind(m.group(1)),
                "params": [_c_kind(p) for p in params]}
    return out


# ------------------------------------------------------------ Python side
def _load_lib(e: ast.AST, env: dict) -> str | None:
    """The library name of ``_build.load("<name>")`` (or of a name bound
    to one)."""
    if isinstance(e, ast.Name) and e.id in env:
        return _load_lib(env[e.id], env)
    if isinstance(e, ast.Call) and call_name(e) == "load" and e.args \
            and isinstance(e.args[0], ast.Constant) \
            and isinstance(e.args[0].value, str):
        return e.args[0].value
    return None


def _ctypes_list(e: ast.AST, scope) -> list[str] | None:
    """The kinds of a literal ``argtypes`` expression: list literals of
    ctypes types, ``+`` and ``* <int>``, parentheses, names of module
    constants."""
    if isinstance(e, ast.Name):
        v = scope(e.id)
        return None if v is None else _ctypes_list(v, scope)
    if isinstance(e, (ast.List, ast.Tuple)):
        out = []
        for x in e.elts:
            chain = attr_chain(x)
            if not chain or chain[-1] not in _CTYPES:
                return None
            out.append(_CTYPES[chain[-1]])
        return out
    if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add):
        a, b = _ctypes_list(e.left, scope), _ctypes_list(e.right, scope)
        return None if a is None or b is None else a + b
    if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Mult):
        lst, n = (e.left, e.right) if const_int(e.right) is not None \
            else (e.right, e.left)
        k, base = const_int(n), _ctypes_list(lst, scope)
        return None if k is None or base is None else base * k
    return None


def _ctype(e: ast.AST | None) -> str | None:
    if e is None:
        return "int"                 # ctypes' default restype
    if isinstance(e, ast.Constant) and e.value is None:
        return None
    chain = attr_chain(e)
    return _CTYPES.get(chain[-1], "?" + chain[-1]) if chain else "?"


class _Scope:
    """Name lookup for the static sizing: the function's own single-name
    assignments, then its module's, then a module-level constant of that
    name elsewhere in the tree (an imported one)."""

    def __init__(self, tree: SourceTree, mod: ModuleInfo, fn: ast.AST,
                 top: dict):
        self.tree, self.top = tree, top
        self.local = _assignments(fn)
        self.module = top[id(mod)]

    def __call__(self, name: str) -> ast.AST | None:
        if name in self.local:
            return self.local[name]
        if name in self.module:
            return self.module[name]
        for m in self.tree.modules:
            v = self.top[id(m)].get(name)
            if v is not None:
                return v
        return None


def _assignments(node: ast.AST, top: bool = False) -> dict[str, ast.AST]:
    out = {}
    nodes = node.body if top else ast.walk(node)
    for n in nodes:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            out[n.targets[0].id] = n.value
    return out


def _length(e: ast.AST, scope: _Scope, depth: int = 0) -> int | None:
    """The number of values ``e`` holds, where it is static."""
    if depth > 8:
        return None
    if isinstance(e, (ast.List, ast.Tuple)):
        total = 0
        for x in e.elts:
            n = _length(x.value, scope, depth + 1) \
                if isinstance(x, ast.Starred) else 1
            if n is None:
                return None
            total += n
        return total
    if isinstance(e, ast.Name):
        v = scope(e.id)
        return None if v is None else _length(v, scope, depth + 1)
    if isinstance(e, (ast.ListComp, ast.GeneratorExp)) \
            and len(e.generators) == 1 and not e.generators[0].ifs:
        return _length(e.generators[0].iter, scope, depth + 1)
    if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add):
        a = _length(e.left, scope, depth + 1)
        b = _length(e.right, scope, depth + 1)
        return None if a is None or b is None else a + b
    if isinstance(e, ast.Call):
        name = call_name(e)
        lens = set()
        for fi in scope.tree.by_def_name.get(name, []):
            for r in ast.walk(fi.node):
                if isinstance(r, ast.Return):
                    lens.add(len(r.value.elts)
                             if isinstance(r.value, ast.Tuple) else None)
        if len(lens) == 1:
            return lens.pop()
    return None


def _arity(args: list, scope: _Scope) -> int | None:
    total = 0
    for a in args:
        n = _length(a.value, scope) if isinstance(a, ast.Starred) else 1
        if n is None:
            return None
        total += n
    return total


class _Binding:
    def __init__(self, fi: FunctionInfo, var: str, lib: str | None,
                 entry: str, line: int):
        self.fi, self.var, self.lib, self.entry, self.line = \
            fi, var, lib, entry, line
        self.argtypes: ast.AST | None = None
        self.restype: ast.AST | None = None
        self.set_line = line


def _bindings(fi: FunctionInfo) -> tuple[list[_Binding], dict[int, _Binding]]:
    """``fn = <lib>.<entry>`` and the ``fn.argtypes`` / ``fn.restype``
    assignments of one function, in line order (a name may be bound to
    one entry point, then another), and the binding each call of a bound
    name reaches (by the call node's id)."""
    env = _assignments(fi.node)
    events = []
    for n in ast.walk(fi.node):
        if isinstance(n, ast.Assign) and len(n.targets) == 1:
            events.append((n.lineno, 0, n))
        elif isinstance(n, ast.Call):
            events.append((n.lineno, 1, n))
    current: dict[str, _Binding] = {}
    out: list[_Binding] = []
    calls: dict[int, _Binding] = {}
    for _, kind, n in sorted(events, key=lambda e: (e[0], e[1])):
        if kind == 1:
            target = n.args[0] if _is_build_launch(n) and n.args else n.func
            if isinstance(target, ast.Name) and target.id in current:
                calls[id(n)] = current[target.id]
            continue
        t, v = n.targets[0], n.value
        if isinstance(t, ast.Name) and isinstance(v, ast.Attribute):
            lib = _load_lib(v.value, env)
            if lib is not None:
                current[t.id] = _Binding(fi, t.id, lib, v.attr, n.lineno)
                out.append(current[t.id])
            continue
        pairs = []
        if isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple) \
                and len(t.elts) == len(v.elts):
            pairs = list(zip(t.elts, v.elts))
        elif isinstance(t, ast.Attribute):
            pairs = [(t, v)]
        for tt, vv in pairs:
            if isinstance(tt, ast.Attribute) and isinstance(tt.value,
                                                            ast.Name) \
                    and tt.value.id in current and tt.attr in ("argtypes",
                                                               "restype"):
                b = current[tt.value.id]
                setattr(b, tt.attr, vv)
                b.set_line = n.lineno
    return out, calls


def _is_build_launch(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    return bool(chain) and chain == ["_build", "launch"]


def _launches_counted(fi: FunctionInfo) -> list[ast.AugAssign]:
    out = []
    for n in ast.walk(fi.node):
        if isinstance(n, ast.AugAssign) and isinstance(n.target,
                                                       ast.Subscript):
            chain = attr_chain(n.target.value)
            if chain and chain[-1] == "LAUNCHES":
                out.append(n)
    return out


def run(tree: SourceTree, reporter: Reporter) -> None:
    entries = c_entries(tree.root)
    top = {id(m): _assignments(m.tree, top=True) for m in tree.modules}
    bound: set[str] = set()
    for fi in tree.functions:
        binds, calls = _bindings(fi)
        if not binds and not _launches_counted(fi):
            continue
        scope = _Scope(tree, fi.module, fi.node, top)
        for b in binds:
            bound.add(b.entry)
            _check_binding(b, entries, scope, reporter)
        _check_calls(fi, calls, scope, reporter)
        _check_count(fi, calls, reporter)
    # a C source carries no Python suppression: an unbound entry point is
    # bound or deleted
    for name, e in sorted(entries.items()):
        if name not in bound:
            reporter.findings.append(Finding(
                PASS_ID, "unbound-entry", e["path"], e["line"], name,
                f'extern "C" {name} ({e["path"]}) has no ctypes binding '
                "in the package"))


def _check_binding(b: _Binding, entries: dict, scope: _Scope,
                   reporter: Reporter) -> None:
    fi = b.fi
    e = entries.get(b.entry)
    if e is None or (b.lib is not None and e["lib"] != b.lib):
        where = f"csrc/{b.lib}.cu" if b.lib else "any .cu source"
        reporter.emit(PASS_ID, "missing-entry", fi.module, b.line,
                      f"binding {b.var} = {b.entry} names no extern \"C\" "
                      f"entry point of {where}", fn=fi)
        return
    if b.argtypes is None:
        reporter.emit(PASS_ID, "argtypes-mismatch", fi.module, b.line,
                      f"{b.entry} is bound without argtypes: ctypes passes "
                      "its arguments unchecked", fn=fi)
        return
    got = _ctypes_list(b.argtypes, scope)
    want = e["params"]
    if got is None:
        reporter.emit(PASS_ID, "argtypes-mismatch", fi.module, b.set_line,
                      f"argtypes of {b.entry} are not a literal list of "
                      "ctypes types the pass can read", fn=fi)
        return
    if len(got) != len(want):
        reporter.emit(PASS_ID, "argtypes-mismatch", fi.module, b.set_line,
                      f"argtypes of {b.entry} list {len(got)} parameters; "
                      f"{e['path']}:{e['line']} declares {len(want)}",
                      fn=fi)
    else:
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                reporter.emit(PASS_ID, "argtypes-mismatch", fi.module,
                              b.set_line,
                              f"argtypes of {b.entry}: parameter {i} is "
                              f"{g}, {e['path']}:{e['line']} declares {w}",
                              fn=fi)
                break
    rt = _ctype(b.restype)
    if rt != e["ret"]:
        reporter.emit(PASS_ID, "argtypes-mismatch", fi.module, b.set_line,
                      f"restype of {b.entry} is {rt}, {e['path']}:"
                      f"{e['line']} returns {e['ret']}", fn=fi)


def _check_calls(fi: FunctionInfo, calls: dict, scope: _Scope,
                 reporter: Reporter) -> None:
    for n in ast.walk(fi.node):
        b = calls.get(id(n))
        if b is None or b.argtypes is None:
            continue
        launched = _is_build_launch(n)
        args, extra = (n.args[1:], 1) if launched else (n.args, 0)
        want = _ctypes_list(b.argtypes, scope)
        got = _arity(args, scope)
        if want is None or got is None:
            continue
        if got + extra != len(want):
            how = " and the stream _build.launch appends" if extra else ""
            reporter.emit(PASS_ID, "launch-arity", fi.module, n.lineno,
                          f"call of {b.entry} passes {got} argument(s)"
                          f"{how}, its argtypes list {len(want)}", fn=fi)


def _check_count(fi: FunctionInfo, calls: dict, reporter: Reporter) -> None:
    launched = []
    for n in ast.walk(fi.node):
        if isinstance(n, ast.Call) and _is_build_launch(n):
            b = calls.get(id(n))
            launched.append(b.lib if b is not None else None)
    counts = _launches_counted(fi)
    if not launched:
        for c in counts:
            reporter.emit(PASS_ID, "launch-count", fi.module, c.lineno,
                          f"{fi.qualname} adds to _build.LAUNCHES but "
                          "launches no kernel", fn=fi)
        return
    if len(counts) != len(launched):
        reporter.emit(PASS_ID, "launch-count", fi.module, fi.node.lineno,
                      f"{fi.qualname} launches {len(launched)} kernel(s) "
                      f"and adds to _build.LAUNCHES {len(counts)} time(s): "
                      "each launch counts exactly once", fn=fi)
        return
    for c, lib in zip(counts, launched):
        key = c.target.slice
        name = key.value if isinstance(key, ast.Constant) else None
        if lib is not None and name != lib:
            reporter.emit(PASS_ID, "launch-count", fi.module, c.lineno,
                          f"{fi.qualname} launches {lib} but counts "
                          f"LAUNCHES[{name!r}]", fn=fi)
