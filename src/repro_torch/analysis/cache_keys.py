"""Pass ``cache-key``: keys of caches of compiled work.

Port of ``repro/analysis/jit_cache.py``.  The port compiles nothing per
shape today, but a CUDA graph of the decode step (ROADMAP §2 item 1) is
one capture per (``meta_pages`` bucket, batch) key, and a key minted from
a raw length captures a new graph for every request length.  This pass
holds such keys now:

* ``unbucketed-cache-key`` — a ``*cache*[key]`` subscript (store or
  read), ``.get`` or ``.setdefault`` whose key derives from a raw length
  or shape (``len(...)``, ``.shape``, ``.size()``, ``.numel()``) without
  flowing through a ``*bucket*`` function;
* ``float-cache-key``      — a key component that is a float (a float
  literal, ``float(...)``, a float-annotated parameter): every distinct
  value mints a new entry;
* ``tensor-cache-key``     — a key component that is a tensor (a
  ``torch`` call's result, a ``Tensor``-annotated parameter): it hashes
  by identity, so nothing is ever found again;
* ``lru-cache-arg``        — ``functools.lru_cache`` / ``functools.cache``
  on a function that takes a tensor or a float (the same two faults, on
  the decorator's hidden key)."""

from __future__ import annotations

import ast

from .framework import Reporter, SourceTree, attr_chain, call_name

PASS_ID = "cache-key"

_SIZE_CALLS = {"len", "size", "numel"}


def run(tree: SourceTree, reporter: Reporter) -> None:
    for fi in tree.functions:
        _check_lru(fi, reporter)
        _check_cache_keys(fi, reporter)


def _ann_kind(ann: ast.AST | None) -> str | None:
    """'tensor' | 'float' | None for a parameter annotation."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.split(".")[-1]
    else:
        chain = attr_chain(ann)
        name = chain[-1] if chain else None
    if name == "Tensor":
        return "tensor"
    if name == "float":
        return "float"
    return None


def _param_kinds(fn: ast.FunctionDef) -> dict[str, str]:
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    defaults = dict(zip([p.arg for p in reversed(a.args)],
                        list(reversed(a.defaults))))
    defaults.update(zip([p.arg for p in a.kwonlyargs], a.kw_defaults))
    out = {}
    for p in params:
        kind = _ann_kind(p.annotation)
        d = defaults.get(p.arg)
        if kind is None and isinstance(d, ast.Constant) \
                and isinstance(d.value, float):
            kind = "float"
        if kind is not None:
            out[p.arg] = kind
    return out


def _check_lru(fi, reporter: Reporter) -> None:
    for dec in fi.node.decorator_list:
        chain = attr_chain(dec.func if isinstance(dec, ast.Call) else dec)
        if not chain or chain[-1] not in ("lru_cache", "cache"):
            continue
        for name, kind in sorted(_param_kinds(fi.node).items()):
            reporter.emit(
                PASS_ID, "lru-cache-arg", fi.module, dec.lineno,
                f"{chain[-1]} on {fi.qualname}, whose parameter {name!r} "
                f"is a {kind}: "
                + ("it hashes by identity, so the cache never hits"
                   if kind == "tensor" else
                   "every distinct value mints a new entry"), fn=fi)


def _check_cache_keys(fi, reporter: Reporter) -> None:
    """Classify each key component: 'raw' (a length or shape not through
    a bucketing call), 'bucketed', 'float', 'tensor' or None."""
    kinds: dict[str, str] = dict(_param_kinds(fi.node))

    def classify(expr: ast.AST) -> str | None:
        if isinstance(expr, ast.Constant):
            return "float" if isinstance(expr.value, float) else None
        if isinstance(expr, ast.Call):
            n = call_name(expr) or ""
            chain = attr_chain(expr.func)
            if "bucket" in n:
                return "bucketed"
            if n in _SIZE_CALLS:
                return "raw"
            if n == "float":
                return "float"
            if chain and chain[0] == "torch":
                return "tensor"
            return None
        if isinstance(expr, ast.Attribute) and expr.attr == "shape":
            return "raw"
        if isinstance(expr, ast.Subscript):
            return classify(expr.value)
        if isinstance(expr, ast.Name):
            return kinds.get(expr.id)
        if isinstance(expr, ast.BinOp):
            got = {classify(expr.left), classify(expr.right)}
            for k in ("bucketed", "tensor", "float", "raw"):
                if k in got:
                    return k
        if isinstance(expr, ast.Tuple):
            # a key tuple leaks if ANY component leaks; comparisons like
            # ``s == bucket`` collapse the length to a bool and stay None
            got = {classify(e) for e in expr.elts}
            for k in ("tensor", "float", "raw", "bucketed"):
                if k in got:
                    return k
        return None

    for node in ast.walk(fi.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            kind = classify(node.value)
            name = node.targets[0].id
            if kind is None:
                kinds.pop(name, None)
            else:
                kinds[name] = kind

    def key_exprs(node: ast.AST):
        # cache[key] on either side of an assignment, or .setdefault/.get
        if isinstance(node, ast.Subscript):
            chain = attr_chain(node.value)
            if chain and "cache" in chain[-1].lower():
                yield node.slice
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            chain = attr_chain(node.func.value)
            if chain and "cache" in chain[-1].lower() and \
                    node.func.attr in ("setdefault", "get") and node.args:
                yield node.args[0]

    messages = {
        "raw": ("unbucketed-cache-key", "derives from a raw length/shape; "
                "route it through a bucketing function or every distinct "
                "size captures anew"),
        "float": ("float-cache-key", "is a float: every distinct value "
                  "mints a new entry"),
        "tensor": ("tensor-cache-key", "is a tensor: it hashes by "
                   "identity, so the entry is never found again"),
    }
    for node in ast.walk(fi.node):
        for key in key_exprs(node):
            parts = key.elts if isinstance(key, ast.Tuple) else [key]
            for part in parts:
                kind = classify(part)
                if kind in messages:
                    code, why = messages[kind]
                    reporter.emit(PASS_ID, code, fi.module, node.lineno,
                                  f"cache key component in {fi.qualname} "
                                  f"{why}", fn=fi)
                    break
