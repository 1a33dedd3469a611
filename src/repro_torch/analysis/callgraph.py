"""Name-resolution call graph over a :class:`~.framework.SourceTree`.

Port of ``repro/analysis/callgraph.py``.  Deliberately conservative (an
over-approximation): a call ``self.f(...)`` resolves to the same class's
``f`` when one exists, otherwise — like any ``obj.f(...)`` — to *every*
method or module-level function named ``f`` in the tree.  Reachability
passes therefore never miss an edge through dynamic dispatch at the cost
of occasionally walking into a same-named stranger; the passes built on
top only flag specific constructs, so extra breadth costs a suppression,
not a false invariant.

Where Python's own scoping fixes the callee, the port resolves it as
Python does, since its device taint is broader than the JAX package's
``jnp`` roots and every stranger would cost a finding:

* a bare ``f(...)`` is the ``f`` defined in an enclosing function, else
  the module's own ``f``, else the ``f`` imported from a module of the
  tree, else every module-level ``f``;
* ``mod.f(...)`` through an imported module of the tree is that module's
  ``f`` (where it defines one);
* a def nested in a function is reachable only by its bare name from
  inside it, never as ``obj.f``.

On a tree without such shadowing (no nested def or method sharing a name
with a module-level function called bare) the graph is the JAX
package's.  ``skip_calls`` (ids of call nodes) lets a pass leave out
edges it knows never run on its path, such as the boundary pass's calls
on a CPU tensor's branch."""

from __future__ import annotations

import ast

from .framework import FunctionInfo, SourceTree, attr_chain


class CallGraph:
    def __init__(self, tree: SourceTree, skip_calls: set[int] | None = None):
        self.tree = tree
        self.skip_calls = skip_calls or set()
        self.edges: dict[str, set[str]] = {}      # qualname@rel -> callees
        self.nodes: dict[str, FunctionInfo] = {}
        self.by_qual: dict[tuple, FunctionInfo] = {}
        self.by_rel = {m.rel: m for m in tree.modules}
        self.imports = {id(m): _imports(m, self.by_rel, tree.root.name)
                        for m in tree.modules}
        for fi in tree.functions:
            self.nodes[self.key(fi)] = fi
            self.by_qual[(id(fi.module), fi.qualname)] = fi
        for fi in tree.functions:
            self.edges[self.key(fi)] = {
                self.key(c) for c in self._callees(fi)}

    @staticmethod
    def key(fi: FunctionInfo) -> str:
        return f"{fi.module.rel}::{fi.qualname}"

    def _callees(self, fi: FunctionInfo) -> set[FunctionInfo]:
        out: set[FunctionInfo] = set()
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call) or id(node) in self.skip_calls:
                continue
            out.update(self.resolve_call(node, fi))
        # a nested def / lambda body executes (at most) when the enclosing
        # function runs; treat "defines" as an edge so closures passed to
        # map() or a checkpoint stay reachable
        for child in ast.iter_child_nodes(fi.node):
            for sub in ast.walk(child):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for cand in self.tree.by_def_name.get(sub.name, []):
                        if cand.module is fi.module and cand.node is sub:
                            out.add(cand)
        return out

    def resolve_call(self, node: ast.Call,
                     caller: FunctionInfo) -> list[FunctionInfo]:
        """The tree functions a call may reach."""
        f = node.func
        if isinstance(f, ast.Name):
            return self._resolve_bare(f.id, caller)
        if not isinstance(f, ast.Attribute):
            return []
        chain = attr_chain(f)
        via_self = bool(chain) and chain[0] == "self" and len(chain) == 2
        mod = None
        if chain and len(chain) == 2:
            tgt = self.imports[id(caller.module)].get(chain[0])
            mod = tgt if isinstance(tgt, str) else None
        return self._resolve(f.attr, caller, via_self=via_self, module=mod)

    @staticmethod
    def _nested(fi: FunctionInfo) -> bool:
        return fi.qualname not in (fi.name, f"{fi.cls}.{fi.name}")

    def _top(self, rel: str, name: str) -> list[FunctionInfo]:
        mod = self.by_rel.get(rel)
        fi = self.by_qual.get((id(mod), name)) if mod else None
        return [fi] if fi is not None else []

    def _resolve_bare(self, name: str,
                      caller: FunctionInfo) -> list[FunctionInfo]:
        qual = caller.qualname
        while True:                      # enclosing functions' own defs
            fi = self.by_qual.get((id(caller.module), f"{qual}.{name}"))
            if fi is not None and self._nested(fi):
                return [fi]
            if "." not in qual:
                break
            qual = qual.rsplit(".", 1)[0]
        own = self._top(caller.module.rel, name)
        if own:
            return own
        tgt = self.imports[id(caller.module)].get(name)
        if isinstance(tgt, tuple):
            got = self._top(tgt[0], tgt[1])
            if got:
                return got
        return [c for c in self.tree.by_def_name.get(name, [])
                if c.qualname == c.name]

    def _resolve(self, name: str, caller: FunctionInfo, *,
                 via_self: bool, module: str | None = None
                 ) -> list[FunctionInfo]:
        if module is not None:
            got = self._top(module, name)
            if got:
                return got
        cands = [c for c in self.tree.by_def_name.get(name, [])
                 if not self._nested(c)]
        if not cands:
            return []
        if via_self and caller.cls:
            same_cls = [c for c in cands
                        if c.cls == caller.cls and c.module is caller.module]
            if same_cls:
                return same_cls
        return cands

    def reachable(self, roots: list[FunctionInfo]) -> list[FunctionInfo]:
        """BFS closure over the call graph, roots included, stable order."""
        seen: dict[str, FunctionInfo] = {}
        frontier = [self.key(r) for r in roots]
        for k in frontier:
            seen[k] = self.nodes[k]
        while frontier:
            nxt = []
            for k in frontier:
                for callee in sorted(self.edges.get(k, ())):
                    if callee not in seen and callee in self.nodes:
                        seen[callee] = self.nodes[callee]
                        nxt.append(callee)
            frontier = nxt
        return list(seen.values())


def _module_rel(dotted: str, by_rel: dict) -> str | None:
    path = dotted.replace(".", "/")
    for rel in (f"{path}.py", f"{path}/__init__.py"):
        if rel in by_rel:
            return rel
    return None


def _imports(mod, by_rel: dict, package: str) -> dict:
    """A module's imports of the tree: alias -> module rel (``import
    pkg.a as z``, ``from pkg import a``), or alias -> (module rel, name)
    for an imported function (``from .a import f``)."""
    here = mod.rel.split("/")[:-1]
    out: dict = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if parts[0] != package or not a.asname:
                    continue
                rel = _module_rel(".".join(parts[1:]), by_rel)
                if rel:
                    out[a.asname] = rel
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = here[:len(here) - node.level + 1]
                parts = base + (node.module.split(".") if node.module
                                else [])
            elif node.module and node.module.split(".")[0] == package:
                parts = node.module.split(".")[1:]
            else:
                continue
            for a in node.names:
                alias = a.asname or a.name
                sub = _module_rel(".".join(parts + [a.name]), by_rel)
                if sub:
                    out[alias] = sub
                    continue
                owner = _module_rel(".".join(parts), by_rel) if parts \
                    else None
                if owner:
                    out[alias] = (owner, a.name)
    return out
