"""Pass ``lifecycle``: page state-machine conformance.

Port of ``repro/analysis/lifecycle.py``, run against the port's own
``PAGE_TRANSITIONS`` (``repro_torch/models/modules.py``).

The canonical transition table lives in ``models/modules.py`` as the
pure literal ``PAGE_TRANSITIONS`` (the same dict the runtime guard
``KVPagePool._require_transition`` enforces).  This pass parses that
literal out of the AST and verifies every ``<x>.state[pid] = PAGE_*``
assignment site in the tree:

* ``undeclared-edge``     — the enclosing method is not a declared edge
  and no dominating guard names one;
* ``unguarded-state-write`` — no dominating ``_require_transition`` call
  (or equivalent ``if state[pid] == PAGE_*: raise`` narrowing) precedes
  the write in the same branch;
* ``guard-dst-mismatch``  — the dominating guard validates a different
  destination state than the one assigned;
* ``undeclared-transition`` — the guard-narrowed (src, dst) pairs are
  not a subset of the declared pairs for that edge;
* ``non-symbolic-state``  — the assigned value is not a ``PAGE_*`` name
  (raw ints defeat both the table and the reader), unless it is the very
  variable the dominating guard validated as its destination
  (``_require_transition(pid, "adopt", st)`` then ``state[pid] = st``):
  the runtime guard then admits only the edge's declared pairs;
* ``table-malformed``     — the literal itself references unknown state
  names or is not a pure literal.

"Dominating" is syntactic: the nearest preceding ``_require_transition``
expression-statement in the same statement list, walking outward through
enclosing blocks.  Raise-guard narrowing (``if self.state[pid] ==
PAGE_X: raise``) is honored for hand-rolled guards in fixtures and
third-party pools."""

from __future__ import annotations

import ast

from .framework import Reporter, SourceTree, attr_chain, call_name

PASS_ID = "lifecycle"
TABLE_NAME = "PAGE_TRANSITIONS"
STATE_PREFIX = "PAGE_"


def _load_table(tree: SourceTree, reporter: Reporter):
    """Find the PAGE_TRANSITIONS literal; returns (module, {edge:
    {(src_name, dst_name), ...}}) with symbolic state names."""
    for mod in tree.modules:
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            if not any(isinstance(t, ast.Name) and t.id == TABLE_NAME
                       for t in node.targets):
                continue
            table = {}
            if not isinstance(node.value, ast.Dict):
                reporter.emit(PASS_ID, "table-malformed", mod, node.lineno,
                              f"{TABLE_NAME} must be a dict literal")
                return mod, {}
            for k, v in zip(node.value.keys, node.value.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    reporter.emit(PASS_ID, "table-malformed", mod, k.lineno,
                                  f"{TABLE_NAME} keys must be string edge "
                                  "names")
                    continue
                pairs = set()
                elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) else []
                for pair in elts:
                    names = [n.id for n in getattr(pair, "elts", [])
                             if isinstance(n, ast.Name)]
                    if len(names) != 2 or not all(
                            n.startswith(STATE_PREFIX) for n in names):
                        reporter.emit(
                            PASS_ID, "table-malformed", mod, pair.lineno,
                            f"{TABLE_NAME}[{k.value!r}] entries must be "
                            f"({STATE_PREFIX}*, {STATE_PREFIX}*) pairs")
                        continue
                    pairs.add((names[0], names[1]))
                table[k.value] = pairs
            return mod, table
    return None, {}


def _state_write(node: ast.AST):
    """Match ``<expr>.state[<pid>] = <value>``; returns (target, value)."""
    if not isinstance(node, ast.Assign) or len(node.targets) != 1:
        return None
    t = node.targets[0]
    if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Attribute) \
            and t.value.attr == "state":
        return t, node.value
    return None


def _guard_in(stmts: list, before_line: int, methods: dict | None = None,
              depth: int = 0):
    """Nearest ``_require_transition(...)`` expression-statement (or
    assignment from one) strictly before ``before_line`` in this list.
    The port validates a batch of pages before writing them all: a
    preceding ``for`` loop whose body guards each page counts, and so does
    a call of a same-class method (``self._check_seal(pids)``) whose body
    guards that way (one level deep)."""
    best = None
    for s in stmts:
        if s.lineno >= before_line:
            break
        call = None
        if isinstance(s, ast.Expr) and isinstance(s.value, ast.Call):
            call = s.value
        elif isinstance(s, ast.Assign) and isinstance(s.value, ast.Call):
            call = s.value
        if call is not None and call_name(call) == "_require_transition":
            best = call
            continue
        if isinstance(s, ast.For):
            g = _guard_in(s.body, float("inf"), methods, depth)
            if g is not None:
                best = g
        elif call is not None and methods and depth == 0:
            chain = attr_chain(call.func)
            if chain and len(chain) == 2 and chain[0] == "self" \
                    and chain[1] in methods:
                g = _guard_in(methods[chain[1]].body, float("inf"),
                              methods, depth + 1)
                if g is not None:
                    best = g
    return best


def _narrowed_sources(fn_node: ast.AST, site: ast.Assign,
                      universe: set[str]) -> set[str] | None:
    """Hand-rolled-guard fallback: walk the function linearly and apply
    ``if <state-expr> == PAGE_X: raise`` / ``!= PAGE_X: raise`` narrowing
    (including through ``st = <x>.state[pid]`` aliases).  Returns the
    possible source-state set at the write, or None if no narrowing
    happened (i.e. genuinely unguarded)."""
    aliases = {"state"}        # names aliasing a state read
    possible = set(universe)
    narrowed = False

    def is_state_read(e: ast.AST) -> bool:
        if isinstance(e, ast.Subscript):
            v = e.value
            return isinstance(v, ast.Attribute) and v.attr == "state"
        if isinstance(e, ast.Call):  # int(self.state[pid])
            return bool(e.args) and is_state_read(e.args[0])
        if isinstance(e, ast.Name):
            return e.id in aliases
        return False

    def state_const(e: ast.AST) -> str | None:
        if isinstance(e, ast.Name) and e.id.startswith(STATE_PREFIX):
            return e.id
        return None

    def scan(stmts: list) -> bool:
        nonlocal possible, narrowed
        for s in stmts:
            if s is site:
                return True
            if isinstance(s, ast.Assign) and is_state_read(s.value):
                for t in s.targets:
                    if isinstance(t, ast.Name):
                        aliases.add(t.id)
            if isinstance(s, ast.If):
                cmp = s.test
                raises = any(isinstance(b, ast.Raise) for b in s.body)
                if isinstance(cmp, ast.Compare) and len(cmp.ops) == 1 \
                        and raises:
                    lhs, rhs = cmp.left, cmp.comparators[0]
                    if is_state_read(rhs):
                        lhs, rhs = rhs, lhs
                    st = state_const(rhs)
                    if is_state_read(lhs) and st is not None:
                        if isinstance(cmp.ops[0], ast.Eq):
                            possible.discard(st)
                            narrowed = True
                        elif isinstance(cmp.ops[0], ast.NotEq):
                            possible &= {st}
                            narrowed = True
                # branch bodies may contain the site: src narrowing from
                # the branch condition itself (st == PAGE_X: ... write)
                if isinstance(cmp, ast.Compare) and len(cmp.ops) == 1 \
                        and isinstance(cmp.ops[0], ast.Eq):
                    lhs, rhs = cmp.left, cmp.comparators[0]
                    if is_state_read(rhs):
                        lhs, rhs = rhs, lhs
                    st = state_const(rhs)
                    if is_state_read(lhs) and st is not None:
                        saved = set(possible)
                        possible &= {st}
                        narrowed = True
                        if scan(s.body):
                            return True
                        possible = saved - {st}
                        if scan(s.orelse):
                            return True
                        continue
                if scan(s.body) or scan(s.orelse):
                    return True
            for attr in ("body", "orelse", "finalbody"):
                if not isinstance(s, ast.If) and hasattr(s, attr):
                    if scan(getattr(s, attr)):
                        return True
        return False

    found = scan(fn_node.body)
    if not found or not narrowed:
        return None
    return possible


def run(tree: SourceTree, reporter: Reporter) -> None:
    table_mod, table = _load_table(tree, reporter)
    if table_mod is None:
        return     # no pool in this tree (e.g. a fixture without one)
    universe = {f"{STATE_PREFIX}FREE", f"{STATE_PREFIX}HOT",
                f"{STATE_PREFIX}COLD", f"{STATE_PREFIX}PACKED"}
    declared = {e for pairs in table.values() for p in pairs for e in p}
    unknown = declared - universe - {f"{STATE_PREFIX}SPILLED"}
    for name in sorted(unknown):
        reporter.emit(PASS_ID, "table-malformed", table_mod, 0,
                      f"{TABLE_NAME} references unknown state {name}")

    classes: dict = {}
    for f in tree.functions:
        if f.cls:
            classes.setdefault((id(f.module), f.cls), {})[f.name] = f.node
    for fi in tree.functions:
        methods = classes.get((id(fi.module), fi.cls)) if fi.cls else None
        for stmt in ast.walk(fi.node):
            m = _state_write(stmt)
            if m is None:
                continue
            _target, value = m
            mod = fi.module

            dst = value.id if isinstance(value, ast.Name) \
                and value.id.startswith(STATE_PREFIX) else None
            guard = _find_dominating_guard(fi.node, stmt, methods)
            if dst is None and isinstance(value, ast.Name) \
                    and guard is not None and len(guard.args) >= 3 \
                    and isinstance(guard.args[2], ast.Name) \
                    and guard.args[2].id == value.id:
                edge = guard.args[1].value if isinstance(
                    guard.args[1], ast.Constant) else None
                if edge not in table:
                    reporter.emit(PASS_ID, "undeclared-edge", mod,
                                  stmt.lineno,
                                  f"guard names edge {edge!r} which is not "
                                  f"declared in {TABLE_NAME}", fn=fi)
                continue        # the guard validated exactly this value
            if dst is None:
                reporter.emit(PASS_ID, "non-symbolic-state", mod,
                              stmt.lineno,
                              "state write must assign a PAGE_* constant",
                              fn=fi)
                continue

            if guard is not None:
                edge = None
                if len(guard.args) >= 2 and isinstance(
                        guard.args[1], ast.Constant):
                    edge = guard.args[1].value
                gdst = guard.args[2].id if len(guard.args) >= 3 and \
                    isinstance(guard.args[2], ast.Name) else None
                if edge not in table:
                    reporter.emit(PASS_ID, "undeclared-edge", mod,
                                  stmt.lineno,
                                  f"guard names edge {edge!r} which is not "
                                  f"declared in {TABLE_NAME}", fn=fi)
                    continue
                if gdst != dst:
                    reporter.emit(PASS_ID, "guard-dst-mismatch", mod,
                                  stmt.lineno,
                                  f"guard validates {edge!r}->{gdst} but "
                                  f"the site assigns {dst}", fn=fi)
                    continue
                # the runtime guard admits exactly the declared (src, dst)
                # pairs ending at gdst; statically we only need the
                # assigned dst to be a declared destination of this edge
                if not any(d == dst for _, d in table[edge]):
                    reporter.emit(PASS_ID, "undeclared-transition", mod,
                                  stmt.lineno,
                                  f"edge {edge!r} declares destinations "
                                  f"{sorted({d for _, d in table[edge]})} "
                                  f"but the site assigns {dst}", fn=fi)
                continue

            # no _require_transition guard: accept a hand-rolled
            # raise-narrowed guard iff the narrowed transition set is
            # declared under the enclosing method's edge name
            edge = fi.name
            srcs = _narrowed_sources(fi.node, stmt, universe)
            if srcs is None:
                reporter.emit(PASS_ID, "unguarded-state-write", mod,
                              stmt.lineno,
                              f"state write to {dst} has no dominating "
                              "_require_transition or raise-guard", fn=fi)
                continue
            if edge not in table:
                reporter.emit(PASS_ID, "undeclared-edge", mod, stmt.lineno,
                              f"state write in {fi.qualname!r}: "
                              f"{edge!r} is not a declared edge in "
                              f"{TABLE_NAME}", fn=fi)
                continue
            extra = {(s, dst) for s in srcs} - table[edge]
            if extra:
                pretty = sorted(f"{s}->{d}" for s, d in extra)
                reporter.emit(PASS_ID, "undeclared-transition", mod,
                              stmt.lineno,
                              f"guard admits undeclared transition(s) "
                              f"{pretty} for edge {edge!r}", fn=fi)


def _find_dominating_guard(fn_node: ast.AST, site: ast.Assign,
                           methods: dict | None = None):
    """Nearest ``_require_transition`` call preceding ``site``, searching
    the innermost statement list containing the site first, then outward."""
    chains: list[list] = []

    def locate(stmts: list, stack: list) -> bool:
        for s in stmts:
            if s is site:
                chains.extend(stack + [stmts])
                return True
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(s, attr, None)
                if sub and locate(sub, stack + [stmts]):
                    return True
        return False

    locate(fn_node.body, [])
    for stmts in reversed(chains):
        g = _guard_in(stmts, site.lineno, methods)
        if g is not None:
            return g
    return None
