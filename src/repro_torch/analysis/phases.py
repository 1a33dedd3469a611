"""Pass ``phase``: async event-loop race checker.

Port of ``repro/analysis/phases.py``; the port's window is
``ServeEngine._overlap_host_work`` (``repro_torch/serve/engine.py``).

DESIGN.md §9's correctness argument for the async engine is phase
discipline: while a decode step is in flight (the *overlap window*,
everything ``_step_async`` runs before ``self._collect()``), the host
may do table refresh, chunked prefill ingest, and readahead staging —
but must not rebind decode slots or mutate page tables the in-flight
step could be reading.  All slot mutation is *post-collect*.

This pass derives the two phases structurally from ``_step_async``'s
body (no annotation needed — the code is the spec): calls textually
before the ``self._collect()`` statement are overlap-window roots,
calls after it are post-collect.  It then walks the class-local call
graph from the overlap roots and flags:

* ``overlap-slot-write``   — assignment to per-slot binding state
  (``self.active[...]``, ``self.positions``, ``self.last_tokens``,
  ``self._slot_steps``) reachable from the overlap window;
* ``overlap-pool-mutation`` — calls into the page-pool / page-table
  mutating API (the ``PAGE_TRANSITIONS`` edges plus the cache-level
  mutators) reachable from the overlap window;
* ``collect-order``        — ``_step_async`` retires/admits/dispatches
  before collecting (the phases only exist if collect splits them).

Every legitimate overlap-window mutation (staging a *parked* request's
pages, failing a request that holds no slot) carries an
``# apack: allow-phase(<reason>)`` — the reason is the safety argument."""

from __future__ import annotations

import ast

from .framework import (FunctionInfo, Reporter, SourceTree, attr_chain,
                        call_name)

PASS_ID = "phase"

LOOP_METHOD = "_step_async"
COLLECT = "_collect"
# per-slot binding state: writes rebind what the in-flight step decodes
SLOT_ATTRS = {"active", "positions", "last_tokens", "_slot_steps"}
# page-pool / page-table mutators (pool lifecycle edges + cache-level
# wrappers that rewrite page tables the dispatched step may read)
POOL_MUTATORS = {"alloc", "free", "evict", "seal", "pack", "repack",
                 "spill", "adopt", "write_token", "note_device_write",
                 "spill_request", "unspill_request", "release",
                 "add_request", "ingest_prefill_chunk", "finish_prefill",
                 "ingest_prefill", "append_token", "repack_pending",
                 "refresh_step", "restore_state", "write_state_slot",
                 # the port's own: the re-pack launch, the on-device
                 # append's claims and notes, the deferred seals
                 "launch_repack", "claim_append_targets",
                 "claim_append_targets_sharded", "note_appended", "_seal"}
# methods that must only run post-collect
POST_COLLECT = {"_retire", "_admit", "_admit_async", "_dispatch",
                "_check_deadlines"}


def _find_loop(tree: SourceTree) -> FunctionInfo | None:
    for fi in tree.functions:
        if fi.name == LOOP_METHOD and fi.cls:
            return fi
    return None


def _stmt_calls(stmt: ast.stmt) -> list[str]:
    out = []
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call):
            n = call_name(node)
            if n:
                out.append(n)
    return out


def run(tree: SourceTree, reporter: Reporter) -> None:
    loop = _find_loop(tree)
    if loop is None:
        return                      # no async engine in this tree
    mod = loop.module

    # ---- split the loop body at the _collect() statement
    overlap_roots: list[str] = []
    post_names: list[tuple[str, int]] = []
    seen_collect = False
    for stmt in loop.node.body:
        calls = _stmt_calls(stmt)
        if COLLECT in calls:
            seen_collect = True
            continue
        for n in calls:
            if not seen_collect:
                overlap_roots.append(n)
            else:
                post_names.append((n, stmt.lineno))
    if not seen_collect:
        reporter.emit(PASS_ID, "collect-order", mod, loop.node.lineno,
                      f"{LOOP_METHOD} never calls {COLLECT}(): the "
                      "overlap/post-collect phase split does not exist",
                      fn=loop)
        return
    del post_names                  # post-collect calls are unrestricted
    # retire/admit/dispatch sneaking into the overlap window is the
    # inverse ordering bug
    for stmt in loop.node.body:
        calls = _stmt_calls(stmt)
        if COLLECT in calls:
            break
        for n in calls:
            if n in POST_COLLECT:
                reporter.emit(PASS_ID, "collect-order", mod, stmt.lineno,
                              f"{n}() runs in the overlap window (before "
                              f"{COLLECT}); slot rebinding must be "
                              "post-collect", fn=loop)

    # ---- class-local reachability from the overlap roots
    cls = loop.cls
    methods = {f.name: f for f in tree.functions
               if f.cls == cls and f.module is mod}
    frontier = [n for n in overlap_roots if n in methods]
    reach: dict[str, FunctionInfo] = {}
    while frontier:
        name = frontier.pop()
        if name in reach:
            continue
        reach[name] = methods[name]
        for node in ast.walk(methods[name].node):
            if isinstance(node, ast.Call):
                n = call_name(node)
                if n in methods and n not in reach:
                    frontier.append(n)

    for name, fi in sorted(reach.items()):
        # ``kv = self.kv``: calls through the alias are the attribute's
        aliases = {}
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                c = attr_chain(node.value)
                if c and c[0] == "self" and len(c) > 1:
                    aliases[node.targets[0].id] = c
        for node in ast.walk(fi.node):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    chain = attr_chain(base)
                    if chain and chain[0] == "self" and \
                            chain[-1] in SLOT_ATTRS:
                        reporter.emit(
                            PASS_ID, "overlap-slot-write", mod, node.lineno,
                            f"write to self.{'.'.join(chain[1:])} is "
                            "reachable from the overlap window (via "
                            f"{fi.qualname}); slot bindings may only "
                            "change post-collect", fn=fi)
            elif isinstance(node, ast.Call):
                n = call_name(node)
                chain = attr_chain(node.func)
                if chain and chain[0] in aliases:
                    chain = aliases[chain[0]] + chain[1:]
                # only flag mutator calls leaving the engine (self.kv.*,
                # self.kv.pool.*, ...) — engine-local helpers are walked
                if n in POOL_MUTATORS and chain and chain[0] == "self" \
                        and len(chain) > 2:
                    reporter.emit(
                        PASS_ID, "overlap-pool-mutation", mod, node.lineno,
                        f"{'.'.join(chain)}() mutates page tables from "
                        f"the overlap window (via {fi.qualname}); the "
                        "in-flight step may be reading them", fn=fi)
