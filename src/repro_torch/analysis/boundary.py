"""Pass ``boundary``: host-sync constructs reachable from hot-path roots.

Port of ``repro/analysis/boundary.py``.  The invariant: the steady-state
decode step makes one sanctioned pull (its token ids) and never otherwise
waits for the card mid-step; a CUDA graph of the step (ROADMAP §2 item 1)
breaks on any such wait.  From every function annotated ``# apack:
hot-path-root`` (host roots like ``ServeEngine.step``) or ``# apack:
hot-path-root(traced)`` (step functions whose tensor parameters live on
the card, like ``decode_step_paged``), the pass walks the call graph and
flags:

* ``item-call``        — ``.item()`` of a device tensor;
* ``host-materialize`` — ``.cpu()`` of anything not known to be on the
  host, ``.numpy()`` / ``.tolist()`` of a device tensor, and
  ``np.asarray`` / ``np.array`` of one;
* ``scalar-coerce``    — ``int()`` / ``float()`` / ``bool()`` of a device
  tensor (each an implicit blocking copy);
* ``synchronize``      — ``torch.cuda.synchronize(...)`` and a stream's or
  event's ``.synchronize()``;
* ``device-get``       — ``.to("cpu")`` / ``.to(cpu_device)`` /
  ``.to(device="cpu")``;
* ``dynamic-shape``    — ops whose output size depends on the data, so
  the host waits to size it: ``nonzero``, ``argwhere``, ``masked_select``,
  ``unique``, ``unique_consecutive``, one-argument ``torch.where``,
  indexing by a boolean mask, and ``repeat_interleave`` with tensor
  repeats and no ``output_size``;
* ``pageable-upload``  — a copy to the card from pageable host memory
  (``torch.tensor(..., device=)``, ``.to(device)`` / ``.cuda()`` of a host
  tensor that is not pinned and sent ``non_blocking``, and a number
  stored through a device index, ``t[:, idx] = 0``, which ``index_put_``
  uploads as a tensor): the copy waits for the stream.

Taint is syntactic and flows between functions: calls rooted at
``torch`` (but not ``torch.cuda``, dtypes, devices or factories given no
device), ``.to()`` to a device, methods of a device value, calls of a
tree function whose return summary says it returns one (a kernel
wrapper, ``_build.launch``, always does), a parameter that some
reachable call site passes a device value (a traced root's tensor
parameters from the start), an attribute that reachable code binds to a
device value (``self.x`` per class, other objects' by name) and a list
that takes one.  ``.cpu()``, ``.numpy()``, ``.tolist()``, ``.item()``,
the number conversions and the accounted ``_fetch`` funnel launder taint
(the flag lands on their argument; their result is on the host).
``.shape``, ``.dtype``, ``.device`` and the size queries are host
metadata.  A step function that a factory returns into an attribute the
hot path calls (``self._step_mesh = build_sharded_step(...)``) is a
traced root, as the JAX package seeds its ``shard_map`` bodies.  Code on
a CPU tensor's branch (``if x.device.type == "cpu":``, ``!= "cuda"``) is
where a kernel wrapper takes its plain version; it never runs on the
card's path, so the walk skips it, its calls included."""

from __future__ import annotations

import ast
import re

from .callgraph import CallGraph
from .framework import (FunctionInfo, Reporter, SourceTree, attr_chain,
                        call_name)

PASS_ID = "boundary"

# torch.<name>(...) calls that return host objects, not device tensors
_HOST_TORCH = {"device", "Size", "finfo", "iinfo", "is_tensor", "no_grad",
               "inference_mode", "enable_grad", "set_grad_enabled",
               "manual_seed", "get_default_dtype", "Generator", "dtype",
               "from_numpy", "is_floating_point", "is_grad_enabled",
               "promote_types", "result_type"}
# constructors and factories that make a CPU tensor unless given a device
_HOST_CTORS = {"tensor", "as_tensor", "zeros", "ones", "empty", "full",
               "arange", "linspace", "eye", "rand", "randn", "randint",
               "randperm"}
# those that copy data they are given (an upload when given a device)
_COPY_CTORS = {"tensor", "as_tensor"}
# modules whose functions compute on the host
_HOST_MODULES = {"np", "numpy", "math", "time", "zlib", "struct", "json"}
# terminal callee names whose result is on the host (taint laundering)
_UNTAINT_CALLS = {"_fetch", "int", "float", "bool", "len", "item", "tolist",
                  "numpy", "cpu", "asarray", "array", "isinstance", "str",
                  "repr", "id", "type", "hasattr", "getattr", "callable"}
# metadata attributes and size queries of a tensor: host values
_METADATA_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda",
                   "requires_grad", "nbytes", "itemsize", "layout", "T"}
_METADATA_CALLS = {"size", "dim", "numel", "element_size", "stride",
                   "data_ptr", "is_contiguous", "nelement", "get_device",
                   "is_pinned", "storage_offset"}
_DYNAMIC_OPS = {"nonzero", "argwhere", "masked_select", "unique",
                "unique_consecutive"}
_BOOL_OPS = {"bool", "isnan", "isinf", "isfinite", "logical_and",
             "logical_or", "logical_not", "logical_xor", "eq", "ne", "gt",
             "ge", "lt", "le", "isin"}
_DTYPE_NAME = re.compile(r"^(u?int\d+|b?float\d+|half|double|bool|"
                         r"complex\d+|[A-Z]{1,2}\d{1,2})$")


def run(tree: SourceTree, reporter: Reporter) -> None:
    cpu_nodes = {id(fi): _cpu_branch_nodes(fi.node) for fi in tree.functions}
    skip = set().union(*cpu_nodes.values()) if cpu_nodes else set()
    graph = CallGraph(tree, skip_calls=skip)
    host_roots = tree.roots("host")
    traced_roots = tree.roots("traced")
    reach = graph.reachable(host_roots + traced_roots)
    # step functions a factory built and the hot path calls through an
    # attribute (``self._step_mesh(...)``): traced roots, as the JAX
    # package seeds its ``shard_map`` bodies
    seeded = [f for f in _factory_steps(graph, reach)
              if f not in traced_roots]
    if seeded:
        traced_roots = traced_roots + seeded
        reach = graph.reachable(host_roots + traced_roots)
    ctx = _Context(graph, cpu_nodes, {})
    while True:
        # summaries, parameters and attributes feed each other: to a
        # fixpoint (each only grows)
        size = (len(ctx.attrs), len(ctx.host_attrs),
                sum(map(len, ctx.cls_attrs.values())))
        ctx.summary = _summaries(ctx, reach)
        params = _param_taint(ctx, reach, traced_roots)
        # the attributes the rest of the tree binds (constructors: the
        # pool's planes are bound in ``__init__``)
        seen = {id(f) for f in reach}
        for fi in tree.functions:
            if id(fi) not in seen:
                _FnChecker(fi, None, ctx).sweep()
        if size == (len(ctx.attrs), len(ctx.host_attrs),
                    sum(map(len, ctx.cls_attrs.values()))):
            break
    for fi in reach:
        _FnChecker(fi, reporter, ctx, params=params[id(fi)]).run()


class _Context:
    """What every function's check shares: the call graph (to resolve a
    call to the tree functions it may reach), the CPU branches, each
    reachable function's return summary ``(device, forwards)`` (whether
    it returns a device value with clean parameters, and with device
    parameters), and the attribute names that some reachable code binds
    to a device value (``self.x = <device>``, ``Cls(x=<device>)``): a
    read of such an attribute is a device value, whatever the object."""

    def __init__(self, graph: CallGraph, cpu_nodes: dict, summary: dict):
        self.graph, self.cpu_nodes, self.summary = graph, cpu_nodes, summary
        self.bodies: dict[int, list] = {}
        self.attrs: set[str] = set()                # bound to a device value
        self.host_attrs: set[str] = set()           # bound to a host value
        self.cls_attrs: dict[str, set[str]] = {}    # self.x in class C

    def add_attr(self, cls: str | None, attr: str, device: bool,
                 host: bool) -> None:
        if device:
            self.attrs.add(attr)
            if cls:
                self.cls_attrs.setdefault(cls, set()).add(attr)
        elif host:
            self.host_attrs.add(attr)

    def body(self, fi: FunctionInfo) -> list:
        """``fi``'s own nodes in walk order: not those of a nested def
        (checked as a function of its own), nor a CPU tensor's branch."""
        got = self.bodies.get(id(fi))
        if got is None:
            nested = {id(n) for d in ast.walk(fi.node) if d is not fi.node
                      and isinstance(d, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                      for n in ast.walk(d)}
            cpu = self.cpu_nodes[id(fi)]
            got = [n for n in ast.walk(fi.node)
                   if id(n) not in cpu and id(n) not in nested]
            self.bodies[id(fi)] = got
        return got

    def attr_taints(self, cls: str | None, attr: str) -> bool:
        """``self.attr`` of class ``cls`` (``cls`` given) is a device
        value where that class binds it to one; any other object's
        ``attr`` where some code binds that name to a device value and
        none to a host value."""
        if cls is not None:
            return attr in self.cls_attrs.get(cls, ())
        return attr in self.attrs and attr not in self.host_attrs


def _tensor_params(fi: FunctionInfo) -> set[str]:
    a = fi.node.args
    out = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
           if not _static_annotation(p) and p.arg not in ("self", "cls")}
    for v in (a.vararg, a.kwarg):
        if v is not None:
            out.add(v.arg)
    return out


def _summaries(ctx: _Context, reach: list) -> dict:
    """Return summaries of the reachable functions, to a fixpoint (they
    only grow): a kernel wrapper (``_build.launch``) returns a device
    value."""
    summary = {id(fi): ctx.summary.get(id(fi), (False, False))
               for fi in reach}
    for fi in reach:
        if any(isinstance(n, ast.Call) and _is_build_launch(n)
               for n in ast.walk(fi.node)):
            summary[id(fi)] = (True, True)
    ctx.summary = summary
    for _ in range(6):
        changed = False
        for fi in reach:
            old = summary[id(fi)]
            if old == (True, True):
                continue
            new = (old[0] or _returns_device(fi, ctx, set()),
                   old[1] or _returns_device(fi, ctx, _tensor_params(fi)))
            if new != old:
                summary[id(fi)] = new
                changed = True
        if not changed:
            break
    return summary


def _returns_device(fi: FunctionInfo, ctx: "_Context", params: set) -> bool:
    chk = _FnChecker(fi, None, ctx, params=params)
    chk.sweep()
    return any(chk.taints(r.value) for r in chk._body()
               if isinstance(r, ast.Return) and r.value is not None)


def _factory_steps(graph: CallGraph, reach: list) -> list[FunctionInfo]:
    """Nested defs that a factory returns into ``self.<attr>``, for each
    ``self.<attr>(...)`` call of a reachable method whose class defines
    no such method (``self._step_mesh = M.build_sharded_step(...)``)."""
    tree = graph.tree
    methods = {(id(f.module), f.cls, f.name) for f in tree.functions
               if f.cls}
    called = set()
    for fi in reach:
        for n in ast.walk(fi.node):
            if isinstance(n, ast.Call) and fi.cls:
                chain = attr_chain(n.func)
                if chain and len(chain) == 2 and chain[0] == "self" and \
                        (id(fi.module), fi.cls, chain[1]) not in methods:
                    called.add((id(fi.module), fi.cls, chain[1]))
    out: list[FunctionInfo] = []
    for fi in tree.functions:
        if not fi.cls:
            continue
        for n in ast.walk(fi.node):
            if not (isinstance(n, ast.Assign) and isinstance(n.value,
                                                            ast.Call)):
                continue
            for t in n.targets:
                chain = attr_chain(t)
                if not (chain and len(chain) == 2 and chain[0] == "self"
                        and (id(fi.module), fi.cls, chain[1]) in called):
                    continue
                for fac in graph.resolve_call(n.value, fi):
                    for r in ast.walk(fac.node):
                        if isinstance(r, ast.Return) and isinstance(
                                r.value, ast.Name):
                            got = graph.by_qual.get(
                                (id(fac.module),
                                 f"{fac.qualname}.{r.value.id}"))
                            if got is not None and got not in out:
                                out.append(got)
    return out


def _param_taint(ctx: "_Context", reach: list, traced_roots: list) -> dict:
    """Which parameters of each reachable function hold device tensors: a
    traced root's tensor parameters, and every parameter that a reachable
    call site passes a device value (positionally or by keyword; a method
    called through an attribute skips ``self``), to a fixpoint."""
    params = {id(fi): set() for fi in reach}
    for fi in traced_roots:
        params[id(fi)] = _tensor_params(fi)
    changed = True
    while changed:
        changed = False
        for fi in reach:
            chk = _FnChecker(fi, None, ctx, params=params[id(fi)])
            chk.sweep()
            for call in chk._body():
                if not isinstance(call, ast.Call):
                    continue
                name = call_name(call) or ""
                if name[:1].isupper():          # a class's constructor
                    for kw in call.keywords:
                        if kw.arg:
                            ctx.add_attr(name, kw.arg, chk.taints(kw.value),
                                         chk._host_like(kw.value))
                hot_pos = [i for i, x in enumerate(call.args)
                           if not isinstance(x, ast.Starred)
                           and chk.taints(x)]
                hot_kw = {kw.arg for kw in call.keywords
                          if kw.arg and chk.taints(kw.value)}
                if not hot_pos and not hot_kw:
                    continue
                for cand in ctx.graph.resolve_call(call, fi):
                    got = params.get(id(cand))
                    if got is None:
                        continue
                    a = cand.node.args
                    names = [p.arg for p in a.posonlyargs + a.args]
                    if names and names[0] in ("self", "cls") and \
                            isinstance(call.func, ast.Attribute):
                        names = names[1:]
                    new = {names[i] for i in hot_pos if i < len(names)}
                    new |= hot_kw & {p.arg for p in a.args + a.kwonlyargs}
                    new -= {"self", "cls"}
                    if not new <= got:
                        got |= new
                        changed = True
    return params


# ------------------------------------------------------------ structure
def _cpu_test(test: ast.AST) -> str | None:
    """'body' or 'orelse': the side of ``if <test>`` that runs for CPU
    tensors (``x.device.type == "cpu"``, ``dev.type != "cuda"``,
    ``not x.is_cuda``), else None."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        chain = attr_chain(test.operand)
        return "body" if chain and chain[-1] == "is_cuda" else None
    chain = attr_chain(test)
    if chain and chain[-1] == "is_cuda":
        return "orelse"
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    lhs, rhs = test.left, test.comparators[0]
    if isinstance(lhs, ast.Constant):
        lhs, rhs = rhs, lhs
    chain = attr_chain(lhs)
    if not (chain and chain[-1] == "type" and isinstance(rhs, ast.Constant)
            and rhs.value in ("cpu", "cuda")):
        return None
    eq = isinstance(test.ops[0], ast.Eq)
    if not eq and not isinstance(test.ops[0], ast.NotEq):
        return None
    return "body" if eq == (rhs.value == "cpu") else "orelse"


def _cpu_branch_nodes(fn: ast.AST) -> set[int]:
    """Ids of every node on a CPU tensor's branch inside ``fn``."""
    out: set[int] = set()
    for node in ast.walk(fn):
        side = _cpu_test(node.test) if isinstance(node, ast.If) else None
        if side is None:
            continue
        for stmt in getattr(node, side):
            out.update(id(n) for n in ast.walk(stmt))
    return out


def _is_build_launch(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    return bool(chain) and chain[-1] == "launch" and len(chain) == 2 \
        and chain[0] == "_build"


def _static_annotation(p: ast.arg) -> bool:
    """Config/scalar-annotated params (``cfg: ModelConfig``, ``bits:
    int``) are host values, not device tensors."""
    ann = p.annotation
    name = None
    if isinstance(ann, ast.Name):
        name = ann.id
    elif isinstance(ann, ast.Attribute):
        name = ann.attr
    elif isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        name = ann.value.split(".")[-1]
    if name is None:
        return False
    return name in ("int", "float", "bool", "str") \
        or name.endswith("Config")


def _is_cpu_target(e: ast.AST) -> bool:
    if isinstance(e, ast.Constant) and isinstance(e.value, str):
        return e.value.split(":")[0] == "cpu"
    if isinstance(e, ast.Call) and call_name(e) == "device" and e.args:
        return _is_cpu_target(e.args[0])
    chain = attr_chain(e)
    return bool(chain) and "cpu" in chain[-1].lower()


def _is_dtype(e: ast.AST) -> bool:
    chain = attr_chain(e)
    return bool(chain) and bool(_DTYPE_NAME.match(chain[-1]))


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _to_target(call: ast.Call) -> ast.AST | None:
    """The device a ``.to(...)`` call moves to (None: a dtype cast)."""
    dev = _kw(call, "device")
    if dev is not None:
        return dev
    for a in call.args:
        if not _is_dtype(a) and not isinstance(a, ast.Starred):
            return a
    return None


class _FnChecker:
    def __init__(self, fi: FunctionInfo, reporter: Reporter | None,
                 ctx: _Context, params: set[str] = frozenset()):
        self.fi = fi
        self.reporter = reporter
        self.ctx = ctx
        self.tainted: set[str] = set()
        self.host: set[str] = set()        # known host tensors / arrays
        self.pinned: set[str] = set()      # host tensors in pinned memory
        self.bools: set[str] = set()       # device tensors of dtype bool
        self.tainted |= set(params)

    # -------------------------------------------------------------- taint
    def taints(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in _METADATA_ATTRS:
                return False
            if isinstance(e.value, ast.Name) and e.value.id == "self" \
                    and self.fi.cls:
                return self.ctx.attr_taints(self.fi.cls, e.attr)
            return self.ctx.attr_taints(None, e.attr) or self.taints(e.value)
        if isinstance(e, ast.Subscript):
            return self.taints(e.value)
        if isinstance(e, ast.Call):
            return self._call_taints(e)
        if isinstance(e, ast.BinOp):
            return self.taints(e.left) or self.taints(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.taints(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.taints(v) for v in e.values)
        if isinstance(e, ast.Compare):
            return self.taints(e.left) or \
                any(self.taints(c) for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return self.taints(e.body) or self.taints(e.orelse)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.taints(x) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(self.taints(v) for v in e.values)
        if isinstance(e, ast.Starred):
            return self.taints(e.value)
        if isinstance(e, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            return self.taints(e.elt) or any(self.taints(g.iter)
                                             for g in e.generators)
        if isinstance(e, ast.DictComp):
            return self.taints(e.value)
        return False

    def _call_taints(self, e: ast.Call) -> bool:
        name = call_name(e)
        chain = attr_chain(e.func)
        if chain and chain[0] in _HOST_MODULES:
            return False
        if chain and chain[0] == "torch":
            if len(chain) > 2 and chain[1] == "cuda":
                return False
            if name in _HOST_TORCH:
                return False
            if name in _HOST_CTORS:
                dev = _kw(e, "device")
                return dev is not None and not _is_cpu_target(dev)
            return True
        if name in _UNTAINT_CALLS or name in _METADATA_CALLS:
            return False
        if isinstance(e.func, ast.Attribute) and name in ("to", "cuda"):
            if name == "cuda":
                return True
            tgt = _to_target(e)
            if tgt is None:
                return self.taints(e.func.value)
            return not _is_cpu_target(tgt)
        # a method of a device value returns one
        if isinstance(e.func, ast.Attribute) and self.taints(e.func.value):
            return True
        hot = any(self.taints(a) for a in e.args) or \
            any(self.taints(kw.value) for kw in e.keywords)
        cands = self.ctx.graph.resolve_call(e, self.fi)
        known = [self.ctx.summary[id(c)] for c in cands
                 if id(c) in self.ctx.summary]
        if not known:
            # a library call forwards its arguments' taint
            return hot
        return any(dev or (hot and fwd) for dev, fwd in known)

    def _is_host(self, e: ast.AST) -> bool:
        """A value known to be on the host: numpy, ``from_numpy``, a
        device-less ``torch.tensor``, a pull's result."""
        if isinstance(e, ast.Name):
            return e.id in self.host
        chain = attr_chain(e.func) if isinstance(e, ast.Call) else None
        if isinstance(e, ast.Call):
            name = call_name(e)
            if chain and chain[0] in ("np", "numpy"):
                return True
            if chain and chain[0] == "torch":
                if name == "from_numpy":
                    return True
                if name in _HOST_CTORS:
                    dev = _kw(e, "device")
                    return dev is None or _is_cpu_target(dev)
                return False
            if name in ("cpu", "numpy", "_fetch", "pin_memory",
                        "contiguous", "reshape", "view", "flatten"):
                if name in ("cpu", "numpy", "_fetch"):
                    return True
                return isinstance(e.func, ast.Attribute) and \
                    self._is_host(e.func.value)
            if name == "to" and isinstance(e.func, ast.Attribute):
                tgt = _to_target(e)
                return (tgt is not None and _is_cpu_target(tgt)) or (
                    tgt is None and self._is_host(e.func.value))
            return False
        if isinstance(e, ast.Subscript):
            return self._is_host(e.value)
        return False

    def _is_pinned(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.pinned
        if isinstance(e, ast.Call) and call_name(e) == "pin_memory":
            return True
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
                and call_name(e) in ("contiguous", "reshape", "view"):
            return self._is_pinned(e.func.value)
        return False

    def _boolean(self, e: ast.AST) -> bool:
        """A device value of dtype bool (syntactically)."""
        if isinstance(e, ast.Compare):
            return self.taints(e)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self._boolean(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd,
                                                          ast.BitOr)):
            return self._boolean(e.left) or self._boolean(e.right)
        if isinstance(e, ast.Call) and call_name(e) in _BOOL_OPS:
            return self.taints(e)
        if isinstance(e, ast.Name):
            return e.id in self.bools
        return False

    def _mark(self, target: ast.AST, tainted: bool, host: bool = False,
              pinned: bool = False, boolean: bool = False) -> None:
        if isinstance(target, ast.Name):
            for s, on in ((self.tainted, tainted), (self.host, host),
                          (self.pinned, pinned), (self.bools, boolean)):
                (s.add if on else s.discard)(target.id)
        elif isinstance(target, ast.Attribute):
            if self.reporter is None:
                own = isinstance(target.value, ast.Name) and \
                    target.value.id == "self"
                self.ctx.add_attr(self.fi.cls if own else None, target.attr,
                                  tainted, host)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self._mark(t, tainted, host, pinned, boolean)
        elif isinstance(target, ast.Starred):
            self._mark(target.value, tainted, host, pinned, boolean)

    def _host_like(self, e: ast.AST) -> bool:
        """A value known to be on the host, or a literal."""
        if isinstance(e, ast.Constant) and e.value is None:
            return False                  # a cleared slot, not a value
        return self._is_host(e) or (
            isinstance(e, (ast.Constant, ast.List, ast.Tuple, ast.Dict))
            and not self.taints(e))

    def _assign(self, target: ast.AST, value: ast.AST) -> None:
        host = self._host_like(value) if isinstance(target, ast.Attribute) \
            else self._is_host(value)
        self._mark(target, self.taints(value), host,
                   self._is_pinned(value), self._boolean(value))

    def _propagate(self, node: ast.AST) -> None:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                self._assign(tgt, node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self._assign(node.target, node.value)
        elif isinstance(node, ast.AugAssign):
            if self.taints(node.value):
                self._mark(node.target, True)
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute) \
                and node.func.attr in ("append", "extend", "insert") \
                and isinstance(node.func.value, ast.Name) \
                and any(self.taints(a) for a in node.args):
            # a list that takes a device value holds one
            self.tainted.add(node.func.value.id)
        elif isinstance(node, (ast.For, ast.comprehension)):
            self._mark(node.target, self.taints(node.iter))
        elif isinstance(node, ast.withitem) and node.optional_vars:
            self._assign(node.optional_vars, node.context_expr)

    # --------------------------------------------------------------- scan
    def _body(self) -> list:
        return self.ctx.body(self.fi)

    def sweep(self) -> None:
        body = self._body()
        # two passes: taint only grows, so a second sweep fixes ordering
        # artifacts from loops and forward references
        for node in body:
            self._propagate(node)
        for node in body:
            self._propagate(node)

    def run(self) -> None:
        self.sweep()
        for node in self._body():
            self._propagate(node)
            if isinstance(node, ast.Call):
                self._flag_call(node)
            elif isinstance(node, ast.Assign):
                self._flag_scalar_store(node)
            elif isinstance(node, ast.Subscript) and \
                    not isinstance(node.ctx, ast.Store) and \
                    self.taints(node.value) and self._boolean(node.slice):
                self._emit("dynamic-shape", node,
                           f"boolean-mask indexing of a device tensor on "
                           f"the {self._where()}: the host waits to size "
                           "the result")

    def _where(self) -> str:
        return "hot path"

    def _emit(self, code: str, node: ast.AST, msg: str) -> None:
        self.reporter.emit(PASS_ID, code, self.fi.module, node.lineno, msg,
                           fn=self.fi, end_line=getattr(node, "end_lineno",
                                                        node.lineno))

    def _flag_scalar_store(self, node: ast.Assign) -> None:
        """``t[..., idx] = <number>`` with ``idx`` a device tensor: the
        number is wrapped in a host tensor and copied to the card
        (``index_put_``), a pageable copy that waits for the stream;
        ``index_fill_`` takes it as an argument instead."""
        value = node.value
        if isinstance(value, ast.UnaryOp):
            value = value.operand
        if not (isinstance(value, ast.Constant)
                and isinstance(value.value, (int, float, bool))):
            return
        for t in node.targets:
            if not (isinstance(t, ast.Subscript) and self.taints(t.value)):
                continue
            parts = t.slice.elts if isinstance(t.slice, ast.Tuple) \
                else [t.slice]
            if any(not isinstance(p, ast.Slice) and self.taints(p)
                   for p in parts):
                self._emit("pageable-upload", node,
                           f"a number stored through a device index on the "
                           f"{self._where()}: index_put_ uploads it from "
                           "pageable memory and waits for the stream "
                           "(index_fill_ does not)")

    def _flag_call(self, call: ast.Call) -> None:
        name = call_name(call)
        chain = attr_chain(call.func)
        recv = call.func.value if isinstance(call.func, ast.Attribute) \
            else None
        where = self._where()
        if name == "synchronize" and (recv is not None):
            self._emit("synchronize", call,
                       f"{'.'.join(chain) if chain else '.synchronize'}() on "
                       f"the {where}: the host waits for the card")
            return
        if recv is not None and name == "cpu" and not call.args \
                and not self._is_host(recv):
            self._emit("host-materialize", call,
                       f".cpu() on the {where}: blocking device-to-host "
                       "copy")
            return
        if recv is not None and name == "to":
            tgt = _to_target(call)
            if tgt is not None and _is_cpu_target(tgt):
                if not self._is_host(recv):
                    self._emit("device-get", call,
                               f".to(cpu) on the {where}: blocking "
                               "device-to-host copy")
                return
            if tgt is not None and self._is_host(recv) and not (
                    self._is_pinned(recv) and _nonblocking(call)):
                self._emit("pageable-upload", call,
                           f".to(device) of a host tensor on the {where} "
                           "not from pinned memory with non_blocking: the "
                           "copy waits for the stream")
            return
        if recv is not None and name == "cuda" and self._is_host(recv):
            self._emit("pageable-upload", call,
                       f".cuda() of a host tensor on the {where}: the copy "
                       "waits for the stream")
            return
        if chain and chain[0] == "torch" and name in _COPY_CTORS:
            dev = _kw(call, "device")
            if dev is not None and not _is_cpu_target(dev) and call.args \
                    and not self.taints(call.args[0]):
                self._emit("pageable-upload", call,
                           f"torch.{name}(..., device=) of host data on the "
                           f"{where}: a pageable copy that waits for the "
                           "stream")
            return
        if recv is not None and name in ("numpy", "tolist") \
                and self.taints(recv):
            self._emit("host-materialize", call,
                       f".{name}() of a device tensor on the {where}: "
                       "blocking device-to-host copy")
            return
        if chain and chain[0] in ("np", "numpy") and name in ("asarray",
                                                            "array"):
            args = list(call.args) + [kw.value for kw in call.keywords]
            if any(self.taints(a) for a in args):
                self._emit("host-materialize", call,
                           f"np.{name} of a device tensor on the {where}: "
                           "blocking device-to-host copy")
            return
        if isinstance(call.func, ast.Name) and name in ("int", "float",
                                                        "bool"):
            if call.args and self.taints(call.args[0]):
                self._emit("scalar-coerce", call,
                           f"{name}() of a device tensor on the {where}: "
                           "implicit blocking sync")
            return
        if recv is not None and name == "item" and not call.args:
            if self.taints(recv):
                self._emit("item-call", call,
                           f".item() of a device tensor on the {where}: "
                           "implicit blocking sync")
            return
        if name in _DYNAMIC_OPS or (name == "where" and len(call.args) == 1):
            torch_form = bool(chain) and chain[0] == "torch"
            if (torch_form and call.args and self.taints(call.args[0])) or \
                    (not torch_form and recv is not None
                     and self.taints(recv)):
                self._emit("dynamic-shape", call,
                           f"{name}() of a device tensor on the {where}: "
                           "the host waits to size the result")
            return
        if name == "repeat_interleave" and _kw(call, "output_size") is None:
            torch_form = bool(chain) and chain[0] == "torch"
            reps = (call.args[1] if torch_form and len(call.args) > 1 else
                    call.args[0] if not torch_form and call.args else
                    _kw(call, "repeats"))
            if reps is not None and self.taints(reps):
                self._emit("dynamic-shape", call,
                           f"repeat_interleave with tensor repeats and no "
                           f"output_size on the {where}: the host waits to "
                           "size the result")


def _nonblocking(call: ast.Call) -> bool:
    v = _kw(call, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True
