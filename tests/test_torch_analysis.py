"""Tests for the PyTorch port's hot-path invariant analyzer
(``repro_torch.analysis``), in the layers of ``tests/test_analysis.py``:

* per-pass fixtures — bad snippets in torch idiom give exactly the
  expected finding codes, good snippets are clean;
* parity — ``repro.analysis`` and ``repro_torch.analysis`` over one tree
  of plain Python (no jax, no torch) give the same roots, reachable
  functions, suppressions and framework findings;
* the live tree — ``src/repro_torch`` matches its committed (empty)
  baseline with every pass run and every suppression used;
* seeded violations — one per pass on a copy of ``src/repro_torch``, and
  the CLI's exit code on one of them;
* the pool's runtime transition guards against ``PAGE_TRANSITIONS``.
"""

import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

from repro_torch.analysis import run_passes                       # noqa: E402
from repro_torch.analysis.callgraph import CallGraph              # noqa: E402
from repro_torch.analysis.framework import Reporter, SourceTree   # noqa: E402
from repro_torch.analysis.runner import DEFAULT_ROOT, PASSES      # noqa: E402

BASELINE = DEFAULT_ROOT / "analysis" / "baseline.json"


def make_tree(tmp_path: Path, files: dict[str, str]) -> Path:
    root = tmp_path / "tree"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def run_pass(root: Path, pass_id: str) -> list:
    tree = SourceTree(root)
    rep = Reporter(tree)
    PASSES[pass_id](tree, rep)
    rep.check_suppression_keys()
    return rep.findings


def codes(findings) -> list[str]:
    return sorted(f.code for f in findings)


# ---------------------------------------------------------------- boundary
BOUNDARY_BAD = """
    import numpy as np
    import torch

    # apack: hot-path-root
    def step(pool):
        logits = torch.softmax(pool, -1)
        toks = logits.argmax(-1).cpu()        # host-materialize
        n = int(torch.sum(pool))              # scalar-coerce
        torch.cuda.synchronize()              # synchronize
        v = logits.max().item()               # item-call
        w = logits.to("cpu")                  # device-get
        a = np.asarray(logits)                # host-materialize
        ids = torch.nonzero(logits > 0)       # dynamic-shape
        sel = logits[logits > 0.5]            # dynamic-shape
        up = torch.tensor([1, 2], device=pool.device)   # pageable-upload
        return helper(toks, n, v, w, a, ids, sel, up)

    def helper(toks, n, v, w, a, ids, sel, up):
        y = torch.exp(ids)
        host = torch.from_numpy(np.zeros(3)).to(y.device)   # pageable-upload
        return float(y.sum()), host           # scalar-coerce (reachable)
"""

BOUNDARY_GOOD = """
    import numpy as np
    import torch

    # apack: hot-path-root
    def step(pool, meta):
        arr = np.asarray(meta)                # host value: fine
        n = int(arr.sum())                    # host numpy: fine
        dev = pool.argmax(-1)
        shape = dev.shape                     # metadata: not a device value
        k = int(shape[0])                     # static: fine
        up = to_device(arr, pool.device)      # pinned, non-blocking upload
        # apack: allow-transfer(the step's one sanctioned token pull)
        toks = dev.cpu().numpy()
        return toks, n, k, wrapper(pool), up

    def to_device(arr, device):
        host = torch.from_numpy(arr).pin_memory()
        return host.to(device, non_blocking=True)

    def wrapper(x):
        if x.device.type == "cpu":
            return plain(x)                   # a CPU tensor's branch
        return x * 2

    def plain(x):
        return torch.tensor(x.tolist()).item()

    def unreachable(pool):
        return pool.cpu()                     # not reachable from a root
"""


class TestBoundaryPass:
    def test_bad_fixture_exact_findings(self, tmp_path):
        root = make_tree(tmp_path, {"m.py": BOUNDARY_BAD})
        assert codes(run_pass(root, "boundary")) == [
            "device-get", "dynamic-shape", "dynamic-shape",
            "host-materialize", "host-materialize", "item-call",
            "pageable-upload", "pageable-upload", "scalar-coerce",
            "scalar-coerce", "synchronize"]

    def test_good_fixture_clean(self, tmp_path):
        root = make_tree(tmp_path, {"m.py": BOUNDARY_GOOD})
        assert run_pass(root, "boundary") == []

    def test_traced_root_taints_tensor_params(self, tmp_path):
        root = make_tree(tmp_path, {"m.py": """
            # apack: hot-path-root(traced)
            def decode_step(q, cfg: ModelConfig, bits: int):
                a = q.tolist()                # param is a device tensor
                b = float(cfg.softcap)        # config annotation: static
                c = bits * 2                  # static arg: fine
                return a, b, c
        """})
        assert codes(run_pass(root, "boundary")) == ["host-materialize"]

    def test_device_values_flow_through_calls_and_attributes(self, tmp_path):
        # a callee's parameter takes the caller's device tensor, and an
        # attribute bound to a device value stays one when read back
        root = make_tree(tmp_path, {"m.py": """
            import torch

            class Pending:
                def __init__(self, logits):
                    self.logits = logits

            # apack: hot-path-root
            def step(x):
                y = torch.relu(x)
                p = Pending(logits=y)
                return pull(y) + int(p.logits.argmax())   # scalar-coerce

            def pull(t):
                return t.item()                           # item-call
        """})
        assert codes(run_pass(root, "boundary")) == ["item-call",
                                                     "scalar-coerce"]

    def test_repeat_interleave_needs_output_size(self, tmp_path):
        root = make_tree(tmp_path, {"m.py": """
            import torch

            # apack: hot-path-root
            def step(x):
                r = torch.ones_like(x)
                a = x.repeat_interleave(r)                      # flagged
                b = x.repeat_interleave(r, output_size=8)       # fine
                c = x.repeat_interleave(2)                      # fine
                return a, b, c
        """})
        assert codes(run_pass(root, "boundary")) == ["dynamic-shape"]

    def test_factory_built_step_is_seeded(self, tmp_path):
        # a step function a factory returns into an attribute that the
        # hot path calls (the mesh step) is a root with device params
        root = make_tree(tmp_path, {"m.py": """
            def build_step():
                def step(planes):
                    return planes.sum().item()        # item-call
                return step

            class Engine:
                def __init__(self):
                    self._step = build_step()

                # apack: hot-path-root
                def run(self):
                    return self._step(None)
        """})
        assert codes(run_pass(root, "boundary")) == ["item-call"]

    def test_suppression_without_reason_is_a_finding(self, tmp_path):
        root = make_tree(tmp_path, {"m.py": """
            import torch

            # apack: hot-path-root
            def step(x):
                # apack: allow-transfer()
                return torch.relu(x).cpu()
        """})
        assert codes(run_pass(root, "boundary")) == ["missing-reason"]


# --------------------------------------------------------------- lifecycle
POOL_HEADER = """
    PAGE_FREE, PAGE_HOT, PAGE_COLD, PAGE_PACKED = 0, 1, 2, 3
    PAGE_TRANSITIONS = {
        "alloc": ((PAGE_FREE, PAGE_HOT),),
        "free":  ((PAGE_HOT, PAGE_FREE), (PAGE_COLD, PAGE_FREE)),
        "seal":  ((PAGE_HOT, PAGE_COLD),),
        "pack":  ((PAGE_COLD, PAGE_PACKED),),
        "adopt": ((PAGE_HOT, PAGE_COLD), (PAGE_HOT, PAGE_PACKED)),
    }
"""


def pool_src(body: str) -> str:
    """Append a class body to POOL_HEADER at its 4-space base indent."""
    return POOL_HEADER + textwrap.indent(textwrap.dedent(body), "    ")


POOL_GOOD = pool_src("""
    class Pool:
        def _require_transition(self, pid, edge, dst):
            if (int(self.state[pid]), dst) not in PAGE_TRANSITIONS[edge]:
                raise ValueError(edge)
            return int(self.state[pid])

        def alloc(self, pid):
            self._require_transition(pid, "alloc", PAGE_HOT)
            self.state[pid] = PAGE_HOT

        def free(self, pids):
            # the port's batch form: guard each page, then write them all
            for pid in pids:
                self._require_transition(pid, "free", PAGE_FREE)
            for pid in pids:
                self.state[pid] = PAGE_FREE

        def _check_seal(self, pids):
            for pid in pids:
                self._require_transition(pid, "seal", PAGE_COLD)

        def seal(self, pids):
            self._check_seal(pids)
            self.state[pids] = PAGE_COLD

        def adopt(self, pid, st):
            if st != PAGE_HOT:
                self._require_transition(pid, "adopt", st)
                self.state[pid] = st
""")


class TestLifecyclePass:
    def test_good_fixture_clean(self, tmp_path):
        root = make_tree(tmp_path, {"pool.py": POOL_GOOD})
        assert run_pass(root, "lifecycle") == []

    def test_unguarded_write(self, tmp_path):
        root = make_tree(tmp_path, {"pool.py": pool_src("""
            class Pool:
                def seal(self, pid):
                    self.state[pid] = PAGE_COLD
        """)})
        assert codes(run_pass(root, "lifecycle")) == ["unguarded-state-write"]

    def test_helper_guard_dst_mismatch(self, tmp_path):
        bad = POOL_GOOD.replace("self.state[pids] = PAGE_COLD",
                                "self.state[pids] = PAGE_PACKED")
        root = make_tree(tmp_path, {"pool.py": bad})
        assert codes(run_pass(root, "lifecycle")) == ["guard-dst-mismatch"]

    def test_loop_guard_on_the_wrong_edge(self, tmp_path):
        bad = POOL_GOOD.replace('self._require_transition(pid, "seal", '
                                'PAGE_COLD)',
                                'self._require_transition(pid, "pack", '
                                'PAGE_COLD)')
        root = make_tree(tmp_path, {"pool.py": bad})
        assert codes(run_pass(root, "lifecycle")) == ["undeclared-transition"]

    def test_variable_write_needs_its_own_guard(self, tmp_path):
        bad = POOL_GOOD.replace('self._require_transition(pid, "adopt", st)',
                                'self._require_transition(pid, "adopt", '
                                'PAGE_COLD)')
        root = make_tree(tmp_path, {"pool.py": bad})
        assert codes(run_pass(root, "lifecycle")) == ["non-symbolic-state"]

    def test_undeclared_transition_via_narrowing(self, tmp_path):
        root = make_tree(tmp_path, {"pool.py": pool_src("""
            class Pool:
                def free(self, pid):
                    if self.state[pid] == PAGE_FREE:
                        raise ValueError("double free")
                    self.state[pid] = PAGE_FREE
        """)})
        assert codes(run_pass(root, "lifecycle")) == ["undeclared-transition"]


# ------------------------------------------------------------------ phases
ENGINE_GOOD = """
    class Engine:
        def _step_async(self):
            self._overlap_host_work()
            self._collect()
            self._retire()
            self._dispatch()

        def _overlap_host_work(self):
            self.stats["ticks"] += 1

        def _collect(self):
            self.active[0] = None

        def _retire(self):
            kv = self.kv
            self.active[0] = None
            kv.release(0)

        def _dispatch(self):
            pass
"""


class TestPhasePass:
    def test_good_fixture_clean(self, tmp_path):
        root = make_tree(tmp_path, {"engine.py": ENGINE_GOOD})
        assert run_pass(root, "phase") == []

    def test_overlap_mutations_flagged_through_an_alias(self, tmp_path):
        bad = ENGINE_GOOD.replace(
            '            self.stats["ticks"] += 1',
            "            kv = self.kv\n"
            "            self.active[0] = None\n"
            "            kv.ingest_prefill_chunk(0)")
        root = make_tree(tmp_path, {"engine.py": bad})
        assert codes(run_pass(root, "phase")) == [
            "overlap-pool-mutation", "overlap-slot-write"]

    def test_collect_order(self, tmp_path):
        bad = ENGINE_GOOD.replace(
            "            self._overlap_host_work()\n            self._collect()",
            "            self._dispatch()\n            self._collect()")
        root = make_tree(tmp_path, {"engine.py": bad})
        assert codes(run_pass(root, "phase")) == ["collect-order"]


# ------------------------------------------------------------------ launch
CU_STUB = """
    // a kernel's C interface
    extern "C" int toy_launch(const void* x, void* out, int n, int bits,
                              float scale, void* stream) {
      return 0;
    }

    /* host query */
    extern "C" int toy_smem_bytes(int n) { return 4 * n; }
"""

BINDING = """
    import ctypes

    from . import _build

    _ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float] \\
        + [ctypes.c_void_p]

    def toy(x, out, n):
        lib = _build.load("toy")
        fn = lib.toy_smem_bytes
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        smem = fn(n)
        ptrs = [x.data_ptr(), out.data_ptr()]
        fn = lib.toy_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        rc = _build.launch(fn, *ptrs, n, 8, 0.5, on=x)
        _build.LAUNCHES["toy"] += 1
        return rc, smem
"""


def launch_tree(tmp_path, binding=BINDING, cu=CU_STUB):
    return make_tree(tmp_path, {"kernels/csrc/toy.cu": cu,
                                "kernels/toy.py": binding})


class TestLaunchPass:
    def test_good_fixture_clean(self, tmp_path):
        assert run_pass(launch_tree(tmp_path), "launch") == []

    def test_argtypes_short_by_one_int(self, tmp_path):
        bad = BINDING.replace("[ctypes.c_int] * 2 +", "[ctypes.c_int] * 1 +")
        got = codes(run_pass(launch_tree(tmp_path, bad), "launch"))
        # the list is short, and the call no longer matches it
        assert got == ["argtypes-mismatch", "launch-arity"]

    def test_argtypes_kind_and_restype(self, tmp_path):
        bad = BINDING.replace("+ [ctypes.c_float]", "+ [ctypes.c_int]") \
            .replace("[ctypes.c_int], ctypes.c_int", "[ctypes.c_int], None")
        got = codes(run_pass(launch_tree(tmp_path, bad), "launch"))
        assert got == ["argtypes-mismatch", "argtypes-mismatch"]

    def test_launch_arity(self, tmp_path):
        bad = BINDING.replace("*ptrs, n, 8, 0.5, on=x", "*ptrs, n, 0.5, on=x")
        assert codes(run_pass(launch_tree(tmp_path, bad), "launch")) == [
            "launch-arity"]

    def test_unbound_and_missing_entries(self, tmp_path):
        bad = BINDING.replace("lib.toy_smem_bytes", "lib.toy_smem")
        assert codes(run_pass(launch_tree(tmp_path, bad), "launch")) == [
            "missing-entry", "unbound-entry"]

    def test_launch_counted_once_under_its_name(self, tmp_path):
        twice = BINDING.replace(
            '        _build.LAUNCHES["toy"] += 1',
            '        _build.LAUNCHES["toy"] += 1\n'
            '        _build.LAUNCHES["toy"] += 1')
        other = BINDING.replace('LAUNCHES["toy"]', 'LAUNCHES["other"]')
        none = BINDING.replace('        _build.LAUNCHES["toy"] += 1\n', "")
        for bad in (twice, other, none):
            root = launch_tree(tmp_path / str(id(bad)), bad)
            assert codes(run_pass(root, "launch")) == ["launch-count"]

    def test_count_without_a_launch(self, tmp_path):
        extra = BINDING + """
    def helper():
        _build.LAUNCHES["toy"] += 1
"""
        assert codes(run_pass(launch_tree(tmp_path, extra), "launch")) == [
            "launch-count"]


# --------------------------------------------------------------- cache-key
class TestCacheKeyPass:
    def test_unbucketed_cache_key(self, tmp_path):
        root = make_tree(tmp_path, {"m.py": """
            def replay(self, ids):
                s = len(ids)
                key = (s, True)
                if key not in self._graph_cache:
                    self._graph_cache[key] = object()
                return self._graph_cache[key]
        """})
        assert codes(run_pass(root, "cache-key")) == [
            "unbucketed-cache-key", "unbucketed-cache-key"]

    def test_bucketed_key_clean(self, tmp_path):
        root = make_tree(tmp_path, {"m.py": """
            def pages_bucket(n, cap):
                b = 1
                while b < n:
                    b *= 2
                return min(b, cap)

            def replay(self, meta_pages, batch: int):
                bucket = pages_bucket(meta_pages.shape[-1], 64)
                key = (bucket, batch)
                return self._graph_cache.setdefault(key, object())
        """})
        assert run_pass(root, "cache-key") == []

    def test_float_and_tensor_keys(self, tmp_path):
        root = make_tree(tmp_path, {"m.py": """
            import torch

            def lookup(self, x: torch.Tensor, scale: float):
                a = self._graph_cache.get(scale)
                b = self._graph_cache.get(torch.argmax(x))
                return a, b
        """})
        assert codes(run_pass(root, "cache-key")) == [
            "float-cache-key", "tensor-cache-key"]

    def test_lru_cache_on_tensor_or_float(self, tmp_path):
        root = make_tree(tmp_path, {"m.py": """
            import functools
            import torch

            @functools.lru_cache(maxsize=None)
            def capture(x: torch.Tensor, n: int):
                return x

            @functools.cache
            def table(bits: int, eps=1e-6):
                return bits
        """})
        assert codes(run_pass(root, "cache-key")) == ["lru-cache-arg",
                                                      "lru-cache-arg"]


# ------------------------------------------------------ parity with JAX's
PLAIN_TREE = {
    "pkg/__init__.py": "",
    "pkg/engine.py": """
        from pkg import util
        from pkg.util import helper


        class Engine:
            # apack: hot-path-root
            def step(self):
                self._advance()
                return util.summarize(helper(1))

            def _advance(self):
                def inner():
                    return leaf(2)
                # apack: allow-transfer(a reason that wraps
                # onto a second line)
                return inner()

            # apack: allow-phase()
            def idle(self):
                return 0


        def leaf(x):
            # apack: allow-bogus(an unknown key)
            return x + 1
    """,
    "pkg/util.py": """
        # apack: hot-path-root(traced)
        def summarize(v):
            return tally(v)


        def tally(v):
            return [v]


        def helper(v):
            return v * 2


        def orphan():
            return tally(3)  # apack: allow-transition(trailing reason)
    """,
    "pkg/broken.py": "def oops(:\n    pass\n",
}


def _framework_view(pkg, root: Path) -> dict:
    fw, cg = pkg.framework, pkg.callgraph
    tree = fw.SourceTree(root)
    graph = cg.CallGraph(tree)
    roots = tree.roots()
    rep = fw.Reporter(tree)
    for mod in tree.modules:
        for fi in [f for f in tree.functions if f.module is mod]:
            for pass_id in ("boundary", "lifecycle", "phase"):
                rep.emit(pass_id, "probe", mod, fi.node.lineno + 1,
                         f"probe of {fi.qualname}")
    rep.check_suppression_keys()
    unknown = [(f.code, f.path, f.line) for f in rep.findings
               if f.code == "unknown-suppression-key"]
    return {
        "roots": sorted((f.qualname, f.root_kind) for f in roots),
        "reachable": sorted(cg.CallGraph.key(f)
                            for f in graph.reachable(roots)),
        "edges": {k: sorted(v) for k, v in graph.edges.items()},
        "suppressions": sorted((s.path, s.line, s.key, s.reason, s.used)
                               for m in tree.modules
                               for s in m.suppressions),
        "fingerprints": sorted(f.fingerprint for f in rep.findings
                               if f.code != "unknown-suppression-key"),
        "unknown": sorted(unknown),
    }


def test_framework_and_callgraph_match_the_reference(tmp_path):
    import repro.analysis.callgraph as jcg
    import repro.analysis.framework as jfw
    import repro_torch.analysis.callgraph as tcg
    import repro_torch.analysis.framework as tfw

    class NS:
        def __init__(self, fw, cg):
            self.framework, self.callgraph = fw, cg
    root = make_tree(tmp_path, PLAIN_TREE)
    ref = _framework_view(NS(jfw, jcg), root)
    port = _framework_view(NS(tfw, tcg), root)
    assert ref["roots"] == [("Engine.step", "host"), ("summarize", "traced")]
    assert "pkg/engine.py::leaf" in ref["reachable"]
    assert any(f.startswith("framework|syntax-error|pkg/broken.py")
               for f in ref["fingerprints"])
    assert any(f.startswith("phase|missing-reason")
               for f in ref["fingerprints"])
    assert port == ref


def test_callgraph_resolves_python_scoping(tmp_path):
    # a nested def and a module's own def shadow same-named strangers
    root = make_tree(tmp_path, {
        "a.py": """
            # apack: hot-path-root
            def step():
                def run():
                    return 1
                return run() + local()

            def local():
                return 2

            class Runner:
                def run(self):
                    return stranger()

            def stranger():
                return 3
        """,
        "b.py": """
            def local():
                return 4
        """})
    tree = SourceTree(root)
    graph = CallGraph(tree)
    got = sorted(CallGraph.key(f) for f in graph.reachable(tree.roots()))
    assert got == ["a.py::local", "a.py::step", "a.py::step.run"]


# ---------------------------------------------------------------- live tree
@pytest.fixture(scope="module")
def live_report():
    return run_passes()


class TestLiveTree:
    def test_matches_committed_baseline(self, live_report):
        assert live_report.ok, "new findings vs baseline:\n" + "\n".join(
            f.render() for f in live_report.new)
        assert not live_report.stale
        assert BASELINE.read_text().split() == ["{", '"findings":', "[]",
                                                "}"]

    def test_all_passes_ran(self, live_report):
        assert sorted(live_report.pass_seconds) == sorted(
            ["boundary", "lifecycle", "phase", "launch", "cache-key"])

    def test_all_suppressions_used_with_reasons(self, live_report):
        # a suppression nothing fires against is dead weight (or a typo'd
        # location); the run counts the used ones
        supps = [s for m in SourceTree(DEFAULT_ROOT).modules
                 for s in m.suppressions]
        assert supps and live_report.suppressions_total == len(supps)
        assert live_report.suppressions_used == len(supps)
        assert all(s.reason for s in supps)

    def test_hot_path_roots_annotated(self):
        tree = SourceTree(DEFAULT_ROOT)
        roots = {(f.module.rel, f.qualname) for f in tree.roots()}
        assert roots == {
            ("serve/engine.py", "ServeEngine.step"),
            ("serve/engine.py", "ServeEngine._launch_fused"),
            ("serve/engine.py", "ServeEngine._dispatch"),
            ("serve/engine.py", "ServeEngine._collect"),
            ("models/model.py", "decode_step_paged"),
            ("models/modules.py", "paged_attention_step")}

    def test_token_pull_is_sanctioned(self, live_report):
        sites = {(f.path, f.code) for f, _ in live_report.sanctioned}
        assert ("serve/engine.py", "host-materialize") in sites
        assert ("models/model.py", "host-materialize") in sites   # _fetch

    def test_launch_pass_reads_every_entry_point(self):
        from repro_torch.analysis.launch_lint import c_entries
        entries = c_entries(DEFAULT_ROOT)
        assert sorted(entries) == sorted([
            "apack_decode_launch", "apack_decode_page_staged",
            "apack_encode_launch", "decompress_matmul_smem_bytes",
            "decompress_matmul_launch", "fused_page_attention_smem_bytes",
            "fused_page_attention_launch", "gather_decode_launch"])
        assert len(entries["fused_page_attention_launch"]["params"]) == 50


# --------------------------------------------------------------- mutations
@pytest.fixture()
def live_copy(tmp_path):
    dst = tmp_path / "repro_torch"
    shutil.copytree(DEFAULT_ROOT, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _edit(root: Path, rel: str, old: str, new: str) -> None:
    p = root / rel
    s = p.read_text()
    assert old in s, f"mutation anchor not found in {rel}"
    p.write_text(s.replace(old, new, 1))


TOKEN_PULL = "            # apack: allow-transfer(the step's one sanctioned pull"

MUTATIONS = {
    "boundary": ("host-materialize", "serve/engine.py", TOKEN_PULL,
                 "            # (deleted"),
    "lifecycle": ("undeclared-transition", "models/modules.py",
                  'self._require_transition(pid, "seal", PAGE_COLD,',
                  'self._require_transition(pid, "pack", PAGE_COLD,'),
    "phase": ("overlap-pool-mutation", "serve/engine.py",
              "    def _overlap_host_work(self) -> None:\n",
              "    def _overlap_host_work(self) -> None:\n"
              "        self.kv.release(0)\n"),
    "launch": ("argtypes-mismatch", "kernels/apack_decode.py",
               "[ctypes.c_int] * 12", "[ctypes.c_int] * 11"),
    "cache-key": ("unbucketed-cache-key", "serve/engine.py",
                  "    def _prefill_forward(self, prompt, shard: int = 0):\n",
                  "    def _prefill_forward(self, prompt, shard: int = 0):\n"
                  "        self._graph_cache[len(prompt)] = None\n"),
}


@pytest.mark.parametrize("pass_id", list(MUTATIONS))
def test_seeded_violation_fails(live_copy, pass_id):
    code, rel, old, new = MUTATIONS[pass_id]
    _edit(live_copy, rel, old, new)
    report = run_passes(live_copy, passes=[pass_id], baseline=BASELINE)
    got = [(f.pass_id, f.code) for f in report.new]
    assert (pass_id, code) in got, got
    assert not report.ok


def test_cli_exits_nonzero_on_mutated_tree(live_copy):
    _edit(live_copy, "serve/engine.py", TOKEN_PULL, "            # (deleted")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--root",
         str(live_copy), "--baseline", str(BASELINE), "--pass", "boundary",
         "--pass", "launch"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 1, out.stdout + out.stderr
    assert "host-materialize" in out.stdout


# ------------------------------------------------------- runtime guards
class TestRuntimeTransitionGuards:
    """The port's pool guards validate against ``PAGE_TRANSITIONS``, the
    table the lifecycle pass reads."""

    def _pool(self):
        from repro_torch.models import modules as m
        return m, m.KVPagePool(num_pages=4, page_size=2, kv_heads=2,
                               head_dim=8, device="cpu")

    def test_every_edge_is_a_pool_method(self):
        from repro_torch.models import modules as m
        for edge in m.PAGE_TRANSITIONS:
            assert hasattr(m.KVPagePool, edge), edge

    def test_illegal_edges_raise_naming_the_transition(self):
        import torch
        m, pool = self._pool()
        pid = pool.alloc()
        with pytest.raises(ValueError, match="HOT->PACKED"):
            pool.pack([pid], None, None)
        with pytest.raises(ValueError, match="repack of non-PACKED"):
            pool.repack([pid], (), torch.ones(1, dtype=torch.bool))
        pool.free([pid])
        with pytest.raises(ValueError, match="FREE->FREE"):
            pool.free([pid])

    def test_guard_admits_exactly_the_declared_pairs(self):
        m, pool = self._pool()
        states = [m.PAGE_FREE, m.PAGE_HOT, m.PAGE_COLD, m.PAGE_PACKED]
        pid = 0
        for edge, pairs in m.PAGE_TRANSITIONS.items():
            for src in states:
                for dst in states:
                    pool.state[pid] = src
                    ok = (src, dst) in pairs
                    if ok:
                        assert pool._require_transition(pid, edge,
                                                        dst) == src
                    else:
                        with pytest.raises(ValueError):
                            pool._require_transition(pid, edge, dst)
        assert np.all(pool.state >= 0)
