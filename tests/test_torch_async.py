"""The port's async scheduler against the JAX package's, on the CPU (the
parity cases of ``tests/test_serve_async.py``; ``hetero-serve-smoke``'s
is in ``test_torch_async_admission.py``): the event loop with chunked
prefill and a mid-run preempt with spill and readahead, on qwen3 SMOKE,
gives the JAX async engine's greedy tokens, ``prefill_chunks``,
``staged_readahead`` and KV traffic, and the port's sync engine's tokens;
chunks of 3 tokens, with an SLO request and host-delay faults, give the
same; the async scheduler refuses a dense cache as the reference does;
the overlap window and the dispatch read nothing back from the device; a
host-delay fault lands in the async engine's window only.  Params are
built once per module, and each workload stays short: XLA's and
PyTorch's CPU ``exp`` can differ in the last f32 bit."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import get_hetero_smoke_config, get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import FaultInjector, Request, ServeEngine

# non-power-of-two lengths: every prompt takes the padded, masked bucket
PROMPT_LENS = [5, 11, 9, 20, 6]
# the KV stats that must come out equal (page ids, and so the pool's high
# water, may differ where a prefill's last-chunk eviction is deferred)
KV_KEYS = ("kv_ratio", "kv_raw_bytes", "kv_read_bytes", "kv_table_bytes",
           "kv_pages_packed", "kv_pages_evicted", "kv_pages_spilled",
           "kv_pages_unspilled")
STAT_KEYS = ("steps", "generated", "completed", "preempted", "resumed",
             "spilled_requests", "prefill_chunks", "staged_readahead")


def _params(arch):
    if arch == "hetero":
        cj, cp = jconfigs.get_hetero_smoke_config(), get_hetero_smoke_config()
    else:
        cj, cp = (jconfigs.get_smoke_config("qwen3-1.7b"),
                  get_smoke_config("qwen3-1.7b"))
    cj = dataclasses.replace(cj, kv_cache_dtype="apack-int8")
    cp = dataclasses.replace(cp, kv_cache_dtype="apack-int8")
    jp = jax.jit(JM.init_params, static_argnums=0)(cj, jax.random.PRNGKey(0))
    return cj, cp, jp, params_from_numpy(cp, jax.tree.map(np.array, jp),
                                         "cpu")


def _run(port, cfg, params, scheduler, *, lens=PROMPT_LENS, max_new=10,
         preempt_at=None, slo=None, **ekw):
    """One wave through the port's (``port``) or the JAX package's engine,
    as ``tests/test_serve_async.py::_run`` serves it: with ``preempt_at``,
    slot 0 is preempted with spill to the tail after that many decode
    steps (spill, readahead, resume mid-run); request ``slo``, when given,
    carries a 1 ms latency SLO.  Returns the tokens, the counters, the KV
    traffic and the order in which the requests were admitted."""
    kw = dict(max_batch=2, max_len=48, kv_page_size=4, kv_calib_pages=2,
              scheduler=scheduler, **ekw)
    if port:
        eng, req = ServeEngine(cfg, params, device="cpu", **kw), Request
    else:
        eng, req = JEngine(cfg, params, kv_backend="ref", **kw), JRequest
    rng = np.random.default_rng(3)
    reqs = [req(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                .astype(np.int32), max_new_tokens=max_new,
                slo_ms=1.0 if i == slo else None)
            for i, n in enumerate(lens)]
    for r in reqs:
        eng.submit(r)
    if preempt_at is not None:
        for _ in range(500):
            eng.step()
            if eng.stats["steps"] >= preempt_at:
                break
        assert eng.active[0] is not None
        eng.preempt(0, spill=True, requeue="tail")
    eng.run_until_drained(max_steps=2000)
    for r in reqs:
        assert r.done and not r.error, (r.rid, r.error)
    ks = eng.kv_stats()
    return {"tokens": [list(r.tokens) for r in reqs],
            "stats": {k: eng.stats[k] for k in STAT_KEYS},
            "kv": {k: ks[k] for k in KV_KEYS},
            "streams": {k: ks["kv_streams"][k]["ratio"]
                        for k in ("global", "local", "state")},
            "keys": sorted(ks),
            "order": [r.rid for r in sorted(reqs, key=lambda r: r.t_admit)]}


@pytest.fixture(scope="module")
def qwen():
    return _params("qwen3")


def _parity(params, *, faults=None, **kw):
    """The workload on the JAX async engine and on the port's async and
    sync engines.  The sync one runs it without the preemption and the
    faults (``faults()`` makes an injector of either package): preempt,
    spill and resume leave the tokens as they were."""
    cj, cp, jp, tp = params
    fj, fp = (faults(False), faults(True)) if faults else (None, None)
    ja = _run(False, cj, jp, "async", faults=fj, **kw)
    pa = _run(True, cp, tp, "async", faults=fp, **kw)
    kw.pop("preempt_at", None)
    ps = _run(True, cp, tp, "sync", **kw)
    ja["faults"], pa["faults"] = fj, fp
    assert pa["tokens"] == ja["tokens"]
    assert pa["tokens"] == ps["tokens"]
    assert pa["stats"] == ja["stats"]
    assert pa["kv"] == ja["kv"]
    assert pa["streams"] == ja["streams"]
    assert pa["keys"] == ja["keys"]
    return ja, pa, ps


def test_qwen3_with_preempt_spill_resume(qwen):
    """Mid-run preempt with spill on both schedulers (the async engine
    lands its step in flight first): the port's async tokens equal the JAX
    async engine's and the port's sync engine's; the chunk, readahead and
    spill counters and the KV traffic equal the JAX engine's."""
    ja, pa, ps = _parity(qwen, lens=PROMPT_LENS[:3], max_new=6,
                         preempt_at=3)
    assert pa["stats"]["preempted"] >= 1
    assert pa["stats"]["spilled_requests"] >= 1
    assert pa["stats"]["prefill_chunks"] > 0
    assert pa["stats"]["staged_readahead"] >= 1
    assert pa["kv"]["kv_pages_unspilled"] > 0


def test_chunked_prefill_equivalence(qwen):
    """Prompts ingested 3 tokens a step, interleaved with decode steps:
    the same pages, tokens, chunk count and KV ratio as the JAX async
    engine, and the sync engine's monolithic ingest's tokens.  The last
    request carries a 1 ms SLO, which admits it first, and three host
    delays land in the overlap window (``delay_host_work``), on both
    packages."""
    def faults(port):
        inj = (FaultInjector if port else JFaultInjector)()
        inj.delay_host_work(0.02, n=3)
        return inj
    ja, pa, ps = _parity(qwen, lens=[20, 7, 23], max_new=4,
                         prefill_chunk_tokens=3, slo=2, faults=faults)
    assert pa["stats"]["prefill_chunks"] >= 3
    assert pa["kv"]["kv_ratio"] is not None and pa["kv"]["kv_ratio"] < 1
    assert pa["order"] == ja["order"] and pa["order"][0] == 2
    assert pa["faults"].stats["host_work_delayed"] == 3
    assert ja["faults"].stats["host_work_delayed"] == 3


def test_async_requires_fused_paged_kv(qwen):
    """The reference's refusals, as ``ValueError``s with its messages: the
    async scheduler on a dense cache or the materialize oracle, and an
    unknown scheduler."""
    cp, tp = dataclasses.replace(qwen[1], kv_cache_dtype="bfloat16"), qwen[3]
    with pytest.raises(ValueError, match="scheduler='async'"):
        ServeEngine(cp, tp, max_batch=2, max_len=32, scheduler="async",
                    device="cpu")
    with pytest.raises(ValueError, match="scheduler='async'"):
        ServeEngine(qwen[1], tp, max_batch=2, max_len=32, scheduler="async",
                    kv_fused=False, device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        ServeEngine(cp, tp, max_batch=2, max_len=32, scheduler="overlapped",
                    device="cpu")
    eng = ServeEngine(qwen[1], tp, max_batch=2, max_len=32, kv_page_size=8,
                      scheduler="async", device="cpu")
    assert eng.prefill_chunk_tokens == 32          # kv_page_size * 4


def test_window_and_dispatch_read_nothing_back(qwen, monkeypatch):
    """Over an async serve with table refresh, chunked prefill of requests
    that arrive while others decode, and a preempt with spill whose
    readahead is staged in the window, ``_overlap_host_work``,
    ``_dispatch`` and ``_start_pump`` make no device-to-host read: no
    ``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()`` or conversion of
    a tensor to a Python number, and no ``kv.transfers`` pull.  Each
    collect makes one pull, plus the pulls of its seal batches
    (histograms or packed bit counts), as the sync step does; the card
    holds the same phases to
    ``torch.cuda.set_sync_debug_mode("error")`` in ``chip_smoke.py``."""
    import traceback

    import torch
    cfg, tp = qwen[1], qwen[3]
    eng = ServeEngine(cfg, tp, device="cpu", max_batch=2, max_len=48,
                      kv_page_size=4, kv_calib_pages=2, scheduler="async",
                      prefill_chunk_tokens=3, kv_refresh=True,
                      kv_refresh_every_pages=4, kv_refresh_min_pages=2,
                      kv_repack_budget=8)
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=6) for i, n in enumerate((9, 14, 11, 7))]
    reads = {"window": 0}
    inside = [False]
    names = ("cpu", "item", "tolist", "numpy", "__int__", "__float__",
             "__bool__", "__index__")

    def counting(orig):
        def f(*a, **k):
            # a kernel's plain version runs only because the tensors lie on
            # the CPU; on the card its kernel runs instead
            if inside[0] and not any(
                    fr.name.endswith("_plain") and "/kernels/" in fr.filename
                    for fr in traceback.extract_stack()):
                reads["window"] += 1
            return orig(*a, **k)
        return f

    for name in names:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(getattr(torch.Tensor, name)))
    d2h = {"window": 0, "collect": 0, "page_events": 0, "collects": 0}

    def watched(fn, phase):
        def f(*a, **k):
            before = eng.kv.transfers["d2h_calls"]
            # a window with no step in flight may pull (the idle engine
            # drains a pump as a sync prefill)
            inside[0] = phase == "window" and not (
                fn.__name__ == "_overlap_host_work" and eng._inflight is None)
            try:
                return fn(*a, **k)
            finally:
                inside[0] = False
                d2h[phase] += eng.kv.transfers["d2h_calls"] - before
        return f

    for name in ("_overlap_host_work", "_dispatch", "_start_pump"):
        monkeypatch.setattr(eng, name, watched(getattr(eng, name), "window"))
    collect = eng._collect
    in_collect = [False]

    def page_event(fn):
        # a seal batch's pulls (histograms, packed bit counts), or a
        # re-pack batch's past the first
        def f(*a, **k):
            before = eng.kv.transfers["d2h_calls"]
            try:
                return fn(*a, **k)
            finally:
                if in_collect[0]:
                    d2h["page_events"] += (eng.kv.transfers["d2h_calls"]
                                           - before)
        return f
    for name in ("_seal", "repack_pending"):
        monkeypatch.setattr(eng.kv, name, page_event(getattr(eng.kv, name)))

    def counted_collect():
        d2h["collects"] += eng._inflight is not None
        in_collect[0] = True
        try:
            return collect()
        finally:
            in_collect[0] = False
    monkeypatch.setattr(eng, "_collect", watched(counted_collect, "collect"))
    for r in reqs[:2]:
        eng.submit(r)
    eng.step()                      # idle engine: admission drains a pump
    for r in reqs[2:]:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    eng.preempt(0, spill=True, requeue="tail")
    eng.run_until_drained(max_steps=200)
    assert all(r.done and not r.error for r in reqs)
    assert reads["window"] == 0
    assert d2h["window"] == 0
    assert eng.stats["prefill_chunks"] > len(reqs)
    assert eng.stats["staged_readahead"] >= 1
    assert eng.stats["kv_pages_repacked"] > 0
    assert d2h["collect"] == d2h["collects"] + d2h["page_events"]
    assert d2h["page_events"] > 0


def test_host_delay_fault_degrades_latency_not_tokens(qwen):
    """``delay_host_work`` lands in the async engine's overlap window; the
    sync engine has none and takes no delay; the tokens are the same
    (against the JAX async engine under the same fault:
    ``test_chunked_prefill_equivalence``)."""
    cp, tp = qwen[1], qwen[3]
    injs, runs = {}, {}
    for sched in ("async", "sync"):
        injs[sched] = FaultInjector()
        injs[sched].delay_host_work(0.02, n=3)
        runs[sched] = _run(True, cp, tp, sched, lens=[9, 6], max_new=5,
                           faults=injs[sched])
    assert injs["async"].stats["host_work_delayed"] == 3
    assert injs["sync"].stats["host_work_delayed"] == 0
    assert runs["async"]["tokens"] == runs["sync"]["tokens"]
