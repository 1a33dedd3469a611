"""Admission, faults and clocks of the port's engine on both schedulers,
on the CPU (the admission and fault cases of
``tests/test_serve_async.py``), and the async scheduler's parity with the
JAX package on ``hetero-serve-smoke`` with a mid-run preempt with spill:
EDF admission over ``Request.slo_ms``, the pressure victim scan never
spilling the head it relieves, and latency clocks that never read the
wall clock (the host-delay fault case is in ``test_torch_async.py``)."""
import dataclasses
import time

import numpy as np
import pytest

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as PM
from repro_torch.serve import Request, ServeEngine

from test_torch_async import _params, _parity


@pytest.fixture(scope="module")
def qwen():
    """qwen3 SMOKE on the paged APack KV and seed-0 port params (these
    cases run no JAX engine)."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              kv_cache_dtype="apack-int8")
    return None, cfg, None, PM.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")


def _requests(cfg, lens, max_new, seed=3, **kw):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=max_new, **kw)
            for i, n in enumerate(lens)]


def test_hetero_with_preempt_spill_resume():
    """``tests/test_serve_async.py``'s heterogeneous lockstep case (global
    + rolling + recurrent layers, mid-run preempt with spill): the port's
    async tokens equal the JAX async engine's and the port's sync
    engine's, and so do the chunk, readahead and spill counters and the
    KV traffic.  Chunked ingest builds the rolling pages (zeros older than
    the window, rolled-out pages evicted after their seals) and the
    recurrent states as the monolithic ingest does."""
    ja, pa, ps = _parity(_params("hetero"), lens=[11, 9, 20], max_new=6,
                         preempt_at=3)
    assert pa["stats"]["staged_readahead"] >= 1
    assert pa["stats"]["preempted"] >= 1
    assert pa["kv"]["kv_pages_evicted"] > 0
    assert pa["stats"]["prefill_chunks"] > 0


@pytest.mark.parametrize("scheduler", ["sync", "async"])
def test_slo_priority_admission(qwen, scheduler):
    """EDF over FIFO on both schedulers: with the pool sized for one
    request, a late-submitted request with a tight SLO is admitted before
    the earlier FIFO traffic; traffic without SLOs stays FIFO."""
    cfg, tp = qwen[1], qwen[3]
    n_layers = cfg.n_cycles * len(cfg.cycle)
    eng = ServeEngine(cfg, tp, max_batch=4, max_len=16, kv_page_size=4,
                      kv_calib_pages=2, kv_pages=n_layers * 4,
                      scheduler=scheduler, device="cpu")
    reqs = _requests(cfg, [8, 8], max_new=4)
    urgent = _requests(cfg, [8], max_new=4, slo_ms=1.0)[0]
    urgent.rid = 99
    for r in reqs:
        eng.submit(r)
    eng.submit(urgent)
    assert [r.rid for r in eng._admission_order()] == [99, 0, 1]
    if scheduler == "sync":
        eng._retire()
        eng._admit()
    else:
        eng.step()              # idle engine: the head binds at once
    active_rids = [r.rid for r in eng.active if r is not None]
    assert active_rids == [99], active_rids
    eng.run_until_drained(max_steps=500)
    assert all(r.done for r in reqs) and urgent.done
    fifo = ServeEngine(cfg, tp, max_batch=4, max_len=16, kv_page_size=4,
                       kv_calib_pages=2, scheduler=scheduler, device="cpu")
    for r in _requests(cfg, [8, 8, 8], max_new=4):
        fifo.submit(r)
    assert [r.rid for r in fifo._admission_order()] == [0, 1, 2]


def test_head_never_its_own_pressure_victim(qwen):
    """The over-commit regression: the queue head, preempted but holding
    its reservation, is never chosen by ``_relieve_pressure``'s
    parked-victim scan, and the reservations drain back to zero."""
    cfg, tp = qwen[1], qwen[3]
    eng = ServeEngine(cfg, tp, max_batch=2, max_len=32, kv_page_size=4,
                      kv_calib_pages=2, device="cpu")
    reqs = _requests(cfg, [8, 8], max_new=8)
    for r in reqs:
        eng.submit(r)
    for _ in range(20):
        if all(a is not None for a in eng.active):
            break
        eng.step()
    head = eng.active[1]
    eng.preempt(1, spill=False, requeue="head")
    assert head.rid in eng._preempted
    assert head.rid in eng._reserved        # the reservation survives
    relieved = eng._relieve_pressure(head, 0)
    assert not relieved, "head was spilled to relieve itself"
    assert head.rid in eng._reserved
    assert head.rid not in eng._spilled
    eng.run_until_drained(max_steps=500)
    assert all(r.done and not r.error for r in reqs)
    assert eng._reserved_total == 0 and not eng._reserved


def test_monotonic_latency_clocks(qwen, monkeypatch):
    """Request timing never reads the wall clock: with ``time.time``
    frozen, latencies stay positive and the percentiles populate."""
    monkeypatch.setattr(time, "time", lambda: 1.0e9)
    cfg = dataclasses.replace(qwen[1], kv_cache_dtype="bfloat16")
    eng = ServeEngine(cfg, qwen[3], max_batch=2, max_len=32, device="cpu")
    reqs = _requests(cfg, [8, 8], max_new=4)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=200)
    for r in reqs:
        assert r.t_done > r.t_submit > 0.0
        assert r.t_admit >= r.t_submit
    lat = eng.latency_stats()
    assert lat["n"] == 2
    assert lat["e2e_p50"] > 0.0
    assert lat["queue_wait_p99"] >= 0.0
    assert eng.stats["e2e_p99_ms"] > 0.0
