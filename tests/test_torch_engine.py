"""Port ServeEngine vs the JAX ServeEngine (``kv_backend="ref"``) on
qwen3-1.7b SMOKE with the same params and prompts; preemption and resume;
the steady-state step's device-to-host reads; the device default; a
mesh that does not fit the batch, and the scheduler options the engine
serves."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as PM
from repro_torch.models import modules as pm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

KW = dict(max_batch=2, max_len=64, kv_page_size=4, kv_calib_pages=2)


def _cfg():
    return dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               kv_cache_dtype="apack-int8")


def _prompts(cfg, lens=(20, 27, 17)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def test_engine_matches_reference_in_lockstep():
    """Three requests through two slots (admission, retire, slot reuse,
    calibration and packing all happen), both engines stepped together.

    The first three paged decode steps' logits agree within 0.05 with the
    same argmax (a transcendental — exp in the softmax merge, cos/sin in
    rope — can differ in its last f32 bit between XLA's and PyTorch's CPU
    libraries; the bf16 residual stream carries that to the logits as about
    one bf16 step).  Then the greedy tokens and the KV traffic ratio must
    be identical: the pages hold the same bytes."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8")
    cfg = _cfg()
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.array, params), "cpu")
    je = JEngine(cfg_j, params, kv_backend="ref", **KW)
    pe = ServeEngine(cfg, tp, device="cpu", **KW)
    jr = [JRequest(i, p, max_new_tokens=8) for i, p in enumerate(_prompts(cfg))]
    pr = [Request(i, p, max_new_tokens=8) for i, p in enumerate(_prompts(cfg))]
    for a, b in zip(jr, pr):
        je.submit(a)
        pe.submit(b)
    for _ in range(3):
        je.step()
        pe.step()
        want = np.asarray(je.last_logits)
        got = pe.last_logits.numpy()
        np.testing.assert_allclose(got, want, atol=0.05)
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
    je.run_until_drained()
    pe.run_until_drained()
    assert [r.tokens for r in pr] == [r.tokens for r in jr]
    assert all(r.done for r in pr)
    ks, jks = pe.kv_stats(), je.kv_stats()
    assert ks["kv_ratio"] == jks["kv_ratio"] and ks["kv_ratio"] < 1
    assert ks["kv_pages_packed"] == jks["kv_pages_packed"] > 0
    assert pe.kv.pool.free_count == pe.kv.pool.num_pages
    lat = pe.latency_stats()
    assert lat["n"] == 3 and lat["e2e_p50"] > 0


LATENCY_KEYS = ("queue_wait_p50_ms", "queue_wait_p99_ms", "e2e_p50_ms",
                "e2e_p99_ms")


def test_stats_carry_the_reference_latency_keys():
    """Both engines, stepped together over the lockstep workload, seed the
    four latency percentiles at 0.0 in ``stats`` and refresh them on every
    retire from the requests completed so far (milliseconds, the
    ``latency_stats`` percentiles x 1e3).  Wall-clock values differ between
    the engines, so only the key sets and the values' sanity compare."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8")
    cfg = _cfg()
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.array, params), "cpu")
    je = JEngine(cfg_j, params, kv_backend="ref", **KW)
    pe = ServeEngine(cfg, tp, device="cpu", **KW)
    for eng in (je, pe):
        assert {k: eng.stats[k] for k in LATENCY_KEYS} == \
            dict.fromkeys(LATENCY_KEYS, 0.0)
    for i, p in enumerate(_prompts(cfg)):
        je.submit(JRequest(i, p, max_new_tokens=3 + 2 * i))
        pe.submit(Request(i, p, max_new_tokens=3 + 2 * i))
    seen = 0
    while pe.queue or any(r is not None for r in pe.active):
        je.step()
        pe.step()
        assert pe.stats["completed"] == je.stats["completed"]
        if pe.stats["completed"] == seen:
            continue
        seen = pe.stats["completed"]
        for eng in (je, pe):
            lat = eng.latency_stats()
            assert lat["n"] == seen
            got = [eng.stats[k] for k in LATENCY_KEYS]
            assert all(np.isfinite(v) and v >= 0.0 for v in got)
            assert got == [lat[k[:-3]] * 1e3 for k in LATENCY_KEYS]
            assert eng.stats["e2e_p50_ms"] > 0.0
    assert seen == 3
    assert set(LATENCY_KEYS) <= set(pe.stats) & set(je.stats)


def _serve_with_preempt(eng, reqs, requeue):
    """Step ``eng`` over ``reqs``; with ``requeue`` set, preempt slot 0
    after the admission step and three decode steps, checking that the
    request keeps its pages and reservation while it waits."""
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    if requeue is not None:
        rid = eng.active[0].rid
        held, total = eng._reserved[rid], eng._reserved_total
        pages = [list(p) for p in eng.kv.page_tables[rid]]
        eng.preempt(0, requeue=requeue)
        assert eng.active[0] is None and eng._reserved_total == total
        assert eng.queue[0 if requeue == "head" else -1].rid == rid
        eng.step()
        assert eng._reserved[rid] == held
        assert [p[:len(q)] for p, q in zip(eng.kv.page_tables[rid],
                                           pages)] == pages
        assert (eng.active[0].rid == rid) == (requeue == "head")
    eng.run_until_drained()
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("requeue", ["head", "tail"])
def test_preempt_resume_matches_uninterrupted_and_reference(requeue):
    """Three requests through two slots; slot 0 is preempted mid-decode and
    requeued at the head (it resumes at once) or the tail (the waiting
    request takes its slot and it resumes when a slot frees).  Its pages
    and reservation are kept, so the continuation reads the same pages:
    the tokens equal an uninterrupted run's and the JAX engine's under the
    same schedule."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8")
    cfg = _cfg()
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.array, params), "cpu")

    def reqs(cls):
        return [cls(i, p, max_new_tokens=10)
                for i, p in enumerate(_prompts(cfg))]
    plain = _serve_with_preempt(ServeEngine(cfg, tp, device="cpu", **KW),
                                reqs(Request), None)
    pe = ServeEngine(cfg, tp, device="cpu", **KW)
    got = _serve_with_preempt(pe, reqs(Request), requeue)
    want = _serve_with_preempt(JEngine(cfg_j, params, kv_backend="ref", **KW),
                               reqs(JRequest), requeue)
    assert got == plain == want
    assert pe.stats["preempted"] == pe.stats["resumed"] == 1
    assert pe.kv.pool.free_count == pe.kv.pool.num_pages
    assert pe._reserved_total == 0
    with pytest.raises(ValueError, match="idle"):
        pe.preempt(0, spill=True)
    with pytest.raises(ValueError, match="idle"):
        pe.preempt(0)
    dense = ServeEngine(dataclasses.replace(cfg, kv_cache_dtype="int8"), tp,
                        device="cpu", **KW)
    with pytest.raises(RuntimeError, match="paged"):
        dense.preempt(0)


def test_steady_state_step_reads_only_tokens_and_seal_pulls(monkeypatch):
    """A decode step reads back the token ids (one ``.cpu()``) plus, when
    pages seal, one pull per seal batch (calibration histograms or packed
    bit counts, accounted in ``kv.transfers``) — no ``.item()``,
    ``.tolist()`` or synchronize."""
    cfg = _cfg()
    eng = ServeEngine(cfg, PM.init_params(cfg, torch.Generator().manual_seed(0),
                                          "cpu"), device="cpu", **KW)
    for i, p in enumerate(_prompts(cfg, (9, 14))):
        eng.submit(Request(i, p, max_new_tokens=12))
    eng.step()                                    # admission + first step
    calls = {"item": 0, "cpu": 0, "tolist": 0, "synchronize": 0}

    def counting(name, orig):
        def f(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        return f

    for name in ("item", "cpu", "tolist"):
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        counting("synchronize", torch.cuda.synchronize))
    for _ in range(8):
        d2h = eng.kv.transfers["d2h_calls"]
        before = dict(calls)
        assert eng.step() == 2
        assert calls["item"] == before["item"]
        assert calls["tolist"] == before["tolist"]
        assert calls["synchronize"] == before["synchronize"]
        assert calls["cpu"] - before["cpu"] == \
            1 + eng.kv.transfers["d2h_calls"] - d2h
    assert eng.kv.transfers["d2h_calls"] > 0       # pages did seal


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="CUDA requested"):
        PM.init_params(cfg, torch.Generator())
    params = PM.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        ServeEngine(cfg, params, **KW)


def test_page_pool_defaults_to_cuda():
    """A pool built directly runs on the card unless it asks for the CPU,
    like every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        pm.KVPagePool(4, 2, 2, 4)
    pool = pm.KVPagePool(4, 2, 2, 4, device="cpu")
    assert pool.plane("sym").device.type == "cpu"


class FakeMesh:
    """Axis sizes only: what the engine's mesh validation reads."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("kw", [{"prefill_chunk_tokens": 8},
                                {"mesh": FakeMesh(data=3, model=1)},
                                {"scheduler": "async"},
                                {"weights": "int4"},
                                {"scheduler": "async",
                                 "prefill_chunk_tokens": 8}])
def test_unported_features_are_refused(kw):
    """A mesh whose data axis does not divide ``max_batch`` raises the
    reference's ValueError (meshes are served: ``test_torch_mesh_serving
    .py``; the other refusals, ``test_torch_sharding.py``); an unknown
    weights mode (packed ``apack-int8`` is served) raises ValueError naming
    the one that exists.  The async
    scheduler, its chunk size and SLO admission are served: the engine
    takes them, defaults the chunk to four pages as the reference does,
    orders a request with ``slo_ms`` first, and raises the reference's
    ValueErrors for the async scheduler on a dense cache and for an
    unknown scheduler (``test_torch_async*.py`` serve them against the JAX
    package)."""
    cfg = _cfg()
    params = PM.init_params(cfg, torch.Generator(), "cpu")
    if "mesh" in kw or "weights" in kw:
        exc, match = ((ValueError, "apack-int8") if "weights" in kw
                      else (ValueError, "max_batch=2 must divide over the "
                                        "3-way data axis"))
        with pytest.raises(exc, match=match):
            ServeEngine(cfg, params, device="cpu", **KW, **kw)
        return
    eng = ServeEngine(cfg, params, device="cpu", kv_refresh=True,
                      kv_pressure=True, **KW, **kw)
    assert eng.scheduler == kw.get("scheduler", "sync")
    assert eng.prefill_chunk_tokens == kw.get("prefill_chunk_tokens",
                                              4 * KW["kv_page_size"])
    prompts = _prompts(cfg)
    eng.submit(Request(0, prompts[0], max_new_tokens=2))
    eng.submit(Request(1, prompts[1], max_new_tokens=2, slo_ms=100.0))
    assert [r.rid for r in eng._admission_order()] == [1, 0]
    eng.run_until_drained(max_steps=100)
    assert eng.stats["completed"] == 2
    assert eng.stats["prefill_chunks"] == (
        0 if eng.scheduler == "sync" else sum(
            -(-len(p) // eng.prefill_chunk_tokens) for p in prompts[:2]))
    dense = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if eng.scheduler == "async":
        with pytest.raises(ValueError, match="scheduler='async' requires"):
            ServeEngine(dense, params, device="cpu", **KW, **kw)
    with pytest.raises(ValueError, match="unknown scheduler"):
        ServeEngine(cfg, params, device="cpu", **KW,
                    **{**kw, "scheduler": "overlapped"})
