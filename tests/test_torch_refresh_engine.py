"""Table refresh in the port's serving engine against the JAX package, on
the CPU (the engine cases of ``tests/test_table_refresh.py``): the
two-phase qwen3 SMOKE workload (diverse prompts, then one hot prompt)
with refresh gives the frozen control's tokens, the fused path equals the
materialize oracle across the refresh boundary, a short two-phase serve's
tokens, stats and KV traffic equal the JAX engine's, and a step that
re-packs and seals nothing makes one device-to-host call.  The JAX
comparison stays as short as ``test_torch_engine.py``'s lockstep run:
XLA's and PyTorch's CPU ``exp`` can differ in the last f32 bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine


def _cfgs():
    cj = dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                             kv_cache_dtype="apack-int8")
    cp = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                             kv_cache_dtype="apack-int8")
    return cj, cp


def _engine_params():
    cj, cp = _cfgs()
    params = jax.jit(JM.init_params, static_argnums=0)(
        jconfigs.get_smoke_config("qwen3-1.7b"), jax.random.PRNGKey(0))
    return cj, cp, params, params_from_numpy(
        cp, jax.tree.map(np.array, params), "cpu")


@pytest.fixture(scope="module")
def smoke():
    return _engine_params()


def _two_phase(eng, req_cls, vocab, n=4, max_new=24, prompt=9):
    """``tests/test_table_refresh.py::_two_phase_engine``'s traffic: diverse
    prompts, then one repeated hot prompt.  Returns phase ratios and
    tokens."""
    rng = np.random.default_rng(11)
    ratios, tokens = [], []
    phases = ([rng.integers(0, vocab, prompt).astype(np.int32)
               for _ in range(n)],
              [np.full(prompt, 7, np.int32) for _ in range(n)])
    for p, prompts in enumerate(phases):
        t0 = dict(eng.kv.traffic)
        reqs = [req_cls(rid=100 * p + i, prompt=pr, max_new_tokens=max_new)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        d = lambda k: eng.kv.traffic[k] - t0[k]
        ratios.append((d("kv_read_bytes") + d("kv_table_bytes"))
                      / d("kv_raw_bytes"))
        tokens.extend(r.tokens for r in reqs)
    return ratios, tokens


ENGINE_KW = dict(max_batch=4, max_len=96, kv_page_size=4, kv_calib_pages=1,
                 kv_refresh_every_pages=24, kv_refresh_min_pages=8,
                 kv_repack_budget=32)


def test_two_phase_refresh_tokens_equal_frozen_and_oracle(smoke):
    """The reference's engine drift smoke on the port: refresh fires and
    re-packs through the decode loop, the tokens equal the frozen
    control's and the materialize oracle's, and the phase-B ratio beats
    the frozen one's."""
    _, cp, _, tp = smoke
    runs = {}
    for name, kw in (("frozen", dict(kv_refresh=False)),
                     ("refresh", dict(kv_refresh=True)),
                     ("oracle", dict(kv_refresh=True, kv_fused=False))):
        eng = ServeEngine(cp, tp, device="cpu", **ENGINE_KW, **kw)
        runs[name] = (eng, *_two_phase(eng, Request, cp.vocab_size))
    er, (ra, rb), tr = runs["refresh"]
    ef, (fa, fb), tf = runs["frozen"]
    eo, _, to = runs["oracle"]
    assert er.stats["kv_refreshes"] > 0 and er.stats["kv_pages_repacked"] > 0
    assert er.kv.generation >= 1
    assert tr == tf == to
    assert eo.stats["kv_pages_repacked"] == er.stats["kv_pages_repacked"]
    assert eo.kv.traffic == er.kv.traffic
    assert rb < fb and rb < ra
    assert er.kv.pool.free_count == er.kv.pool.num_pages


@pytest.mark.parametrize("fused", [True, False])
def test_short_two_phase_serve_equals_the_reference(smoke, fused):
    """A two-phase serve short enough for lockstep (two requests a phase,
    eight tokens each) with refresh firing every four sealed pages: the
    port's tokens, engine stats and KV traffic equal the JAX engine's."""
    cj, cp, params, tp = smoke
    kw = dict(max_batch=2, max_len=40, kv_page_size=4, kv_calib_pages=1,
              kv_refresh=True, kv_refresh_every_pages=4,
              kv_refresh_min_pages=4, kv_repack_budget=3, kv_fused=fused)
    je = JEngine(cj, params, kv_backend="ref", **kw)
    pe = ServeEngine(cp, tp, device="cpu", **kw)
    _, jt = _two_phase(je, JRequest, cp.vocab_size, n=2, max_new=8)
    _, pt = _two_phase(pe, Request, cp.vocab_size, n=2, max_new=8)
    assert pt == jt
    assert pe.stats["kv_refreshes"] > 0 and pe.stats["kv_pages_repacked"] > 0
    keys = ("kv_refreshes", "kv_pages_repacked", "generated", "completed",
            "steps")
    assert {k: pe.stats[k] for k in keys} == {k: je.stats[k] for k in keys}
    ps, js = pe.kv_stats(), je.kv_stats()
    for k in ("kv_ratio", "kv_streams", "kv_repack", "kv_pages_packed",
              "kv_pages_spilled", "kv_spill"):
        assert ps[k] == js[k], k
    assert pe.kv.generation == je.kv.generation >= 1
    np.testing.assert_array_equal(pe.kv.page_gen, je.kv.page_gen)


def test_engine_kv_stats_expose_repack_counters(smoke):
    _, cp, _, tp = smoke
    eng = ServeEngine(cp, tp, device="cpu", max_batch=1, max_len=16,
                      kv_page_size=4, kv_refresh=True)
    assert eng.kv_stats()["kv_repack"] == {
        "read_bytes": 0, "write_bytes": 0, "pages": 0, "kept": 0,
        "refreshes": 0, "generation": 0, "pending": 0}
    assert eng.stats["kv_refreshes"] == eng.stats["kv_pages_repacked"] == 0


def test_repack_step_makes_one_device_to_host_call(smoke, monkeypatch):
    """A step that re-packs and seals nothing pulls once: the tokens and
    the re-pack's verdicts and bit counts together (one ``.cpu()``, one
    ``transfers["d2h_calls"]``), no ``.item()`` or ``.tolist()``."""
    _, cp, _, tp = smoke
    rng = np.random.default_rng(12)
    eng = ServeEngine(cp, tp, device="cpu", max_batch=1, max_len=64,
                      kv_page_size=4, kv_calib_pages=1, kv_refresh=True,
                      kv_refresh_every_pages=4, kv_refresh_min_pages=4,
                      kv_repack_budget=1)
    eng.submit(Request(rid=0, prompt=rng.integers(
        0, cp.vocab_size, 9).astype(np.int32), max_new_tokens=40))
    eng.step()
    for _ in range(200):
        if eng.kv._repack_queue and int(eng.positions[0]) % 4 != 3:
            break
        eng.step()
    else:
        pytest.fail("never reached a re-pack step that seals nothing")
    calls = {"cpu": 0, "item": 0, "tolist": 0}

    def counting(name, orig):
        def f(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        return f
    for name in calls:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    d2h = eng.kv.transfers["d2h_calls"]
    repacked = eng.stats["kv_pages_repacked"]
    eng.step()
    assert eng.stats["kv_pages_repacked"] == repacked + 1
    assert calls == {"cpu": 1, "item": 0, "tolist": 0}
    assert eng.kv.transfers["d2h_calls"] == d2h + 1
