"""Table refresh, pressure preemption, verify-on-repack and faults on the
port's serving mesh (``make_debug_mesh(..., device="cpu")``, every shard
on the CPU, one controller), against the JAX package's single-device
engine with the same options:

- refresh (qwen3-1.7b SMOKE on 2 x 2 and 4 x 1; the two-phase drift
  traffic of ``tests/test_table_refresh.py``, two requests at a time,
  refresh every 4 sealed pages, a re-pack budget that takes every queued
  page in its step): tokens, refreshes, pages re-packed and kept,
  ``kv_ratio``, the stream stats and the generation equal the JAX
  engine's; each re-pack batch runs one decode and one encode call a
  data shard holding its pages, on that shard's lead device; so for
  ``hetero-serve-smoke`` (global, rolling and recurrent layers) on 2 x 2;
- pressure (qwen3 SMOKE, ``kv_pressure`` with spill and a slot deadline,
  a phase's two requests on data shard 0, whose pages hold one of them at
  worst): level 2 preempts, every preempted request resumes, and the
  tokens equal the JAX engine's;
- verify and faults (qwen3 SMOKE, ``kv_verify_on_repack`` with refresh):
  one ``corrupt_packed_page`` on a PACKED page of data shard 1 flips the
  bit on every model shard's copy; its owner fails with
  ``PageIntegrityError`` and the other requests' tokens equal the JAX
  engine's unfaulted run; so for a poisoned generation.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as PM
from repro_torch.models import modules as pm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import FaultInjector, Request, ServeEngine

REFRESH = dict(max_len=40, kv_page_size=4, kv_calib_pages=1,
               kv_refresh=True, kv_refresh_every_pages=4,
               kv_refresh_min_pages=4, kv_repack_budget=64)


def _cfg(arch, jax_pkg=False):
    get = jconfigs.get_smoke_config if jax_pkg else get_smoke_config
    return dataclasses.replace(get(arch), kv_cache_dtype="apack-int8")


def _phases(vocab, n=2):
    """Diverse prompts, then one repeated hot prompt (the drift)."""
    rng = np.random.default_rng(11)
    return ([rng.integers(0, vocab, 9).astype(np.int32) for _ in range(n)],
            [np.full(9, 7, np.int32)] * n)


def _two_phase(eng, cls, vocab, hook=None, max_new=6):
    """Serve each phase's requests to the end, ``hook(eng, reqs)`` after
    the drift phase's second step."""
    reqs = []
    for p, prompts in enumerate(_phases(vocab)):
        batch = [cls(100 * p + i, x, max_new_tokens=max_new)
                 for i, x in enumerate(prompts)]
        for r in batch:
            eng.submit(r)
        if hook is not None and p == 1:
            for _ in range(2):
                eng.step()
            hook(eng, batch)
        eng.run_until_drained(max_steps=300)
        reqs += batch
    return reqs


@pytest.fixture(scope="module")
def ref():
    """The port's params of both archs and the JAX single-device engine's
    two-phase refresh serve of each (two requests at a time)."""
    out = {}
    for arch in ("qwen3-1.7b", "hetero-serve-smoke"):
        cj, cp = _cfg(arch, True), _cfg(arch)
        params = jax.jit(JM.init_params, static_argnums=0)(
            cj, jax.random.PRNGKey(0))
        tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
        eng = JEngine(cj, params, kv_backend="ref", max_batch=2, **REFRESH)
        reqs = _two_phase(eng, JRequest, cj.vocab_size)
        out[arch] = {"cfg": cp, "params": tp, "eng": eng,
                     "tokens": [r.tokens for r in reqs]}
    return out


def _engine(a, shape, **kw):
    """A mesh engine whose requests run two at a time as the reference's:
    on 2 x 2 one slot a data shard, on 4 x 1 the first two data shards'
    slots."""
    return ServeEngine(a["cfg"], a["params"], device="cpu",
                       mesh=make_debug_mesh(*shape, device="cpu"),
                       max_batch=shape[0], **kw)


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", (2, 2)),
                                        ("qwen3-1.7b", (4, 1)),
                                        ("hetero-serve-smoke", (2, 2))])
def test_refresh_on_the_mesh_equals_the_reference(ref, arch, shape,
                                                  monkeypatch):
    a = ref[arch]
    eng = _engine(a, shape, **REFRESH)
    pool = eng.kv.pool
    calls = []
    launch = PM.PagedKVCache._launch_repack

    def spy(self, items, force):
        # every re-pack batch: one decode and one encode call a data shard
        # holding its pages, each on that shard's lead device
        groups = self.pool.index([pid for _, pid in items])
        calls.append(sorted(s for s, _, _ in groups))
        dec, enc = [], []
        d0, e0 = PM.apack_decode.decode, PM.apack_encode.encode
        monkeypatch.setattr(PM.apack_decode, "decode", lambda *x, **k: (
            dec.append(x[0].device), d0(*x, **k))[1])
        monkeypatch.setattr(PM.apack_encode, "encode", lambda *x, **k: (
            enc.append(x[0].device), e0(*x, **k))[1])
        job = launch(self, items, force)
        monkeypatch.setattr(PM.apack_decode, "decode", d0)
        monkeypatch.setattr(PM.apack_encode, "encode", e0)
        assert len(dec) == len(enc) == len(groups)
        assert dec == enc == [self.pool.lead(s) for s, _, _ in groups]
        return job
    monkeypatch.setattr(PM.PagedKVCache, "_launch_repack", spy)
    reqs = _two_phase(eng, Request, a["cfg"].vocab_size)
    assert [r.tokens for r in reqs] == a["tokens"]
    assert all(r.error is None for r in reqs)
    ref_eng = a["eng"]
    for k in ("kv_refreshes", "kv_pages_repacked", "generated", "steps"):
        assert eng.stats[k] == ref_eng.stats[k], k
    assert eng.stats["kv_refreshes"] > 0
    ps, js = eng.kv_stats(), ref_eng.kv_stats()
    for k in ("kv_ratio", "kv_repack", "kv_pages_packed", "kv_streams"):
        assert ps[k] == js[k], k
    assert eng.kv.generation == ref_eng.kv.generation >= 1
    assert [0, 1] in calls
    assert pool.free_count == pool.num_pages


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_pressure_on_the_mesh_preempts_and_resumes(ref, shape):
    """Two slots a data shard, both requests of a phase on shard 0, whose
    12 pages hold one request's 10 at worst: level 2 preempts with spill
    and rotates them."""
    a = ref["qwen3-1.7b"]
    n_data = shape[0]
    eng = ServeEngine(a["cfg"], a["params"], device="cpu",
                      mesh=make_debug_mesh(*shape, device="cpu"),
                      max_batch=2 * n_data, max_len=40, kv_page_size=4,
                      kv_calib_pages=2, kv_pages=12 * n_data,
                      kv_pressure=True, slot_deadline_steps=4)
    reqs = _two_phase(eng, Request, a["cfg"].vocab_size)
    assert all(r.done and r.error is None for r in reqs)
    assert [r.tokens for r in reqs] == a["tokens"]
    st = eng.stats
    assert st["pressure_preempted"] > 0
    assert st["resumed"] == st["preempted"] == st["spilled_requests"]
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages
    assert eng.kv.spill_tier.live_count == 0


@pytest.mark.parametrize("shape,fault", [((2, 2), "corrupt"),
                                         ((4, 1), "corrupt"),
                                         ((2, 2), "poison")])
def test_fault_on_shard_1_fails_only_its_owner(ref, shape, fault):
    """With ``kv_verify_on_repack`` and refresh every 2 sealed pages (the
    drift phase's next seal re-packs every PACKED page; tokens do not
    depend on when tables refresh): a fault on a PACKED page of data
    shard 1 (request 1's) fails its owner alone; a flipped bit lands in
    every model shard's copy of the page."""
    a = ref["qwen3-1.7b"]
    inj = FaultInjector()
    eng = _engine(a, shape, faults=inj, kv_verify_on_repack=True,
                  **dict(REFRESH, kv_refresh_every_pages=2,
                         kv_refresh_min_pages=2))
    hit = {}

    def inject(eng, batch):
        pool, kv = eng.kv.pool, eng.kv
        rid = batch[1].rid
        pid = next(p for layer in kv.attn_layers
                   for p in kv.page_tables[rid][layer]
                   if p >= 0 and pool.state[p] == pm.PAGE_PACKED)
        assert pool.shard_of(pid) == 1
        loc = pid - pool.pages_per_shard
        if fault == "corrupt":
            before = [p["sym"][0, loc].clone() for p in pool.parts[1]]
            inj.corrupt_packed_page(kv, pid)
            for p, b in zip(pool.parts[1], before):
                assert int((p["sym"][0, loc] != b).sum()) == 1
        else:
            inj.poison_generation(kv, pid)
        hit["rid"] = rid
    reqs = _two_phase(eng, Request, a["cfg"].vocab_size, hook=inject)
    want = "checksum" if fault == "corrupt" else "poisoned"
    for r, t in zip(reqs, a["tokens"]):
        if r.rid == hit["rid"]:
            assert r.done and want in (r.error or "")
        else:
            assert r.error is None and r.tokens == t, r.rid
    assert eng.stats["failed"] == 1
    assert eng.kv_stats()["kv_integrity_failures"] == 1
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages
