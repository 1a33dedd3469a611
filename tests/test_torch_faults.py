"""The host spill tier, integrity checks, pressure escalation, deadlines,
the watchdog and fault injection in the port, against the JAX package on
the CPU: the cases of ``tests/test_faults.py``.

At the cache level both packages are fed the same tokens and must agree
exactly: spilled records (state, fill, layer, generation, payload arrays
in the JAX package's dtypes, and so the CRC of ``payload_crc``), handles,
free-list order, readahead and traffic counters, and the page checksums
stamped with ``verify_on_repack``.  At the engine level a spilled and
resumed request's tokens equal the uninterrupted run's, a detected
corruption fails only its owner, and the pressure rotation through an
undersized pool gives the uncontended tokens and the JAX engine's stats
(a short run: XLA's and PyTorch's CPU ``exp`` can differ in the last f32
bit, ROADMAP §3)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import modules as jm
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch import configs as pconfigs
from repro_torch.models import model as PM
from repro_torch.models import modules as m
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import StragglerWatchdog, WatchdogEvent
from repro_torch.serve import (AdmissionImpossible, FaultInjector,
                               PageIntegrityError, Request, ServeEngine,
                               TransferDropped)


def _cfgs(arch="qwen3-1.7b"):
    if arch == "hetero":
        cj, cp = (jconfigs.get_hetero_smoke_config(),
                  pconfigs.get_hetero_smoke_config())
    else:
        cj, cp = (jconfigs.get_smoke_config(arch),
                  pconfigs.get_smoke_config(arch))
    return (dataclasses.replace(cj, kv_cache_dtype="apack-int8"),
            dataclasses.replace(cp, kv_cache_dtype="apack-int8"))


def _random_token(rng, kv, lo=0.01, hi=0.02):
    h, dh, n = kv.pool.kv_heads, kv.pool.head_dim, kv.n_layers
    return (rng.integers(-127, 128, (n, h, dh)).astype(np.int8),
            rng.integers(-127, 128, (n, h, dh)).astype(np.int8),
            rng.uniform(lo, hi, (n, h)).astype(np.float32),
            rng.uniform(lo, hi, (n, h)).astype(np.float32))


def _pair(n_tokens=16, num_pages=64, calib_pages=1, packed=True, **kw):
    """A JAX cache and the port's fed the same random tokens: at least one
    PACKED page on the first layer, unless ``packed`` is False."""
    cj, cp = _cfgs()
    pair = (JM.PagedKVCache(cj, num_pages=num_pages, page_size=4,
                            calib_pages=calib_pages, **kw),
            PM.PagedKVCache(cp, num_pages=num_pages, page_size=4,
                            calib_pages=calib_pages, device="cpu", **kw))
    rng = np.random.default_rng(3)
    for kv in pair:
        kv.add_request(0)
    for _ in range(n_tokens):
        tok = _random_token(rng, pair[0])
        for kv in pair:
            kv.append_token(0, *tok)
    layer = pair[1].attn_layers[0]
    assert bool(pair[1]._packed[layer]) == packed
    return pair, layer


def _port_page(pool, pid) -> dict:
    return {k: pool.plane(k)[:, pid].clone() for k in
            ("sym", "ofs", "sym_bits", "ofs_bits", "stored", "page_scale")}


def _assert_records_equal(jrec, prec):
    for f in ("state", "fill", "layer", "gen", "comp_bytes", "raw_bytes",
              "crc"):
        assert getattr(prec, f) == getattr(jrec, f), f
    assert sorted(prec.payload) == sorted(jrec.payload)
    for k, v in jrec.payload.items():
        assert prec.payload[k].dtype == v.dtype, k
        np.testing.assert_array_equal(prec.payload[k], v, err_msg=k)


# --------------------------------------------------- pool + tier plumbing
def test_pool_spill_adopt_roundtrip_is_bit_exact():
    """A PACKED page's planes survive spill -> adopt unchanged, and its
    spilled payload (keys, JAX dtypes, bytes) and CRC are the JAX pool's
    for the same page."""
    (jk, pk), layer = _pair()
    pid = min(pk._packed[layer])
    pool = pk.pool
    want = _port_page(pool, pid)
    d2h = pk.transfers["d2h_calls"]
    [(st, fill, payload, comp)] = pool.spill([pid], pk._fetch)
    assert pk.transfers["d2h_calls"] == d2h + 1
    jst, jfill, jpayload, jcomp = jk.pool.spill(pid)
    assert (st, fill, comp) == (jst, jfill, jcomp)
    assert st == m.PAGE_PACKED and pool.state[pid] == m.PAGE_FREE
    _assert_records_equal(
        jm.SpillRecord(jst, jfill, 0, 0, jpayload, jcomp, 0,
                       crc=jm.payload_crc(jpayload)),
        m.SpillRecord(st, fill, 0, 0, payload, comp, 0,
                      crc=m.payload_crc(payload)))
    [pid2] = pool.adopt([(st, fill, payload)], pk._put)
    assert pid2 == jk.pool.adopt(jst, jfill, jpayload)
    got = _port_page(pool, pid2)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert pool.state[pid2] == m.PAGE_PACKED and pool.fill[pid2] == fill
    assert pool.spill_count == pool.unspill_count == 1
    assert pool.packed_bits[pid2] == int(want["sym_bits"].sum()
                                         + want["ofs_bits"].sum())


def test_adopt_into_exhausted_pool_is_a_hard_error():
    (_, pk), layer = _pair()
    pid = min(pk._packed[layer])
    [(st, fill, payload, _)] = pk.pool.spill([pid], pk._fetch)
    while pk.pool.free_count:
        pk.pool.alloc()
    with pytest.raises(RuntimeError, match="re-reserve"):
        pk.pool.adopt([(st, fill, payload)], pk._put)


def test_checksum_detects_bit_flip_and_quarantines():
    tier = m.HostSpillTier()
    inj = FaultInjector()
    payload = {"a": np.arange(64, dtype=np.uint8),
               "b": np.ones(8, np.float32)}
    rec = m.SpillRecord(state=m.PAGE_PACKED, fill=4, layer=0, gen=0,
                        payload=payload, comp_bytes=64, raw_bytes=256)
    h = tier.put(rec)
    assert rec.crc == jm.payload_crc(payload)
    assert tier.get(h) is rec
    inj.flip_bit(tier, h, array="a", bit=13)
    with pytest.raises(PageIntegrityError, match="checksum"):
        tier.get(h)
    assert h in tier.quarantined
    assert tier.live_count == 0 and tier.live_bytes == 0
    assert tier.integrity_failures == 1
    with pytest.raises(KeyError, match="quarantined=True"):
        tier.get(h)


def test_poisoned_generation_refused_at_read_time():
    """An out-of-pool table generation never reaches a decoding kernel:
    ``materialize`` and ``step_meta`` raise for the owning request."""
    (_, pk), layer = _pair()
    pid = min(pk._packed[layer])
    inj = FaultInjector()
    inj.poison_generation(pk, pid)
    with pytest.raises(PageIntegrityError, match="poisoned table") as ei:
        pk.materialize([0], 32)
    assert ei.value.rid == 0
    with pytest.raises(PageIntegrityError, match="poisoned table"):
        pk.step_meta([0], 32)
    assert inj.stats["generations_poisoned"] == 1


def test_verify_on_repack_catches_in_place_corruption():
    """With ``verify_on_repack`` every pack stamps the JAX package's page
    checksum (the planes ride the pack's pull); a resident PACKED page
    flipped in place fails it before the re-pack decodes it, and the next
    queued page re-packs as the JAX cache's does."""
    (jk, pk), layer = _pair(verify_on_repack=True, refresh_every_pages=1,
                            refresh_min_pages=1)
    for pid in (p for s in pk._packed for p in s):
        assert pk.page_crc[pid] == jk.page_crc[pid] != 0
    assert pk.maybe_refresh() == jk.maybe_refresh() != []
    assert list(pk._repack_queue) == list(jk._repack_queue)
    layer, pid = pk._repack_queue[0]
    FaultInjector().corrupt_packed_page(pk, pid, bit=5)
    JFaultInjector().corrupt_packed_page(jk, pid, bit=5)
    assert torch.equal(pk.pool.plane("sym")[0, pid].view(torch.int32),
                       torch.from_numpy(jk.pool.sym[0, pid].view(np.int32)))
    for kv, err in ((jk, jm.PageIntegrityError), (pk, PageIntegrityError)):
        with pytest.raises(err, match="re-pack") as ei:
            kv.repack_pending(1, force=True)
        assert ei.value.rid == 0 and ei.value.pid == pid
    assert pk.traffic["kv_integrity_failures"] == 1
    layer, other = pk._repack_queue[0]                    # a clean page
    assert pk.repack_pending(1, force=True) == \
        jk.repack_pending(1, force=True) == 1
    assert pk.page_gen[other] == jk.page_gen[other] == 1
    assert pk.page_crc[other] == jk.page_crc[other]
    assert pk.traffic == jk.traffic


def test_transfer_drops_are_retried_then_propagate():
    _, cp = _cfgs()
    kv = PM.PagedKVCache(cp, num_pages=8, page_size=4, calib_pages=1,
                         transfer_retries=2, device="cpu")
    inj = FaultInjector()
    kv.faults = inj
    inj.drop_transfers("h2d", 2)
    kv._put(np.zeros(4, np.float32))
    assert kv.traffic["kv_transfer_drops"] == 2
    assert kv.traffic["kv_transfer_retries"] == 2
    assert inj.stats["h2d_dropped"] == 2
    inj.drop_transfers("d2h", 3)
    with pytest.raises(TransferDropped):
        kv._fetch(torch.zeros(4))
    assert kv.traffic["kv_transfer_drops"] == 5


def test_spill_and_readahead_equal_the_reference():
    """A request with HOT, COLD and PACKED pages (calibration waits for 3
    pages) spilled and unspilled in both caches: the same records and
    handles, free-list order, page tables after readahead, pool states,
    planes and traffic; one pull for the spill, one upload for the
    readahead.  The COLD pages of a layer that calibrated while they were
    parked pack at readahead."""
    (jk, pk), layer = _pair(n_tokens=10, calib_pages=3,
                               packed=False)
    assert {int(pk.pool.state[p]) for p in pk.page_tables[0][layer]} == \
        {m.PAGE_HOT, m.PAGE_COLD}
    d2h = pk.transfers["d2h_calls"]
    assert pk.spill_request(0) == jk.spill_request(0) > 0
    assert pk.transfers["d2h_calls"] == d2h + 1
    assert pk.page_tables == jk.page_tables
    assert pk.pool.free_list == jk.pool.free_lists[0]
    for h, rec in jk.spill_tier._records.items():
        _assert_records_equal(rec, pk.spill_tier._records[h])
    # another request calibrates every layer while request 0 is parked
    rng = np.random.default_rng(4)
    for kv in (jk, pk):
        kv.add_request(1)
    for _ in range(12):
        tok = _random_token(rng, jk)
        for kv in (jk, pk):
            kv.append_token(1, *tok)
    h2d = pk.transfers["h2d_calls"]
    restored = pk.unspill_request(0)
    assert restored == jk.unspill_request(0)
    assert pk.page_tables == jk.page_tables
    np.testing.assert_array_equal(pk.pool.state, jk.pool.state)
    np.testing.assert_array_equal(pk.page_gen, jk.page_gen)
    assert pk.traffic == jk.traffic
    assert pk.stream_stats()["spill"] == jk.stream_stats()["spill"]
    assert pk.spill_tier.live_count == 0
    for pid in restored:
        if pk.pool.state[pid] == m.PAGE_PACKED:
            got = _port_page(pk.pool, pid)
            np.testing.assert_array_equal(
                got["sym"].numpy().view(np.uint32), jk.pool.sym[:, pid])
            np.testing.assert_array_equal(got["page_scale"].numpy(),
                                          jk.pool.page_scale[:, pid])
    # one upload of the payloads, plus the packing's table rows
    assert pk.transfers["h2d_calls"] - h2d == 2


# --------------------------------------------- spill -> resume, end to end
def _mk_engine(cfg, params, max_batch=2, max_len=32, **kw):
    return ServeEngine(cfg, params, max_batch=max_batch, max_len=max_len,
                       kv_page_size=4, kv_calib_pages=2, device="cpu", **kw)


@pytest.fixture(scope="module")
def qwen():
    cj, cp = _cfgs()
    params = jax.jit(JM.init_params, static_argnums=0)(
        jconfigs.get_smoke_config("qwen3-1.7b"), jax.random.PRNGKey(0))
    return cj, cp, params, params_from_numpy(
        cp, jax.tree.map(np.array, params), "cpu")


def _run_spill(cfg, params, *, spill_at=None):
    eng = _mk_engine(cfg, params, max_batch=2, max_len=40)
    rng = np.random.default_rng(7)
    r = Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, 10)
                .astype(np.int32), max_new_tokens=10)
    eng.submit(r)
    for step in range(120):
        if r.done:
            break
        if step == spill_at and eng.active[0] is not None:
            eng.preempt(0, spill=True)
        eng.step()
        eng._retire()
    return r, eng


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hetero"])
def test_spill_resume_is_token_identical(arch, qwen):
    """Preempt with spill mid-decode and resume: the tokens equal the
    uninterrupted run's, the spill and readahead streams stay out of the
    KV read accounting, and (hetero) the recurrent state rides the
    snapshot."""
    if arch == "hetero":
        cp = _cfgs("hetero")[1]
        params = PM.init_params(cp, torch.Generator().manual_seed(0), "cpu")
    else:
        cp, params = qwen[1], qwen[3]
    base, ctrl = _run_spill(cp, params)
    toks, eng = _run_spill(cp, params, spill_at=4)
    assert toks.tokens == base.tokens and toks.error is None
    assert eng.stats["spilled_requests"] == eng.stats["resumed"] == 1
    ks, ks0 = eng.kv_stats(), ctrl.kv_stats()
    sp = ks["kv_spill"]
    assert sp["pages"] > 0 and sp["calls"] >= 1
    assert sp["readahead_pages"] == sp["pages"]
    assert 0 < sp["spill_bytes"] < sp["raw_bytes"]
    assert ks["kv_read_bytes"] == ks0["kv_read_bytes"]
    assert ks["kv_raw_bytes"] == ks0["kv_raw_bytes"]
    assert ks["kv_ratio"] == ks0["kv_ratio"]
    assert eng.kv.spill_tier.live_count == 0
    assert ks["kv_pages_spilled"] == ks["kv_pages_unspilled"]
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages
    if arch == "hetero":
        assert ks["kv_streams"]["state"]["snapshots"] == 1


def test_bit_flip_fails_only_the_owning_request(qwen):
    """Host memory corrupted under a parked page: the owner comes back with
    a structured error, its batchmate's tokens are untouched, the pool and
    tier drain (the evidence kept)."""
    _, cp, _, tp = qwen

    def run(corrupt):
        eng = _mk_engine(cp, tp, max_batch=2, max_len=40)
        rng = np.random.default_rng(9)
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, cp.vocab_size, 8).astype(np.int32), max_new_tokens=8)
                for i in range(2)]
        for r in reqs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        eng.preempt(0, spill=True)
        if corrupt:
            handles = [-e - 1 for pids in eng.kv.page_tables[0]
                       for e in pids if e < 0]
            assert handles, "spill left no tier handles"
            FaultInjector().flip_bit(eng.kv.spill_tier, handles[0])
        eng.run_until_drained(max_steps=200)
        return reqs, eng

    ctrl, _ = run(corrupt=False)
    reqs, eng = run(corrupt=True)
    assert reqs[0].done and "checksum" in (reqs[0].error or "")
    assert eng.stats["failed"] == 1
    assert reqs[1].error is None and reqs[1].tokens == ctrl[1].tokens
    ks = eng.kv_stats()
    assert ks["kv_integrity_failures"] == ks["kv_quarantined_pages"] == 1
    assert len(eng.kv.spill_tier.quarantined) == 1
    assert eng.kv.spill_tier.live_count == 0
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages
    assert eng._reserved_total == 0


def test_poisoned_generation_fails_owner_in_step_loop(qwen):
    _, cp, _, tp = qwen
    eng = _mk_engine(cp, tp, max_batch=2, max_len=40)
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cp.vocab_size, 8).astype(np.int32), max_new_tokens=8)
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    layer = eng.kv.attn_layers[0]
    FaultInjector().poison_generation(eng.kv, eng.kv.page_tables[0][layer][0])
    eng.run_until_drained(max_steps=200)
    assert reqs[0].done and "poisoned" in (reqs[0].error or "")
    assert eng.stats["failed"] == 1
    assert reqs[1].done and reqs[1].error is None
    assert len(reqs[1].tokens) >= 8


# ------------------------------------------------- pressure + scheduling
def test_watchdog_preempts_hung_slot_and_recovers(qwen):
    _, cp, _, tp = qwen

    def run(inj):
        eng = _mk_engine(cp, tp, max_batch=2, max_len=48,
                         watchdog_ratio=4.0, watchdog_patience=2, faults=inj)
        rng = np.random.default_rng(5)
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, cp.vocab_size, 8).astype(np.int32),
                    max_new_tokens=14) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        for _ in range(9):
            eng.step()
        if inj is not None:
            # a stall far past the watchdog's ratio of the trailing median
            # step, whatever the host's load (a CPU step is ~0.1 s alone)
            wd = eng.watchdog
            inj.delay_steps(max(1.5, 2 * wd.ratio * float(
                np.median(wd.step_times[-8:]))), n=3)
        eng.run_until_drained(max_steps=300)
        return reqs, eng

    ctrl, _ = run(None)
    reqs, eng = run(FaultInjector())
    assert eng.stats["watchdog_preempted"] >= 1
    assert eng.stats["spilled_requests"] >= 1
    assert all(r.done and r.error is None for r in reqs)
    for r, c in zip(reqs, ctrl):
        assert r.tokens == c.tokens
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages


@pytest.mark.parametrize("pressure", [True, False])
def test_blocked_admission_raises_instead_of_spinning(qwen, pressure):
    """An outside hold on the whole pool: with ``kv_pressure`` the
    escalation raises ``AdmissionImpossible`` naming the request; without
    it ``run_until_drained`` gives up after bounded patience."""
    _, cp, _, tp = qwen
    eng = _mk_engine(cp, tp, max_batch=1, max_len=24, kv_pressure=pressure,
                     pressure_backoff_max=4)
    eng._reserved[999] = eng.kv.pool.num_pages
    eng._reserved_total = eng.kv.pool.num_pages
    eng.submit(Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                       max_new_tokens=4))
    with pytest.raises(AdmissionImpossible,
                       match="no active slots" if pressure
                       else "no-progress") as ei:
        eng.run_until_drained(max_steps=100)
    assert ei.value.rid == 0 and ei.value.pages_needed > 0


def test_pressure_rotation_equals_the_reference(qwen):
    """Pool at about half the working set, ``kv_pressure`` and a deadline:
    preempt-with-spill rotation drains every request with the uncontended
    run's tokens, and the tokens, stats and spill accounting equal the JAX
    engine's."""
    cj, cp, params, tp = qwen
    per_req = PM.PagedKVCache.pages_for_config(cp, 12, 4)
    kw = dict(max_batch=3, max_len=16, kv_page_size=4, kv_calib_pages=2)

    def reqs(cls):
        rng = np.random.default_rng(11)
        return [cls(rid=i, prompt=rng.integers(0, cp.vocab_size, 8)
                    .astype(np.int32), max_new_tokens=4) for i in range(3)]

    ctrl = reqs(Request)
    eng0 = ServeEngine(cp, tp, device="cpu", **kw)
    for r in ctrl:
        eng0.submit(r)
    eng0.run_until_drained(max_steps=400)
    pk = dict(kv_pages=max(per_req, (3 * per_req) // 2), kv_pressure=True,
              slot_deadline_steps=4)
    pe = ServeEngine(cp, tp, device="cpu", **kw, **pk)
    je = JEngine(cj, params, kv_backend="ref", **kw, **pk)
    pr, jr = reqs(Request), reqs(JRequest)
    for a, b in zip(pr, jr):
        pe.submit(a)
        je.submit(b)
    pe.run_until_drained(max_steps=400)
    je.run_until_drained(max_steps=400)
    assert all(r.done and r.error is None for r in pr)
    assert [r.tokens for r in pr] == [r.tokens for r in ctrl] == \
        [r.tokens for r in jr]
    for k in ("preempted", "resumed", "spilled_requests", "failed",
              "pressure_preempted", "deadline_preempted",
              "kv_admission_blocked", "admission_retries", "steps"):
        assert pe.stats[k] == je.stats[k], k
    ps, js = pe.kv_stats(), je.kv_stats()
    for k in ("kv_spill", "kv_pages_spilled", "kv_pages_unspilled",
              "kv_ratio", "kv_streams"):
        assert ps[k] == js[k], k
    assert ps["kv_spill"]["pages"] > 0 and pe.stats["preempted"] > 0
    assert pe.kv.pool.free_count == pe.kv.pool.num_pages
    assert pe.kv.spill_tier.live_count == 0


# ------------------------------------------------ shared watchdog events
def test_straggler_watchdog_events_and_escalation():
    seen = []
    wd = StragglerWatchdog(ratio=5.0, patience=3, window=8,
                           on_event=seen.append)
    for _ in range(8):
        assert wd.observe(0.01) is None
    ev = wd.observe(1.0)
    assert isinstance(ev, WatchdogEvent)
    assert ev.kind == "straggler" and ev.consecutive == 1
    assert wd.observe(0.01) is None and wd.events == 0
    evs = [wd.observe(dt) for dt in (1.0, 10.0, 100.0)]
    assert [e.kind for e in evs] == ["straggler", "straggler", "hung"]
    assert evs[-1].consecutive == 3 and seen[-1].kind == "hung"
    assert len(wd.event_log) == 4
    wd.reset()
    assert wd.events == 0
