"""Table refresh and generation-versioned re-pack in the port against the
JAX package, on the CPU.

The cases of ``tests/test_table_refresh.py`` at the cache level: both
caches are fed the same synthetic tokens (constant scales, so a page's
seal keeps the value distribution's shape; ``synth_token`` of that file)
and must agree exactly: drift sketches, triggers, ``generation``,
``gen_rows``, ``table_gen``, ``page_gen``, the stacked table rows, the
re-packed planes, the kept/swapped counts and every traffic counter.  The
engine cases are in ``test_torch_refresh_engine.py``."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import fastpath as jfastpath
from repro.models import model as JM
from repro_torch.configs import get_smoke_config
from repro_torch.core import format as pfmt
from repro_torch.kernels import fastpath as pfastpath
from repro_torch.models import model as PM

PLANES = ("sym", "ofs", "sym_bits", "ofs_bits", "stored", "page_scale")


def _cfgs():
    cj = dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                             kv_cache_dtype="apack-int8")
    cp = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                             kv_cache_dtype="apack-int8")
    return cj, cp


def make_pair(**kw):
    """A JAX cache and the port's, built alike."""
    cj, cp = _cfgs()
    kw.setdefault("page_size", 4)
    kw.setdefault("calib_pages", 2)
    return (JM.PagedKVCache(cj, num_pages=256, **kw),
            PM.PagedKVCache(cp, num_pages=256, device="cpu", **kw))


def synth_token(rng, kv, mode):
    """``tests/test_table_refresh.py::synth_token``: peaked (a 5-point
    lattice), shifted (another, 7-point one) or broad (uniform int8)."""
    h, dh, n = kv.pool.kv_heads, kv.pool.head_dim, kv.n_layers
    if mode == "peaked":
        q = (64 * rng.integers(-2, 3, (n, h, dh))).clip(-127, 127)
    elif mode == "shifted":
        q = (32 * rng.integers(-3, 4, (n, h, dh))).clip(-127, 127)
    else:
        q = rng.integers(-127, 128, (n, h, dh))
    q = q.astype(np.int8)
    s = np.full((n, h), 0.01, np.float32)
    return q, q.copy(), s, s.copy()


def feed(pair, rid, rng, n_tokens, mode):
    for _ in range(n_tokens):
        tok = synth_token(rng, pair[0], mode)
        for kv in pair:
            kv.append_token(rid, *tok)


def add(pair, rid):
    for kv in pair:
        kv.add_request(rid)


def port_planes(kv, pid) -> dict:
    p = kv.pool
    out = {k: p.plane(k)[:, pid].numpy() for k in PLANES}
    out["sym"], out["ofs"] = out["sym"].view(np.uint32), \
        out["ofs"].view(np.uint32)
    out["stored"] = out["stored"].astype(bool)
    return out


def assert_same(jk, pk):
    """Every piece of refresh state, and every PACKED page's planes, equal
    between the two caches."""
    assert pk.generation == jk.generation
    assert pk.gen_rows == jk.gen_rows
    np.testing.assert_array_equal(pk.table_gen, jk.table_gen)
    np.testing.assert_array_equal(pk.page_gen, jk.page_gen)
    np.testing.assert_array_equal(pk.drift_hists, jk.drift_hists)
    np.testing.assert_array_equal(pk.drift_pages, jk.drift_pages)
    np.testing.assert_array_equal(pk.calib_bits, jk.calib_bits)
    assert list(pk._repack_queue) == list(jk._repack_queue)
    assert pk._packed == jk._packed and pk._cold == jk._cold
    for a, b in zip(pk._tables_stacked(), jk._tables_stacked()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pk.pool.state, jk.pool.state)
    for layer in pk.attn_layers:
        for pid in pk._packed[layer]:
            got = port_planes(pk, pid)
            for k in PLANES:
                np.testing.assert_array_equal(
                    got[k], getattr(jk.pool, k)[:, pid], err_msg=(pid, k))
    assert pk.traffic == jk.traffic
    assert pk.stream_stats() == jk.stream_stats()


def refresh_step(pair, budget=None) -> int:
    """One ``refresh_step`` of each cache, the port's re-pack job pulled
    and finished as the engine does: the same layers refreshed and the
    same pages re-packed.  Returns that page count."""
    jk, pk = pair
    want = jk.refresh_step(budget)
    rs = pk.refresh_step(budget)
    job = rs["job"]
    got = pk.finish_refresh(rs, None if job is None
                            else pk._fetch(job["pull"]))
    assert rs["refreshed_layers"] == want["refreshed_layers"]
    assert got == want["repacked"]
    return got


def page_tensor(kv, layer, kind, pid) -> pfmt.CompressedTensor:
    """One PACKED port page as a ``CompressedTensor`` coded with the table
    of its ``page_gen``, the ``decompress_np`` round-trip oracle."""
    p = kv.pool
    return pfmt.CompressedTensor(
        shape=(p.page_size, p.kv_heads, p.head_dim), bits=8,
        table=kv._table_at(int(kv.page_gen[pid]), layer, kind),
        elems_per_stream=p.elems_per_stream,
        n_valid=p.n_streams * p.elems_per_stream,
        sym_plane=p.plane("sym")[kind, pid].numpy().view(np.uint32).copy(),
        ofs_plane=p.plane("ofs")[kind, pid].numpy().view(np.uint32).copy(),
        sym_bits=p.plane("sym_bits")[kind, pid].numpy().copy(),
        ofs_bits=p.plane("ofs_bits")[kind, pid].numpy().copy(),
        stored=p.plane("stored")[kind, pid].numpy().astype(bool))


# ---------------------------------------------------------- drift monitor
def test_sketch_accumulates_only_after_calibration():
    pair = make_pair()
    rng = np.random.default_rng(0)
    add(pair, 0)
    jk, pk = pair
    layer = pk.attn_layers[0]
    feed(pair, 0, rng, 2 * pk.page_size * pk.calib_pages, "broad")
    assert pk.tables[layer][0] is not None
    base = int(pk.drift_pages[layer])
    feed(pair, 0, rng, 3 * pk.page_size, "broad")
    assert int(pk.drift_pages[layer]) == base + 3
    per_page = pk.page_size * pk.pool.kv_heads * pk.pool.head_dim
    assert pk.drift_hists[layer, 0].sum() == \
        int(pk.drift_pages[layer]) * per_page
    assert_same(jk, pk)


def test_sketch_off_pulls_no_histograms():
    """``drift_sketch=False`` (the engine without ``kv_refresh``): the same
    pages, seals and packs, no sketch, and the packs pull no more bytes
    than the bit counts."""
    cj, cp = _cfgs()
    on = PM.PagedKVCache(cp, 64, page_size=4, calib_pages=2, device="cpu")
    off = PM.PagedKVCache(cp, 64, page_size=4, calib_pages=2, device="cpu",
                          drift_sketch=False)
    rng = np.random.default_rng(0)
    for kv in (on, off):
        kv.add_request(0)
    for _ in range(40):
        tok = synth_token(rng, on, "broad")
        on.append_token(0, *tok)
        off.append_token(0, *tok)
    assert off.drift_pages.sum() == 0 and on.drift_pages.sum() > 0
    assert off.transfers["d2h_calls"] == on.transfers["d2h_calls"]
    assert off.transfers["d2h_bytes"] < on.transfers["d2h_bytes"]
    assert off.traffic == on.traffic


@pytest.mark.parametrize("case", ["regression", "every", "quiet"])
def test_triggers_fire_as_the_reference(case):
    """The regression trigger on a peaked -> broad shift, the every-M-pages
    trigger without drift, and an in-distribution serve that stays quiet:
    ``drift_status``, ``check_refresh`` and ``maybe_refresh`` as the JAX
    cache's."""
    kw = {"regression": dict(refresh_threshold=0.3, refresh_min_pages=4),
          "every": dict(refresh_every_pages=6, refresh_min_pages=2),
          "quiet": dict(refresh_threshold=0.15, refresh_min_pages=4)}[case]
    pair = make_pair(**kw)
    jk, pk = pair
    rng = np.random.default_rng({"regression": 1, "every": 2,
                                 "quiet": 3}[case])
    add(pair, 0)
    if case == "regression":
        feed(pair, 0, rng, 24, "peaked")
        assert pk.check_refresh() == jk.check_refresh() == []
        for kv in pair:
            kv.drift_hists[:] = 0
            kv.drift_pages[:] = 0
        feed(pair, 0, rng, 24, "broad")
        layer = pk.attn_layers[0]
        assert pk.drift_status(layer) == jk.drift_status(layer)
        assert pk.drift_status(layer)["regression"] > 1.3
        assert set(pk.check_refresh()) == set(jk.check_refresh()) \
            == set(pk.attn_layers)
    elif case == "every":
        feed(pair, 0, rng, 8 + 6 * pk.page_size, "broad")
        assert set(pk.check_refresh()) == set(jk.check_refresh()) \
            == set(pk.attn_layers)
    else:
        feed(pair, 0, rng, 48, "broad")
        assert pk.check_refresh() == jk.check_refresh() == []
        assert pk.maybe_refresh() == jk.maybe_refresh() == []
        assert pk.generation == 0
    assert_same(jk, pk)


# --------------------------------------------------------- re-pack
@pytest.fixture(scope="module")
def drifted_once():
    """Both caches after a peaked phase and a shifted one (calibrated on
    the first; the table search is the slow part, so tests take copies)."""
    pair = make_pair(refresh_threshold=0.3, refresh_min_pages=4)
    rng = np.random.default_rng(5)
    add(pair, 0)
    feed(pair, 0, rng, 24, "peaked")
    feed(pair, 0, rng, 24, "shifted")
    refreshed = copy.deepcopy(pair)
    assert refreshed[1].maybe_refresh() == refreshed[0].maybe_refresh() != []
    return pair, refreshed


@pytest.fixture
def drifted(drifted_once):
    return copy.deepcopy(drifted_once[0])


@pytest.fixture
def refreshed(drifted_once):
    return copy.deepcopy(drifted_once[1])


def test_refresh_bumps_generation_resets_sketch_queues_repack(refreshed):
    """After the refresh (peaked calibration, shifted traffic): one
    generation bump for every layer, the sketches reset, every PACKED page
    of a refreshed layer queued once, and two generations' row blocks in
    the stacked tables, as in the JAX cache."""
    jk, pk = refreshed
    assert pk.generation == 1
    assert all(int(pk.table_gen[layer]) == 1 for layer in pk.attn_layers)
    assert all(int(pk.drift_pages[layer]) == 0 for layer in pk.attn_layers)
    assert len(pk._repack_queue) == sum(len(s) for s in pk._packed)
    assert pk._tables_stacked()[0].shape[0] == 2 * pk.n_layers * 2
    assert_same(jk, pk)


def test_repacked_pages_equal_the_reference_and_round_trip(drifted,
                                                           refreshed):
    """One batch re-packs every queued page: the size gate keeps the peaked
    pages and swaps the shifted ones as the JAX cache's page-by-page
    re-pack does, the new planes are bit-identical to it, and every page
    decodes (``fastpath.decompress_np``) to what it held before."""
    pk0 = drifted[1]
    jk, pk = refreshed
    want = {(layer, pid, kind): pfastpath.decompress_np(
        page_tensor(pk0, layer, kind, pid), "cpu")
        for layer in pk0.attn_layers for pid in pk0._packed[layer]
        for kind in (0, 1)}
    d2h = pk.transfers["d2h_calls"]
    n = pk.repack_pending()
    assert n == jk.repack_pending() == len(want) // 2
    assert pk.transfers["d2h_calls"] == d2h + 1        # one batch, one pull
    assert pk.traffic["kv_repack_pages"] > 0
    assert pk.traffic["kv_repack_kept"] > 0
    assert {int(pk.page_gen[p]) for s in pk._packed for p in s} == {0, 1}
    for (layer, pid, kind), w in want.items():
        got = pfastpath.decompress_np(page_tensor(pk, layer, kind, pid),
                                      "cpu")
        np.testing.assert_array_equal(got, w)
    # and the JAX decoder reads the port's re-packed page as its own
    layer = pk.attn_layers[0]
    pid = max(pk._packed[layer], key=lambda p: int(pk.page_gen[p]))
    ct = page_tensor(pk, layer, 0, pid)
    jct = dataclasses.replace(ct, table=jk._table_at(int(jk.page_gen[pid]),
                                                     layer, 0))
    np.testing.assert_array_equal(jfastpath.decompress_np(jct),
                                  want[(layer, pid, 0)])
    assert_same(jk, pk)


def test_budgeted_repack_mixed_generations_decode_identically(drifted,
                                                              refreshed):
    """Part of the queue re-packed: pages of generations 0 and 1 coexist,
    and ``materialize`` (the gather decode with per-page table rows) gives
    the same cache before, in the middle and after, equal to the JAX
    cache's."""
    def both(pair):
        jk, pk = pair
        p = [{f: x.numpy() for f, x in c.items()}
             for c in pk.materialize([0], 64)]
        j = jk.materialize([0], 64)["blocks"][0]
        for layer, c in enumerate(p):
            for f, x in c.items():
                np.testing.assert_array_equal(x, np.asarray(j[f][layer]))
        return p
    pre = both(drifted)
    jk, pk = refreshed
    assert pk.repack_pending(budget=3) == jk.repack_pending(budget=3) == 3
    assert {int(pk.page_gen[p]) for s in pk._packed for p in s} == {0, 1}
    mid = both(refreshed)
    assert pk.repack_pending() == jk.repack_pending() > 0
    post = both(refreshed)
    for a, b in ((pre, mid), (mid, post)):
        for x, y in zip(a, b):
            for f in x:
                np.testing.assert_array_equal(x[f], y[f])
    assert_same(jk, pk)


def test_repack_skips_freed_and_already_current_pages(refreshed):
    jk, pk = refreshed
    layer = pk.attn_layers[0]
    victim = sorted(pk._packed[layer])[0]
    for kv in refreshed:
        kv._packed[layer].discard(victim)
    queued = len(pk._repack_queue)
    done = pk.repack_pending()
    assert done == jk.repack_pending() == queued - 1
    assert int(pk.page_gen[victim]) == 0 and not pk._repack_queue
    swapped = pk.traffic["kv_repack_pages"]
    for kv in refreshed:
        for lyr in kv.attn_layers:
            for pid in kv._packed[lyr]:
                kv._repack_queue.append((lyr, pid))
    redone = pk.repack_pending()
    assert redone == jk.repack_pending() == done - swapped
    assert pk.traffic["kv_repack_pages"] == swapped
    assert_same(jk, pk)


def test_page_queued_twice_matches_the_reference(refreshed):
    """A second refresh queues pages still waiting from the first: the
    port's batch stops at the repeated page and the next batch takes it,
    which leaves the same counts as the reference's page-by-page loop."""
    jk, pk = refreshed
    rng = np.random.default_rng(8)
    for kv in refreshed:
        kv.refresh_every_pages = 2
        kv.repack_pending(budget=2)
    feed(refreshed, 0, rng, 20, "broad")
    assert pk.maybe_refresh() == jk.maybe_refresh() != []
    queue = list(pk._repack_queue)
    assert len(set(queue)) < len(queue)
    for budget in (3, 5, None):
        assert pk.repack_pending(budget) == jk.repack_pending(budget)
        assert_same(jk, pk)


def test_pool_repack_guards_non_packed_pages(drifted):
    _, pk = drifted
    pool = pk.pool
    hot = pool.alloc()
    z = torch.zeros
    planes = (z(2, 1, pool.sym_words, pool.n_streams, dtype=torch.int32),
              z(2, 1, pool.ofs_words, pool.n_streams, dtype=torch.int32),
              z(2, 1, pool.n_streams, dtype=torch.int32),
              z(2, 1, pool.n_streams, dtype=torch.int32),
              z(2, 1, pool.n_streams, dtype=torch.bool))
    with pytest.raises(ValueError, match="repack of non-PACKED"):
        pool.repack([hot], planes, torch.ones(1, dtype=torch.bool))


def test_repack_keeps_out_of_the_read_stream_ratios(refreshed):
    jk, pk = refreshed
    before = dict(pk.traffic)
    n = pk.repack_pending()
    assert n == jk.repack_pending() > 0
    t = pk.traffic
    for key in ("kv_read_bytes", "kv_raw_bytes", "kv_read_bytes_global",
                "kv_raw_bytes_global", "kv_table_bytes", "kv_pages_packed"):
        assert t[key] == before[key], key
    assert t["kv_repack_pages"] + t["kv_repack_kept"] == n
    rp = pk.stream_stats()["repack"]
    assert rp["generation"] == 1 and rp["pending"] == 0
    assert_same(jk, pk)


def test_table_planes_grow_at_a_refresh(drifted):
    """The kernel's table planes start at one generation's rows and grow
    (doubling) when a refresh adds a block: an event, never a step."""
    kv = drifted[1]
    kv.enable_device_pool(1)
    assert kv.dev.n_tables == 2 * kv.n_layers
    rs = kv.refresh_step()
    assert rs["refreshed_layers"]
    kv.finish_refresh(rs, kv._fetch(rs["job"]["pull"]))
    assert kv.dev.n_tables == 4 * kv.n_layers
    vm, ol, cm = kv._tables_stacked()
    np.testing.assert_array_equal(kv.dev.planes["vm"][:len(vm)].numpy(), vm)
    np.testing.assert_array_equal(kv.dev.planes["cum"][:len(cm)].numpy(), cm)


def test_synthetic_drift_ratio_equals_the_reference():
    """The drift harness of the reference: the frozen control degrades from
    phase A to B, refresh recovers, and both caches' per-phase ratios are
    the JAX caches' exactly."""
    def run(refresh: bool):
        pair = make_pair(refresh_threshold=0.2, refresh_min_pages=4)
        rng = np.random.default_rng(7)
        add(pair, 0)
        windows = []
        for mode in ("peaked", "shifted"):
            t0 = [dict(kv.traffic) for kv in pair]
            for _ in range(8 * pair[1].page_size):
                tok = synth_token(rng, pair[0], mode)
                for kv in pair:
                    kv.append_token(0, *tok)
                    kv._accrue_read_traffic([0], 256)
                if refresh:
                    refresh_step(pair, budget=4)
            windows.append([
                ((kv.traffic["kv_read_bytes"] - t["kv_read_bytes"])
                 + (kv.traffic["kv_table_bytes"] - t["kv_table_bytes"]))
                / (kv.traffic["kv_raw_bytes"] - t["kv_raw_bytes"])
                for kv, t in zip(pair, t0)])
        assert_same(*pair)
        return pair[1], [w[1] for w in windows], windows

    kv_f, (a_f, b_f), wf = run(False)
    kv_r, (a_r, b_r), wr = run(True)
    assert all(j == p for w in wf + wr for j, p in [w])
    assert kv_f.generation == 0 and kv_r.generation >= 1
    assert kv_r.traffic["kv_repack_pages"] > 0
    assert b_f > a_f * 1.05 and b_r < b_f
