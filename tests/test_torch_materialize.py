"""The port's materialize oracle and dense-cache path vs the JAX package on
the CPU: the gather decode (plain version and CPU wrapper) against the JAX
gather kernel in interpret mode and its jnp reference, the bucket sizes,
``PagedKVCache.materialize`` after lockstep engine steps, the dense
``decode_step``, and the ``kv_fused=False``, ``"int8"`` and ``"bfloat16"``
engines in lockstep with the JAX engines; then the port's fused and oracle
engines against each other.

Tolerances: codec and cache contents are compared bit for bit (the coder is
integer-exact and the caches hold the same bytes).  Logits are held within
0.05 with the same argmax: a transcendental (exp in the softmax, cos/sin in
rope) can differ in its last f32 bit between XLA's and PyTorch's CPU
libraries, and the bf16 residual stream carries that to the logits as
about one bf16 step (``test_torch_engine.py``).  Fused against oracle
within one package keeps the reference's own 2e-3 logit bound
(``tests/test_fused_page_attention.py::_lockstep``)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels import paged_decode as jpd
from repro.models import model as JM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.tables import find_table, histogram
from repro_torch.kernels import apack_encode, paged_decode
from repro_torch.models import model as PM
from repro_torch.models import modules as pm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

ATOL = 0.05
KW = dict(max_batch=2, max_len=64, kv_page_size=4)


# ------------------------------------------------------------ gather decode
def _values(rng, pages, s, e, n_noisy):
    """Laplace-shaped u8 values with ``n_noisy`` streams of uniform noise
    per page, which AC would inflate, so the encoder stores them."""
    v = np.clip(np.round(rng.laplace(0, 6, (pages, s, e))), -127, 127)
    v = v.astype(np.int64) & 0xFF
    v[:, :n_noisy] = rng.integers(0, 256, (pages, n_noisy, e))
    return v.astype(np.int32)


def _pool(rng, pages, s, e, rows_of_page, n_tables, n_noisy):
    """A pooled plane stack whose page p is coded under table row
    ``rows_of_page[p]`` of an ``n_tables``-row stack (each row fitted to
    its own pages)."""
    v = _values(rng, pages, s, e, n_noisy)
    stack = [[], [], []]
    for r in range(n_tables):
        mine = v[[p for p in range(pages) if rows_of_page[p] == r]]
        t = find_table(histogram(mine if len(mine) else v, 8), 8, True)
        for i, a in enumerate(t.as_arrays()):
            stack[i].append(a)
    vm, ol, cm = (torch.from_numpy(np.stack(a).astype(np.int32))
                  for a in stack)
    rows = torch.as_tensor(rows_of_page, dtype=torch.long)
    sym, ofs, _, _, st = apack_encode.encode_plain(
        torch.from_numpy(v), vm[rows], ol[rows], cm[rows], n_steps=e, bits=8)
    return v, sym, ofs, st.to(torch.int32), (vm, ol, cm)


CASES = {
    # duplicates and edge padding, two generations' K rows of a 2-layer
    # stack (rows 0 and 4), stored streams
    "dup_edge_two_gens": dict(pages=6, s=128, e=32, n_tables=8,
                              rows=[0, 4, 0, 4, 4, 0], one_d=False,
                              idx=[3, 1, 3, 0, 5], n_noisy=3),
    "one_d_table": dict(pages=4, s=128, e=16, n_tables=1, rows=[0] * 4,
                        one_d=True, idx=[2, 2, 0, 3, 1, 0], n_noisy=2),
    "streams_not_128": dict(pages=5, s=37, e=24, n_tables=3,
                            rows=[2, 0, 1, 2, 0], one_d=False,
                            idx=[4, 0, 4, 2, 1, 3, 3], n_noisy=5),
    "mostly_stored": dict(pages=3, s=64, e=16, n_tables=2, rows=[1, 0, 1],
                          one_d=False, idx=[0, 2, 1], n_noisy=48),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_decode_matches_reference(case):
    """The port's plain gather decode and its CPU wrapper are bit-exact
    with the JAX gather kernel in interpret mode and with
    ``gather_decode_ref`` on the same planes, and decode every gathered
    page back to its values."""
    c = CASES[case]
    rng = np.random.default_rng(len(case))
    v, sym, ofs, st, (vm, ol, cm) = _pool(rng, c["pages"], c["s"], c["e"],
                                          c["rows"], c["n_tables"],
                                          c["n_noisy"])
    assert int(st.sum()) > 0
    n = len(c["idx"])
    g = paged_decode.gather_bucket(n)
    idx = np.pad(np.asarray(c["idx"], np.int32), (0, g - n), mode="edge")
    tid = np.asarray(c["rows"], np.int32)[idx]
    if c["one_d"]:
        vm, ol, cm = vm[0], ol[0], cm[0]
    kw = dict(n_steps=c["e"], bits=8)
    ptid = None if c["one_d"] else torch.from_numpy(tid)
    got = paged_decode.gather_decode_plain(sym, ofs, st, torch.from_numpy(idx),
                                           vm, ol, cm, table_idx=ptid, **kw)
    wrap = paged_decode.gather_decode(sym, ofs, st, torch.from_numpy(idx),
                                      vm, ol, cm, table_idx=ptid, **kw)
    jargs = (jnp.asarray(sym.numpy().view(np.uint32)),
             jnp.asarray(ofs.numpy().view(np.uint32)), jnp.asarray(st.numpy()),
             jnp.asarray(idx), jnp.asarray(vm.numpy()), jnp.asarray(ol.numpy()),
             jnp.asarray(cm.numpy()))
    jtid = None if c["one_d"] else jnp.asarray(tid)
    want_k = np.asarray(jpd.gather_decode_pallas(*jargs, interpret=True,
                                                 table_idx=jtid, **kw))
    want_r = np.asarray(jpd.gather_decode_ref(*jargs, table_idx=jtid, **kw))
    assert np.array_equal(got.numpy(), want_k)
    assert np.array_equal(got.numpy(), want_r)
    assert np.array_equal(wrap.numpy(), want_k)
    assert np.array_equal(got.numpy(), v[idx])


def test_gather_decode_refuses_bad_ids():
    rng = np.random.default_rng(0)
    _, sym, ofs, st, (vm, ol, cm) = _pool(rng, 2, 16, 8, [0, 1], 2, 0)
    kw = dict(n_steps=8, bits=8)
    with pytest.raises(IndexError, match="page ids"):
        paged_decode.gather_decode(sym, ofs, st, torch.tensor([0, 2]), vm, ol,
                                   cm, table_idx=torch.tensor([0, 1]), **kw)
    with pytest.raises(IndexError, match="table ids"):
        paged_decode.gather_decode(sym, ofs, st, torch.tensor([0, 1]), vm, ol,
                                   cm, table_idx=torch.tensor([0, -1]), **kw)
    with pytest.raises(ValueError, match="bits"):
        paged_decode.gather_decode(sym, ofs, st, torch.tensor([0]), vm, ol,
                                   cm, n_steps=8, bits=17)


@pytest.mark.parametrize("form", ["numpy", "cpu_tensor"])
def test_gather_decode_checks_host_ids_on_the_host(form, monkeypatch):
    """Ids given on the host, as numpy arrays (what ``materialize`` passes)
    or CPU tensors, are range-checked there: out-of-range page or table
    ids raise ``IndexError`` with the same messages as ids on the card,
    before any decode, and in-range ids decode as the JAX gather kernel
    does, through no ``.cpu()`` or ``.tolist()``."""
    rng = np.random.default_rng(3)
    v, sym, ofs, st, (vm, ol, cm) = _pool(rng, 3, 32, 16, [0, 1, 1], 2, 2)
    kw = dict(n_steps=16, bits=8)
    wrap = np.asarray if form == "numpy" else torch.tensor
    decodes = []
    plain = paged_decode.gather_decode_plain
    monkeypatch.setattr(paged_decode, "gather_decode_plain",
                        lambda *a, **k: decodes.append(1) or plain(*a, **k))
    for page, table, match in (([0, 3], [0, 1], r"page ids span \[0, 3\], "
                                                r"outside \[0, 3\)"),
                               ([-1, 2], [0, 1], r"page ids span \[-1, 2\]"),
                               ([0, 2], [2, 1], r"table ids span \[1, 2\], "
                                                r"outside \[0, 2\)"),
                               ([0, 2], [0, -1], r"table ids span \[-1, 0\]")):
        with pytest.raises(IndexError, match=match):
            paged_decode.gather_decode(sym, ofs, st, wrap(page), vm, ol, cm,
                                       table_idx=wrap(table), **kw)
    with pytest.raises(IndexError, match="page ids"):
        paged_decode.gather_decode(sym, ofs, st, wrap([5]), vm[0], ol[0],
                                   cm[0], **kw)
    assert decodes == []
    idx = np.asarray([2, 0, 2, 1], np.int32)
    tid = np.asarray([1, 0, 1, 1], np.int32)
    pulls = []
    for name in ("cpu", "tolist"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda *a, _o=orig, **k:
                            pulls.append(1) or _o(*a, **k))
    got = paged_decode.gather_decode(sym, ofs, st, wrap(idx), vm, ol, cm,
                                     table_idx=wrap(tid), **kw)
    assert pulls == [] and decodes == [1]
    want = jpd.gather_decode_ref(
        jnp.asarray(sym.numpy().view(np.uint32)),
        jnp.asarray(ofs.numpy().view(np.uint32)), jnp.asarray(st.numpy()),
        jnp.asarray(idx), jnp.asarray(vm.numpy()), jnp.asarray(ol.numpy()),
        jnp.asarray(cm.numpy()), table_idx=jnp.asarray(tid), **kw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), v[idx])


def test_gather_bucket_matches_reference():
    assert [paged_decode.gather_bucket(n) for n in range(1, 5001)] == \
        [jpd.gather_bucket(n) for n in range(1, 5001)]


# ------------------------------------------------------- model and engines
def _cfgs(kv):
    return (dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype=kv),
            dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype=kv))


@pytest.fixture(scope="module")
def params():
    cfg_j, cfg = _cfgs("apack-int8")
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    return jp, params_from_numpy(cfg, jax.tree.map(np.array, jp), "cpu")


def _prompts(cfg, lens):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _engines(kv, params, lens, max_new, **kw):
    cfg_j, cfg = _cfgs(kv)
    jp, tp = params
    je = JEngine(cfg_j, jp, kv_backend="ref", **KW, **kw)
    pe = ServeEngine(cfg, tp, device="cpu", **KW, **kw)
    jr = [JRequest(i, p, max_new_tokens=max_new)
          for i, p in enumerate(_prompts(cfg, lens))]
    pr = [Request(i, p, max_new_tokens=max_new)
          for i, p in enumerate(_prompts(cfg, lens))]
    for a, b in zip(jr, pr):
        je.submit(a)
        pe.submit(b)
    return je, pe, jr, pr


def _slot_rids(eng):
    return [r.rid if r is not None else None for r in eng.active]


def test_materialize_matches_reference(params):
    """Oracle engines of both packages in lockstep; after every step both
    caches materialize the same int8 K/V and scales in every layer, bit for
    bit.  ``kv_calib_pages=8`` keeps the first sealed pages COLD for a few
    steps, so the run crosses HOT+COLD and then HOT+PACKED pages."""
    je, pe, jr, pr = _engines("apack-int8", params, (9, 14, 6), 10,
                              kv_fused=False, kv_calib_pages=8)
    seen = set()
    for _ in range(40):
        je.step()
        pe.step()
        rids = _slot_rids(pe)
        assert rids == _slot_rids(je)
        if all(r is None for r in rids):
            break
        states = {int(pe.kv.pool.state[pid]) for rid in rids if rid is not None
                  for pids in pe.kv.page_tables[rid] for pid in pids}
        seen.add(frozenset(states))
        jc = je.kv.materialize(rids, KW["max_len"])["blocks"][0]
        pc = pe.kv.materialize(rids, KW["max_len"])
        for layer, c in enumerate(pc):
            for f in ("k", "v", "k_scale", "v_scale"):
                assert np.array_equal(c[f].numpy(),
                                      np.asarray(jc[f][layer])), (layer, f)
    assert frozenset({pm.PAGE_HOT, pm.PAGE_COLD}) in seen
    assert frozenset({pm.PAGE_HOT, pm.PAGE_PACKED}) in seen
    assert [r.tokens for r in pr] == [r.tokens for r in jr]
    assert pe.kv_stats()["kv_ratio"] == je.kv_stats()["kv_ratio"]


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_prefill_and_decode_step_match_reference(params, kv):
    """The port's ``prefill`` caches (padded to 24 positions) equal the
    jitted JAX ``prefill``'s; then one dense ``decode_step`` at per-row
    positions [12, 9] on those caches: logits within 0.05 with the same
    argmax, and the new tokens' cache entries bit-identical."""
    cfg_j, cfg = _cfgs(kv)
    jp, tp = params
    sp = PM.serving_params(tp)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    jl, jc = jax.jit(lambda p, t: JM.prefill(cfg_j, p, {"tokens": t}, 24))(
        jp, jnp.asarray(toks, jnp.int32))
    pl, pc = PM.prefill(cfg, sp, torch.from_numpy(toks).long(), 24)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
    fields = ("k", "v", "k_scale", "v_scale") if kv == "int8" else ("k", "v")
    for layer, c in enumerate(pc):
        assert set(c) == set(fields)
        for f in fields:
            want = np.asarray(jc["blocks"][0][f][layer].astype(jnp.float32))
            assert np.array_equal(c[f].float().numpy(), want), (layer, f)
    pos = np.array([12, 9])
    nxt = np.array([[5], [77]])
    jl2, jc2 = jax.jit(lambda p, c, t, q: JM.decode_step(cfg_j, p, c, t, q))(
        jp, jc, jnp.asarray(nxt, jnp.int32), jnp.asarray(pos, jnp.int32))
    pl2, pc2 = PM.decode_step(cfg, sp, pc, torch.from_numpy(nxt).long(),
                              torch.from_numpy(pos).long())
    want = np.asarray(jl2)
    np.testing.assert_allclose(pl2.numpy(), want, atol=ATOL)
    assert np.array_equal(pl2.numpy().argmax(-1), want.argmax(-1))
    for layer, c in enumerate(pc2):
        for f in fields:
            w = np.asarray(jc2["blocks"][0][f][layer].astype(jnp.float32))
            for row, p in enumerate(pos):
                assert np.array_equal(c[f][row, p].float().numpy(),
                                      w[row, p]), (layer, f, row)


@pytest.mark.parametrize("kv,fused", [("apack-int8", False), ("int8", None),
                                      ("bfloat16", None)])
def test_engines_match_reference_in_lockstep(params, kv, fused):
    """Three requests through two slots, both packages' engines stepped
    together: logits of the first three steps within 0.05 with the same
    argmax, then identical greedy tokens; the oracle's KV traffic ratio and
    packed page count are equal too (the pages hold the same bytes)."""
    je, pe, jr, pr = _engines(kv, params, (20, 27, 17), 8, kv_fused=fused,
                              kv_calib_pages=2)
    assert pe.paged == je.paged and pe.fused == je.fused
    for _ in range(3):
        je.step()
        pe.step()
        want = np.asarray(je.last_logits)
        got = pe.last_logits.numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
    je.run_until_drained()
    pe.run_until_drained()
    assert all(r.done for r in pr)
    assert [r.tokens for r in pr] == [r.tokens for r in jr]
    if pe.paged:
        ks, jks = pe.kv_stats(), je.kv_stats()
        assert ks["kv_fused"] is False
        assert ks["kv_ratio"] == jks["kv_ratio"] and ks["kv_ratio"] < 1
        assert ks["kv_pages_packed"] == jks["kv_pages_packed"] > 0
        assert pe.kv.pool.free_count == pe.kv.pool.num_pages
    else:
        assert pe.kv_stats() == je.kv_stats() == {}


def test_fused_and_oracle_engines_agree(params):
    """The port's fused and materialize engines in lockstep on the same
    requests (non-page-aligned prompts): active-slot logits within the
    reference's 2e-3 at every step, identical greedy tokens, KV ratio and
    packed page count.  The reference's test also compares host-device
    ``transfers``; that does not carry over, because the port's pool has
    no host mirror, so its oracle uploads index rows where the reference
    pulls and pushes page payloads."""
    cfg = _cfgs("apack-int8")[1]
    _, tp = params
    engines, reqs = {}, {}
    for fused in (True, False):
        engines[fused] = ServeEngine(cfg, tp, device="cpu", kv_fused=fused,
                                     kv_calib_pages=2, **KW)
        reqs[fused] = [Request(i, p, max_new_tokens=10)
                       for i, p in enumerate(_prompts(cfg, (9, 11, 6)))]
        for r in reqs[fused]:
            engines[fused].submit(r)
    worst = 0.0
    for _ in range(100):
        n0, n1 = engines[False].step(), engines[True].step()
        assert n0 == n1
        if n0 == 0 and not engines[False].queue:
            break
        act = [s for s, r in enumerate(engines[False].active)
               if r is not None]
        worst = max(worst, float((engines[False].last_logits[act]
                                  - engines[True].last_logits[act])
                                 .abs().max()))
    assert worst < 2e-3
    assert [r.tokens for r in reqs[False]] == [r.tokens for r in reqs[True]]
    a, b = engines[False].kv_stats(), engines[True].kv_stats()
    assert a["kv_ratio"] == b["kv_ratio"]
    assert a["kv_pages_packed"] == b["kv_pages_packed"] > 0


def test_oracle_step_pulls_nothing_for_the_gather(params, monkeypatch):
    """An oracle (``kv_fused=False``) decode step that gathers PACKED pages
    reads back the token ids (one ``.cpu()``) plus one pull per seal batch
    (accounted in ``kv.transfers``), as the fused step does
    (``test_torch_engine.py::
    test_steady_state_step_reads_only_tokens_and_seal_pulls``): the
    gather's ids are checked on the host, so it adds no ``.cpu()``,
    ``.item()``, ``.tolist()`` or synchronize."""
    cfg = _cfgs("apack-int8")[1]
    eng = ServeEngine(cfg, params[1], device="cpu", kv_fused=False,
                      kv_calib_pages=2, **KW)
    for i, p in enumerate(_prompts(cfg, (9, 14))):
        eng.submit(Request(i, p, max_new_tokens=14))
    for _ in range(3):                            # admission, calibration
        eng.step()
    gathers = []
    plain = paged_decode.gather_decode_plain
    monkeypatch.setattr(paged_decode, "gather_decode_plain",
                        lambda *a, **k: gathers.append(len(a[3]))
                        or plain(*a, **k))
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
        n_gathers = len(gathers)
        before = dict(calls)
        assert eng.step() == 2
        assert len(gathers) == n_gathers + 2       # one per K/V kind
        assert calls["item"] == before["item"]
        assert calls["tolist"] == before["tolist"]
        assert calls["synchronize"] == before["synchronize"]
        assert calls["cpu"] - before["cpu"] == \
            1 + eng.kv.transfers["d2h_calls"] - d2h
    assert min(gathers) > 0


def test_materialize_of_host_appends_matches_reference():
    """A cache fed by host ``append_token`` (no engine, no device pool):
    ``materialize`` over a batch with an idle slot and requests in another
    order than they were added equals the JAX cache's, bit for bit, and
    charges the same read traffic."""
    cfg_j, cfg = _cfgs("apack-int8")
    jkv = JM.PagedKVCache(cfg_j, 48, page_size=4, calib_pages=2,
                          backend="ref")
    pkv = PM.PagedKVCache(cfg, 48, page_size=4, calib_pages=2, device="cpu")
    rng = np.random.default_rng(2)
    layers, h, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    for rid, n in ((0, 13), (1, 9), (2, 6)):
        jkv.add_request(rid)
        pkv.add_request(rid)
        for _ in range(n):
            kq = np.clip(np.round(rng.laplace(0, 20, (layers, h, dh))),
                         -127, 127).astype(np.int8)
            vq = np.clip(np.round(rng.laplace(0, 12, (layers, h, dh))),
                         -127, 127).astype(np.int8)
            ks = rng.uniform(0.01, 0.02, (layers, h)).astype(np.float32)
            vs = rng.uniform(0.01, 0.02, (layers, h)).astype(np.float32)
            for kv in (jkv, pkv):
                kv.append_token(rid, kq, vq, ks, vs)
    assert {pm.PAGE_HOT, pm.PAGE_PACKED} <= set(pkv.pool.state.tolist())
    rids = [2, None, 0, 1]
    jc = jkv.materialize(rids, 20)["blocks"][0]
    pc = pkv.materialize(rids, 20)
    for layer, c in enumerate(pc):
        for f in ("k", "v", "k_scale", "v_scale"):
            assert np.array_equal(c[f].numpy(), np.asarray(jc[f][layer]))
    assert pkv.traffic == {k: jkv.traffic[k] for k in pkv.traffic}
