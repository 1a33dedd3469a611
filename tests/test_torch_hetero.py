"""Heterogeneous stacks in the port against the JAX package, on the CPU:
rolling-window page eviction, per-kind page reservation, prefill ingest of
rolling and recurrent layers, the materialized ring and state leaves,
recurrent-state snapshots, ``ServeEngine`` on ``hetero-serve-smoke`` and
recurrentgemma-9b SMOKE (window 8) in the fused, oracle and dense int8
modes, preempt/resume, the weight round trip's JAX layout of prefix and
cycle leaves, and the CLI's ``--window-size``.

The engines' runs stay short (a few dozen steps): XLA's and PyTorch's CPU
``exp`` can differ in the last f32 bit, and a long lockstep run can meet a
near-tie flip there (ROADMAP, faults)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import compress_params as jcompress_params
from repro_torch import configs as pconfigs
from repro_torch.launch import serve as cli
from repro_torch.models import model as PM
from repro_torch.models import modules as pm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine, compress_params

ARCHS = ("hetero-serve-smoke", "recurrentgemma-9b")
KW = dict(max_batch=2, max_len=40, kv_page_size=4, kv_calib_pages=2)
PROMPT_LENS = (9, 14, 6)
MAX_NEW = 6
CT_FIELDS = ("sym_plane", "ofs_plane", "sym_bits", "ofs_bits", "stored")


def _cfgs(arch, kv="apack-int8"):
    if arch == "hetero-serve-smoke":
        cj, cp = (jconfigs.get_hetero_smoke_config(),
                  pconfigs.get_hetero_smoke_config())
    else:
        cj = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                 window_size=8)
        cp = dataclasses.replace(pconfigs.get_smoke_config(arch),
                                 window_size=8)
    return (dataclasses.replace(cj, kv_cache_dtype=kv),
            dataclasses.replace(cp, kv_cache_dtype=kv))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _random_token(rng, n_layers, h, dh):
    return (rng.integers(-127, 128, (n_layers, h, dh)).astype(np.int8),
            rng.integers(-127, 128, (n_layers, h, dh)).astype(np.int8),
            rng.uniform(0.01, 0.02, (n_layers, h)).astype(np.float32),
            rng.uniform(0.01, 0.02, (n_layers, h)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_params(cj):
    """The JAX init, compiled once per config (eager op-by-op init spends
    seconds compiling each op)."""
    return jax.jit(JM.init_params, static_argnums=0)(cj,
                                                     jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """One JAX params draw and the port's copy, per architecture."""
    cj, cp = _cfgs(request.param)
    params = _jax_params(cj)
    return dict(name=request.param, cj=cj, cp=cp, params=params,
                tp=params_from_numpy(cp, jax.tree.map(np.array, params),
                                     "cpu"))


def _serve(eng, reqs, preempt_at=None):
    for r in reqs:
        eng.submit(r)
    for _ in range(preempt_at or 0):
        eng.step()
    if preempt_at:
        eng.preempt(0)
    eng.run_until_drained()
    return [r.tokens for r in reqs]


@pytest.fixture(scope="module")
def reference(arch):
    """The JAX engines' tokens and KV stats on the shared workload: the
    paged engine (materialize oracle; the JAX tests hold its fused path to
    the same tokens) and the dense int8 one."""
    out = {}
    for kv in ("apack-int8", "int8"):
        cj = dataclasses.replace(arch["cj"], kv_cache_dtype=kv)
        eng = JEngine(cj, arch["params"], kv_backend="ref", kv_fused=False,
                      **KW)
        reqs = [JRequest(i, p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(_prompts(cj.vocab_size))]
        out[kv] = (_serve(eng, reqs), eng.kv_stats())
    return out


# ------------------------------------------------------ rolling eviction
def test_eviction_trace_matches_reference():
    """A one-layer rolling stack fed token by token on the host append
    path: after every token the page table's base, its live page ids and
    the pool's free count equal the reference's, the oldest page leaves
    exactly when its last token leaves the window, and the live set never
    exceeds ``window_pages``."""
    cfgs = [dataclasses.replace(c.get_smoke_config("qwen3-1.7b"),
                                num_layers=1, block_pattern=("local",),
                                window_size=8, kv_cache_dtype="apack-int8")
            for c in (jconfigs, pconfigs)]
    jkv = JM.PagedKVCache(cfgs[0], num_pages=16, page_size=4, calib_pages=1)
    pkv = PM.PagedKVCache(cfgs[1], num_pages=16, page_size=4, calib_pages=1,
                          device="cpu")
    rng = np.random.default_rng(0)
    traces = ([], [])
    for kv in (jkv, pkv):
        kv.add_request(0)
    for _ in range(24):
        tok = _random_token(rng, 1, pkv.pool.kv_heads, pkv.pool.head_dim)
        for kv, trace in zip((jkv, pkv), traces):
            kv.append_token(0, *tok)
            trace.append((kv.seq_len[0], kv.page_base[0][0],
                          list(kv.page_tables[0][0]), kv.pool.free_count))
    assert traces[0] == traces[1]
    for seq_len, base, pids, _ in traces[1]:
        assert base == max(0, (seq_len - 8 + 1) // 4)
        assert len(pids) <= pkv.window_pages
    assert pkv.pool.evict_count == jkv.pool.evict_count == traces[1][-1][1]
    assert pkv.traffic == {k: jkv.traffic[k] for k in pkv.traffic}
    hot = pkv.pool.alloc()
    with pytest.raises(RuntimeError, match="evict of live HOT"):
        pkv.pool.evict([hot])
    pkv.pool.free([hot])
    pkv.release(0)
    assert pkv.pool.free_count == pkv.pool.num_pages


def test_pages_needed_per_layer_kind():
    """Global layers reserve the full sequence, rolling ones at most
    ``window_pages``, recurrent ones nothing, as in the reference."""
    cj, cp = _cfgs("hetero-serve-smoke")
    kv = PM.PagedKVCache(cp, num_pages=4, page_size=4, device="cpu")
    assert kv.window_pages == 8 // 4 + 1
    for n in (1, 4, 9, 32, 100):
        assert kv.pages_needed(n) == \
            JM.PagedKVCache.pages_for_config(cj, n, 4)
    assert kv.attn_layers == [1, 2] and kv.state_layers == [0, 3]


# ------------------------------------------- ingest, materialize, snapshot
def _jax_caches(cp, caches):
    """The port's per-layer prefill caches in the JAX package's layout:
    prefix layers in a list, each cycle position's layers stacked."""
    import jax.numpy as jnp
    n_prefix, n_cycle = len(cp.prefix_pattern), len(cp.cycle)

    def arr(x):
        return jnp.asarray(x.numpy())
    return {"prefix": [{f: arr(x) for f, x in c.items()}
                       for c in caches[:n_prefix]],
            "blocks": tuple({f: jnp.stack([arr(c[f]) for c in
                                           caches[n_prefix + i::n_cycle]])
                             for f in caches[n_prefix + i]}
                            for i in range(n_cycle))}


POOL_PLANES = ("tok_q", "tok_scale", "cold_q", "page_scale", "sym", "ofs",
               "sym_bits", "ofs_bits", "stored")


def _same_pool(jp, pp):
    assert np.array_equal(jp.state, pp.state)
    assert np.array_equal(jp.fill, pp.fill)
    for f in POOL_PLANES:
        a = np.asarray(getattr(jp, f))
        b = pp.plane(f).numpy()
        assert np.array_equal(a.astype(b.dtype), b), f


@pytest.fixture(scope="module")
def ingested():
    """Both packages' caches on ``hetero-serve-smoke`` (a global, a
    rolling and two recurrent layers) after ingesting two prompts, one
    below the window (6) and one above it (23: its first kept page holds
    three rolled-out positions), then four host-appended tokens each.  The
    prefill caches are the port's forward (bit-identical to the
    reference's, ``test_engine_matches_reference``), given to the JAX cache
    in its layout."""
    cj, cp = _cfgs("hetero-serve-smoke")
    params = _jax_params(cj)
    tp = PM.serving_params(params_from_numpy(
        cp, jax.tree.map(np.array, params), "cpu"))
    pages = 2 * JM.PagedKVCache.pages_for_config(cj, 40, 4)
    jkv = JM.PagedKVCache(cj, pages, page_size=4, calib_pages=2)
    pkv = PM.PagedKVCache(cp, pages, page_size=4, calib_pages=2,
                          device="cpu")
    rng = np.random.default_rng(1)
    for rid, s in enumerate((6, 23)):
        prompt = torch.from_numpy(rng.integers(0, cj.vocab_size, (1, s)))
        caches = PM.forward(cp, tp, prompt, last_only=True)[1]
        jkv.add_request(rid)
        pkv.add_request(rid)
        jkv.ingest_prefill(rid, _jax_caches(cp, caches), s)
        pkv.ingest_prefill(rid, caches, s)
        assert pkv.page_base[rid] == jkv.page_base[rid], (rid, s)
        assert pkv.page_tables[rid] == jkv.page_tables[rid], (rid, s)
    for _ in range(4):
        for rid in range(2):
            tok = _random_token(rng, pkv.n_layers, pkv.pool.kv_heads,
                                pkv.pool.head_dim)
            jkv.append_token(rid, *tok)
            pkv.append_token(rid, *tok)
    return jkv, pkv


def test_ingest_prefill_matches_reference(ingested):
    """Page tables and bases (rolled-out pages skipped, positions older
    than the window as zeros), every pool plane, the calibration
    histograms, the traffic counters and the recurrent states."""
    jkv, pkv = ingested
    assert pkv.page_tables == jkv.page_tables
    assert pkv.page_base == jkv.page_base
    _same_pool(jkv.pool, pkv.pool)
    assert np.array_equal(pkv.hists, jkv.hists)
    assert pkv.pool.evict_count == jkv.pool.evict_count > 0
    for rid in range(2):
        for layer in pkv.state_layers:
            for f, v in jkv.states[rid][layer].items():
                assert np.array_equal(pkv.states[rid][layer][f].numpy(), v)


def test_materialize_ring_and_states_match_reference(ingested):
    """The dense cache rebuilt from the pool: global layers at absolute
    positions, rolling layers in ring slots with dead positions skipped,
    recurrent layers' states (the init state for an idle slot)."""
    jkv, pkv = ingested
    slots = [1, None, 0]
    want = jkv.materialize(slots, 40)
    got = pkv.materialize(slots, 40)
    for layer, c in enumerate(got):
        w, j = jkv._layer_cache(want, layer)
        for f, x in c.items():
            ref = np.asarray(w[f] if j is None else w[f][j])
            assert np.array_equal(x.numpy(), ref), (layer, f)
    assert pkv.traffic == {k: jkv.traffic[k] for k in pkv.traffic}


# ----------------------------------------------------------- engines
def _same_kv_stats(got, want):
    assert got["kv_ratio"] == want["kv_ratio"] < 1.1
    assert got["kv_pages_evicted"] == want["kv_pages_evicted"] > 0
    assert got["kv_pages_packed"] == want["kv_pages_packed"] > 0
    for kind in ("global", "local"):
        assert got["kv_streams"][kind] == {
            k: want["kv_streams"][kind][k] for k in got["kv_streams"][kind]}


@pytest.mark.parametrize("mode", ["oracle", "int8"])
def test_engine_matches_reference(arch, reference, mode):
    """The materialize oracle and the dense int8 cache: tokens identical
    to the JAX engine's on the same params, and on the paged mode
    ``kv_ratio``, the stream stats and ``kv_pages_evicted`` (> 0) equal.
    The fused mode is held to the same in
    ``test_fused_engine_with_preempt_matches_reference``."""
    kv = "int8" if mode == "int8" else "apack-int8"
    cp = dataclasses.replace(arch["cp"], kv_cache_dtype=kv)
    eng = ServeEngine(cp, arch["tp"], device="cpu",
                      kv_fused=mode != "oracle", **KW)
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts(cp.vocab_size))]
    want_tokens, want = reference[kv]
    assert _serve(eng, reqs) == want_tokens
    if mode == "int8":
        assert eng.kv_stats() == {}
        return
    got = eng.kv_stats()
    _same_kv_stats(got, want)
    assert got["kv_streams"]["state"] == {
        k: want["kv_streams"]["state"][k] for k in got["kv_streams"]["state"]}
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages


def test_fused_engine_with_preempt_matches_reference(arch, reference):
    """The fused engine, slot 0 preempted after four steps and resumed at
    once.  Its recurrent states leave the device store through a snapshot
    whose byte-plane containers are bit-identical to the reference's
    ``byteplane.compress_float(table_mode="weight")`` of the same f32
    stream (``snapshot_state`` :1865), the dense copy is dropped, the
    states come back bit for bit at resume, and every request's tokens
    equal the JAX engine's uninterrupted ones; the KV stats too, since the
    preempted request lost no step."""
    from repro.core import byteplane as jbyteplane
    eng = ServeEngine(arch["cp"], arch["tp"], device="cpu", **KW)
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts(arch["cp"].vocab_size))]
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    rid = eng.active[0].rid
    live = eng.kv.read_state_slot(0)
    snap = eng.preempt(0)
    assert eng.kv.states[rid] == {}
    flat = np.concatenate([live[layer][f].numpy().reshape(-1)
                           for layer, f, _ in snap["manifest"]])
    assert [(layer, f) for layer, f, _ in snap["manifest"]] == [
        (layer, f) for layer in eng.kv.state_layers for f in ("conv", "h")]
    want = jbyteplane.compress_float(flat, table_mode="weight")
    assert len(snap["planes"].planes) == len(want.planes)
    for a, b in zip(snap["planes"].planes, want.planes):
        assert a.n_valid == b.n_valid
        for f in CT_FIELDS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    st = eng.kv_stats()["kv_streams"]["state"]
    assert st == {"raw_bytes": flat.nbytes,
                  "snapshot_bytes": want.total_bits // 8, "snapshots": 1,
                  "ratio": (want.total_bits // 8) / flat.nbytes}
    eng.kv.dev_states[eng.kv.state_layers[0]]["h"][0] = 0.0   # slot reused
    eng.step()
    assert eng.active[0].rid == rid and eng.stats["resumed"] == 1
    for layer, d in live.items():
        for f, v in d.items():
            assert torch.equal(eng.kv.states[rid][layer][f], v)
    eng.run_until_drained()
    assert [r.tokens for r in reqs] == reference["apack-int8"][0]
    _same_kv_stats(eng.kv_stats(), reference["apack-int8"][1])
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages


def test_compress_params_follows_the_reference_layout():
    """``compress_params`` lays prefix and cycle leaves out as the JAX
    tree (``prefix/i/...``, ``blocks/c/...`` stacked over the cycles, from
    ``cfg``): the same paths in flatten order and the same containers, and
    ``decompress_params`` puts every leaf back in its layer.  Two cycles
    (8 layers); the min size lets only the embedding through the coder,
    so every stacked leaf is compared by value as it passes through."""
    from repro_torch.serve import decompress_params
    cj, cp = (dataclasses.replace(c, num_layers=8) for c in
              _cfgs("recurrentgemma-9b"))
    params = _jax_params(cj)
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    paths = [jax.tree_util.keystr(k, simple=True, separator="/")
             for k, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    want = jcompress_params(params, min_size=32768)
    got = compress_params(cp, tp, min_size=32768)
    assert got.paths == paths
    assert set(got.containers) == {paths[i] for i in want.containers}
    assert "blocks/2/ffn/w_up" in got.passthrough
    assert got.compressed_bytes == want.compressed_bytes
    for i, (ct, scale, _) in want.containers.items():
        pct, pscale, _ = got.containers[paths[i]]
        assert np.array_equal(pscale, scale)
        for f in CT_FIELDS:
            assert np.array_equal(getattr(pct, f), getattr(ct, f)), paths[i]
    for i, arr in want.passthrough.items():
        assert np.array_equal(got.passthrough[paths[i]].numpy(), arr)
    back = decompress_params(got, "cpu")
    for layer, blk in enumerate(back["blocks"]):
        ref = tp["blocks"][layer]
        assert blk["inner"].keys() == ref["inner"].keys()
        assert torch.equal(blk["norm1"], ref["norm1"])
        assert torch.equal(blk["inner"]["a_param" if "a_param" in ref["inner"]
                                        else "wq"], ref["inner"]["a_param"
                                        if "a_param" in ref["inner"]
                                        else "wq"])


def test_cli_serves_with_window_size(capsys):
    """``--arch recurrentgemma-9b --smoke --window-size 8``: pages roll out
    of the window and every stream prints."""
    cli.main(["--arch", "recurrentgemma-9b", "--smoke", "--kv", "apack-int8",
              "--device", "cpu", "--no-compress", "--window-size", "8",
              "--requests", "3",
              "--prompt-len", "10", "--max-new", "8", "--max-batch", "2",
              "--kv-page-size", "4"])
    lines = capsys.readouterr().out.splitlines()
    kv = [ln for ln in lines if ln.startswith("paged KV traffic:")]
    assert len(kv) == 1, lines
    evicted = int(kv[0].split("evicted_pages=")[1].split()[0])
    assert evicted > 0
    assert any(ln.strip().startswith("stream local") for ln in lines)
    assert any("'completed': 3" in ln for ln in lines)


def test_packed_weights_on_hetero_stacks_are_refused(arch):
    """Packed weights on a heterogeneous stack are served now (ROADMAP 1.13,
    held against the JAX package in ``test_torch_packed_hetero.py``): the
    engine packs the attention sites of global and rolling layers and every
    layer's FFN.  An sLSTM stack builds without FFNs (ROADMAP 1.9's
    xLSTM kinds are ported); an unknown layer kind is refused."""
    eng = ServeEngine(arch["cp"], arch["tp"], device="cpu",
                      weights="apack-int8", weight_min_size=1024, **KW)
    kinds = PM.layer_kinds(arch["cp"])
    for kind, blk in zip(kinds, eng.params["blocks"]):
        assert isinstance(blk["ffn"]["w_up"], pm.PackedWeight)
        assert isinstance(blk["inner"].get("wq"), pm.PackedWeight) \
            == (kind in PM.ATTN_KINDS)
    xcfg = dataclasses.replace(arch["cp"], block_pattern=("slstm",) * 3)
    xl = PM.init_params(xcfg, torch.Generator(), "cpu")
    assert all("ffn" not in blk for kind, blk in zip(PM.layer_kinds(xcfg),
                                                     xl["blocks"])
               if kind == "slstm")
    with pytest.raises(ValueError, match="unknown layer kinds"):
        PM.init_params(dataclasses.replace(arch["cp"],
                                           block_pattern=("conv",) * 3),
                       torch.Generator(), "cpu")
    assert pm.PAGE_TRANSITIONS["evict"] == ((pm.PAGE_COLD, pm.PAGE_FREE),
                                            (pm.PAGE_PACKED, pm.PAGE_FREE))
