"""Port paged APack KV cache vs the JAX package: the page lifecycle guard,
byte-identical pool planes and traffic under identical host token appends,
and identical per-step page-table metadata."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as PM
from repro_torch.models import modules as pm


def _cfgs():
    return (dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8"),
            dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8"))


def test_pool_transitions_raise_on_illegal_edges():
    pool = pm.KVPagePool(4, 2, 2, 4, device="cpu")
    pid = pool.alloc()
    with pytest.raises(ValueError, match="seal of non-full"):
        pool.seal([pid])
    with pytest.raises(ValueError, match="pack of non-COLD"):
        pool.pack([pid], (None,) * 5, [0])
    pool.free([pid])
    with pytest.raises(ValueError, match="double free"):
        pool.free([pid])
    with pytest.raises(ValueError, match="non-HOT"):
        pool.note_device_write(pid)
    pid = pool.alloc()
    for _ in range(2):
        pool.note_device_write(pid)
    with pytest.raises(RuntimeError, match="overfull"):
        pool.note_device_write(pid)
    pool.state[pool.free_list[-1]] = pm.PAGE_HOT          # corrupt free list
    with pytest.raises(RuntimeError, match="corrupt free list"):
        pool.alloc()


def _feed(kvs, rng, rid, n, layers, h, dh):
    for _ in range(n):
        kq = np.clip(np.round(rng.laplace(0, 20, (layers, h, dh))), -127,
                     127).astype(np.int8)
        vq = np.clip(np.round(rng.laplace(0, 12, (layers, h, dh))), -127,
                     127).astype(np.int8)
        ks = rng.uniform(0.01, 0.02, (layers, h)).astype(np.float32)
        vs = rng.uniform(0.01, 0.02, (layers, h)).astype(np.float32)
        for kv in kvs:
            kv.append_token(rid, kq, vq, ks, vs)


def test_pool_planes_and_traffic_match_reference():
    """Identical int8 K/V tokens through host ``append_token``: after enough
    pages to calibrate and pack, the pool planes are byte-identical, and
    ``kv_ratio``/traffic and ``step_meta`` are equal."""
    cfg_j, cfg_p = _cfgs()
    jkv = JM.PagedKVCache(cfg_j, 48, page_size=4, calib_pages=2,
                          backend="ref")
    pkv = PM.PagedKVCache(cfg_p, 48, page_size=4, calib_pages=2,
                          device="cpu")
    rng = np.random.default_rng(0)
    layers, h, dh = cfg_p.num_layers, cfg_p.num_kv_heads, cfg_p.head_dim
    for rid, n in ((0, 13), (1, 9), (2, 6)):
        jkv.add_request(rid)
        pkv.add_request(rid)
        _feed((jkv, pkv), rng, rid, n, layers, h, dh)
    jp, pp = jkv.pool, pkv.pool
    assert (pp.state == pm.PAGE_PACKED).sum() > 0
    assert (pp.state == pm.PAGE_HOT).sum() > 0
    assert np.array_equal(jp.state, pp.state)
    assert np.array_equal(jp.fill, pp.fill)
    for f in ("sym", "ofs", "sym_bits", "ofs_bits", "stored", "page_scale",
              "cold_q", "tok_q", "tok_scale"):
        want = np.asarray(getattr(jp, f))
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        got = pp.plane(f).numpy()
        assert np.array_equal(got, want.astype(got.dtype)), f
    for layer in range(layers):
        for kind in (0, 1):
            a, b = jkv.tables[layer][kind], pkv.tables[layer][kind]
            assert (a.v_min, a.ol, a.cum) == (b.v_min, b.ol, b.cum)
    jm = jkv.step_meta([0, None, 2, 1], 32)
    pmeta = pkv.step_meta([0, None, 2, 1], 32)
    for k in ("pid", "tid", "state", "t0", "qw"):
        assert np.array_equal(np.asarray(jm["blocks"][0][k]),
                              pmeta[k].numpy()), k
    assert pkv.kv_ratio() == jkv.kv_ratio()
    for k, v in pkv.traffic.items():
        assert v == jkv.traffic[k], k
    # release returns every page and scrubs it
    for rid in (0, 1, 2):
        pkv.release(rid)
    assert pp.free_count == pp.num_pages
    assert not pp.plane("sym").any() and not pp.plane("tok_q").any()


def test_unported_layer_kinds_are_refused():
    """Every layer kind of the registry is ported since the xLSTM kinds
    (an mLSTM layer is a state layer of the paged cache, no pages); an
    unknown kind is refused."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              block_pattern=("global", "mlstm"),
                              num_layers=2)
    kv = PM.PagedKVCache(cfg, 8, device="cpu")
    assert kv.attn_layers == [0] and kv.state_layers == [1]
    with pytest.raises(ValueError, match="unknown layer kinds"):
        PM.PagedKVCache(dataclasses.replace(cfg, block_pattern=(
            "global", "conv")), 8, device="cpu")
