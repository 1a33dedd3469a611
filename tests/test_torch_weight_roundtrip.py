"""The checkpoint-style weight round trip, ``compress_params`` ->
``decompress_params``, of the port against the JAX package's at SMOKE
width, on the same params (``params_from_numpy`` of the JAX tree): the
same containers per JAX leaf, the same byte counts and ratio, the same
decompressed values bit for bit, and a serving engine on the round-tripped
params that generates the JAX engine's tokens."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import compress_params as jcompress_params
from repro.serve import decompress_params as jdecompress_params
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (DEFAULT_WEIGHT_MIN_SIZE, Request, ServeEngine,
                               compress_params, decompress_params)

CT_FIELDS = ("sym_plane", "ofs_plane", "sym_bits", "ofs_bits", "stored")


@pytest.fixture(scope="module")
def smoke():
    """The JAX SMOKE params, their leaf paths in flatten order, and the
    port's copy of them on the CPU."""
    cfg_j = jconfigs.get_smoke_config("qwen3-1.7b")
    cfg = get_smoke_config("qwen3-1.7b")
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    paths = [jax.tree_util.keystr(k, simple=True, separator="/")
             for k, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    tp = params_from_numpy(cfg, jax.tree.map(np.array, params), "cpu")
    return cfg_j, cfg, params, paths, tp


@pytest.fixture(scope="module")
def round_trips(smoke):
    """``min_size -> (JAX CompressedParams, port CompressedParams)``, and
    the parts' seconds of the port's call at the default min size."""
    _, cfg, params, _, tp = smoke
    tc: dict = {}
    return {m: (jcompress_params(params, min_size=m),
                compress_params(cfg, tp, min_size=m, timings=tc if m ==
                                DEFAULT_WEIGHT_MIN_SIZE else None))
            for m in (DEFAULT_WEIGHT_MIN_SIZE, 64)}, tc


def _same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("min_size", [DEFAULT_WEIGHT_MIN_SIZE, 64])
def test_compress_params_matches_reference(smoke, round_trips, min_size):
    """One container per JAX leaf, keyed by its path, in the JAX flatten
    order: planes, bit counts, stored flags, table, per-channel scale (one
    per last-axis channel, shared by the stacked layers) and dtype equal
    the JAX containers'; so do the passthrough leaves, ``original_bytes``,
    ``compressed_bytes`` and ``ratio``.  At ``min_size=64`` the stacked
    norm scales [L, d] are compressed too (one layer's [d] would not be),
    and the stacked q/k norms [L, 16] pass through."""
    cfg_j, cfg, params, paths, tp = smoke
    want, got = round_trips[0][min_size]
    assert got.paths == paths
    assert set(got.containers) == {paths[i] for i in want.containers}
    assert set(got.passthrough) == {paths[i] for i in want.passthrough}
    norms = {"blocks/0/norm1", "blocks/0/norm2"}
    assert (norms <= set(got.containers)) == (min_size == 64)
    assert "blocks/0/inner/q_norm" in got.passthrough
    for i, (ct, scale, dtype) in want.containers.items():
        pct, pscale, pdtype = got.containers[paths[i]]
        for f in CT_FIELDS:
            a, b = getattr(pct, f), getattr(ct, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (paths[i], f)
        assert (pct.shape, pct.bits, pct.n_valid, pct.elems_per_stream) == \
            (ct.shape, ct.bits, ct.n_valid, ct.elems_per_stream)
        assert (tuple(pct.table.v_min), tuple(pct.table.cum),
                tuple(pct.table.ol), pct.table.mode) == \
            (tuple(ct.table.v_min), tuple(ct.table.cum), tuple(ct.table.ol),
             "weight")
        assert pct.total_bits == ct.total_bits
        assert pscale.dtype == scale.dtype and pscale.shape == scale.shape
        assert np.array_equal(pscale, scale) and pdtype == dtype
        assert pscale.shape[-1] == ct.shape[-1] and pscale.size == \
            ct.shape[-1]
    for i, arr in want.passthrough.items():
        assert np.array_equal(got.passthrough[paths[i]].numpy(), arr)
    assert (got.original_bytes, got.compressed_bytes) == \
        (want.original_bytes, want.compressed_bytes)
    assert got.ratio == want.ratio and got.ratio > 1
    # decompressed values, bit for bit, in the port's per-layer layout
    back = decompress_params(got, "cpu")
    jback = params_from_numpy(cfg, jax.tree.map(
        np.array, jdecompress_params(want)), "cpu")
    _same_tree(back, jback)


def test_compress_params_times_its_parts(round_trips):
    """``timings`` gets every part of the round trip, and the values do
    not change for it: the default-size round trip above, which the other
    tests hold to the JAX package's, is the timed one, and a timed
    ``decompress_params`` gives what an untimed one does."""
    tc = round_trips[1]
    assert set(tc) == {"stack", "quantize_histogram", "find_table", "encode",
                       "pull"}
    cp = round_trips[0][DEFAULT_WEIGHT_MIN_SIZE][1]
    td: dict = {}
    back = decompress_params(cp, "cpu", timings=td)
    assert set(td) == {"upload", "decode", "dequantize"}
    assert all(v >= 0 for v in (*tc.values(), *td.values()))
    _same_tree(back, decompress_params(cp, "cpu"))


def test_engine_on_round_tripped_params_matches_reference(smoke,
                                                          round_trips):
    """A SMOKE serving engine (paged APack KV, fused) on the port's
    round-tripped params generates the JAX engine's greedy tokens on the
    JAX's round-tripped params, with the same KV ratio; six new tokens a
    request, short of the CPU ``exp`` last-bit flip (ROADMAP §3)."""
    cfg_j, cfg, _, _, _ = smoke
    want, got = round_trips[0][DEFAULT_WEIGHT_MIN_SIZE]
    kw = dict(max_batch=2, max_len=64, kv_page_size=4, kv_calib_pages=2)
    je = JEngine(dataclasses.replace(cfg_j, kv_cache_dtype="apack-int8"),
                 jdecompress_params(want), kv_backend="ref", **kw)
    pe = ServeEngine(dataclasses.replace(cfg, kv_cache_dtype="apack-int8"),
                     decompress_params(got, "cpu"), device="cpu", **kw)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (19, 26, 11)]
    jr = [JRequest(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    pr = [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for a, b in zip(jr, pr):
        je.submit(a)
        pe.submit(b)
    je.run_until_drained()
    pe.run_until_drained()
    assert all(r.done for r in pr)
    assert [r.tokens for r in pr] == [r.tokens for r in jr]
    assert pe.kv_stats()["kv_ratio"] == je.kv_stats()["kv_ratio"]
