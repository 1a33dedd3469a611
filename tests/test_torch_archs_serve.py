"""``ServeEngine`` on the remaining transformer architectures in the port
against the JAX engine, at SMOKE width on the CPU, on the same converted
params: greedy tokens, ``kv_ratio`` and the packed-page count equal on
minitron-8b (dense and packed weights, the untied head packed and
``weight_stats`` equal), command-r-plus-104b (parallel blocks),
paligemma-3b (text through the gemma-scaled embeddings) and dbrx-132b (top-k
MoE) in the fused paged APack KV mode, and on kimi-k2-1t-a32b (MoE with a
shared expert after a dense global prefix layer) on the sync and async
schedulers, the JAX test's case (``tests/test_paged_kv_hetero.py::
test_engine_serves_hybrid_and_prefix_stacks``).  The JAX engines run the
reference backend (``kv_backend="ref"``); the JAX tests hold it to their
Pallas path.  Also the weight round trip's JAX layout of the untied head
and the MoE trees, and the CLI's ``--arch`` on these stacks.

Pad positions of a bucketed prefill and idle decode slots take MoE
capacity in both packages; the runs are short (6 new tokens), as in the
other lockstep tests (ROADMAP, faults: a near-tie flip from a last-bit
``exp`` difference would be scored teacher-forced)."""
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
from repro_torch.models import modules as pm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (Request, ServeEngine, compress_params,
                               decompress_params)

KW = dict(max_batch=2, max_len=40, kv_page_size=4, kv_calib_pages=2)
PACKED = dict(weights="apack-int8", weight_min_size=4096)
CT_FIELDS = ("sym_plane", "ofs_plane", "sym_bits", "ofs_bits", "stored")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cj, cp = (dataclasses.replace(c.get_smoke_config(arch),
                                  kv_cache_dtype="apack-int8")
              for c in (jconfigs, pconfigs))
    params = jax.jit(JM.init_params, static_argnums=0)(
        cj, jax.random.PRNGKey(0))
    return cj, cp, params, params_from_numpy(
        cp, jax.tree.map(np.array, params), "cpu")


def _serve(eng, req_cls, prompts, max_new=6, **run):
    reqs = [req_cls(i, p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(**run)
    assert all(r.done for r in reqs)
    return [list(r.tokens) for r in reqs]


def _prompts(vocab, lens=(9, 14, 12), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch,weights", [
    ("minitron-8b", None), ("minitron-8b", "apack-int8"),
    ("command-r-plus-104b", None), ("paligemma-3b", None),
    ("dbrx-132b", None)])
def test_engine_matches_jax(arch, weights):
    """The fused paged engine: tokens, ``kv_ratio`` and the packed-page
    count equal to the JAX engine's (its materialize oracle, whose tokens
    the JAX tests hold to its fused path); with packed weights,
    ``weight_stats`` equal (the read bytes of the same steps included) and
    the untied head served through a ``PackedWeight``."""
    cj, cp, params, tp = _setup(arch)
    wkw = PACKED if weights else {}
    je = JEngine(cj, params, kv_backend="ref", kv_fused=False, **KW, **wkw)
    want = _serve(je, JRequest, _prompts(cj.vocab_size))
    eng = ServeEngine(cp, tp, device="cpu", **KW, **wkw)
    assert _serve(eng, Request, _prompts(cp.vocab_size)) == want
    if weights:
        assert eng.weight_stats() == je.weight_stats()
        assert isinstance(eng.params["unembed"], pm.PackedWeight)
    got, ref = eng.kv_stats(), je.kv_stats()
    assert got["kv_ratio"] == ref["kv_ratio"] < 1.1
    assert got["kv_pages_packed"] == ref["kv_pages_packed"] > 0
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages


@pytest.mark.parametrize("scheduler", ["sync", "async"])
def test_kimi_prefix_moe_engine_matches_jax(scheduler):
    """kimi-k2 SMOKE (a dense global prefix layer, then MoE layers with a
    shared expert) on the JAX test's case: 3 requests of 9-token prompts,
    6 new tokens, 2 slots, ``max_len`` 32, pages of 4; tokens and
    ``kv_ratio`` equal to the JAX engine's on the same scheduler, every
    page back in the pool."""
    cj, cp, params, tp = _setup("kimi-k2-1t-a32b")
    kw = dict(max_batch=2, max_len=32, kv_page_size=4, kv_calib_pages=2,
              scheduler=scheduler)
    prompts = _prompts(cj.vocab_size, (9, 9, 9), seed=8)
    # the sync reference through its materialize oracle (the JAX tests
    # hold it to its fused path); the async scheduler needs the fused path
    je = JEngine(cj, params, kv_backend="ref",
                 kv_fused=scheduler == "async", **kw)
    want = _serve(je, JRequest, prompts, max_steps=300)
    eng = ServeEngine(cp, tp, device="cpu", **kw)
    assert _serve(eng, Request, prompts, max_steps=300) == want
    ks = eng.kv_stats()
    assert ks["kv_ratio"] == je.kv_stats()["kv_ratio"] < 1.2
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages


@pytest.mark.parametrize("arch", ["minitron-8b", "kimi-k2-1t-a32b"])
def test_compress_params_carries_head_and_moe_trees(arch):
    """The JAX CLI's default weight path on an untied head and on MoE
    trees: ``compress_params`` gives the JAX package's paths (``unembed``,
    ``blocks/0/ffn/router``, ``.../wi``, ``.../shared/w_up``, the dense
    ``prefix/0/ffn``), containers and byte counts, and
    ``decompress_params`` puts every leaf back."""
    cj, cp, params, tp = _setup(arch)
    paths = [jax.tree_util.keystr(k, simple=True, separator="/")
             for k, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    want = jcompress_params(params, min_size=32768)
    got = compress_params(cp, tp, min_size=32768)
    assert got.paths == paths
    assert set(got.containers) == {paths[i] for i in want.containers}
    assert got.compressed_bytes == want.compressed_bytes
    for i, (ct, scale, _) in want.containers.items():
        pct, pscale, _ = got.containers[paths[i]]
        assert np.array_equal(pscale, scale)
        for f in CT_FIELDS:
            assert np.array_equal(getattr(pct, f), getattr(ct, f)), paths[i]
    back = decompress_params(got, "cpu")
    assert back.keys() == tp.keys()
    for layer, blk in enumerate(back["blocks"]):
        assert blk["ffn"].keys() == tp["blocks"][layer]["ffn"].keys()
        assert torch.equal(blk["norm2"], tp["blocks"][layer]["norm2"])


@pytest.mark.parametrize("arch,extra", [
    ("minitron-8b", []),
    ("dbrx-132b", ["--weights", "apack-int8", "--weight-min-size", "1024"]),
    ("kimi-k2-1t-a32b", ["--no-compress", "--scheduler", "async"]),
    ("command-r-plus-104b", ["--no-compress", "--kv-materialize"]),
    ("paligemma-3b", ["--no-compress", "--kv", "int8"])])
def test_cli_serves_the_new_archs(arch, extra, capsys):
    """``--arch`` serves every new decoder: the default weight round trip
    (minitron's untied head through the coder), packed weights around the
    routed experts (dbrx), the async scheduler (kimi), the materialize
    oracle (command-r) and a dense int8 cache (paligemma)."""
    cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
              "3", "--prompt-len", "8", "--max-new", "4", "--max-batch",
              "2", "--kv-page-size", "4"] + (["--kv", "apack-int8"]
                                             if "--kv" not in extra else [])
             + extra)
    lines = capsys.readouterr().out.splitlines()
    assert any("'completed': 3" in ln for ln in lines), lines
    assert any(ln.startswith("APack weight compression:")
               for ln in lines) == (not extra)
    assert any(ln.startswith("packed weight store:")
               for ln in lines) == ("--weights" in extra)


def test_encoder_is_refused_by_the_engine_and_cli():
    """hubert-xlarge forwards only: the engine and the CLI refuse it,
    saying why."""
    _, cp, _, tp = _setup("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder.*no decode path"):
        ServeEngine(cp, tp, device="cpu", **KW)
    with pytest.raises(ValueError, match="encoder"):
        cli.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
