"""Packed weights on heterogeneous stacks (``pack_weights`` by layer kind)
in the port against the JAX package, on the CPU: ``hetero-serve-smoke``
and recurrentgemma-9b SMOKE (window 8) with ``weight_min_size=1024``.

``pack_weights`` must pack the same sites (the attention projections of
global and rolling layers, every layer's FFN, prefix layers one tensor
each; the RG-LRU block's own matrices, the embedding and the tied head
dense) with bit-identical planes and the same stats, and the engines'
``weight_stats()`` must be equal.  The packed engine's tokens are scored
teacher-forced, as the reference scores packed-weight parity: the JAX
model's packed forward over the port engine's sequences
predicts each generated token, and both packages' teacher-forced logits
agree within 0.05 (the engine tests' bound for a transcendental's last
bit)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import modules as jmm
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as pconfigs
from repro_torch.models import model as PM
from repro_torch.models import modules as pmm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

KW = dict(max_batch=2, max_len=40, kv_page_size=4, kv_calib_pages=2,
          weights="apack-int8", weight_min_size=1024)
CW_FIELDS = ("sym_plane", "ofs_plane", "stored", "v_min", "ol", "cum",
             "scale")


def _cfgs(arch):
    if arch == "hetero-serve-smoke":
        cj, cp = (jconfigs.get_hetero_smoke_config(),
                  pconfigs.get_hetero_smoke_config())
    else:
        cj = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                 window_size=8)
        cp = dataclasses.replace(pconfigs.get_smoke_config(arch),
                                 window_size=8)
    return (dataclasses.replace(cj, kv_cache_dtype="apack-int8"),
            dataclasses.replace(cp, kv_cache_dtype="apack-int8"))


@functools.lru_cache(maxsize=None)
def _jax_params(cj):
    return jax.jit(JM.init_params, static_argnums=0)(cj,
                                                     jax.random.PRNGKey(0))


@pytest.fixture(scope="module",
                params=("hetero-serve-smoke", "recurrentgemma-9b"))
def arch(request):
    cj, cp = _cfgs(request.param)
    params = _jax_params(cj)
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    eng = ServeEngine(cp, tp, device="cpu", **KW)
    # the JAX engine packs with ``pack_weights(cfg, params, min_size)``:
    # its planes and stats are the JAX package's packing, done once
    je = JEngine(cj, params, kv_backend="ref", **KW)
    return dict(name=request.param, cj=cj, cp=cp, params=params, tp=tp,
                eng=eng, je=je, jpacked=(je.params, je._weight_stats),
                ppacked=(eng.params, eng._weight_stats))


def _jax_leaf(cfg, jp, layer, grp, name):
    """The JAX packed leaf of network layer ``layer``: its own prefix
    tensor, or layer ``j`` of its cycle position's stack."""
    n_prefix, n_cycle = len(cfg.prefix_pattern), len(cfg.cycle)
    if layer < n_prefix:
        return jp["prefix"][layer][grp][name], None
    j, c = divmod(layer - n_prefix, n_cycle)
    return jp["blocks"][c][grp][name], j


def test_pack_weights_by_kind_matches_jax(arch):
    """The same sites packed per layer kind, each layer's planes equal to
    the JAX package's (its prefix tensor or its slice of the stack), and
    the same stats: one packed tensor per (site, cycle position) and one
    per prefix-layer tensor."""
    cfg = arch["cp"]
    (jp, jstats), (pp, pstats) = arch["jpacked"], arch["ppacked"]
    assert pstats == jstats and pstats["packed_tensors"] > 0
    assert isinstance(pp["embed"], torch.Tensor) and "unembed" not in pp
    n_sites = 0
    for layer, (kind, blk) in enumerate(zip(PM.layer_kinds(cfg),
                                            pp["blocks"])):
        names = [("ffn", n) for n in ("w_up", "w_gate", "w_down")]
        if kind in PM.ATTN_KINDS:
            names += [("inner", n) for n in ("wq", "wk", "wv", "wo")]
        else:
            for name, w in blk["inner"].items():
                assert not isinstance(w, pmm.PackedWeight), name
        for grp, name in names:
            pw = blk[grp][name]
            jw, j = _jax_leaf(cfg, jp, layer, grp, name)
            assert isinstance(pw, pmm.PackedWeight), (layer, name)
            assert isinstance(jw, jmm.PackedWeight), (layer, name)
            assert (pw.shape, pw.n_contract, pw.dtype) == \
                (jw.shape, jw.n_contract, jw.dtype)
            jcw = jw.cw if j is None else jax.tree.map(lambda a: a[j], jw.cw)
            for f in CW_FIELDS:
                want = np.asarray(getattr(jcw, f))
                got = getattr(pw.cw, f).numpy()
                if want.dtype == np.uint32:
                    got = got.view(np.uint32)
                np.testing.assert_array_equal(got, want, err_msg=(layer, f))
            n_sites += 1
    assert n_sites >= pstats["packed_tensors"] > 0


def test_weight_stats_equal_the_jax_engines(arch):
    """``weight_stats()`` of the port's packed engine (before it serves)
    equals the JAX engine's."""
    assert arch["eng"].weight_stats() == arch["je"].weight_stats()


def test_packed_engine_teacher_forced_against_jax(arch):
    """The port's packed engine serves three requests; the JAX model's
    packed forward, teacher-forced over each served sequence, predicts
    every generated token, and the two packages' teacher-forced logits
    agree within 0.05."""
    cfg = arch["cp"]
    jp = arch["jpacked"][0]
    eng = arch["eng"]
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=6) for i, n in enumerate((9, 14, 6))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and len(r.tokens) == 6 for r in reqs)
    fwd = jax.jit(lambda p, t: JM.forward(arch["cj"], p, {"tokens": t},
                                          remat=False)[0])
    seqs = [np.concatenate([r.prompt, np.asarray(r.tokens[:-1])])
            for r in reqs]
    # one JAX forward over the three sequences, each padded at its end
    # (causal: a position's logits do not read the pad after it)
    width = max(len(q) for q in seqs)
    batch = np.zeros((len(seqs), width), np.int32)
    for i, q in enumerate(seqs):
        batch[i, :len(q)] = q
    wants = np.asarray(fwd(jp, jnp.asarray(batch)))
    agree = total = 0
    for r, seq, want in zip(reqs, seqs, wants):
        want = want[:len(seq)]
        got = PM.forward(cfg, eng.params,
                         torch.as_tensor(seq[None]))[0][0].numpy()
        np.testing.assert_allclose(got, want, atol=0.05)
        pred = want[len(r.prompt) - 1:].argmax(-1)
        agree += int((pred == np.asarray(r.tokens)).sum())
        total += len(r.tokens)
    assert agree == total
