"""xLSTM (xlstm-125m: alternating mLSTM and sLSTM layers) in the port
against the JAX package, at SMOKE width on the CPU, on the same converted
params and seeded numpy inputs:

- ``mlstm_full``/``slstm_full`` (with and without a pad mask) and
  ``mlstm_step``/``slstm_step`` against the compiled JAX functions: the
  bf16 outputs within one bf16 step (``OUT_ATOL``; at this size the full
  outputs come out bit-equal but for one value of the padded mLSTM), the
  f32 states of the full form within ``STATE_RTOL`` of their largest
  magnitude (XLA's and PyTorch's CPU ``exp``, ``log1p`` and reductions
  part in the last f32 bits), the step's within ``STEP_RTOL``, one bf16
  step: its q, k and v are bf16 products of a 2-row matmul, where XLA and
  PyTorch sum in other orders and can round an element apart;
- the SMOKE forward's logits within 0.05 with the same argmax, the
  port's decode against its forward at the reference's own 0.08
  (``tests/test_archs.py``: the chunkwise and step forms part by bf16
  ulps), ``exact_param_count`` of the full config equal to the JAX
  package's;
- the paged cache of an all-state stack: no pages, ``kv_ratio`` None,
  and the state snapshot round trip bit for bit with the -1e30
  stabilizers of the empty state included, its containers equal to the
  JAX package's ``compress_float(table_mode="weight")``;
- the fused engine's tokens and KV stats equal to the JAX engine's,
  uninterrupted and with slot 0 preempted and resumed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import modules as jm
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch import configs as pconfigs
from repro_torch.models import model as PM
from repro_torch.models import modules as pm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

ARCH = "xlstm-125m"
OUT_ATOL = 2 ** -7          # one bf16 step at magnitudes below 2
STATE_RTOL = 1e-5
STEP_RTOL = 2 ** -8
CT_FIELDS = ("sym_plane", "ofs_plane", "sym_bits", "ofs_bits", "stored")
KW = dict(max_batch=2, max_len=24, kv_page_size=4)
PROMPT_LENS = (8, 11, 5)
MAX_NEW = 6


@functools.lru_cache(maxsize=None)
def _jax_params(cj):
    return jax.jit(JM.init_params, static_argnums=0)(cj,
                                                     jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def pair():
    cj = jconfigs.get_smoke_config(ARCH)
    cp = pconfigs.get_smoke_config(ARCH)
    params = _jax_params(cj)
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    return dict(cj=cj, cp=cp, params=params, tp=tp,
                sp=PM.serving_params(tp))


def _close_states(got: dict, want: dict, rtol=STATE_RTOL):
    assert got.keys() == want.keys()
    for f, w in want.items():
        w = np.asarray(w)
        g = got[f].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = np.abs(w[np.abs(w) < 1e29]).max(initial=1.0)
        np.testing.assert_allclose(g, w, atol=rtol * scale, rtol=0,
                                   err_msg=f)


def _bf16(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("padded", [False, True])
def test_cells_match_jax(pair, kind, padded):
    """The block's full-sequence form (32 steps, with the last 11 pad
    steps when ``padded``) and then one decode step from the JAX side's
    final state, against the compiled JAX functions."""
    cj, cp = pair["cj"], pair["cp"]
    layer = 0 if kind == "mlstm" else 1
    jp = jax.tree.map(lambda x: x[0], pair["params"]["blocks"][layer]
                      ["inner"])
    pp = pair["sp"]["blocks"][layer]["inner"]
    jfull, jstep = {"mlstm": (jm.mlstm_full, jm.mlstm_step),
                    "slstm": (jm.slstm_full, jm.slstm_step)}[kind]
    pfull, pstep = {"mlstm": (pm.mlstm_full, pm.mlstm_step),
                    "slstm": (pm.slstm_full, pm.slstm_step)}[kind]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(0, 1, (2, 32, cj.d_model)),
                    jnp.float32).astype(jnp.bfloat16)
    pad = np.arange(32) >= 21 if padded else None
    jy, jst = jax.jit(lambda p, a, m: jfull(p, a, cj, pad_mask=m))(
        jp, x, None if pad is None else jnp.asarray(pad))
    py, pst = pfull(pp, _bf16(x), cp, pad_mask=None if pad is None
                    else torch.from_numpy(pad))
    assert py.dtype == torch.bfloat16
    np.testing.assert_allclose(py.float().numpy(),
                               np.array(jy.astype(jnp.float32)),
                               atol=OUT_ATOL, rtol=0)
    _close_states(pst, jst)
    x1 = jnp.asarray(rng.normal(0, 1, (2, 1, cj.d_model)),
                     jnp.float32).astype(jnp.bfloat16)
    jy1, jst1 = jax.jit(lambda p, a, c: jstep(p, a, c, cj))(jp, x1, jst)
    py1, pst1 = pstep(pp, _bf16(x1), {f: torch.from_numpy(np.array(v))
                                      for f, v in jst.items()}, cp)
    np.testing.assert_allclose(py1.float().numpy(),
                               np.array(jy1.astype(jnp.float32)),
                               atol=OUT_ATOL, rtol=0)
    _close_states(pst1, jst1, STEP_RTOL)


def test_pad_steps_carry_the_state(pair):
    """Pad steps are no-ops (``log_sigmoid(1e30)`` is exactly 0): the
    final state of 8 steps and 8 pad steps equals that of the 8 steps
    alone, bit for bit for the sLSTM cell, within ``STATE_RTOL`` for the
    mLSTM, whose one 16-step chunk sums its products in another order
    than an 8-step chunk."""
    cp = pair["cp"]
    assert pm.log_sigmoid(torch.tensor([1e30])).item() == 0.0
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, 16, cp.d_model)).astype(np.float32)).to(torch.bfloat16)
    for layer, full in ((0, pm.mlstm_full), (1, pm.slstm_full)):
        p = pair["sp"]["blocks"][layer]["inner"]
        _, want = full(p, x[:, :8], cp)
        _, got = full(p, x, cp, pad_mask=torch.arange(16) >= 8)
        if layer == 1:
            for f in want:
                assert torch.equal(got[f], want[f]), f
        else:
            _close_states(got, {f: v.numpy() for f, v in want.items()})


def test_forward_and_decode(pair):
    """Forward logits within 0.05 of the compiled JAX model's with the
    same argmax; the dense-cache decode against the port's own forward at
    the reference's 0.08; the full config's exact parameter count."""
    cj, cp = pair["cj"], pair["cp"]
    toks = np.random.default_rng(0).integers(0, cj.vocab_size, (2, 32))
    jl = np.asarray(jax.jit(lambda p, t: JM.forward(
        cj, p, {"tokens": t}, remat=False)[0])(pair["params"],
                                              jnp.asarray(toks)))
    pl, caches = PM.forward(cp, pair["sp"], torch.from_numpy(toks))
    assert pl.shape == (2, 32, cp.vocab_size) and torch.isfinite(pl).all()
    assert [sorted(c) for c in caches] == [["c", "m", "n"],
                                           ["c", "h", "m", "n"]]
    np.testing.assert_allclose(pl.numpy(), jl, atol=0.05)
    assert np.array_equal(pl.argmax(-1).numpy(), jl.argmax(-1))
    b, s = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cp.vocab_size, (b, s)))
    full, _ = PM.forward(cp, pair["sp"], toks)
    cache = PM.init_cache(cp, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = PM.decode_step(cp, pair["sp"], cache, toks[:, t:t + 1],
                                   torch.full((b,), t))
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=0.08)
    full_cfg = pconfigs.get_config(ARCH)
    assert PM.exact_param_count(full_cfg) == JM.exact_param_count(
        jconfigs.get_config(ARCH))


def test_all_state_stack_needs_no_pages():
    cp = dataclasses.replace(pconfigs.get_smoke_config(ARCH),
                             kv_cache_dtype="apack-int8")
    assert PM.PagedKVCache.pages_for_config(cp, 128, 4) == 0
    kv = PM.PagedKVCache(cp, num_pages=0, page_size=4, device="cpu")
    assert kv.attn_layers == [] and kv.state_layers == [0, 1]
    assert kv.pages_needed(1000) == 0 and kv.kv_ratio() is None


def test_snapshot_roundtrip_bit_exact():
    """The reference's ``test_snapshot_roundtrip_bit_exact``: every state
    leaf random or left at its init value (the -1e30 stabilizers), coded
    and decoded bit for bit, the containers equal to the JAX package's
    weight-mode byte planes of the same f32 stream."""
    from repro.core import byteplane as jbyteplane
    cp = dataclasses.replace(pconfigs.get_smoke_config(ARCH),
                             kv_cache_dtype="apack-int8")
    kv = PM.PagedKVCache(cp, num_pages=0, page_size=4, device="cpu")
    kv.add_request(0)
    rng = np.random.default_rng(2)
    for layer in kv.state_layers:
        tmpl = kv._state_template(kv.layer_kinds[layer])
        # the first layer's stabilizer stays at its init, -1e30
        kv.states[0][layer] = {
            f: (v.clone() if (layer, f) == (0, "m") or rng.uniform() >= 0.8
                else torch.from_numpy(rng.normal(0, 3, v.shape).astype(
                    np.float32)))
            for f, v in tmpl.items()}
    assert (kv.states[0][0]["m"] == pm.NEG_INF).all()
    before = {layer: {f: v.clone() for f, v in st.items()}
              for layer, st in kv.states[0].items()}
    snap = kv.snapshot_state(0)
    flat = np.concatenate([before[layer][f].numpy().reshape(-1)
                           for layer, f, _ in snap["manifest"]])
    want = jbyteplane.compress_float(flat, table_mode="weight")
    assert len(snap["planes"].planes) == len(want.planes)
    for a, b in zip(snap["planes"].planes, want.planes):
        for f in CT_FIELDS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    kv.add_request(1)
    kv.restore_state(1, snap)
    for layer, fields in before.items():
        for f, v in fields.items():
            got = kv.states[1][layer][f]
            assert got.view(torch.int32).equal(v.view(torch.int32)), (
                layer, f)
    assert kv.traffic["state_snapshots"] == 1


def _prompts(vocab):
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def reference(pair):
    cj = dataclasses.replace(pair["cj"], kv_cache_dtype="apack-int8")
    eng = JEngine(cj, pair["params"], **KW)
    reqs = [JRequest(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts(cj.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=100)
    return [r.tokens for r in reqs], eng.kv_stats()


@pytest.mark.parametrize("preempt", [False, True])
def test_engine_matches_reference(pair, reference, preempt):
    """The fused engine on xlstm SMOKE: no pages, ``kv_ratio`` None, the
    tokens of the JAX engine; with slot 0 preempted after four steps (its
    states through the byte-plane snapshot) and resumed, the same tokens
    and the states back bit for bit."""
    cp = dataclasses.replace(pair["cp"], kv_cache_dtype="apack-int8")
    eng = ServeEngine(cp, pair["tp"], device="cpu", **KW)
    reqs = [Request(i, p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts(cp.vocab_size))]
    for r in reqs:
        eng.submit(r)
    if preempt:
        for _ in range(4):
            eng.step()
        rid = eng.active[0].rid
        live = eng.kv.read_state_slot(0)
        eng.preempt(0)
        eng.step()
        assert eng.active[0].rid == rid and eng.stats["resumed"] == 1
        for layer, d in live.items():
            for f, v in d.items():
                assert torch.equal(eng.kv.states[rid][layer][f], v)
    eng.run_until_drained(max_steps=100)
    want_tokens, want = reference
    assert [r.tokens for r in reqs] == want_tokens
    got = eng.kv_stats()
    assert got["kv_ratio"] is None is want["kv_ratio"]
    assert got["kv_pool_pages"] == 0 == want["kv_pool_pages"]
    st = got["kv_streams"]["state"]
    if preempt:
        assert st["snapshots"] == 1 and 0 < st["ratio"] < 1.1
    else:
        assert st == want["kv_streams"]["state"]
