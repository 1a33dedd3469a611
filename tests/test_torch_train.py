"""Training in the port against the JAX package, at SMOKE width on the CPU
(counterparts of ``tests/test_train_substrate.py`` and of
``tests/test_archs.py::test_train_step_grads_finite``):

- ``_q8_encode``/``_q8_decode`` bit-equal to the compiled JAX functions;
- ``lr_schedule`` equal to the compiled one but where XLA's and
  PyTorch's ``cos`` part in the last bit (3 of 130 steps here), and there
  within ``LR_ULPS`` f32 ulps (``1 + cos`` cancels near ``cos = -1``,
  which turns one ulp of ``cos`` into up to four of the result), and
  ``apply_updates`` on the same numpy params, grads and state: the new
  params, f32 moments and ``Q8`` scales within ``UPDATE_ULPS`` ulps of
  their leaf's largest magnitude and the int8 payloads within one code
  (the global norm's f32 sums run in other orders, so the clip factor
  parts in its last bit, and ``pow`` can part by an ulp);
- one ``make_train_step`` step on qwen3, xlstm and dbrx SMOKE (the last
  with its MoE aux losses) against the JAX step on the same converted
  params and batch: the loss within rel 1e-3 (the reference's bound for
  grad accumulation), each gradient leaf within ``GRAD_SHARE`` of its
  largest magnitude (the backward's bf16 roundings sit at other points of
  the two autodiff graphs), the params after the step within ``2.02 lr``
  (the first Adam step moves a param by ``lr`` times the sign of its
  gradient, so an element whose gradient is near 0 can move ``2 lr``
  apart) and 99% of them within ``lr / 100``;
- the port's loss and gradients finite on every architecture;
- grad accumulation 4 against 1 on xlstm SMOKE at the reference's rel
  1e-3 and 2e-2; the loss falling over 30 steps on qwen3 SMOKE;
- ``compress_grads``' round trip and error feedback, and
  ``compressed_psum_mean`` on one replica bit-equal to the JAX package's;
  the data pipeline's
  batches bit-equal to the JAX package's, its resume, and disjoint hosts.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import (BinTokenDataset as JBin, DataConfig as JDataConfig,
                        SyntheticLM as JSynth)
from repro.models import model as JM
from repro.train import AdamWConfig as JAdamW
from repro.train import apply_updates as japply, init_state as jinit
from repro.train import compress_grads as jcg
from repro.train import lr_schedule as jlr
from repro.train import optimizer as jopt
from repro.train.train_step import make_loss_fn as jloss_fn
from repro_torch import configs as pconfigs
from repro_torch import tree
from repro_torch.data import (BinTokenDataset, DataConfig, Prefetcher,
                              SyntheticLM, write_bin)
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train import (AdamWConfig, apply_updates, init_state,
                               lr_schedule, make_train_step)
from repro_torch.train import compress_grads as cg
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_loss_fn, value_and_grad

LR_ULPS = 4
UPDATE_ULPS = 4
GRAD_SHARE = 2e-2
ARCHS = jconfigs.all_arch_ids()


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of many small steps and no parity
    bound (the suite's workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params(cj):
    return jax.jit(JM.init_params, static_argnums=0)(cj,
                                                     jax.random.PRNGKey(0))


def _pair(arch):
    cj, cp = jconfigs.get_smoke_config(arch), pconfigs.get_smoke_config(arch)
    params = _jax_params(cj)
    return cj, cp, params, params_from_numpy(
        cp, jax.tree.map(np.array, params), "cpu")


def _batches(cfg, b=2, s=32, seed=0):
    """The reference test's batch (``tests/test_archs.py::make_batch``),
    for both packages."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        fe = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
        lab = rng.integers(0, cfg.vocab_size, (b, s))
        return ({"frame_embeds": jnp.asarray(fe), "labels": jnp.asarray(lab)},
                {"frame_embeds": torch.from_numpy(fe),
                 "labels": torch.from_numpy(lab)})
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    jb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "vision":
        pe = rng.normal(0, 1, (b, 8, cfg.d_model)).astype(np.float32)
        jb["patch_embeds"] = jnp.asarray(pe)
        pb["patch_embeds"] = torch.from_numpy(pe)
    return jb, pb


def _close(a, b, n=None):
    """|a - b| within ``n`` (``UPDATE_ULPS``) f32 ulps of the largest
    magnitude of b."""
    b = np.asarray(b, np.float32)
    tol = (n or UPDATE_ULPS) * np.spacing(np.abs(b).max(initial=0))
    return float(np.abs(np.asarray(a) - b).max(initial=0)) <= tol


def _ulps(a, b):
    """Largest distance in f32 ulps between two f32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max(initial=0))


# --------------------------------------------------------------- optimizer
def test_q8_bit_equal():
    rng = np.random.default_rng(1)
    for shape in ((1024,), (8, 224), (3, 5, 64), (7,), ()):
        x = rng.normal(0, 0.1, shape).astype(np.float32)
        want = jax.jit(jopt._q8_encode)(jnp.asarray(x))
        got = opt._q8_encode(torch.from_numpy(x))
        assert got.q.shape == x.shape
        assert np.array_equal(got.q.numpy(), np.array(want.q))
        assert np.array_equal(got.scale.numpy(), np.array(want.scale))
        back = opt._q8_decode(got, x.shape)
        wback = jax.jit(lambda s: jopt._q8_decode(s, x.shape, x.size))(want)
        assert np.array_equal(back.numpy(), np.array(wback))
        # per-block absmax scaling bounds the error by max|block|/127
        assert float((back - torch.from_numpy(x)).abs().max()) <= \
            float(np.abs(x).max(initial=0)) / 127 * 1.01 + 1e-30


def test_lr_schedule_matches_jax():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = JAdamW(lr=3e-4, warmup_steps=10, total_steps=100)
    steps = np.arange(0, 130, dtype=np.int32)
    got = lr_schedule(cfg, torch.from_numpy(steps)).numpy()
    want = np.array(jax.jit(lambda s: jlr(jcfg, s))(jnp.asarray(steps)))
    assert _ulps(got, want) <= LR_ULPS
    assert np.mean(got == want) >= 0.95
    assert got[0] == 0.0 and abs(got[10] - 3e-4) < 1e-9
    assert got[-1] == pytest.approx(3e-5, rel=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_apply_updates_matches_jax(state_dtype):
    """Three AdamW steps on the same params and grads (a matrix, a vector,
    a scalar; the clip binding on the second), both packages compiled or
    eager as they train."""
    rng = np.random.default_rng(2)
    p0 = {"w": rng.normal(0, 1, (8, 64)).astype(np.float32),
          "b": rng.normal(0, 1, (64,)).astype(np.float32),
          "s": np.float32(0.5)}
    grads = [{k: (rng.normal(0, sc, np.shape(v)).astype(np.float32))
              for k, v in p0.items()} for sc in (0.01, 3.0, 0.1)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              state_dtype=state_dtype)
    jcfg, pcfg = JAdamW(**kw), AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jinit(jcfg, jp)
    pp = tree.map(torch.as_tensor, p0)
    ps = init_state(pcfg, pp)
    step = jax.jit(lambda p, g, s: japply(jcfg, p, g, s))
    for g in grads:
        jp, js, jm = step(jp, jax.tree.map(jnp.asarray, g), js)
        pp, ps, pm_ = apply_updates(pcfg, pp, tree.map(torch.as_tensor, g),
                                    ps)
        for k in p0:
            assert _close(pp[k].numpy(), jp[k]), k
        assert _ulps(pm_["grad_norm"].numpy(),
                     np.array(jm["grad_norm"])) <= UPDATE_ULPS
        for mom in ("m", "v"):
            for k in p0:
                a, b = ps[mom][k], js[mom][k]
                if state_dtype == "int8":
                    assert np.abs(a.q.numpy().astype(int)
                                  - np.array(b.q).astype(int)).max() <= 1
                    assert _close(a.scale.numpy(), b.scale), (mom, k)
                else:
                    assert _close(a.numpy(), b), (mom, k)
    assert int(ps["step"]) == 3


def test_grad_clip():
    cfg = AdamWConfig(grad_clip=1e-6)
    params = {"w": torch.ones(4)}
    new_p, _, m = apply_updates(cfg, params, {"w": torch.full((4,), 100.0)},
                                init_state(cfg, params))
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float((new_p["w"] - params["w"]).abs().max()) < 0.01


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "xlstm-125m", "dbrx-132b"])
def test_train_step_matches_jax(arch):
    cj, cp, params, tp = _pair(arch)
    jb, pb = _batches(cj)
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn(cj)))(params, jb)
    pl, pg = value_and_grad(make_loss_fn(cp), tp, pb)
    assert float(pl) == pytest.approx(float(jl), rel=1e-3)
    got = jax.tree.leaves(params_to_numpy(cp, pg))
    for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.array, jg)), got):
        assert g.shape == want.shape
        assert np.abs(g - want).max() <= GRAD_SHARE * np.abs(want).max(), \
            jax.tree_util.keystr(path)
    # the JAX step is these grads through ``apply_updates``
    # (``make_train_step`` :44-63 at grad_accum 1)
    kw = dict(lr=1e-3, state_dtype="int8")
    p1, _, m1 = jax.jit(lambda p, g: japply(JAdamW(**kw), p, g, jinit(
        JAdamW(**kw), p)))(params, jg)
    q1, s1, n1 = make_train_step(cp, AdamWConfig(**kw))(
        tp, init_state(AdamWConfig(**kw), tp), pb)
    assert float(n1["loss"]) == pytest.approx(float(jl), rel=1e-3)
    lr = float(m1["lr"])
    assert float(n1["lr"]) == lr
    diffs = np.concatenate([
        np.abs(a - np.array(b)).reshape(-1) for a, b in zip(
            jax.tree.leaves(params_to_numpy(cp, q1)), jax.tree.leaves(p1))])
    assert diffs.max() <= 2.02 * lr
    assert np.mean(diffs <= lr / 100) >= 0.99
    assert isinstance(s1["m"]["blocks"][0]["norm1"], opt.Q8)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grads_finite(arch):
    """``tests/test_archs.py::test_train_step_grads_finite`` on the port:
    the reference's batch, the loss and every gradient finite."""
    cj, cp, _, tp = _pair(arch)
    _, pb = _batches(cp)
    loss, grads = value_and_grad(make_loss_fn(cp), tp, pb)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in tree.leaves(grads))


def test_grad_accum_matches_full_batch(one_thread):
    """The reference's ``test_grad_accum_matches_full_batch`` on xlstm
    SMOKE; the bf16 accumulator halves the memory and stays near."""
    _, cp, _, tp = _pair("xlstm-125m")
    ocfg = AdamWConfig(lr=1e-3)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cp.vocab_size,
                                                     (8, 32)))}
    st = init_state(ocfg, tp)
    p1, _, m1 = make_train_step(cp, ocfg, grad_accum=1)(tp, st, batch)
    for dt in (torch.float32, torch.bfloat16):
        p2, _, m2 = make_train_step(cp, ocfg, grad_accum=4,
                                    accum_dtype=dt)(tp, st, batch)
        assert float(m1["loss"]) == pytest.approx(float(m2["loss"]),
                                                  rel=1e-3)
        d = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree.leaves(p1), tree.leaves(p2)))
        assert d < 2e-2


def test_loss_decreases_on_learnable_data(one_thread):
    """The reference's test on qwen3 SMOKE: 30 steps on ``SyntheticLM``
    batches of 8 x 64."""
    cp = pconfigs.get_smoke_config("qwen3-1.7b")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    data = SyntheticLM(DataConfig(batch_size=8, seq_len=64,
                                  vocab_size=cp.vocab_size))
    from repro_torch.models import model as PM
    params = PM.init_params(cp, torch.Generator().manual_seed(0), "cpu")
    state = init_state(ocfg, params)
    step = make_train_step(cp, ocfg)
    losses = []
    for _ in range(30):
        b = data.next_batch()
        params, state, m = step(params, state,
                                {"tokens": torch.from_numpy(b["tokens"])})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5


# -------------------------------------------------------- compress_grads
def test_quantize_roundtrip_and_error_feedback():
    rng = np.random.default_rng(0)
    g = rng.normal(0, 0.01, (3000,)).astype(np.float32)
    q, s, n = cg.quantize_blockwise(torch.from_numpy(g))
    jq, js, jn = jax.jit(jcg.quantize_blockwise, static_argnums=())(
        jnp.asarray(g))
    assert n == int(jn) == 3000
    assert np.array_equal(q.numpy(), np.array(jq))
    assert np.array_equal(s.numpy(), np.array(js))
    out = cg.dequantize_blockwise(q, s, n, g.shape)
    assert float((out - torch.from_numpy(g)).abs().max()) <= \
        float(s.max()) * 1.01
    # the running mean of error-fed quantizations tracks the gradient
    g = torch.from_numpy(rng.normal(0, 1e-3, (512,)).astype(np.float32))
    e = cg.init_error_feedback({"g": g})["g"]
    acc = torch.zeros_like(g)
    for _ in range(50):
        q, s, n = cg.quantize_blockwise(g + e)
        deq = cg.dequantize_blockwise(q, s, n, g.shape)
        e = (g + e) - deq
        acc = acc + deq
    assert float((acc / 50 - g).abs().max()) < float(g.abs().max()) * 0.05
    # the int8 mean-all-reduce, served on a mesh: on one replica it equals
    # the JAX package's on a one-device mesh, bit for bit
    mesh = jax.make_mesh((1,), ("data",))
    jo, je = jcg.compressed_psum_mean({"g": jnp.asarray(g.numpy())}, mesh,
                                      ("data",), {"g": jnp.asarray(e.numpy())})
    po, pe = cg.compressed_psum_mean([{"g": g}], mesh, ("data",), [{"g": e}])
    assert np.array_equal(po[0]["g"].numpy(), np.asarray(jo["g"]))
    assert np.array_equal(pe[0]["g"].numpy(), np.asarray(je["g"]))


# ------------------------------------------------------------------ data
def test_synthetic_batches_equal_jax_and_resume():
    cfg = DataConfig(batch_size=2, seq_len=16, vocab_size=100, seed=3)
    a, j = SyntheticLM(cfg), JSynth(JDataConfig(**dataclasses.asdict(cfg)))
    for _ in range(3):
        x, y = a.next_batch(), j.next_batch()
        assert all(np.array_equal(x[k], y[k]) for k in ("tokens", "labels"))
    state = a.state_dict()
    nxt = a.next_batch()["tokens"]
    b = SyntheticLM(cfg)
    b.load_state_dict(state)
    assert np.array_equal(b.next_batch()["tokens"], nxt)
    other = dataclasses.replace(cfg, host_index=1)
    assert not np.array_equal(SyntheticLM(cfg).next_batch()["tokens"],
                              SyntheticLM(other).next_batch()["tokens"])
    pf = Prefetcher(SyntheticLM(cfg))
    assert np.array_equal(next(pf)["tokens"],
                          SyntheticLM(cfg).next_batch()["tokens"])
    pf.close()


def test_bin_dataset_equals_jax_and_hosts_disjoint(tmp_path):
    tokens = np.arange(20000) % 997
    path = tmp_path / "t.bin"
    write_bin(path, tokens)
    cfg = DataConfig(batch_size=2, seq_len=16, vocab_size=997)
    ds, js = BinTokenDataset(path, cfg), JBin(path, JDataConfig(
        **dataclasses.asdict(cfg)))
    for _ in range(3):
        x, y = ds.next_batch(), js.next_batch()
        assert np.array_equal(x["tokens"], y["tokens"])
        assert np.array_equal(x["labels"][:, :-1], x["tokens"][:, 1:])
    state = ds.state_dict()
    nxt = ds.next_batch()["tokens"]
    ds2 = BinTokenDataset(path, cfg)
    ds2.load_state_dict(state)
    assert np.array_equal(ds2.next_batch()["tokens"], nxt)
    c0 = DataConfig(batch_size=1, seq_len=64, vocab_size=997, host_index=0,
                    host_count=2)
    c1 = dataclasses.replace(c0, host_index=1)
    assert not np.array_equal(BinTokenDataset(path, c0).next_batch()
                              ["tokens"], BinTokenDataset(path, c1)
                              .next_batch()["tokens"])
