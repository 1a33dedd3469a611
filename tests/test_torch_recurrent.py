"""The port's RG-LRU recurrent block, geglu FFN and rolling (local)
attention against the JAX package's, compiled (jit) on the CPU, on the
same numpy-seeded inputs and params: ``recurrent_full`` with and without
``pad_mask``/``true_len``, ``recurrent_step``, the associative scan,
``mlp`` with geglu, and ``attention_full``/``attention_step`` with
``local=True``.  Every case holds the port bit for bit (f32 states, bf16
outputs, int8 ring caches), which the CPU allows: the transcendentals
(``exp``, ``log1p``, ``logistic``, ``tanh``) of XLA's and PyTorch's CPU
libraries differ in the last f32 bit on some inputs, and none of these
inputs reach such a bit through a bf16 rounding or a state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import modules as jm
from repro_torch import configs as pconfigs
from repro_torch.models import modules as pm

D = 64


def _cfgs(name):
    if name == "hetero-serve-smoke":
        return (dataclasses.replace(jconfigs.get_hetero_smoke_config(),
                                    kv_cache_dtype="apack-int8"),
                dataclasses.replace(pconfigs.get_hetero_smoke_config(),
                                    kv_cache_dtype="apack-int8"))
    return (dataclasses.replace(jconfigs.get_smoke_config(name),
                                window_size=8, kv_cache_dtype="apack-int8"),
            dataclasses.replace(pconfigs.get_smoke_config(name),
                                window_size=8, kv_cache_dtype="apack-int8"))


def _t(x) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype and bits."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.to(torch.float32).numpy(),
                          np.asarray(jnp.asarray(want, jnp.float32)))


def _x(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)


@pytest.fixture(scope="module")
def rec():
    cfg_j, cfg = _cfgs("recurrentgemma-9b")
    p = jm.init_recurrent(cfg_j, jax.random.PRNGKey(1))
    return cfg_j, cfg, p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("s,true_len", [(13, None), (2, None), (16, 11),
                                        (64, 37), (8, 2)])
def test_recurrent_full_and_step_match_reference(rec, s, true_len):
    """Outputs and final states bit for bit, the bucketed case with pad
    steps made inert; then one step from that state."""
    cfg_j, cfg, p, pt = rec
    rng = np.random.default_rng(s)
    x = _x(rng, 2, s, D)
    pad = None if true_len is None else jnp.arange(s) >= true_len
    y, c = jax.jit(lambda p, x: jm.recurrent_full(
        p, x, cfg_j, pad_mask=pad, true_len=true_len))(p, x)
    yt, ct = pm.recurrent_full(
        pt, _t(x), cfg,
        pad_mask=None if true_len is None else torch.arange(s) >= true_len,
        true_len=true_len)
    assert _same(yt, y)
    assert all(_same(ct[f], c[f]) for f in ("h", "conv"))
    x1 = _x(rng, 2, 1, D)
    y1, c1 = jax.jit(lambda p, x, c: jm.recurrent_step(p, x, c, cfg_j))(
        p, x1, c)
    y1t, c1t = pm.recurrent_step(pt, _t(x1), {f: _t(v) for f, v in c.items()},
                                 cfg)
    assert _same(y1t, y1)
    assert all(_same(c1t[f], c1[f]) for f in ("h", "conv"))


@pytest.mark.parametrize("n", [1, 2, 5, 64, 2176])
def test_linear_scan_associates_as_the_reference(n):
    """``linear_scan`` follows ``jax.lax.associative_scan``'s odd/even
    recursion with the FMA combine, so the f32 states are identical (the
    products of ``a`` are not used by the block; they agree until they
    underflow, where XLA flushes subnormals to zero)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 8)).astype(np.float32)
    b = rng.standard_normal((2, n, 8)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, hj = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    _, ht = pm.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(ht.numpy(), np.asarray(hj))


def test_geglu_mlp_matches_reference_in_bf16():
    cfg_j, cfg = _cfgs("recurrentgemma-9b")
    p = jm.init_mlp(cfg_j, jax.random.PRNGKey(2))
    x = _x(np.random.default_rng(3), 2, 9, D)
    y = jax.jit(lambda p, x: jm.mlp(p, x, cfg_j))(p, x)
    yt = pm.mlp({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    assert yt.dtype == torch.bfloat16 and _same(yt, y)


def test_gelu_matches_reference_on_every_normal_bf16():
    """``modules.gelu`` op by op in bf16 against the compiled
    ``jax.nn.gelu`` on every finite bf16 value whose result is a normal
    number (XLA flushes subnormal results to zero)."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    x = jnp.asarray(bits.view(jnp.bfloat16))
    y = np.asarray(jax.jit(jax.nn.gelu)(x).astype(jnp.float32))
    got = pm.gelu(torch.from_numpy(bits.astype(np.int16)).view(
        torch.bfloat16)).to(torch.float32).numpy()
    normal = np.isfinite(y) & (np.abs(y) >= np.finfo(np.float32).tiny)
    assert normal.sum() > 45000
    assert np.array_equal(got[normal], y[normal])


@pytest.mark.parametrize("s,true_len", [(13, None), (5, None), (16, 11),
                                        (8, 8), (32, 19), (16, 3)])
def test_local_attention_ring_matches_reference(s, true_len):
    """``attention_full(local=True)``: output and the int8 ring (slot ``j``
    = the latest real position ``p`` with ``p % window == j``, at the true
    end) bit for bit, for prompts above and below the window; then one
    ``attention_step(local=True)`` on that ring at per-slot positions."""
    cfg_j, cfg = _cfgs("hetero-serve-smoke")
    p = jm.init_attention(cfg_j, jax.random.PRNGKey(1))
    pt = {k: _t(v) if "norm" in k else _t(v).to(torch.bfloat16)
          for k, v in p.items()}
    rng = np.random.default_rng(s)
    x = _x(rng, 2, s, D)
    y, c = jax.jit(lambda p, x: jm.attention_full(
        p, x, cfg_j, local=True, true_len=true_len))(p, x)
    yt, ct = pm.attention_full(pt, _t(x), cfg, local=True, true_len=true_len)
    assert ct["k"].shape[1] == cfg.window_size
    assert _same(yt, y)
    assert all(np.array_equal(ct[f].numpy(), np.asarray(c[f])) for f in c)
    t = s if true_len is None else true_len
    pos = np.array([t, t + 9])
    x1 = _x(rng, 2, 1, D)
    y1, c1 = jax.jit(lambda p, x, c, q: jm.attention_step(
        p, x, c, q, cfg_j, local=True))(p, x1, c, jnp.asarray(pos))
    y1t, c1t = pm.attention_step(pt, _t(x1), ct, torch.from_numpy(pos), cfg,
                                 local=True)
    assert _same(y1t, y1)
    assert all(np.array_equal(c1t[f].numpy(), np.asarray(c1[f])) for f in c1)
