"""Packed-weight serving of the port against the JAX package on the CPU:
``quantize_symmetric``, ``compress_quantized``, the plain
``compressed_matmul`` and ``reference_matmul``, ``pack_weights`` and the
packed engine, each fed the same numpy inputs from a seed.

Tolerances.  The codec is lossless and the quantization elementwise, so
codes, scales, planes, tables and byte counts must be bit-identical.  An f32
product is held to the worst-case rounding bound of a K-term sum,
``K * 2^-24 * sum_k |x_k| |w_kn|`` per output, which covers any summation
order (the port and the JAX kernel both sum the K tiles in kt order; they
agree exactly on this CPU, but the order inside a tile belongs to each
library's GEMM).  Engine logits are held as in ``test_torch_engine.py``:
within 0.05 with the same argmax, then identical greedy tokens and equal
``weight_stats()`` and ``kv_ratio``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import quant as jquant
from repro.kernels import decompress_matmul as jdm
from repro.models import model as JM
from repro.models import modules as jmm
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import quant as pquant
from repro_torch.kernels import decompress_matmul as pdm
from repro_torch.models import model as PM
from repro_torch.models import modules as pmm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

KW = dict(max_batch=2, max_len=64, kv_page_size=4, kv_calib_pages=2,
          weights="apack-int8", weight_min_size=1024)
CW_FIELDS = ("sym_plane", "ofs_plane", "stored", "v_min", "ol", "cum",
             "scale")


def _np(t):
    """Port tensor -> numpy; planes are u32 bits held in int32."""
    return t.numpy()


def _assert_cw_equal(jcw, pcw):
    for f in CW_FIELDS:
        want = np.asarray(getattr(jcw, f))
        got = _np(getattr(pcw, f))
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == want.shape, (f, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("k", "n", "tile_k", "payload_bits", "k_pad", "n_pad"):
        assert getattr(pcw, f) == getattr(jcw, f), f


def _assert_within_sum_bound(got, want, x, w):
    """|got - want| <= K * 2^-24 * (|x| @ |w|), elementwise."""
    bound = x.shape[1] * 2.0 ** -24 * (np.abs(x).astype(np.float64)
                                       @ np.abs(w).astype(np.float64))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= bound).all(), (err.max(), bound.min())


def _cfgs():
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8")
    cfg_p = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8")
    return cfg_j, cfg_p


@pytest.fixture(scope="module")
def smoke():
    cfg_j, cfg_p = _cfgs()
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg_p, jax.tree.map(np.array, params), "cpu")
    return cfg_j, cfg_p, params, tp


# ---------------------------------------------------------- quantization
@pytest.mark.parametrize("shape", [(64, 37), (48, 4, 16), (3, 5, 7, 9)])
def test_quantize_symmetric_bit_identical(shape):
    """Codes and scales equal the JAX function's eager call (the form
    ``_pack_quantize`` makes): f32, axis=-1 over every leading axis, a true
    division by 127 and round-half-even; an all-zero channel takes the
    1e-12 floor."""
    rs = np.random.RandomState(sum(shape))
    for scale in (0.02, 1.0, 3e4):
        x = (rs.standard_normal(shape) * scale).astype(np.float32)
        x[..., 0] = 0.0
        x.reshape(-1, shape[-1])[:5, 1] = 0.5 * scale     # ties at .5 codes
        q, qp = jquant.quantize_symmetric(jnp.asarray(x), axis=-1)
        pq, pqp = pquant.quantize_symmetric(torch.from_numpy(x), axis=-1)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
        np.testing.assert_array_equal(pqp.scale.numpy(), np.asarray(qp.scale))
        np.testing.assert_array_equal(
            pquant.dequantize_symmetric(pq, pqp).numpy(),
            np.asarray(jquant.dequantize_symmetric(q, qp)))


# ------------------------------------------------------------- the codec
def _weight(case, rs):
    k, n, tile_k, kind = case
    if kind == "uniform":          # incompressible: every stream stored
        q = rs.randint(-128, 128, (k, n)).astype(np.int8)
        return q, rs.uniform(0.001, 0.01, n).astype(np.float32), tile_k
    w = (rs.standard_normal((k, n)) * 0.05).astype(np.float32)
    q, qp = jquant.quantize_symmetric(jnp.asarray(w), axis=-1)
    return np.array(q), np.array(qp.scale).reshape(-1), tile_k


CODEC_CASES = [(200, 130, 64, "normal"),     # K % tile_k != 0, N % 128 != 0
               (600, 64, 512, "normal"),     # tile_k 512, K = 600
               (128, 128, 64, "uniform")]    # stored streams


@pytest.mark.parametrize("case", CODEC_CASES)
def test_compress_quantized_bit_identical(case):
    q, scale, tile_k = _weight(case, np.random.RandomState(case[0]))
    jcw = jdm.compress_quantized(q, scale, tile_k)
    pcw = pdm.compress_quantized(torch.from_numpy(q),
                                 torch.from_numpy(scale), tile_k)
    _assert_cw_equal(jcw, pcw)
    if case[3] == "uniform":
        assert pcw.stored.all()
    else:
        assert not pcw.stored.all()


@pytest.mark.parametrize("m", [1, 4, 37])
def test_plain_compressed_matmul_matches_jax(m):
    """Four K tiles (K = 200, tile_k = 64) and a padded N, packed by both
    packages' ``compress_linear``: the plain version against the JAX
    kernel in interpret mode (as JAX's own tests run it) and against both
    packages' ``reference_matmul``."""
    rs = np.random.RandomState(m)
    wf = (rs.standard_normal((200, 130)) * 0.05).astype(np.float32)
    jcw = jdm.compress_linear(wf, tile_k=64)
    pcw = pdm.compress_linear(torch.from_numpy(wf), tile_k=64)
    _assert_cw_equal(jcw, pcw)
    x = rs.standard_normal((m, 200)).astype(np.float32)
    q, qp = jquant.quantize_symmetric(jnp.asarray(wf), axis=-1)
    w = np.asarray(q, np.float32) * np.asarray(qp.scale, np.float32)
    block_m = max(8, min(256, -(-m // 8) * 8))          # as packed_proj
    want = np.asarray(jdm.compressed_matmul(jnp.asarray(x), jcw,
                                            block_m=block_m))
    got = pdm.compressed_matmul(torch.from_numpy(x), pcw).numpy()
    assert got.shape == want.shape == (m, 130)
    _assert_within_sum_bound(got, want, x, w)
    ref_j = np.asarray(jdm.reference_matmul(jnp.asarray(x), jcw))
    ref_p = pdm.reference_matmul(torch.from_numpy(x), pcw).numpy()
    _assert_within_sum_bound(ref_p, ref_j, x, w)
    _assert_within_sum_bound(got, ref_p, x, w)


def test_compressed_matmul_takes_bf16_and_checks_k():
    rs = np.random.RandomState(5)
    q, scale, tile_k = _weight((64, 32, 64, "normal"), rs)
    cw = pdm.compress_quantized(torch.from_numpy(q), torch.from_numpy(scale),
                                tile_k)
    x = torch.from_numpy(rs.standard_normal((3, 64)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    y = pdm.compressed_matmul(xb, cw)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, pdm.compressed_matmul(xb.float(), cw),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="expected"):
        pdm.compressed_matmul(x[:, :60], cw)


# ------------------------------------------------------------ pack_weights
@pytest.fixture(scope="module")
def packed(smoke):
    cfg_j, cfg_p, params, tp = smoke
    return (JM.pack_weights(cfg_j, params, min_size=1024),
            PM.pack_weights(cfg_p, tp, min_size=1024))


def test_pack_weights_matches_jax(smoke, packed):
    """SMOKE with min_size=1024: the same sites packed, each layer's planes
    equal to its slice of the JAX stack, and the same stats."""
    cfg_j, cfg_p, params, tp = smoke
    (jp, jstats), (pp, pstats) = packed
    assert pstats == jstats
    assert pstats["packed_tensors"] == 7
    assert isinstance(pp["embed"], torch.Tensor)
    stack = jp["blocks"][0]
    for layer, blk in enumerate(pp["blocks"]):
        for grp, names in (("inner", ("wq", "wk", "wv", "wo")),
                           ("ffn", ("w_up", "w_gate", "w_down"))):
            for name in names:
                jw, pw = stack[grp][name], blk[grp][name]
                assert isinstance(jw, jmm.PackedWeight)
                assert isinstance(pw, pmm.PackedWeight), name
                assert (pw.shape, pw.n_contract, pw.dtype) == \
                    (jw.shape, jw.n_contract, jw.dtype)
                jcw = jax.tree.map(lambda a: a[layer], jw.cw)
                jcw.payload_bits = None                   # stack total
                pcw = dataclasses.replace(pw.cw)
                pcw.payload_bits = None
                _assert_cw_equal(jcw, pcw)
        assert blk["inner"]["q_norm"] is tp["blocks"][layer]["inner"]["q_norm"]
    # the default min_size packs nothing at SMOKE width, as in the JAX package
    _, st = PM.pack_weights(cfg_p, tp)
    assert st["packed_tensors"] == 0


def test_serving_params_pass_packed_weights_through(smoke, packed):
    cfg_p = smoke[1]
    pp = packed[1][0]
    sp = PM.serving_params(pp)
    blk = sp["blocks"][0]
    assert blk["inner"]["wq"] is pp["blocks"][0]["inner"]["wq"]
    assert blk["inner"]["q_norm"].dtype == torch.float32
    assert sp["embed"].dtype == torch.bfloat16
    # a packed projection equals the dense product of its dequantized codes
    pw = blk["ffn"]["w_up"]
    x = torch.randn(2, 5, cfg_p.d_model, generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    y = pmm.proj(x, pw)
    wf = pdm.dequantized_weight(pw.cw)[:pw.cw.k, :pw.cw.n]
    want = (x.reshape(-1, pw.cw.k).float() @ wf).reshape(2, 5, -1)
    assert y.dtype == torch.bfloat16 and y.shape == want.shape
    torch.testing.assert_close(y.float(), want.to(torch.bfloat16).float(),
                               rtol=2 ** -7, atol=1e-6)
    with pytest.raises(ValueError, match="contracts"):
        pmm.proj(x, pw, 2)


# ------------------------------------------------------------ engine parity
def test_packed_engine_matches_reference_in_lockstep(smoke):
    """Three requests through two slots with every projection packed, both
    engines stepped together: the first three decode steps' logits agree
    within 0.05 with the same argmax, then the greedy tokens, the weight
    accounting and the KV traffic ratio are identical.  (The packed
    products agree bit for bit on this CPU; the bound is the dense
    engine test's, for a transcendental's last bit.)"""
    cfg_j, cfg_p, params, tp = smoke
    je = JEngine(cfg_j, params, kv_backend="ref", **KW)
    pe = ServeEngine(cfg_p, tp, device="cpu", **KW)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_p.vocab_size, n).astype(np.int32)
               for n in (20, 27, 17)]
    jr = [JRequest(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
    pr = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
    for a, b in zip(jr, pr):
        je.submit(a)
        pe.submit(b)
    for _ in range(3):
        je.step()
        pe.step()
        want = np.asarray(je.last_logits)
        got = pe.last_logits.numpy()
        np.testing.assert_allclose(got, want, atol=0.05)
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
    je.run_until_drained()
    pe.run_until_drained()
    assert [r.tokens for r in pr] == [r.tokens for r in jr]
    assert all(r.done for r in pr)
    assert pe.weight_stats() == je.weight_stats()
    assert pe.weight_stats()["compressed_read_bytes_total"] > 0
    ks, jks = pe.kv_stats(), je.kv_stats()
    assert ks["kv_ratio"] == jks["kv_ratio"]
    assert ks["kv_pages_packed"] == jks["kv_pages_packed"] > 0


def test_dense_engine_reports_dense_weights(smoke):
    _, cfg_p, _, tp = smoke
    kw = {k: v for k, v in KW.items() if not k.startswith("weight")}
    eng = ServeEngine(cfg_p, tp, device="cpu", **kw)
    assert eng.weight_stats() == {"weights": "dense"}
    assert not isinstance(eng.params["blocks"][0]["ffn"]["w_up"],
                          pmm.PackedWeight)
    with pytest.raises(ValueError, match="apack-int8"):
        ServeEngine(cfg_p, tp, device="cpu", **{**KW, "weights": "int4"})
