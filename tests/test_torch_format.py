"""The port's codec host layer against the JAX package's, on the same numpy
inputs: the golden container (``core.format``), ``kernels.fastpath``,
``kernels.ops``, float byte planes (``core.byteplane``),
``quantize_affine``, the baselines and the distributions.  No tolerance:
the coder is integer-exact, and the quantizers are a few IEEE f32 ops."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import baselines as jbaselines
from repro.core import byteplane as jbyteplane
from repro.core import distributions as jdistributions
from repro.core import format as jfmt
from repro.core import quant as jquant
from repro.core import tables as jtables
from repro.kernels import fastpath as jfastpath
from repro.kernels import ops as jops
from repro_torch.core import baselines, byteplane, distributions
from repro_torch.core import format as fmt
from repro_torch.core import quant
from repro_torch.core import tables
from repro_torch.kernels import fastpath, ops

CT_FIELDS = ("sym_plane", "ofs_plane", "sym_bits", "ofs_bits", "stored")


def _values(rng, n, bits, n_noisy=0):
    """``n`` Laplace-shaped unsigned values (two's complement around 0),
    the first ``n_noisy`` uniform noise, which AC would inflate."""
    half = 1 << (bits - 1)
    v = np.round(rng.laplace(0, (1 << bits) / 40, n))
    v = np.clip(v, -half + 1, half - 1).astype(np.int64) & ((1 << bits) - 1)
    v[:n_noisy] = rng.integers(0, 1 << bits, n_noisy)
    return v


def _tables(v, bits, kind):
    """The same table for both packages: the port's, and the JAX package's
    copy of it (the searches agree, ``test_torch_codec.py``)."""
    if kind == "uniform":
        return tables.uniform_table(bits), jtables.uniform_table(bits)
    t = tables.table_for(v, bits, True)
    return t, jtables.ApackTable(**dataclasses.asdict(t))


def _same_ct(got, want):
    """Every field of two containers (port's, JAX's) equal, bit for bit."""
    for f in CT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert (got.shape, got.bits, got.elems_per_stream, got.n_valid) == \
        (want.shape, want.bits, want.elems_per_stream, want.n_valid)
    assert (tuple(got.table.v_min), tuple(got.table.ol), tuple(got.table.cum),
            got.table.mode) == (tuple(want.table.v_min), tuple(want.table.ol),
                                tuple(want.table.cum), want.table.mode)
    assert (got.payload_bits, got.total_bits, got.slotted_bits,
            got.original_bits, got.n_streams) == \
        (want.payload_bits, want.total_bits, want.slotted_bits,
         want.original_bits, want.n_streams)
    assert got.ratio() == want.ratio()
    assert got.ratio(include_metadata=False) == \
        want.ratio(include_metadata=False)


# ---------------------------------------------------------- golden container
GOLDEN_CASES = [(4, 1300, "fitted", 512), (8, 1100, "fitted", 512),
                (16, 700, "fitted", 512), (8, 600, "uniform", 512),
                (8, 97, "fitted", 33)]


@pytest.mark.parametrize("bits,n,kind,e", GOLDEN_CASES)
def test_golden_container_matches_reference(bits, n, kind, e):
    """``format.compress``/``decompress`` and ``estimate_bits`` against
    ``repro.core.format``: sizes that are not a multiple of the stream
    length (the tail padded with the table's most probable value), bits
    4/8/16, one noisy stream stored, and stored mode throughout with the
    uniform table."""
    rng = np.random.default_rng(bits * n)
    v = _values(rng, n, bits, n_noisy=e if kind == "fitted" else 0)
    t, jt = _tables(v, bits, kind)
    got = fmt.compress(v, t, bits=bits, elems_per_stream=e)
    want = jfmt.compress(v, jt, bits=bits, elems_per_stream=e)
    _same_ct(got, want)
    assert got.stored.any() and (kind == "uniform") == got.stored.all()
    back = fmt.decompress(got)
    assert back.dtype == jfmt.decompress(want).dtype
    assert np.array_equal(back, v)
    h = tables.histogram(v, bits)
    assert fmt.estimate_bits(h, t) == jfmt.estimate_bits(h, jt)
    assert fmt._pad_value(t) == jfmt._pad_value(jt)
    assert fmt.DEFAULT_ELEMS_PER_STREAM == jfmt.DEFAULT_ELEMS_PER_STREAM
    assert fmt.DIR_BITS_PER_STREAM == jfmt.DIR_BITS_PER_STREAM


# ------------------------------------------------------------------ fastpath
@pytest.mark.parametrize("bits,n,kind,e", GOLDEN_CASES + [
    (8, 2048, "uniform", 512)])
def test_fastpath_matches_golden_and_reference(bits, n, kind, e):
    """``fastpath.compress_np`` on the CPU equals the golden
    ``repro.core.format.compress`` and ``repro.kernels.fastpath``, planes
    trimmed to the golden widths; the uniform-table cases store every
    stream, so their symbol plane has no rows (W = 0), and
    ``decompress_np`` reads it as a row of zeros."""
    rng = np.random.default_rng(bits + n)
    v = _values(rng, n, bits, n_noisy=e if kind == "fitted" else 0)
    v = v.reshape(-1, 4) if n % 4 == 0 else v
    t, jt = _tables(v, bits, kind)
    got = fastpath.compress_np(v, t, bits=bits, elems_per_stream=e,
                               device="cpu")
    _same_ct(got, jfmt.compress(v, jt, bits=bits, elems_per_stream=e))
    _same_ct(got, jfastpath.compress_np(v, jt, bits=bits,
                                        elems_per_stream=e))
    if kind == "uniform":
        assert got.sym_plane.shape[0] == 0 and got.stored.all()
    back = fastpath.decompress_np(got, device="cpu")
    want = jfastpath.decompress_np(got)
    assert back.dtype == want.dtype and back.shape == v.shape
    assert np.array_equal(back, want) and np.array_equal(back, v)
    if e == 33:
        # the table found when none is given is the reference's
        _same_ct(fastpath.compress_np(v, bits=bits, elems_per_stream=e,
                                      device="cpu"),
                 jfastpath.compress_np(v, bits=bits, elems_per_stream=e))


def test_fastpath_entry_points_default_to_cuda():
    """A numpy input computes on the card unless the caller asks for the
    CPU; without a card that raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    v = np.zeros(8, np.uint8)
    t = tables.uniform_table(8)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        fastpath.compress_np(v, t)
    ct = fastpath.compress_np(v, t, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        fastpath.decompress_np(ct)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        ops.apack_encode(v, t)
    with pytest.raises(ValueError, match="table codes 8"):
        fastpath.compress_np(v, t, bits=4, device="cpu")


# ----------------------------------------------------------------------- ops
OPS_CASES = [(4, 37 * 64 - 5, 64, "fitted"), (8, 130 * 33, 33, "fitted"),
             (16, 129 * 16 + 3, 16, "fitted"), (8, 5 * 512 + 1, 512, "fitted"),
             (8, 200 * 7, 7, "uniform")]


@pytest.mark.parametrize("bits,n,e,kind", OPS_CASES)
def test_ops_match_reference(bits, n, e, kind):
    """``ops.apack_encode`` on the CPU: every ``CompressedArrays`` field
    equals ``repro.kernels.ops.apack_encode(backend="ref")`` (u32 planes as
    int32 bit patterns), at stream counts that are not multiples of 128
    (37, 130, 130, 6, 200), odd sizes and stream lengths, bits 4/8/16, and
    stored mode; ``apack_decode`` gives the values back in the reference's
    dtype."""
    rng = np.random.default_rng(n)
    v = _values(rng, n, bits, n_noisy=e if kind == "fitted" else 0)
    t, jt = _tables(v, bits, kind)
    got = ops.apack_encode(torch.from_numpy(v), t, elems_per_stream=e)
    want = jops.apack_encode(jnp.asarray(v), jt, elems_per_stream=e,
                             backend="ref")
    for f in ("sym_plane", "ofs_plane"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f)).view(np.int32)), f
    for f in ("sym_bits", "ofs_bits", "stored", "v_min", "ol", "cum"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.shape, got.bits, got.elems_per_stream, got.n_valid) == \
        (want.shape, want.bits, want.elems_per_stream, want.n_valid)
    assert got.payload_bits == want.payload_bits
    assert got.stored.any() and (kind == "uniform") == bool(got.stored.all())
    back = ops.apack_decode(got)
    jback = np.asarray(jops.apack_decode(want, backend="ref"))
    assert str(back.dtype).removeprefix("torch.") == str(jback.dtype)
    assert np.array_equal(back.numpy(), jback)
    assert np.array_equal(back.numpy(), v)
    assert ops.apack_roundtrip_check(v, t, elems_per_stream=e, device="cpu")
    # the host container through ops: the trimmed planes read the same
    ct = fastpath.compress_np(v, t, bits=bits, elems_per_stream=e,
                              device="cpu")
    ca = ops.CompressedArrays.from_compressed_tensor(ct, "cpu")
    assert ca.payload_bits == ct.payload_bits
    assert np.array_equal(ops.apack_decode(ca).numpy(), v)


def test_ops_refuse_tensors_past_the_kernels_reach():
    """A tensor too large for the kernels' addressing is refused with a
    ValueError before any work, on every device."""
    ops.check_size(ops.MAX_DECODE_STREAMS, 512, 8)
    with pytest.raises(ValueError, match="decode kernel takes at most"):
        ops.check_size(ops.MAX_DECODE_STREAMS + 1)
    with pytest.raises(ValueError, match="past the encode kernel"):
        ops.check_size(ops.MAX_DECODE_STREAMS, 8192, 16)
    big = torch.empty(ops.MAX_DECODE_STREAMS + 1, dtype=torch.int32)
    ca = ops.CompressedArrays(None, None, big, big, None, None, None, None,
                              shape=(1,), bits=8, elems_per_stream=1,
                              n_valid=1)
    with pytest.raises(ValueError, match="decode kernel takes at most"):
        ops.apack_decode(ca)


# ----------------------------------------------------------------- byteplane
def _floats(dtype, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    x[:7] = [0.0, -0.0, 1.5, -3.25, 1e-30, 65504.0, -1e-3]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table_mode", ["activation", "weight"])
def test_byteplane_matches_reference(dtype, table_mode):
    """``compress_float``/``decompress_float`` on f32 and bf16 in both
    table modes: every plane's container equals ``repro.core.byteplane``'s
    (the fast path against its ``jnp`` path; the golden coders on a short
    tensor of 512-value streams; the fast path on 64-value streams), and
    the tensor comes back bit for bit, with its dtype."""
    x = _floats(dtype, 5000, seed=len(dtype) + len(table_mode))
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(tx.view(torch.int16 if dtype == "bfloat16"
                                  else torch.int32).numpy(),
                          np.asarray(jx).view(np.int16 if dtype == "bfloat16"
                                              else np.int32))
    for backend, jbackend, n, e in (("fastpath", "jnp", 5000, 64),
                                    ("golden", "golden", 700, 512)):
        got = byteplane.compress_float(tx[:n].reshape(-1, 10 if n == 5000
                                                      else 7),
                                       elems_per_stream=e, backend=backend,
                                       table_mode=table_mode)
        want = jbyteplane.compress_float(jx[:n].reshape(got.shape),
                                         elems_per_stream=e,
                                         backend=jbackend,
                                         table_mode=table_mode)
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        assert len(got.planes) == len(want.planes)
        for a, b in zip(got.planes, want.planes):
            _same_ct(a, b)
        assert any(p.stored.all() for p in got.planes)   # a mantissa plane
        assert not all(p.stored.all() for p in got.planes)
        assert (got.total_bits, got.original_bits, got.ratio()) == \
            (want.total_bits, want.original_bits, want.ratio())
        back = byteplane.decompress_float(got, backend=backend, device="cpu")
        assert back.dtype == tx.dtype and back.shape == got.shape
        assert torch.equal(back.reshape(-1).view(torch.uint8),
                           tx[:n].reshape(-1).view(torch.uint8))


def test_byteplane_takes_numpy_and_refuses_what_it_cannot_code():
    x = _floats("float32", 600, seed=9)
    cp = byteplane.compress_float(x, elems_per_stream=64, device="cpu")
    assert cp.dtype == "float32"
    assert torch.equal(byteplane.decompress_float(cp, device="cpu"),
                       torch.from_numpy(x))
    with pytest.raises(ValueError, match="table_mode"):
        byteplane.compress_float(x, table_mode="both", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        byteplane.compress_float(x, backend="jnp", device="cpu")
    with pytest.raises(TypeError, match="not a float"):
        byteplane.compress_float(torch.zeros(4, dtype=torch.int32))


# ------------------------------------------ quantize_affine, baselines, data
@pytest.mark.parametrize("bits,axis", [(8, None), (8, -1), (8, 0), (12, 1)])
def test_quantize_affine_matches_reference(bits, axis):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((37, 29)) * 3 + 0.5).astype(np.float32)
    x[3] = 7.0                                  # a constant-ish row
    q, qp = quant.quantize_affine(torch.from_numpy(x), bits, axis)
    jq, jqp = jquant.quantize_affine(jnp.asarray(x), bits, axis)
    assert str(q.dtype).removeprefix("torch.") == str(jq.dtype)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(qp.scale.numpy(), np.asarray(jqp.scale))
    assert np.array_equal(qp.zero_point.numpy(), np.asarray(jqp.zero_point))
    assert (qp.bits, qp.signed, qp.axis) == (jqp.bits, jqp.signed, jqp.axis)
    assert np.array_equal(quant.dequantize_affine(q, qp).numpy(),
                          np.asarray(jquant.dequantize_affine(jq, jqp)))


@pytest.mark.parametrize("name", sorted(distributions.PAPER_LIKE))
def test_distributions_and_baselines_match_reference(name):
    """Each paper-like generator draws the reference's values from the same
    seed, and each baseline prices them (and edge cases) as the reference
    does."""
    v = distributions.PAPER_LIKE[name](3001, seed=4)
    jv = jdistributions.PAPER_LIKE[name](3001, seed=4)
    assert v.dtype == jv.dtype and np.array_equal(v, jv)
    for x in (v, np.zeros(40, np.uint8), np.array([], np.uint8),
              np.array([5, 0, 0, 0, 250, 250, 0], np.uint8)):
        for f in ("rle_bits", "rlez_bits", "shapeshifter_bits",
                  "baseline_bits"):
            assert getattr(baselines, f)(x) == getattr(jbaselines, f)(x), f
    assert baselines.shapeshifter_bits(v, zero_vector=False, group=4) == \
        jbaselines.shapeshifter_bits(v, zero_vector=False, group=4)
