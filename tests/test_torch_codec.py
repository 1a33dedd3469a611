"""Port codec vs the JAX package: table search, plain encode/decode, the
golden container and the Pallas kernels in interpret mode, all on the same
numpy inputs.  Codec outputs are compared bit for bit (no tolerance: the
arithmetic coder is integer-exact)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import format as jfmt
from repro.core import tables as jtables
from repro.kernels import apack_decode as japack_decode
from repro.kernels import apack_encode as japack_encode
from repro.kernels import ref as jref
from repro_torch.core import tables as ptables
from repro_torch.kernels import (apack_decode, apack_encode,
                                 decompress_matmul, paged_decode)
from repro_torch.kernels import ref as pref


def _values(rng, s, e, bits, n_noisy):
    """Laplace-shaped unsigned values (two's complement around 0) with
    ``n_noisy`` streams of uniform noise, which AC would inflate, so they
    go to stored mode."""
    half = 1 << (bits - 1)
    v = np.round(rng.laplace(0, (1 << bits) / 40, (s, e)))
    v = np.clip(v, -half + 1, half - 1).astype(np.int64) & ((1 << bits) - 1)
    v[:n_noisy] = rng.integers(0, 1 << bits, (n_noisy, e))
    return v.astype(np.int32)


def _same_table(a, b):
    return (tuple(a.v_min), tuple(a.ol), tuple(a.cum), a.bits, a.mode) == \
        (tuple(b.v_min), tuple(b.ol), tuple(b.cum), b.bits, b.mode)


@pytest.mark.parametrize("bits,is_act", [(4, False), (8, True), (16, True)])
def test_find_table_matches_reference(bits, is_act):
    rng = np.random.default_rng(bits)
    v = _values(rng, 8, 64, bits, 1)
    h = jtables.histogram(v, bits)
    h[::7] = 0                                   # empty ranges
    assert _same_table(ptables.find_table(h, bits, is_act),
                       jtables.find_table(h, bits, is_act))
    assert _same_table(ptables.uniform_table(bits),
                       jtables.uniform_table(bits))
    t = jtables.find_table(h, bits, is_act)
    assert ptables.expected_bits_per_value(h, t) == \
        jtables.expected_bits_per_value(h, t)


def _shaped_hist(rng, shape):
    """An 8-bit histogram of int8 values two's-complement coded: a normal
    weight column, a narrow or wide Laplace activation body, or a few
    spikes."""
    n = 50_000
    x = {"normal": lambda: rng.normal(0, 40, n),
         "narrow": lambda: rng.laplace(0, 2, n),
         "wide": lambda: rng.laplace(0, 30, n),
         "spikes": lambda: rng.choice([-90, -3, 0, 5, 60], n)}[shape]()
    v = np.clip(np.round(x), -127, 127).astype(np.int64) & 0xFF
    return np.bincount(v, minlength=256).astype(np.int64)


@pytest.mark.parametrize("shape", ["normal", "narrow", "wide", "spikes"])
def test_table_search_scores_equal_reference(shape):
    """The search scores a candidate from per-range terms summed in numpy's
    order; each score equals the JAX package's ``_encoded_size_csum`` bit
    for bit, so both searches take the same path to the same table."""
    rng = np.random.default_rng(len(shape))
    h = _shaped_hist(rng, shape)
    csum = np.concatenate([[0], np.cumsum(h)])
    total = int(h.sum())
    terms = ptables._range_terms(csum, total, 8)
    for i in range(300):
        # every other draw packs the boundaries into 30 values: ranges of
        # width 1 and 2 beside wide ones
        pool = np.arange(1, 256) if i % 2 else np.arange(110, 140)
        v_min = [0] + sorted(rng.choice(pool, 15, replace=False).tolist())
        xs = [terms[a][b] for a, b in zip(v_min, v_min[1:] + [256])]
        got = ptables._np_sum([x for x in xs if x >= 0.0])
        assert got == jtables._encoded_size_csum(csum, total, v_min, 8)
    for is_act in (False, True):
        assert _same_table(ptables.find_table(h, 8, is_act),
                           jtables.find_table(h, 8, is_act))


CASES = [(4, 37, 33, "fitted"), (8, 4, 128, "fitted"),
         (16, 130, 7, "fitted"), (8, 37, 33, "uniform")]


@pytest.mark.parametrize("bits,s,e,table", CASES)
def test_encode_decode_bit_identical(bits, s, e, table):
    """Planes, bit counts and stored flags equal ``repro.kernels.ref`` and
    the golden container ``repro.core.format.compress``; decode returns
    the input.  Stream counts 4/37/130 are not multiples of 128, n_steps
    33 and 7 are odd, and each case mixes stored and coded streams (the
    uniform table stores every Laplace stream)."""
    rng = np.random.default_rng(s * bits)
    v = _values(rng, s, e, bits, n_noisy=2)
    t = (jtables.find_table(jtables.histogram(v, bits), bits, True)
         if table == "fitted" else jtables.uniform_table(bits))
    got = apack_encode.encode(torch.from_numpy(v),
                              *pref.table_tensors(t), n_steps=e, bits=bits)
    sym, ofs, sb, ob, st = (x.numpy() for x in got)
    want = [np.asarray(x) for x in
            jref.encode(jnp.asarray(v), jref.TableArrays.from_table(t), e,
                        bits)]
    assert np.array_equal(sym, want[0].view(np.int32))
    assert np.array_equal(ofs, want[1].view(np.int32))
    assert np.array_equal(sb, want[2]) and np.array_equal(ob, want[3])
    assert np.array_equal(st, want[4])
    assert st.any() and (table == "uniform" or not st.all())
    # golden container: exact-size planes, same words, zero capacity tail
    ct = jfmt.compress(v.reshape(-1), t, bits=bits, elems_per_stream=e)
    for plane, gold in ((sym, ct.sym_plane), (ofs, ct.ofs_plane)):
        w = gold.shape[0]
        assert np.array_equal(plane[:w], gold.view(np.int32))
        assert not plane[w:].any()
    assert np.array_equal(sb, ct.sym_bits) and np.array_equal(ob, ct.ofs_bits)
    assert np.array_equal(st, ct.stored)
    back = apack_decode.decode(*(torch.from_numpy(x) for x in (sym, ofs, st)),
                               *pref.table_tensors(t), n_steps=e, bits=bits)
    assert np.array_equal(back.numpy(), v)
    assert np.array_equal(
        back.numpy(),
        np.asarray(jref.decode(jnp.asarray(want[0]), jnp.asarray(want[1]),
                               jnp.asarray(want[4]),
                               jref.TableArrays.from_table(t), e, bits)))


def test_plain_codec_matches_pallas_interpret():
    """The Pallas encode/decode kernels in interpret mode on one block of
    128 streams: the kernel contract is ``encode_ac`` (no stored
    selection), decode takes the selected planes."""
    rng = np.random.default_rng(3)
    s, e, bits = 128, 16, 8
    v = _values(rng, s, e, bits, n_noisy=3)
    t = jtables.find_table(jtables.histogram(v, bits), bits, True)
    vm, ol, cum = (jnp.asarray(a) for a in t.as_arrays())
    ks, ko, ksb, kob, kovf = (np.asarray(x) for x in japack_encode.encode_pallas(
        jnp.asarray(v), vm, ol, cum, n_steps=e, bits=bits, interpret=True))
    tt = pref.table_tensors(t)
    ps_, po, psb, pob, povf = pref.encode_ac(torch.from_numpy(v), *tt, e, bits)
    assert np.array_equal(pref.as_i32_bits(ps_).numpy(), ks.view(np.int32))
    assert np.array_equal(pref.as_i32_bits(po).numpy(), ko.view(np.int32))
    assert np.array_equal(psb.numpy(), ksb) and np.array_equal(pob.numpy(), kob)
    assert np.array_equal(povf.numpy(), kovf.astype(bool))
    sym, ofs, _, _, st = apack_encode.encode(torch.from_numpy(v), *tt,
                                             n_steps=e, bits=bits)
    kdec = japack_decode.decode_pallas(
        jnp.asarray(sym.numpy().view(np.uint32)),
        jnp.asarray(ofs.numpy().view(np.uint32)),
        jnp.asarray(st.numpy().astype(np.int32)), vm, ol, cum,
        n_steps=e, bits=bits, interpret=True)
    assert np.array_equal(np.asarray(kdec), v)
    assert np.array_equal(
        apack_decode.decode(sym, ofs, st, *tt, n_steps=e, bits=bits).numpy(),
        v)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    import repro_torch
    repro_torch.reset_launch_counts()
    v = torch.zeros(2, 4, 8, dtype=torch.int32)
    tt = pref.table_tensors(ptables.uniform_table(8))
    out = apack_encode.encode(v, *tt, n_steps=8, bits=8)
    apack_decode.decode(out[0], out[1], out[4], *tt, n_steps=8, bits=8)
    cw = decompress_matmul.compress_linear(torch.ones(8, 4), tile_k=8)
    decompress_matmul.compressed_matmul(torch.ones(2, 8), cw)
    paged_decode.gather_decode(out[0], out[1], out[4], torch.tensor([1, 0]),
                               *tt, n_steps=8, bits=8)
    assert repro_torch.launch_counts() == {
        "apack_decode": 0, "apack_encode": 0, "fused_page_attention": 0,
        "decompress_matmul": 0, "gather_decode": 0}


@pytest.mark.cuda
def test_cuda_codec_kernels_match_plain():
    """On the card: both kernels bit-exact against the plain versions at
    the full-width KV page shape (128 streams x 128 values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    v = torch.from_numpy(np.stack([_values(rng, 128, 128, 8, 4)
                                   for _ in range(3)])).cuda()
    t = jtables.find_table(jtables.histogram(v.cpu().numpy(), 8), 8, True)
    tt = pref.table_tensors(t, "cuda")
    got = apack_encode.encode(v, *tt, n_steps=128, bits=8)
    want = apack_encode.encode_plain(v, *tt, n_steps=128, bits=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    back = apack_decode.decode(got[0], got[1], got[4], *tt, n_steps=128,
                               bits=8)
    assert torch.equal(back, v)


@pytest.mark.parametrize("shared_row", [False, True])
@pytest.mark.parametrize("stored_dtype", [torch.bool, torch.int32])
def test_decode_pages_match_pallas_interpret(shared_row, stored_dtype):
    """The port's decode over leading dims [2, 3]: six pages of S = 37
    streams x 33 values (not a multiple of 8), each mixing stored and coded
    streams, with a distinct table row per page or one shared 1-D row, and
    bool or int32 stored flags, equals the Pallas decode kernel in
    interpret mode page by page, and gives back the values."""
    rng = np.random.default_rng(17)
    s, e, bits = 37, 33, 8
    v = np.stack([_values(rng, s, e, bits, n_noisy=3) for _ in range(6)])
    if shared_row:
        rows = [jtables.find_table(jtables.histogram(v, bits), bits, True)]
        tt = pref.table_tensors(rows[0])
    else:
        rows = [jtables.find_table(jtables.histogram(p, bits), bits, True)
                for p in v]
        assert len({tuple(t.cum) for t in rows}) == 6
        tt = tuple(torch.from_numpy(np.stack([t.as_arrays()[i] for t in rows])
                                    .astype(np.int32)).reshape(2, 3, -1)
                   for i in range(3))
    vals = torch.from_numpy(v).reshape(2, 3, s, e)
    sym, ofs, _, _, st = apack_encode.encode(vals, *tt, n_steps=e, bits=bits)
    assert st.any() and not st.all()
    got = apack_decode.decode(sym, ofs, st.to(stored_dtype), *tt, n_steps=e,
                              bits=bits).reshape(6, s, e).numpy()
    assert np.array_equal(got, v)
    sym_u = sym.reshape(6, *sym.shape[2:]).numpy().view(np.uint32)
    ofs_u = ofs.reshape(6, *ofs.shape[2:]).numpy().view(np.uint32)
    st_i = st.reshape(6, s).numpy().astype(np.int32)
    for p in range(6):
        vm, ol, cum = (jnp.asarray(a) for a in rows[p % len(rows)].as_arrays())
        want = japack_decode.decode_pallas(
            jnp.asarray(sym_u[p]), jnp.asarray(ofs_u[p]), jnp.asarray(st_i[p]),
            vm, ol, cum, n_steps=e, bits=bits, block_streams=s,
            interpret=True)
        assert np.array_equal(got[p], np.asarray(want))


def test_require_table_reads_rows_where_they_lie():
    """The kernels' table argument: a 1-D row, or one row expanded to the
    pages, reaches the kernel as that row with stride 0; an int32 table
    with a row per page as itself with stride n; neither is copied.  Other
    dtypes are converted, and a row count other than 1 or the page count
    raises."""
    from repro_torch.kernels import _build
    cpu = torch.device("cpu")
    row = torch.arange(17, dtype=torch.int32)
    per_page = torch.arange(6 * 16, dtype=torch.int32).reshape(2, 3, 16)
    for t, n, stride in ((row, 17, 0), (row.expand(2, 3, 17), 17, 0),
                         (per_page, 16, 16)):
        rows, got = _build.require_table(t, 6, n, "t", cpu)
        assert got == stride and rows.data_ptr() == t.data_ptr()
        assert rows.shape[-1] == n
    rows, got = _build.require_table(per_page.long(), 6, 16, "t", cpu)
    assert got == 16 and rows.dtype == torch.int32
    assert torch.equal(rows, per_page.reshape(6, 16))
    with pytest.raises(ValueError, match="4 rows for 6 pages"):
        _build.require_table(per_page[:, :2], 6, 16, "t", cpu)
    with pytest.raises(ValueError, match="shape"):
        _build.require_table(row, 6, 16, "t", cpu)


def test_decode_checks_bits_before_any_work():
    """The decode wrapper's bits range check comes first, whatever the
    device."""
    z = torch.zeros(1, 4, 2, dtype=torch.int32)
    tt = pref.table_tensors(ptables.uniform_table(8))
    for bits in (0, 17):
        with pytest.raises(ValueError, match="outside"):
            apack_decode.decode(z, z, z[:, 0], *tt, n_steps=4, bits=bits)
