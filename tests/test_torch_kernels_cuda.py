"""Kernel checks that need the card (decompress-matmul, fused paged
attention, gather decode, encode, decode, and the codec host layer over
the encode and decode kernels), in a file that imports neither
JAX nor the JAX package, so that they run on a CUDA machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import decompress_matmul as dm


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 8, 9, 37])
def test_cuda_decompress_matmul_kernel(m):
    """Over three K tiles (K = 1100, tile_k 512) and a ragged N (200): with
    unit scales and small-integer x every sum is exact in f32, so the
    kernel equals the integer product bit for bit; with the real scales it
    stays within the K-term f32 bound, K * 2^-24 * (|x| @ |W|), of the
    plain version (TF32 off).  M = 1, 4 and 8 take the kernel's register
    path, 9 and 37 its shared-memory tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(11)
    w = torch.from_numpy((rs.standard_normal((1100, 200)) * 0.05)
                         .astype(np.float32)).cuda()
    q, qp = quant.quantize_symmetric(w, axis=-1)
    cw = dm.compress_quantized(q, qp.scale.reshape(-1), 512)
    unit = dataclasses.replace(cw, scale=torch.ones_like(cw.scale))
    xi = torch.from_numpy(rs.randint(-4, 5, (m, 1100)).astype(np.float32))
    got = dm.compressed_matmul(xi.cuda(), unit).cpu()
    assert torch.equal(got, (xi.double() @ q.cpu().double()).float())
    x = torch.from_numpy(rs.standard_normal((m, 1100)).astype(np.float32))
    got = dm.compressed_matmul(x.cuda(), cw).double().cpu()
    want = dm.compressed_matmul_plain(x.cuda(), cw).double().cpu()
    wf = (q.float() * qp.scale.reshape(1, -1)).double().cpu()
    bound = 1100 * 2.0 ** -24 * (x.double().abs() @ wf.abs())
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
def test_cuda_gather_decode_kernel():
    """A pool of 12 full-width KV pages (128 streams x 128 values, some
    streams stored) coded under three table rows, gathered 1000 times with
    duplicates and edge padding to the 1024 bucket: the kernel equals the
    plain version bit for bit and gives back every page's values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.tables import find_table, histogram
    from repro_torch.kernels import apack_encode, paged_decode
    rng = np.random.default_rng(7)
    v = (np.clip(np.round(rng.laplace(0, 18, (12, 128, 128))), -127, 127)
         .astype(np.int64) & 0xFF)
    v[:, :6] = rng.integers(0, 256, (12, 6, 128))
    rows = np.arange(12) % 3
    tabs = [find_table(histogram(v[rows == r], 8), 8, True).as_arrays()
            for r in range(3)]
    vm, ol, cm = (torch.from_numpy(np.stack([t[i] for t in tabs])
                                   .astype(np.int32)).cuda() for i in range(3))
    vals = torch.from_numpy(v.astype(np.int32)).cuda()
    r = torch.from_numpy(rows).cuda()
    sym, ofs, _, _, st = apack_encode.encode(vals, vm[r], ol[r], cm[r],
                                             n_steps=128, bits=8)
    idx = np.pad(rng.integers(0, 12, 1000), (0, 24), mode="edge")
    pidx = torch.from_numpy(idx.astype(np.int32)).cuda()
    tidx = torch.from_numpy(rows[idx].astype(np.int32)).cuda()
    kw = dict(n_steps=128, bits=8, table_idx=tidx)
    got = paged_decode.gather_decode(sym, ofs, st, pidx, vm, ol, cm, **kw)
    want = paged_decode.gather_decode_plain(sym, ofs, st, pidx, vm, ol, cm,
                                            **kw)
    torch.cuda.synchronize()
    assert int(st.sum()) > 0
    assert torch.equal(got, want)
    assert torch.equal(got, vals[pidx.long()])


def _gather_pool(rng, pages, n_rows, dev):
    """``pages`` full-width KV pages (128 streams x 128 values, six noisy
    streams a page that the coder stores) coded with the encode kernel
    under ``n_rows`` table rows, page p under row p % n_rows."""
    from repro_torch.core.tables import find_table, histogram
    from repro_torch.kernels import apack_encode
    v = (np.clip(np.round(rng.laplace(0, 18, (pages, 128, 128))), -127, 127)
         .astype(np.int64) & 0xFF)
    v[:, :6] = rng.integers(0, 256, (pages, 6, 128))
    rows = np.arange(pages) % n_rows
    tabs = [find_table(histogram(v[rows == r], 8), 8, True).as_arrays()
            for r in range(n_rows)]
    vm, ol, cm = (torch.from_numpy(np.stack([t[i] for t in tabs])
                                   .astype(np.int32)).to(dev)
                  for i in range(3))
    vals = torch.from_numpy(v.astype(np.int32)).to(dev)
    r = torch.from_numpy(rows).to(dev)
    sym, ofs, _, _, st = apack_encode.encode(vals, vm[r], ol[r], cm[r],
                                             n_steps=128, bits=8)
    return vals, rows, sym, ofs, st, (vm, ol, cm)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ids", [1, 3, 1024])
def test_cuda_gather_decode_sizes_and_id_places(n_ids):
    """G = 1, 3 (padded to 4 by a duplicate) and 1024 gathered pages with
    duplicates and mixed table rows: the wrapper with the ids on the host
    (numpy, as ``materialize`` passes them) and on the card, and the
    kernel's launch alone, all equal the plain version bit for bit;
    out-of-range host ids raise ``IndexError``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import paged_decode as pd
    rng = np.random.default_rng(n_ids)
    dev = torch.device("cuda")
    vals, rows, sym, ofs, st, (vm, ol, cm) = _gather_pool(rng, 24, 4, dev)
    g = pd.gather_bucket(n_ids)
    idx = np.pad(rng.integers(0, 24, n_ids), (0, g - n_ids), mode="edge")
    idx = idx.astype(np.int32)
    tid = rows[idx].astype(np.int32)
    pidx, tidx = torch.from_numpy(idx).to(dev), torch.from_numpy(tid).to(dev)
    kw = dict(n_steps=128, bits=8)
    want = pd.gather_decode_plain(sym, ofs, st, pidx, vm, ol, cm,
                                  table_idx=tidx, **kw)
    outs = [pd.gather_decode(sym, ofs, st, idx, vm, ol, cm, table_idx=tid,
                             **kw),
            pd.gather_decode(sym, ofs, st, pidx, vm, ol, cm, table_idx=tidx,
                             **kw),
            pd.launch_gather_decode(sym, ofs, st, pidx, tidx, vm, ol, cm,
                                    **kw)]
    torch.cuda.synchronize()
    assert torch.equal(want, vals[pidx.long()])
    for out in outs:
        assert torch.equal(out, want)
    with pytest.raises(IndexError, match="page ids"):
        pd.gather_decode(sym, ofs, st, np.asarray([0, 24], np.int32), vm, ol,
                         cm, table_idx=np.asarray([0, 1], np.int32), **kw)


ENCODE_CASES = {
    # S not a multiple of the kernel's 128-thread blocks, at bits 4, 8, 16
    "s100_b8": ((3, 100, 36), 8, "laplace"),
    "s37_b4": ((4, 37, 33), 4, "laplace"),
    "s130_b16": ((2, 130, 7), 16, "laplace"),
    # a uniform table: every stream stored
    "stored": ((4, 128, 128), 8, "uniform"),
    # the serve's pack of a decode step's seal: [2 kinds, 28 pages, ...]
    "pack28": ((2, 28, 128, 128), 8, "laplace"),
}


def _codec_case(case):
    """Values and the table of an ``ENCODE_CASES`` case, on the card: a
    Laplace body with three noisy streams (stored under a fitted table)."""
    from repro_torch.core.tables import find_table, histogram, uniform_table
    from repro_torch.kernels import ref
    shape, bits, kind = ENCODE_CASES[case]
    rng = np.random.default_rng(len(case))
    top = (1 << bits) - 1
    v = np.clip(np.round(rng.laplace(top / 2, top / 24, shape)), 0, top)
    v = v.astype(np.int32)
    v[..., :3, :] = rng.integers(0, top + 1, v[..., :3, :].shape)
    t = (uniform_table(bits) if kind == "uniform"
         else find_table(histogram(v, bits), bits, True))
    dev = torch.device("cuda")
    return torch.from_numpy(v).to(dev), ref.table_tensors(t, dev), bits, kind


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_cuda_encode_kernel(case):
    """The encode kernel equals the plain encoder bit for bit (planes, bit
    counts, stored flags) at stream counts that are not a multiple of its
    block, bits 4, 8 and 16, a uniform table (every stream stored) and the
    [2, 28, 128, 128] pack shape; its planes decode back to the values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import apack_decode, apack_encode
    vals, tabs, bits, kind = _codec_case(case)
    e = vals.shape[-1]
    got = apack_encode.encode(vals, *tabs, n_steps=e, bits=bits)
    want = apack_encode.encode_plain(vals, *tabs, n_steps=e, bits=bits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[4].all()) == (kind == "uniform") and bool(got[4].any())
    back = apack_decode.decode_plain(got[0], got[1], got[4], *tabs,
                                     n_steps=e, bits=bits)
    assert torch.equal(back, vals)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ENCODE_CASES) + ["pack28_rows"])
def test_cuda_decode_kernel(case):
    """The decode kernel equals the plain decoder bit for bit, and gives
    back the values, on the encode kernel's planes in every encode case
    and at [2, 28, 128, 128] with a table row per page (four rows); bool
    and int32 stored flags give identical outputs, and so does a shared
    1-D row copied out to every page."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.tables import find_table, histogram
    from repro_torch.kernels import apack_decode, apack_encode
    vals, tabs, bits, _ = _codec_case(case.removesuffix("_rows"))
    lead = tuple(vals.shape[:-2])
    if case.endswith("_rows"):
        v = vals.reshape(-1, *vals.shape[-2:]).cpu().numpy()
        rows = np.arange(v.shape[0]) % 4
        ts = [find_table(histogram(v[rows == r], bits), bits, True)
              .as_arrays() for r in range(4)]
        tabs = tuple(torch.from_numpy(np.stack([ts[r][i] for r in rows])
                                      .astype(np.int32)).reshape(*lead, -1)
                     .to(vals.device) for i in range(3))
    e = vals.shape[-1]
    sym, ofs, _, _, st = apack_encode.encode(vals, *tabs, n_steps=e,
                                             bits=bits)
    kw = dict(n_steps=e, bits=bits)
    got = apack_decode.decode(sym, ofs, st, *tabs, **kw)
    want = apack_decode.decode_plain(sym, ofs, st, *tabs, **kw)
    variants = [apack_decode.decode(sym, ofs, st.to(torch.int32), *tabs,
                                    **kw)]
    if tabs[0].dim() == 1:
        variants.append(apack_decode.decode(
            sym, ofs, st, *(t.expand(*lead, t.shape[-1]).contiguous()
                            for t in tabs), **kw))
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, vals)
    for out in variants:
        assert torch.equal(out, got)


def _attention_pool(rng, ps, h, dh, s, pool, dev):
    """A pool of ``pool`` pages of shape [ps, h, dh] in every lifecycle
    state's planes, each PACKED page-kind ``s`` streams, K and V coded with
    one table row each (plain encoder)."""
    from repro_torch.core.tables import find_table, histogram
    from repro_torch.kernels import ref

    def i8(*shape):
        return torch.from_numpy(np.clip(np.round(rng.laplace(0, 18, shape)),
                                        -127, 127).astype(np.int8))

    def sc(*shape):
        return torch.from_numpy(rng.uniform(.01, .02, shape)
                                .astype(np.float32))
    planes = {"tok_k": i8(pool, ps, h, dh), "tok_v": i8(pool, ps, h, dh),
              "tok_sk": sc(pool, ps, h), "tok_sv": sc(pool, ps, h),
              "cold_k": i8(pool, ps, h, dh), "cold_v": i8(pool, ps, h, dh),
              "pscale_k": sc(pool, h), "pscale_v": sc(pool, h)}
    e = ps * h * dh // s
    rows = []
    for kind in "kv":
        u = (planes[f"cold_{kind}"].to(torch.int32) & 0xFF).reshape(pool, s, e)
        u[:, :2] = torch.from_numpy(rng.integers(0, 256, (pool, 2, e))
                                    .astype(np.int32))   # stored streams
        planes[f"cold_{kind}"] = ((u + 128) % 256 - 128).to(torch.int8) \
            .reshape(pool, ps, h, dh)
        tabs = ref.table_tensors(find_table(histogram(u.numpy(), 8), 8, True))
        rows.append(tabs)
        sym, ofs, _, _, st = ref.encode(u, *tabs, e, 8)
        planes[f"sym_{kind}"], planes[f"ofs_{kind}"] = sym, ofs
        planes[f"stored_{kind}"] = st.to(torch.int32)
    for i, key in enumerate(("vm", "ol", "cum")):
        planes[key] = torch.stack([rows[0][i], rows[1][i]])
    return {k: v.to(dev) for k, v in planes.items()}, e


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 8, 128, 16, 128), (4, 2, 16, 4, 4)])
@pytest.mark.parametrize("slots,softcap", [(1, 0.0), (7, 0.0), (16, 30.0)])
def test_cuda_fused_page_attention_kernel(shape, slots, softcap):
    """The split-page kernel and its combine pass against the plain
    version at f32 rtol 1e-5 / atol 1e-6 (each page's dot products sum in
    another order): page tables of 1, 7 and 16 slots mixing HOT, COLD,
    PACKED (stored streams included) and FREE pages, a job with a rolling
    window and a job whose slots are all FREE; at qwen3-1.7b's page
    [16, 8, 128] (GQA 2) and at SMOKE's [4, 2, 16]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import fused_page_attention as fpa
    ps, h, dh, hq, s = shape
    rng = np.random.default_rng(slots + ps)
    dev = torch.device("cuda")
    planes, e = _attention_pool(rng, ps, h, dh, s, 12, dev)
    jobs = 4
    pid = rng.integers(0, 12, (jobs, slots))
    state = rng.integers(1, 4, (jobs, slots))
    state[:, 0] = 3                                     # a PACKED page each
    if slots > 2:
        state[:, -2:] = 0                               # FREE padding
    state[-1] = 0                                       # a fully FREE job
    t0 = np.broadcast_to(np.arange(slots) * ps, (jobs, slots))
    meta = np.stack([state, t0], -1)
    qpos = np.full(jobs, max(slots - 2, 1) * ps - 1)
    window = np.array([0, 0, 2 * ps + 1, 0])
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (pid, np.zeros_like(pid), meta,
                      np.stack([qpos, window], -1))]
    q = torch.from_numpy(rng.normal(0, 1, (jobs, hq, dh))
                         .astype(np.float32)).to(dev)
    kw = dict(n_steps=e, softcap=softcap)
    got = fpa.fused_page_attention(q, *args, planes, **kw)
    want = fpa.fused_page_attention_plain(q, *args, planes, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert (got[2][-1] == 0).all() and (got[2][:-1] > 0).all()


ROUNDTRIP_CASES = {"b4_odd": (4, 37 * 64 - 5, 64, "fitted"),
                   "b8_fastpath": (8, 130 * 512 + 7, 512, "fitted"),
                   "b16_unstaged": (16, 300 * 512 - 9, 512, "fitted"),
                   "stored": (8, 3 * 512, 512, "uniform")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROUNDTRIP_CASES))
def test_cuda_ops_and_fastpath_match_cpu(case):
    """``ops`` and ``fastpath`` on the card (the encode and decode kernels,
    one shared table row) equal the same calls on the CPU (the plain
    versions) bit for bit: every ``CompressedArrays`` field, the trimmed
    host containers (a uniform table stores every stream, leaving the
    symbol plane no rows) and the decoded values with their dtype (uint8,
    ``torch.uint16`` at 16 bits, where 512-value streams take the decode
    kernel's unstaged path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.tables import table_for, uniform_table
    from repro_torch.kernels import fastpath, ops
    bits, n, e, kind = ROUNDTRIP_CASES[case]
    rng = np.random.default_rng(n)
    top = (1 << bits) - 1
    v = np.clip(np.round(rng.laplace(top / 2, top / 24, n)), 0, top)
    v = v.astype(np.int64)
    v[:e] = rng.integers(0, top + 1, e)              # a stored stream
    t = uniform_table(bits) if kind == "uniform" else table_for(v, bits)
    got = ops.apack_encode(torch.from_numpy(v).cuda(), t, e)
    want = ops.apack_encode(torch.from_numpy(v), t, e)
    for f in ("sym_plane", "ofs_plane", "sym_bits", "ofs_bits", "stored",
              "v_min", "ol", "cum"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    back = ops.apack_decode(got)
    assert back.dtype == (torch.uint8 if bits <= 8 else torch.uint16)
    assert torch.equal(back.cpu(), ops.apack_decode(want))
    assert np.array_equal(back.cpu().numpy(), v)
    ct = fastpath.compress_np(v, t, bits=bits, elems_per_stream=e,
                              device="cuda")
    ct_cpu = fastpath.compress_np(v, t, bits=bits, elems_per_stream=e,
                                  device="cpu")
    for f in ("sym_plane", "ofs_plane", "sym_bits", "ofs_bits", "stored"):
        a, b = getattr(ct, f), getattr(ct_cpu, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (ct.sym_plane.shape[0] == 0) == (kind == "uniform")
    assert np.array_equal(fastpath.decompress_np(ct, "cuda"), v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_byteplane_matches_cpu(dtype):
    """Float byte planes coded on the card equal those coded on the CPU,
    and decode on the card to the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import byteplane
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, 9000)
                         .astype(np.float32)).to(dtype).reshape(90, 100)
    got = byteplane.compress_float(x.cuda())
    want = byteplane.compress_float(x)
    for a, b in zip(got.planes, want.planes, strict=True):
        for f in ("sym_plane", "ofs_plane", "sym_bits", "ofs_bits", "stored"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    back = byteplane.decompress_float(got, device="cuda")
    assert back.dtype == dtype and torch.equal(back.cpu(), x)


@pytest.mark.cuda
def test_cuda_quantizers_divide_as_the_cpu():
    """``quantize_symmetric`` and ``quantize_affine`` (per column, 8 and 16
    bits) and ``true_divide`` give on the card the CPU's codes and scales
    bit for bit.  A division by a Python number would not: CUDA computes it
    as a multiply by the reciprocal, one bit off for some values, and the
    card's containers would then differ from the CPU's and the JAX
    package's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.standard_normal((4096, 700)) *
                          rng.uniform(0.001, 3, 700)).astype(np.float32))
    for fn in (lambda t: quant.quantize_symmetric(t, axis=-1),
               lambda t: quant.quantize_symmetric(t, bits=16, axis=-1),
               lambda t: quant.quantize_affine(t, axis=-1),
               lambda t: quant.quantize_affine(t, bits=12, axis=0)):
        q, qp = fn(x.cuda())
        qc, qpc = fn(x)
        assert torch.equal(qp.scale.cpu(), qpc.scale)
        assert torch.equal(qp.zero_point.cpu(), qpc.zero_point)
        assert q.dtype == qc.dtype
        assert torch.equal(q.cpu().to(torch.int32), qc.to(torch.int32))
    y = torch.from_numpy(rng.uniform(0.5, 2.0, 10 ** 6).astype(np.float32))
    assert torch.equal(quant.true_divide(y.cuda(), 127).cpu(),
                       quant.true_divide(y, 127))
