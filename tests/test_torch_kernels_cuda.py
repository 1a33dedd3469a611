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


def _gather_pool(rng, pages, n_rows, dev, streams=128):
    """``pages`` full-width KV pages (``streams`` streams x 128 values: 128
    at qwen3-1.7b's [16, 8, 128] page, 32 at recurrentgemma-9b's
    [16, 1, 256]; six noisy streams a page that the coder stores) coded
    with the encode kernel under ``n_rows`` table rows, page p under row
    p % n_rows."""
    from repro_torch.core.tables import find_table, histogram
    from repro_torch.kernels import apack_encode
    v = (np.clip(np.round(rng.laplace(0, 18, (pages, streams, 128))), -127,
                 127).astype(np.int64) & 0xFF)
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
@pytest.mark.parametrize("streams", [128, 32])
def test_cuda_gather_decode_sizes_and_id_places(n_ids, streams):
    """G = 1, 3 (padded to 4 by a duplicate) and 1024 gathered pages with
    duplicates and mixed table rows, at qwen3-1.7b's page (128 streams)
    and recurrentgemma-9b's (32): the wrapper with the ids on the host
    (numpy, as ``materialize`` passes them) and on the card, and the
    kernel's launch alone, all equal the plain version bit for bit;
    out-of-range host ids raise ``IndexError``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import paged_decode as pd
    rng = np.random.default_rng(n_ids)
    dev = torch.device("cuda")
    vals, rows, sym, ofs, st, (vm, ol, cm) = _gather_pool(rng, 24, 4, dev,
                                                          streams)
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
    # recurrentgemma-9b's page [16, 1, 256]: 32 streams of 128 values, 12
    # rolling layers' pages sealed in one step
    "pack12_s32": ((2, 12, 32, 128), 8, "laplace"),
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
@pytest.mark.parametrize("case", sorted(ENCODE_CASES)
                         + ["pack28_rows", "pack12_s32_rows"])
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


def _mixed_jobs(rng, shape, slots, dev):
    """Inputs of the fused attention kernel at page ``shape`` (ps, H, dh,
    Hq, stream length) over a pool of 12 pages: 4 jobs of ``slots``
    slots mixing HOT, COLD, PACKED and FREE pages, a PACKED page in each,
    a job with a rolling window and a job whose slots are all FREE.
    Returns (q, [page_idx, table_idx, meta, jobmeta], planes, n_steps)."""
    ps, h, dh, hq, s = shape
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
    return q, args, planes, e


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
    rng = np.random.default_rng(slots + shape[0])
    q, args, planes, e = _mixed_jobs(rng, shape, slots, torch.device("cuda"))
    kw = dict(n_steps=e, softcap=softcap)
    got = fpa.fused_page_attention(q, *args, planes, **kw)
    want = fpa.fused_page_attention_plain(q, *args, planes, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert (got[2][-1] == 0).all() and (got[2][:-1] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 8, 128, 48, 128),
                                   (16, 8, 112, 64, 112),
                                   (16, 8, 128, 96, 128)])
@pytest.mark.parametrize("slots,softcap", [(1, 0.0), (9, 0.0), (9, 30.0)])
def test_cuda_fused_page_attention_head_blocks(shape, slots, softcap):
    """Pages past 4096 query-head values, where the kernel splits the KV
    heads over blocks (``heads_per_block``): dbrx-132b's page [16, 8, 128]
    with Hq 48 (6144 values, 2 head blocks, each stream one head's run),
    kimi-k2's [16, 8, 112] with Hq 64 (7168, 2 head blocks, 128-value
    streams straddling heads) and command-r-plus's Hq 96 (12288, 4 head
    blocks), against the plain version at f32 rtol 1e-5 / atol 1e-6, as
    ``test_cuda_fused_page_attention_kernel``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import fused_page_attention as fpa
    _, h, dh, hq, _ = shape
    assert fpa.heads_per_block(hq, h, dh) < h
    rng = np.random.default_rng(slots + hq)
    q, args, planes, e = _mixed_jobs(rng, shape, slots, torch.device("cuda"))
    kw = dict(n_steps=e, softcap=softcap)
    got = fpa.fused_page_attention(q, *args, planes, **kw)
    want = fpa.fused_page_attention_plain(q, *args, planes, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert (got[2][-1] == 0).all() and (got[2][:-1] > 0).all()


def _head_shard(planes: dict, j: int, n: int) -> dict:
    """Model shard ``j`` of ``n``'s planes of a pool: its KV-head block of
    the dense HOT/COLD planes and page scales (contiguous copies), the
    PACKED planes and tables whole (``sharding.plane_pspecs``)."""
    out = dict(planes)
    for key, ax in (("tok_k", 2), ("tok_v", 2), ("cold_k", 2),
                    ("cold_v", 2), ("tok_sk", 2), ("tok_sv", 2),
                    ("pscale_k", 1), ("pscale_v", 1)):
        hl = planes[key].shape[ax] // n
        out[key] = planes[key].narrow(ax, j * hl, hl).contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 8, 128, 16, 128),
                                   (16, 8, 128, 48, 128),
                                   (4, 2, 16, 4, 4)])
@pytest.mark.parametrize("slots,softcap", [(7, 0.0), (16, 30.0)])
def test_cuda_fused_page_attention_head_shards(shape, slots, softcap):
    """Head tensor-parallelism: two launches, each over one model shard's
    half of the KV heads (jobmeta ``(qpos, window, h0)``, dense planes of
    its heads, PACKED planes whole, ``h_full`` the page's heads), each
    against the plain version at f32 rtol 1e-5 / atol 1e-6, and side by
    side bit-equal to one launch over every head; at qwen3-1.7b's page
    [16, 8, 128], at dbrx-132b's (Hq 48: head blocks inside a shard) and
    at SMOKE's [4, 2, 16]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import fused_page_attention as fpa
    ps, h, dh, hq, _ = shape
    rng = np.random.default_rng(slots + hq + 1)
    q, args, planes, e = _mixed_jobs(rng, shape, slots, torch.device("cuda"))
    kw = dict(n_steps=e, softcap=softcap)
    full = fpa.fused_page_attention(q, *args, planes, **kw)
    parts = []
    for j in range(2):
        shard = _head_shard(planes, j, 2)
        jm = torch.cat([args[3], torch.full_like(args[3][:, :1], j * h // 2)],
                       dim=1)
        qj = q[:, j * hq // 2:(j + 1) * hq // 2].contiguous()
        sargs = [*args[:3], jm]
        got = fpa.fused_page_attention(qj, *sargs, shard, h_full=h, **kw)
        want = fpa.fused_page_attention_plain(qj, *sargs, shard, h_full=h,
                                              **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        parts.append(got)
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts], dim=1), full[i])


@pytest.mark.cuda
def test_cuda_decompress_matmul_k_split():
    """Kernel 5 on a K range (``dm.split_k``): qwen3-1.7b's w_down shape
    cut to K 2048 (4 K tiles of 512) over N 384, split in two K halves;
    each half against its plain version within the K-term f32 bound, and
    the halves' sum against the whole launch within twice that bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(5)
    w = torch.from_numpy((rs.standard_normal((2048, 384)) * 0.05)
                         .astype(np.float32)).cuda()
    q, qp = quant.quantize_symmetric(w, axis=-1)
    cw = dm.compress_quantized(q, qp.scale.reshape(-1), 512)
    x = torch.from_numpy(rs.standard_normal((4, 2048))
                         .astype(np.float32)).cuda()
    wf = (q.float() * qp.scale.reshape(1, -1)).double()
    halves = dm.split_k(cw, 2)
    ys = []
    for j, part in enumerate(halves):
        xj = x[:, j * 1024:(j + 1) * 1024]
        got = dm.compressed_matmul(xj, part).double()
        want = dm.compressed_matmul_plain(xj, part).double()
        bound = 1024 * 2.0 ** -24 * (xj.double().abs()
                                     @ wf[j * 1024:(j + 1) * 1024].abs())
        assert bool(((got - want).abs() <= bound).all())
        ys.append(got)
    full = dm.compressed_matmul(x, cw).double()
    bound = 2 * 2048 * 2.0 ** -24 * (x.double().abs() @ wf.abs())
    assert bool(((ys[0] + ys[1] - full).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("slots,softcap", [(1, 0.0), (7, 0.0), (16, 30.0)])
def test_cuda_fused_page_attention_full_head_block(slots, softcap):
    """minitron-8b's page [16, 8, 128] with 32 query heads (GQA 4: 4096
    query-head values, the most one head block holds, every accumulator
    of a thread in use), on the page tables of
    ``test_cuda_fused_page_attention_kernel``, against the plain version:
    m and l at f32 rtol 1e-5 / atol 1e-6, acc with its relative part taken
    against sum(w |v|) (``fused_page_attention_f64``), the magnitude of
    its f32 sums, since acc cancels toward zero in places, where the
    plain f32 version itself can sit outside the plain tolerance of the
    exact result (as ``chip_smoke.py``'s checks hold it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import fused_page_attention as fpa
    shape = (16, 8, 128, 32, 128)
    assert fpa.heads_per_block(32, 8, 128) == 8
    rng = np.random.default_rng(slots + 16)
    q, args, planes, e = _mixed_jobs(rng, shape, slots, torch.device("cuda"))
    kw = dict(n_steps=e, softcap=softcap)
    got = fpa.fused_page_attention(q, *args, planes, **kw)
    want = fpa.fused_page_attention_plain(q, *args, planes, **kw)
    mag = fpa.fused_page_attention_f64(q, *args, planes, **kw)[3].float()
    torch.cuda.synchronize()
    assert ((got[0] - want[0]).abs() <= 1e-5 * mag + 1e-6).all()
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert (got[2][-1] == 0).all() and (got[2][:-1] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("qpos_off", [7, 16, 2047])
def test_cuda_fused_page_attention_rolling_window(qpos_off):
    """recurrentgemma-9b's local layer: page [16, 1, 256] (MQA, Hq 16 over
    one KV head, 32 streams a PACKED page), J = 4 jobs, 130 page slots
    past three evicted pages, window 2048, against the plain version at
    f32 rtol 1e-5 / atol 1e-6, ``acc``'s relative part against sum(w |v|)
    (``fused_page_attention_f64``).  ``qpos - window`` falls inside the oldest
    page (7: it is partly rolled out), exactly on a page boundary (16: the
    oldest page and the next one's first token are masked), or leaves the
    window over the whole table but its last page (2047)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import fused_page_attention as fpa
    ps, h, dh, hq, s, slots, window = 16, 1, 256, 16, 32, 130, 2048
    rng = np.random.default_rng(qpos_off)
    dev = torch.device("cuda")
    planes, e = _attention_pool(rng, ps, h, dh, s, 40, dev)
    jobs, base = 4, 3
    pid = rng.integers(0, 40, (jobs, slots))
    state = rng.integers(2, 4, (jobs, slots))           # COLD and PACKED
    state[:, -1] = 1                                    # the HOT last page
    t0 = np.broadcast_to((base + np.arange(slots)) * ps, (jobs, slots))
    meta = np.stack([state, t0], -1)
    qpos = np.full(jobs, base * ps + window + qpos_off)
    qpos[-1] = base * ps + slots * ps - 3               # a fuller HOT page
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (pid, np.zeros_like(pid), meta,
                      np.stack([qpos, np.full(jobs, window)], -1))]
    q = torch.from_numpy(rng.normal(0, 1, (jobs, hq, dh))
                         .astype(np.float32)).to(dev)
    got = fpa.fused_page_attention(q, *args, planes, n_steps=e)
    want = fpa.fused_page_attention_plain(q, *args, planes, n_steps=e)
    mag = fpa.fused_page_attention_f64(q, *args, planes, n_steps=e)[3]
    torch.cuda.synchronize()
    # acc cancels toward zero over ~2000 keys: its relative part is taken
    # against the magnitude of its f32 sums, sum(w |v|)
    assert ((got[0] - want[0]).abs()
            <= 1e-5 * mag.float() + 1e-6).all()
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert (got[2] > 0).all()


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


def _synth_caches(verify=False, device_pool=False):
    """Two port caches, one on the card and one on the CPU, fed the same
    synthetic tokens: a peaked lattice, then a shifted one (the drift of
    ``tests/test_table_refresh.py``), then refreshed; with
    ``device_pool``, each with its device pool (the fused path's planes
    and table stack)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import PagedKVCache
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              kv_cache_dtype="apack-int8")
    caches = [PagedKVCache(cfg, 256, page_size=4, calib_pages=2,
                           refresh_threshold=0.3, refresh_min_pages=4,
                           verify_on_repack=verify, device=d)
              for d in ("cuda", "cpu")]
    rng = np.random.default_rng(5)
    for kv in caches:
        if device_pool:
            kv.enable_device_pool()
        kv.add_request(0)
    h, dh, n = caches[0].pool.kv_heads, caches[0].pool.head_dim, 2
    for step in (64, 32):
        for _ in range(24):
            q = (step * rng.integers(-2, 3, (n, h, dh))).clip(
                -127, 127).astype(np.int8)
            s = np.full((n, h), 0.01, np.float32)
            for kv in caches:
                kv.append_token(0, q, q.copy(), s, s.copy())
    assert caches[0].maybe_refresh() == caches[1].maybe_refresh() != []
    return caches


def _assert_pools_equal(a, b):
    for name in ("sym", "ofs", "sym_bits", "ofs_bits", "stored",
                 "page_scale", "cold_q"):
        assert torch.equal(a.pool.plane(name).cpu(), b.pool.plane(name)), \
            name
    for name in ("page_gen", "page_crc"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert a.traffic == b.traffic and a.gen_rows == b.gen_rows


@pytest.mark.cuda
@pytest.mark.parametrize("budget,verify", [(None, False), (3, True)])
def test_cuda_batched_repack_matches_cpu(budget, verify):
    """The re-pack batch on the card (one decode launch with each page's
    own generation rows, one encode launch with its layer's new rows, the
    size gate decided on the card) leaves the pool exactly as the plain
    versions on the CPU do: planes, generations, checksums, counters; and
    the card's ``materialize`` (gather kernel, rows of both generations)
    equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import repro_torch
    gpu, cpu = _synth_caches(verify)
    repro_torch.reset_launch_counts()
    assert gpu.repack_pending(budget) == cpu.repack_pending(budget) > 0
    counts = repro_torch.launch_counts()
    assert counts["apack_decode"] >= 1 and counts["apack_encode"] >= 1
    _assert_pools_equal(gpu, cpu)
    assert len({int(gpu.page_gen[p]) for s in gpu._packed for p in s}) == 2
    got = gpu.materialize([0], 64)
    want = cpu.materialize([0], 64)
    for g, w in zip(got, want):
        for f in g:
            assert torch.equal(g[f].cpu(), w[f]), f


@pytest.mark.cuda
def test_cuda_spill_and_readahead_match_cpu():
    """A request's pages spilled from the card in one pull and read back in
    one upload from pinned memory: the same records (payload bytes, CRCs)
    and the same pool afterwards as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, cpu = _synth_caches()
    d2h, h2d = gpu.transfers["d2h_calls"], gpu.transfers["h2d_calls"]
    assert gpu.spill_request(0) == cpu.spill_request(0) > 0
    assert gpu.transfers["d2h_calls"] == d2h + 1
    for h, rec in cpu.spill_tier._records.items():
        g = gpu.spill_tier._records[h]
        assert (g.state, g.fill, g.gen, g.crc) == \
            (rec.state, rec.fill, rec.gen, rec.crc)
    assert gpu.unspill_request(0) == cpu.unspill_request(0)
    assert gpu.transfers["h2d_calls"] >= h2d + 1
    _assert_pools_equal(gpu, cpu)
    assert gpu.page_tables == cpu.page_tables


@pytest.mark.cuda
def test_cuda_refresh_grows_the_tables_on_the_default_device():
    """A cache built on ``device="cuda"`` (no index; its tensors report
    ``cuda:0``) with its device pool: the refresh's new generation block
    does not fit the device table stack, which grows, and every view then
    reads the same rows as the CPU cache's after the same refresh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, cpu = _synth_caches(device_pool=True)
    cap = gpu.dev.n_tables
    for kv in (gpu, cpu):
        kv._flush_tables()
    n = gpu.n_table_rows
    assert n > cap and gpu.dev.n_tables >= n
    for name in ("vm", "ol", "cum"):
        got = gpu.dev.planes[name]
        assert got.shape[0] == gpu.dev.n_tables
        assert torch.equal(got[:n].cpu(), cpu.dev.planes[name][:n]), name


@pytest.mark.cuda
def test_cuda_cli_refresh_on_the_default_device(capsys):
    """The CLI on its default device (no ``--device``) with
    ``--kv-refresh``: the refresh grows the device table stack, and every
    request is served."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-1.7b", "--smoke", "--kv", "apack-int8",
                "--no-compress", "--requests", "6", "--prompt-len", "8",
                "--max-new", "8", "--max-batch", "3", "--kv-page-size", "4",
                "--kv-refresh", "--kv-refresh-every", "4",
                "--kv-refresh-threshold", "0.2", "--kv-repack-budget", "8"])
    lines = capsys.readouterr().out.splitlines()
    assert any("'completed': 6" in ln for ln in lines), lines
    line = [ln for ln in lines if ln.startswith("table refresh: on;")]
    assert len(line) == 1, lines
    assert int(line[0].split("generation=")[1].split()[0]) >= 1


def _mesh_devices(n_cards: int):
    """A 2 x 2 serving mesh's device rows: every shard on ``cuda:0``, or
    each on its own card."""
    devs = [torch.device("cuda", i if n_cards == 4 else 0) for i in range(4)]
    return [devs[:2], devs[2:]]


@pytest.mark.cuda
@pytest.mark.parametrize("n_cards", [1, 4])
@pytest.mark.parametrize("weights", [None, "apack-int8"])
def test_cuda_mesh_serve_matches_one_device(n_cards, weights):
    """The engine on a 2 x 2 serving mesh (``launch.mesh.Mesh``), its
    shards on one card or on four, against the single-device engine on
    qwen3-1.7b SMOKE with random weights, 8 requests of 9 tokens, 8 new:
    dense weights give equal tokens; packed weights at tile 32 (every
    site K-split over the model axis) give teacher-forced logits within
    0.05 with the same argmax.  Every shard's free list is whole after
    the drain."""
    if torch.cuda.device_count() < n_cards:
        pytest.skip(f"needs {n_cards} CUDA devices")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              kv_cache_dtype="apack-int8")
    dev = torch.device("cuda", 0)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    kw = dict(max_batch=8, max_len=32)
    if weights:
        kw.update(weights=weights, weight_min_size=1024, weight_tile_k=32)

    def serve(eng):
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, 9)
                        .astype(np.int64), max_new_tokens=8)
                for i in range(8)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [list(r.tokens) for r in reqs]
    single = ServeEngine(cfg, params, device=dev, **kw)
    mesh = ServeEngine(cfg, params, mesh=Mesh(_mesh_devices(n_cards)), **kw)
    want, got = serve(single), serve(mesh)
    pool = mesh.kv.pool
    assert [pool.free_count_shard(s) for s in range(2)] == \
        [pool.pages_per_shard] * 2
    if not weights:
        assert got == want
        return
    for toks in got:
        seq = torch.as_tensor([toks], device=dev)
        a = M.forward(cfg, mesh.params, seq)[0].float()
        b = M.forward(cfg, single.params, seq)[0].float()
        assert float((a - b).abs().max()) <= 0.05
        assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("verify", [False, True])
def test_cuda_repack_a_shard_matches_one_device(verify):
    """Two requests on a one-card 2 x 2 mesh's cache, one a data shard, and
    on a single-device cache, fed the same synthetic drift and refreshed:
    the re-pack launches kernels 1 and 2 once a data shard a batch, each
    on its shard's pages, and leaves every page's planes, bit counts,
    generation and checksum bit-equal to the single-device re-pack of the
    same page; PACKED planes equal on both model shards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import repro_torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import PagedKVCache
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              kv_cache_dtype="apack-int8")
    kw = dict(page_size=4, calib_pages=2, refresh_threshold=0.3,
              refresh_min_pages=4, verify_on_repack=verify)
    mesh = make_debug_mesh(2, 2, device="cuda")
    caches = [PagedKVCache(cfg, 256, device="cuda", mesh=mesh, **kw),
              PagedKVCache(cfg, 256, device="cuda", **kw)]
    rng = np.random.default_rng(5)
    caches[0].add_request(0, 0)
    caches[0].add_request(1, 1)
    caches[1].add_request(0)
    caches[1].add_request(1)
    h, dh, n = caches[0].pool.kv_heads, caches[0].pool.head_dim, 2
    for step in (64, 32):
        for _ in range(24):
            for rid in (0, 1):
                q = (step * rng.integers(-2, 3, (n, h, dh))).clip(
                    -127, 127).astype(np.int8)
                s = np.full((n, h), 0.01, np.float32)
                for kv in caches:
                    kv.append_token(rid, q, q.copy(), s, s.copy())
    assert caches[0].maybe_refresh() == caches[1].maybe_refresh() != []
    launches = []
    for kv in caches:
        repro_torch.reset_launch_counts()
        groups = kv.pool.index([p for _, p in kv._repack_queue])
        assert kv.repack_pending(None) > 0
        c = repro_torch.launch_counts()
        launches.append((len(groups), c["apack_decode"], c["apack_encode"]))
    assert launches == [(2, 2, 2), (1, 1, 1)]
    mk, sk = caches
    pairs = [(a, b) for rid in (0, 1) for la, lb in
             zip(mk.page_tables[rid], sk.page_tables[rid])
             for a, b in zip(la, lb)]
    assert {mk.pool.shard_of(a) for a, _ in pairs} == {0, 1}
    for a, b in pairs:
        assert mk.pool.state[a] == sk.pool.state[b]
        assert mk.page_gen[a] == sk.page_gen[b]
        assert mk.page_crc[a] == sk.page_crc[b]
        assert mk.pool.packed_bits[a] == sk.pool.packed_bits[b]
    ia = mk.pool.index([a for a, _ in pairs])
    ib = sk.pool.index([b for _, b in pairs])
    for f in ("sym", "ofs", "sym_bits", "ofs_bits", "stored", "page_scale",
              "cold_q", "tok_q"):
        assert torch.equal(mk.pool.read(f, ia), sk.pool.read(f, ib)), f
    for s in (0, 1):
        for f in ("sym", "ofs", "stored"):
            assert torch.equal(mk.pool.parts[s][0][f], mk.pool.parts[s][1][f])
    assert mk.traffic == sk.traffic and mk.gen_rows == sk.gen_rows
