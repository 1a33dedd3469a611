"""Kernel checks that need the card (decompress-matmul, gather decode), in
a file that imports neither JAX nor the JAX package, so that they run on a CUDA machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device every test skips."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import decompress_matmul as dm


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 37])
def test_cuda_decompress_matmul_kernel(m):
    """Over three K tiles (K = 1100, tile_k 512) and a ragged N (200): with
    unit scales and small-integer x every sum is exact in f32, so the
    kernel equals the integer product bit for bit; with the real scales it
    stays within the K-term f32 bound, K * 2^-24 * (|x| @ |W|), of the
    plain version (TF32 off)."""
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
