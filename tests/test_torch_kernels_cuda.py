"""Kernel checks that need the card, in a file that imports neither JAX
nor the JAX package, so that they run on a CUDA machine without JAX:

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
