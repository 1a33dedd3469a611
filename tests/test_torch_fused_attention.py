"""Port fused paged attention (plain version) vs the JAX package's
``fused_page_attention_ref`` and its Pallas kernel in interpret mode, on a
pool mixing HOT, COLD, PACKED and FREE pages with two table rows.

Tolerance: f32 rtol 1e-5, atol 1e-6 on (acc, m, l) — both sides compute in
f32 page by page in the same update order, but the summation order inside
each page's dot products differs between the two frameworks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import tables as jtables
from repro.kernels import fused_page_attention as jfpa
from repro.kernels import ref as jref
from repro_torch.kernels import fused_page_attention as pfpa

PS, H, DH, HQ = 4, 2, 16, 4          # SMOKE page [4, 2, 16], GQA 2
S, E = 4, 32                         # 4 streams x 32 values per page-kind
POOL = 12


def _pool(rng):
    def i8(*shape):
        return np.clip(np.round(rng.laplace(0, 18, shape)), -127,
                       127).astype(np.int8)
    planes = {"tok_k": i8(POOL, PS, H, DH), "tok_v": i8(POOL, PS, H, DH),
              "tok_sk": rng.uniform(.01, .02, (POOL, PS, H)).astype(np.float32),
              "tok_sv": rng.uniform(.01, .02, (POOL, PS, H)).astype(np.float32),
              "cold_k": i8(POOL, PS, H, DH), "cold_v": i8(POOL, PS, H, DH),
              "pscale_k": rng.uniform(.01, .02, (POOL, H)).astype(np.float32),
              "pscale_v": rng.uniform(.01, .02, (POOL, H)).astype(np.float32)}
    # two (K, V) table rows: pages 0-5 coded with rows 0/1, 6-11 with 2/3
    vm, ol, cm = [], [], []
    for kind in "kv":
        u = (planes[f"cold_{kind}"].astype(np.int64) & 0xFF).reshape(
            POOL, S, E).astype(np.int32)
        sym = np.zeros((POOL, jref.sym_capacity_words(E), S), np.uint32)
        ofs = np.zeros((POOL, jref.ofs_capacity_words(E, 8), S), np.uint32)
        st = np.zeros((POOL, S), np.int32)
        for half in (0, 1):
            pages = slice(6 * half, 6 * half + 6)
            t = jtables.find_table(jtables.histogram(u[pages], 8), 8, True)
            res = [jref.encode(jnp.asarray(u[p]),
                               jref.TableArrays.from_table(t), E, 8)
                   for p in range(pages.start, pages.stop)]
            sym[pages] = np.stack([np.asarray(r[0]) for r in res])
            ofs[pages] = np.stack([np.asarray(r[1]) for r in res])
            st[pages] = np.stack([np.asarray(r[4]) for r in res])
            row = 2 * half + (kind == "v")
            a, b, c = t.as_arrays()
            vm.append((row, a)), ol.append((row, b)), cm.append((row, c))
        planes[f"sym_{kind}"], planes[f"ofs_{kind}"] = sym, ofs
        planes[f"stored_{kind}"] = st
    for key, rows in (("vm", vm), ("ol", ol), ("cum", cm)):
        arr = np.zeros((4, rows[0][1].shape[0]), np.int32)
        for r, x in rows:
            arr[r] = x
        planes[key] = arr
    return planes


def _tables(rng, jobs, slots):
    pid = rng.integers(0, POOL, (jobs, slots)).astype(np.int32)
    tid = np.where(pid < 6, 0, 2).astype(np.int32)
    state = rng.integers(1, 4, (jobs, slots)).astype(np.int32)
    state[:, -2:] = 0                                   # FREE padding
    t0 = np.broadcast_to(np.arange(slots) * PS, (jobs, slots))
    meta = np.stack([state, t0], -1).astype(np.int32)
    qpos = np.full(jobs, (slots - 2) * PS - 1, np.int32)
    qpos[-1] = 0                                        # fully masked job
    return pid, tid, meta, qpos


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 5.0)])
def test_plain_matches_reference_and_pallas(window, softcap):
    rng = np.random.default_rng(window + int(softcap))
    planes = _pool(rng)
    jobs, slots = 3, 6
    pid, tid, meta, qpos = _tables(rng, jobs, slots)
    win = np.full(jobs, window, np.int32)
    q = rng.normal(0, 1, (jobs, HQ, DH)).astype(np.float32)
    got = pfpa.fused_page_attention(
        torch.from_numpy(q), torch.from_numpy(pid), torch.from_numpy(tid),
        torch.from_numpy(meta), torch.from_numpy(np.stack([qpos, win], -1)),
        {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
         for k, v in planes.items()}, n_steps=E, softcap=softcap)
    jm = jnp.asarray(np.stack([qpos, win, np.zeros(jobs, np.int32)], -1))
    jplanes = {k: jnp.asarray(v) for k, v in planes.items()}
    args = (jnp.asarray(q), jnp.asarray(pid), jnp.asarray(tid),
            jnp.asarray(meta), jm)
    for backend in ("ref", "pallas_interpret"):
        want = jfpa.fused_page_attention(*args, jplanes, n_steps=E,
                                         num_heads=HQ, softcap=softcap,
                                         backend=backend)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
    acc, m, l = (x.numpy() for x in got)
    # a fully masked job: nothing accumulates; m holds the mask value
    # (after the softcap, as in the reference)
    m_masked = -1e30 if softcap == 0 else -softcap
    assert (l[-1] == 0).all() and (acc[-1] == 0).all()
    np.testing.assert_allclose(m[-1], m_masked, rtol=1e-6)
    assert {int(s) for s in meta[:-1, :, 0].ravel()} == {0, 1, 2, 3}


@pytest.mark.parametrize("chunk,slots,free_chunk,window,softcap", [
    (1, 7, None, 0, 0.0),       # one page a chunk, as the kernel's blocks
    (3, 7, 1, 0, 0.0),          # ragged chunks, the middle one all FREE
    (7, 7, None, 0, 0.0),       # one chunk: the unsplit fold
    (1, 6, None, 6, 5.0),       # window and softcap
    (3, 6, 0, 6, 5.0),          # window, softcap, the first chunk all FREE
    (1, 1, None, 0, 0.0),       # a single page slot
])
def test_split_pages_combine_to_the_unsplit_fold(chunk, slots, free_chunk,
                                                 window, softcap):
    """The kernel folds each chunk of a job's pages on its own and merges
    the partials with ``combine_partials``.  On the CPU: the plain version
    run chunk by chunk and merged equals the unsplit plain version and the
    JAX ``fused_page_attention_ref`` within f32 rtol 1e-5 / atol 1e-6 (the
    merge rescales each chunk once by exp(m_b - m) where the sequential
    fold rescales page by page).  Chunks whose slots are all FREE, and the
    fully masked job, fold to (acc 0, m masked, l 0) and change nothing."""
    rng = np.random.default_rng(100 + chunk + slots + window)
    planes = _pool(rng)
    jobs = 3
    pid, tid, meta, qpos = _tables(rng, jobs, slots)
    if slots == 1:
        meta[:, :, 0] = 3                                # one PACKED page
        qpos[:] = [PS - 1, 1, 0]
    if free_chunk is not None:
        meta[:, free_chunk * chunk:(free_chunk + 1) * chunk, 0] = 0
    win = np.full(jobs, window, np.int32)
    jobmeta = np.stack([qpos, win], -1)
    tp = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
          for k, v in planes.items()}
    q = rng.normal(0, 1, (jobs, HQ, DH)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, pid, tid, meta, jobmeta)]
    kw = dict(n_steps=E, softcap=softcap)
    parts = [pfpa.fused_page_attention_plain(
        args[0], args[1][:, c:c + chunk], args[2][:, c:c + chunk],
        args[3][:, c:c + chunk], args[4], tp, **kw)
        for c in range(0, slots, chunk)]
    got = pfpa.combine_partials(*(torch.stack([p_[i] for p_ in parts], 1)
                                  for i in range(3)))
    whole = pfpa.fused_page_attention_plain(*args, tp, **kw)
    jm = jnp.asarray(np.stack([qpos, win, np.zeros(jobs, np.int32)], -1))
    want = jfpa.fused_page_attention(
        jnp.asarray(q), jnp.asarray(pid), jnp.asarray(tid), jnp.asarray(meta),
        jm, {k: jnp.asarray(v) for k, v in planes.items()}, n_steps=E,
        num_heads=HQ, softcap=softcap, backend="ref")
    for g, w1, w2 in zip(got, whole, want):
        np.testing.assert_allclose(g.numpy(), w1.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w2), rtol=1e-5,
                                   atol=1e-6)
    if chunk == slots:                  # one chunk merges to itself exactly
        for g, w1 in zip(got, whole):
            assert torch.equal(g, w1)
    acc, m, l = (x.numpy() for x in got)
    assert (l[-1] == 0).all() and (acc[-1] == 0).all()
    assert (l[:-1] > 0).all()


def test_wrapper_refuses_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other non-CUDA device
    is refused rather than silently computed somewhere else."""
    q = torch.zeros(1, HQ, DH, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pfpa.fused_page_attention(q, q, q, q, q, {}, n_steps=E)
