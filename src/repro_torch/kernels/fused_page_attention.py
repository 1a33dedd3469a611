"""Fused paged gather-decode + attention: the CUDA kernel's wrapper and its
plain version.

Port of ``repro/kernels/fused_page_attention.py`` (``_page_tile`` :67,
``_fused_kernel`` :101, ``fused_page_attention_pallas`` :169,
``fused_page_attention_ref`` :293).  For each job (one batch slot of one
attention layer) the page table is walked page by page; each page's K/V
tile is built by lifecycle state — HOT int8 x per-token scale, COLD int8 x
per-(page, head) scale, PACKED APack-decoded — scored with the causal mask
on absolute position (``t0 + i < qpos``), the rolling window
(``> qpos - window`` when ``window > 0``) and the optional softcap, and
folded into an online softmax.  The result is the *unnormalized*
``(acc, m, l)``; the caller merges the current token and divides
(``models.modules.paged_attention_step``).  The CUDA kernel folds each page
in a block of its own and merges the pages' partial states in a second
pass; ``combine_partials`` is that merge in plain PyTorch, for the tests.

Head tensor-parallelism over a serving mesh's model axis follows the
reference (``_page_tile`` :67-97, ``_fused_kernel`` :110-134): a job's
``jobmeta`` row may be ``(qpos, window, h0)``; the dense HOT/COLD planes
and the page scales then hold only the launch's ``H`` KV heads, a PACKED
page still decodes all ``h_full`` heads (its streams interleave them) and
the job reads heads ``[h0, h0 + H)`` of it.  A ``[J, 2]`` jobmeta is
``h0 = 0`` on a pool of every head.  Per-KV-head attention has no
cross-head sum, so two launches over the two halves of the heads, side by
side, equal one launch over all of them bit for bit.  The TPU kernel keeps
``acc [hkv, g, dh]`` for any head count; a block of the CUDA kernel holds
at most
``MAX_BLOCK_VALUES`` query-head values, so a wider page splits its KV heads
over blocks (``heads_per_block``), each decoding only the streams that hold
its heads' values.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, apack_decode, ref

F32 = torch.float32
I32 = torch.int32
PAGE_FREE, PAGE_HOT, PAGE_COLD, PAGE_PACKED = 0, 1, 2, 3
NEG_INF = -1e30          # the reference's mask value
# the pool planes the kernel reads, in the launcher's argument order
PLANE_KEYS = ("tok_k", "tok_sk", "tok_v", "tok_sv", "cold_k", "cold_v",
              "pscale_k", "pscale_v", "sym_k", "ofs_k", "stored_k",
              "sym_v", "ofs_v", "stored_v", "vm", "ol", "cum")

# pages each block of the kernel folds before the combine pass
PAGES_PER_BLOCK = 1
# query-head values a block accumulates: MAX_ACC (16) registers a thread x
# 256 threads (``csrc/fused_page_attention.cu``)
MAX_BLOCK_VALUES = 16 * 256
# dynamic shared memory a block may use on sm_90
_MAX_SMEM = 232448

_ARGTYPES = ([ctypes.c_void_p] * 28 + [ctypes.c_int] * 19
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _head_offsets(jobmeta: torch.Tensor) -> torch.Tensor:
    """Each job's first KV head ``h0``: jobmeta's third column, or 0 for a
    ``[J, 2]`` jobmeta."""
    if jobmeta.shape[1] > 2:
        return jobmeta[:, 2].long()
    return torch.zeros(jobmeta.shape[0], dtype=torch.long,
                       device=jobmeta.device)


def _page_tiles(planes: dict, page_idx, table_idx, state, n_steps: int,
                bits: int, h0=None, h_full: int | None = None):
    """f32 K and V tiles [J, P, ps, H, dh] of every (job, page slot) by
    lifecycle state (``_page_tile`` / ``dequant_page``); all PACKED pages
    of both kinds decode in one batched call, to ``h_full`` heads (H when
    None), of which a job keeps ``[h0, h0 + H)`` (``h0`` [J]).  Slots in no
    lifecycle state (FREE) stay zero: they are fully masked, and a zero
    tile folds in exactly as the reference's tile of whatever page the slot
    names."""
    ps, h, dh = planes["tok_k"].shape[1:]
    hf = h if h_full is None else h_full
    pid = page_idx.long()
    tiles = torch.zeros(2, *pid.shape, ps, h, dh, dtype=F32,
                        device=planes["tok_k"].device)
    for i, kind in enumerate("kv"):
        for st, src, sc in ((PAGE_HOT, f"tok_{kind}", f"tok_s{kind}"),
                            (PAGE_COLD, f"cold_{kind}", f"pscale_{kind}")):
            sel = state == st
            if sel.any():
                p = pid[sel]
                s = planes[sc][p].to(F32)
                s = s[..., None] if st == PAGE_HOT else s[:, None, :, None]
                tiles[i][sel] = planes[src][p].to(F32) * s
    packed = state == PAGE_PACKED
    if packed.any():
        p = pid[packed]
        row = table_idx.long()[packed]
        rows = torch.cat([row, row + 1])          # K rows, then V rows
        u = ref.decode(torch.cat([planes["sym_k"][p], planes["sym_v"][p]]),
                       torch.cat([planes["ofs_k"][p], planes["ofs_v"][p]]),
                       torch.cat([planes["stored_k"][p],
                                  planes["stored_v"][p]]),
                       planes["vm"][rows], planes["ol"][rows],
                       planes["cum"][rows], n_steps, bits)
        sgn = torch.where(u >= 128, u - 256, u).to(F32).reshape(
            2, -1, ps, hf, dh)
        if hf != h:
            # each page keeps its job's head block
            heads = (h0[:, None].expand(pid.shape)[packed][:, None]
                     + torch.arange(h, device=sgn.device))
            sgn = sgn.gather(3, heads[None, :, None, :, None].expand(
                2, -1, ps, h, dh))
        for i, kind in enumerate("kv"):
            tiles[i][packed] = (sgn[i] * planes[f"pscale_{kind}"][p]
                                .to(F32)[:, None, :, None])
    return tiles[0], tiles[1]


def fused_page_attention_plain(q, page_idx, table_idx, meta, jobmeta,
                               planes: dict, *, n_steps: int,
                               softcap: float = 0.0, bits: int = 8,
                               h_full: int | None = None):
    """Plain PyTorch version (``fused_page_attention_ref`` :293): the same
    page-by-page online-softmax update order, jobs as a batch axis; a
    ``[J, 3]`` jobmeta's ``h0`` and ``h_full`` as the kernel takes them."""
    jn, hq, dh = q.shape
    n_pages = page_idx.shape[1]
    ps, hkv = planes["tok_k"].shape[1:3]
    g = hq // hkv
    q3 = q.to(F32).reshape(jn, hkv, g, dh)
    acc = torch.zeros(jn, hkv, g, dh, dtype=F32, device=q.device)
    m_run = torch.full((jn, hkv, g), NEG_INF, dtype=F32, device=q.device)
    l_run = torch.zeros(jn, hkv, g, dtype=F32, device=q.device)
    qpos = jobmeta[:, 0:1].to(I32)
    window = jobmeta[:, 1:2].to(I32)
    offs = torch.arange(ps, dtype=I32, device=q.device)
    kt_all, vt_all = _page_tiles(planes, page_idx, table_idx, meta[..., 0],
                                 n_steps, bits, _head_offsets(jobmeta),
                                 h_full)
    for p in range(n_pages):
        state = meta[:, p, 0]
        kt, vt = kt_all[:, p], vt_all[:, p]
        scores = torch.einsum("jkgd,jskd->jkgs", q3, kt) * (dh ** -0.5)
        pos = meta[:, p, 1:2].to(I32) + offs
        valid = (pos < qpos) & (state != PAGE_FREE)[:, None]
        valid &= torch.where(window > 0, pos > qpos - window, True)
        vmask = valid[:, None, None, :]
        scores = torch.where(vmask, scores, NEG_INF)
        if softcap > 0:
            scores = softcap * torch.tanh(scores / softcap)
        m_new = torch.maximum(m_run, scores.amax(-1))
        # explicit * valid: a fully masked page keeps m at NEG_INF and
        # exp(NEG_INF - NEG_INF) == 1 would otherwise pollute l
        w = torch.exp(scores - m_new[..., None]) * vmask
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + w.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("jkgs,jskd->jkgd", w, vt)
        m_run = m_new
    return (acc.reshape(jn, hq, dh), m_run.reshape(jn, hq),
            l_run.reshape(jn, hq))


def fused_page_attention_f64(q, page_idx, table_idx, meta, jobmeta,
                             planes: dict, *, n_steps: int,
                             softcap: float = 0.0, bits: int = 8,
                             h_full: int | None = None):
    """The same unnormalized state in f64 over all pages at once, plus the
    magnitude ``sum_k w_k |v_k|`` of each ``acc`` element: the size at
    which the f32 sums of ``acc`` run, against which the kernel's and the
    plain version's summation-order error is measured when a long page
    table makes ``acc`` cancel toward zero.  For checks; returns ``(acc,
    m, l, mag)``."""
    jn, hq, dh = q.shape
    ps, hkv = planes["tok_k"].shape[1:3]
    kt, vt = _page_tiles(planes, page_idx, table_idx, meta[..., 0], n_steps,
                         bits, _head_offsets(jobmeta), h_full)
    k = kt.double().reshape(jn, -1, hkv, dh)
    v = vt.double().reshape(jn, -1, hkv, dh)
    q3 = q.double().reshape(jn, hkv, hq // hkv, dh)
    scores = torch.einsum("jkgd,jskd->jkgs", q3, k) * (dh ** -0.5)
    pos = (meta[..., 1:2].long() + torch.arange(ps, device=q.device)
           ).reshape(jn, -1)
    qpos, window = jobmeta[:, 0:1].long(), jobmeta[:, 1:2].long()
    valid = (pos < qpos) & (meta[..., 0] != PAGE_FREE).repeat_interleave(
        ps, dim=1)
    valid &= torch.where(window > 0, pos > qpos - window, True)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    m_all = scores.amax(-1)
    w = torch.exp(scores - m_all[..., None]) * valid[:, None, None]
    acc = torch.einsum("jkgs,jskd->jkgd", w, v)
    mag = torch.einsum("jkgs,jskd->jkgd", w, v.abs())
    return (acc.reshape(jn, hq, dh), m_all.reshape(jn, hq),
            w.sum(-1).reshape(jn, hq), mag.reshape(jn, hq, dh))


def combine_partials(acc, m, l):
    """Merge online-softmax partials ``acc [J, NB, Hq, dh]``, ``m`` and
    ``l [J, NB, Hq]`` of consecutive page chunks into the state of the
    whole page table, as the kernel's combine pass does: ``m = max_b m_b``,
    ``acc = sum_b acc_b * exp(m_b - m)``, ``l = sum_b l_b * exp(m_b - m)``,
    summed in chunk order."""
    m_all = m.amax(1)
    acc_all = torch.zeros_like(acc[:, 0])
    l_all = torch.zeros_like(l[:, 0])
    for b in range(m.shape[1]):
        w = torch.exp(m[:, b] - m_all)
        acc_all = acc_all + acc[:, b] * w[..., None]
        l_all = l_all + l[:, b] * w
    return acc_all, m_all, l_all


def heads_per_block(hq: int, h: int, dh: int) -> int:
    """KV heads a block of the kernel folds: all ``h`` when the page's
    ``hq * dh`` query-head values fit one block's accumulators
    (``MAX_BLOCK_VALUES``), else the largest divisor of ``h`` whose query
    heads fit; the kernel's grid then gets ``h // heads_per_block`` head
    blocks a (job, page).  Raises when one KV head's query group alone
    does not fit."""
    g = hq // h
    fit = [d for d in range(1, h + 1) if h % d == 0
           and d * g * dh <= MAX_BLOCK_VALUES]
    if not fit:
        raise ValueError(f"fused_page_attention: one KV head's {g} query "
                         f"heads x dh {dh} exceed the {MAX_BLOCK_VALUES} "
                         "values a block accumulates")
    return max(fit)


def fused_page_attention(q: torch.Tensor, page_idx: torch.Tensor,
                         table_idx: torch.Tensor, meta: torch.Tensor,
                         jobmeta: torch.Tensor, planes: dict, *,
                         n_steps: int, softcap: float = 0.0, bits: int = 8,
                         h_full: int | None = None):
    """Fused paged attention over a job batch.

    Args:
      q:         f32 [J, Hq, dh] rope'd, unscaled queries.
      page_idx:  int32 [J, P] pool page per (job, page slot).
      table_idx: int32 [J, P] K row of the stacked tables (V row = +1).
      meta:      int32 [J, P, 2] (lifecycle state, first token position).
      jobmeta:   int32 [J, 2] (qpos, window) or [J, 3] (qpos, window, h0);
                 window 0 means global, h0 the first of a PACKED page's
                 ``h_full`` KV heads that the dense planes hold (0 for
                 [J, 2]).
      planes:    the ``model.DevicePoolPlanes`` dict (``PLANE_KEYS``) or a
                 model shard's: HOT/COLD planes and page scales of H heads,
                 PACKED planes of the whole page.
      h_full:    KV heads of a PACKED page (H, the dense planes' heads,
                 when None).

    Returns ``(acc f32 [J, Hq, dh], m f32 [J, Hq], l f32 [J, Hq])``.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.  Past ``MAX_BLOCK_VALUES`` query-head values a page, the
    kernel splits the KV heads over blocks (``heads_per_block``)."""
    _build.refuse_fake("fused_page_attention", q, page_idx, table_idx,
                       meta, jobmeta, *planes.values())
    if q.device.type == "cpu":
        return fused_page_attention_plain(q, page_idx, table_idx, meta,
                                          jobmeta, planes, n_steps=n_steps,
                                          softcap=softcap, bits=bits,
                                          h_full=h_full)
    if q.device.type != "cuda":
        raise ValueError(f"fused_page_attention: unsupported device "
                         f"{q.device}")
    if bits != 8:
        raise ValueError("fused_page_attention decodes 8-bit KV pages only")
    dev = q.device
    jn, hq, dh = q.shape
    n_pages = page_idx.shape[1]
    pp, ps, h, _ = planes["tok_k"].shape
    hf = h if h_full is None else h_full
    ws, s = planes["sym_k"].shape[1:]
    wo = planes["ofs_k"].shape[1]
    t_rows = planes["vm"].shape[0]
    jw = jobmeta.shape[1] if jobmeta.dim() == 2 else 0
    if hq % h or hf % h or s * n_steps != ps * hf * dh or (ps * h * dh) % 16 \
            or jw not in (2, 3):
        raise ValueError(
            f"fused_page_attention: Hq={hq}, H={h}, h_full={hf}, S={s}, "
            f"n_steps={n_steps}, page [{ps}, {h}, {dh}], jobmeta "
            f"{tuple(jobmeta.shape)} do not fit together")
    if t_rows < 2:
        raise ValueError("fused_page_attention: fewer than two table rows")
    hpb = heads_per_block(hq, h, dh)
    rs, ro = apack_decode.staged_rows(n_steps, bits, ws, wo)
    lib = _build.load("fused_page_attention")
    fn = lib.fused_page_attention_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 8, ctypes.c_int
    smem = fn(hpb * (hq // h), h, hf, dh, ps, s, rs, ro)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_page_attention: {smem} bytes of shared "
                         f"memory a block, above the {_MAX_SMEM} it has")
    shapes = {"tok_k": (pp, ps, h, dh), "tok_v": (pp, ps, h, dh),
              "cold_k": (pp, ps, h, dh), "cold_v": (pp, ps, h, dh),
              "tok_sk": (pp, ps, h), "tok_sv": (pp, ps, h),
              "pscale_k": (pp, h), "pscale_v": (pp, h),
              "sym_k": (pp, ws, s), "sym_v": (pp, ws, s),
              "ofs_k": (pp, wo, s), "ofs_v": (pp, wo, s),
              "stored_k": (pp, s), "stored_v": (pp, s),
              "vm": (t_rows, 17), "ol": (t_rows, 16), "cum": (t_rows, 17)}
    dtypes = {"tok_k": torch.int8, "tok_v": torch.int8,
              "cold_k": torch.int8, "cold_v": torch.int8,
              "tok_sk": F32, "tok_sv": F32, "pscale_k": F32, "pscale_v": F32}
    plane_ptrs = [_build.require(planes[k], dtypes.get(k, I32), shapes[k], k,
                                 dev) for k in PLANE_KEYS]
    nb = -(-n_pages // PAGES_PER_BLOCK)
    acc_p = torch.empty(jn, nb, hq, dh, dtype=F32, device=dev)
    m_p = torch.empty(jn, nb, hq, dtype=F32, device=dev)
    l_p = torch.empty(jn, nb, hq, dtype=F32, device=dev)
    acc = torch.empty(jn, hq, dh, dtype=F32, device=dev)
    m_out = torch.empty(jn, hq, dtype=F32, device=dev)
    l_out = torch.empty(jn, hq, dtype=F32, device=dev)
    ptrs = [_build.require(q, F32, (jn, hq, dh), "q", dev),
            _build.require(page_idx, I32, (jn, n_pages), "page_idx", dev),
            _build.require(table_idx, I32, (jn, n_pages), "table_idx", dev),
            _build.require(meta, I32, (jn, n_pages, 2), "meta", dev),
            _build.require(jobmeta, I32, (jn, jw), "jobmeta", dev),
            *plane_ptrs, acc_p.data_ptr(), m_p.data_ptr(), l_p.data_ptr(),
            acc.data_ptr(), m_out.data_ptr(), l_out.data_ptr()]
    fn = lib.fused_page_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = _build.launch(fn, *ptrs, jn, n_pages, pp, t_rows, hq, h, hf, dh, ps,
                       s, ws, wo, n_steps, bits, PAGES_PER_BLOCK, rs, ro, hpb,
                       jw, dh ** -0.5, float(softcap), on=q)
    _build.check(rc, "fused_page_attention")
    _build.LAUNCHES["fused_page_attention"] += 1
    return acc, m_out, l_out
