"""Model building blocks of the port: plain functions on tensors, params as
dicts of tensors, plus the KV page pool.

Port of the parts of ``repro/models/modules.py`` that serving qwen3-1.7b
from the paged APack KV cache runs: ``rms_norm`` :25, ``rope`` :31,
``_kv_quantize``/``_kv_dequantize`` :44/:54, ``PackedWeight`` :69,
``packed_proj`` :100 (single device), ``proj`` :139, ``attention_full`` :175
and ``attention_step`` :267 (global layers), ``paged_attention_step`` :326
(single device), ``init_attention_cache`` :436 (global), ``mlp`` :461
(swiglu), the page lifecycle ``PAGE_*``/``PAGE_TRANSITIONS`` :916-950
and ``KVPagePool`` :1077 (no spill tier, one shard).

dtype placement follows the JAX package exactly, since it decides the KV
bytes: activations and projections in bf16 (each weight cast to bf16 before
its product), norms, rope, attention scores and softmax in f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import decompress_matmul as dm
from repro_torch.kernels.fused_page_attention import fused_page_attention
from repro_torch.kernels.ref import ofs_capacity_words, sym_capacity_words

from .config import CHUNK, ModelConfig

F32 = torch.float32
BF16 = torch.bfloat16
NEG_INF = -1e30
# directory cost per stream: sym_bits(32) + ofs_bits(32) + stored flag(1)
# (``repro/core/format.py``)
DIR_BITS_PER_STREAM = 65
_INV127 = float(np.float32(1.0 / 127.0))


# ------------------------------------------------------------------ basics
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(F32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding in f32.  x: [..., S, H, dh];
    positions: broadcastable to [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    # theta^-(i/half), the form XLA compiles the reference's
    # 1 / theta^(i/half) into (it differs in the last bit for 1/4 of i)
    freqs = theta ** -(torch.arange(0, half, dtype=F32, device=x.device)
                       * (1.0 / half))
    ang = positions[..., None].to(F32) * freqs               # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def kv_quantize(x: torch.Tensor):
    """Per-(position, head) absmax int8: [..., H, dh] -> (int8, f32 [..., H])."""
    xf = x.to(F32)
    # times f32(1/127): the compiled reference multiplies by the
    # reciprocal constant rather than dividing
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) * _INV127
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale[..., None].to(F32)


@dataclasses.dataclass
class PackedWeight:
    """An APack-compressed projection weight in the param tree
    (``PackedWeight`` :69): the 2-D [K, N] ``CompressedLinear``, the
    original dense ``shape``, how many leading axes contract into K
    (``n_contract``: 1 for wq/wk/wv and the FFN, 2 for wo) and the dense
    dtype's name."""

    cw: dm.CompressedLinear
    shape: tuple
    n_contract: int
    dtype: str

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """f32 [M, K] @ the packed [K, N] weight -> f32 [M, N], through the
        fused decompress-matmul.  A subclass may compute the same product
        another way (a check's dense oracle) without touching this module."""
        return dm.compressed_matmul(x, self.cw)


def packed_proj(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Packed projection (``packed_proj`` :100, single device): flatten x's
    trailing contraction axes into K, run the fused decompress-matmul in
    f32, restore the output axes and cast back to x's dtype."""
    nc = pw.n_contract
    lead = x.shape[:x.dim() - nc]
    kdim = 1
    for s in x.shape[x.dim() - nc:]:
        kdim *= s
    y = pw.matmul(x.reshape(-1, kdim).to(F32))
    return y.reshape(*lead, *pw.shape[nc:]).to(x.dtype)


def proj(x: torch.Tensor, w, n_contract: int = 1) -> torch.Tensor:
    """Projection contracting x's last ``n_contract`` axes with w's leading
    ones (``proj`` :139): the fused APack path when the param tree holds a
    ``PackedWeight`` at this site, else a dense product in x's dtype (the
    weight is cast first, as the JAX package's ``proj`` does; a weight
    already in x's dtype is not copied)."""
    if isinstance(w, PackedWeight):
        if w.n_contract != n_contract:
            raise ValueError(f"packed weight contracts {w.n_contract} axes, "
                             f"the site {n_contract}")
        return packed_proj(x, w)
    k = 1
    for s in w.shape[:n_contract]:
        k *= s
    out = w.shape[n_contract:]
    y = matmul(x.reshape(*x.shape[:x.dim() - n_contract], k),
               w.reshape(k, -1))
    return y.reshape(*y.shape[:-1], *out)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in a's dtype with f32 accumulation.  On the card this is
    cuBLAS in bf16.  On the CPU the product runs in f32 and rounds once,
    which is how XLA's CPU backend evaluates the JAX package's bf16 dots;
    PyTorch's CPU bf16 GEMM rounds differently in the last bit, and that
    bit changes int8 KV values downstream."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(F32), b.to(F32)).to(a.dtype)
    return torch.matmul(a, b.to(a.dtype))


# --------------------------------------------------------------- attention
def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    q = proj(x, p["wq"])
    k = proj(x, p["wk"])
    v = proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attention_full(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Prefill attention of a global layer, chunked over queries
    (``attention_full`` :175).  Returns ``(y [B, S, D], cache)`` with the
    cache of every position: int8 ``{k, v, k_scale, v_scale}`` when
    ``cfg.kv_int8``, else the unquantized ``{k, v}``."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    pos = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos[None, :])
    kf, vf = k.to(F32), v.to(F32)
    scale = dh ** -0.5
    outs = []
    for start in range(0, s, CHUNK):
        qc = q[:, start:start + CHUNK].reshape(b, -1, hkv, g, dh)
        c = qc.shape[1]
        scores = torch.einsum("bckgd,bskd->bkgcs", qc.to(F32), kf) * scale
        qpos = start + torch.arange(c, device=x.device)
        mask = pos[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, NEG_INF)
        if cfg.logit_softcap > 0:
            cap = cfg.logit_softcap
            scores = cap * torch.tanh(scores / cap)
        w = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgcs,bskd->bckgd", w, vf).to(x.dtype))
    out = torch.cat(outs, dim=1).reshape(b, s, h, dh)
    y = proj(out, p["wo"], 2)
    if not cfg.kv_int8:
        return y, {"k": k, "v": v}
    qk, sk = kv_quantize(k)
    qv, sv = kv_quantize(v)
    return y, {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}


def attention_step(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                   cfg: ModelConfig):
    """Single-token decode step of a global layer against a dense cache
    (``attention_step`` :267).  x [B, 1, D]; cache k/v [B, Sc, Hkv, dh],
    int8 with per-(position, head) ``k_scale``/``v_scale`` or in the cache
    dtype; pos [B], each slot's own position.

    Slot ``pos`` of every row is written, then the whole cache is read
    under the causal mask ``index <= pos``.  The JAX function returns an
    updated copy; the port writes the cache's tensors in place, so a step
    holds one cache, and returns the same dict."""
    b = x.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    if "k_scale" in cache:
        qk, sk = kv_quantize(k[:, 0])
        qv, sv = kv_quantize(v[:, 0])
        for f, val in (("k", qk), ("v", qv), ("k_scale", sk),
                       ("v_scale", sv)):
            cache[f][rows, pos] = val
        kc = kv_dequantize(cache["k"], cache["k_scale"])
        vc = kv_dequantize(cache["v"], cache["v_scale"])
    else:
        cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
        kc, vc = cache["k"], cache["v"]
    sc = cache["k"].shape[1]
    valid = torch.arange(sc, device=x.device)[None, :] <= pos[:, None]
    scores = torch.einsum("bkgd,bskd->bkgs",
                          q.reshape(b, hkv, g, dh).to(F32), kc.to(F32)) \
        * (dh ** -0.5)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    if cfg.logit_softcap > 0:
        scores = cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, vc.to(F32))
    y = proj(out.reshape(b, h, dh).to(x.dtype), p["wo"], 2)[:, None, :]
    return y, cache


def init_attention_cache(cfg: ModelConfig, batch: int, seq_len: int,
                         device, dtype=BF16) -> dict:
    """Zero dense cache of a global layer (``init_attention_cache`` :436):
    int8 K/V with f32 per-(position, head) scales when ``cfg.kv_int8``,
    else K/V in ``dtype``."""
    shape = (batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=F32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=F32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_attention_step(p: dict, x: torch.Tensor, planes: dict,
                         meta: dict, pos: torch.Tensor, cfg: ModelConfig):
    """Single-token decode step of one global layer against the paged APack
    KV pool (``paged_attention_step`` :326, single device).

    The fused kernel reads the layer's pages (``meta``: ``pid``/``tid``
    int32 [B, P], ``kmeta`` int32 [B, P, 2] of (state, t0), ``qw`` int32
    [B, 2] of (qpos, window)) and returns the unnormalized online-softmax
    state; the current token's self term is merged here, then normalized.
    Returns ``(y [B, 1, D], {k, v, k_scale, v_scale})``: the new token's
    quantized K/V for the on-device append."""
    b = x.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    qk, sk = kv_quantize(k[:, 0])
    qv, sv = kv_quantize(v[:, 0])
    kd = kv_dequantize(qk, sk)                                 # [B, Hkv, dh]
    vd = kv_dequantize(qv, sv)
    ps_sz = planes["tok_k"].shape[1]
    n_streams = planes["sym_k"].shape[2]
    n_steps = (ps_sz * hkv * dh) // max(n_streams, 1)
    acc, m_run, l_run = fused_page_attention(
        q[:, 0].to(F32).contiguous(), meta["pid"], meta["tid"],
        meta["kmeta"], meta["qw"], planes, n_steps=n_steps,
        softcap=float(cfg.logit_softcap))
    q3 = q[:, 0].reshape(b, hkv, g, dh).to(F32)
    s_self = torch.einsum("bkgd,bkd->bkg", q3, kd) * (dh ** -0.5)
    if cfg.logit_softcap > 0:
        s_self = cfg.logit_softcap * torch.tanh(s_self / cfg.logit_softcap)
    accr = acc.reshape(b, hkv, g, dh)
    mr = m_run.reshape(b, hkv, g)
    lr = l_run.reshape(b, hkv, g)
    m_tot = torch.maximum(mr, s_self)
    alpha = torch.exp(mr - m_tot)
    w_self = torch.exp(s_self - m_tot)
    l_tot = lr * alpha + w_self
    out = (accr * alpha[..., None] + w_self[..., None] * vd[:, :, None, :]) \
        / l_tot[..., None]
    y = proj(out.reshape(b, h, dh).to(x.dtype), p["wo"], 2)[:, None, :]
    return y, {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}


# --------------------------------------------------------------------- mlp
def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_variant != "swiglu":
        raise NotImplementedError(
            f"mlp_variant={cfg.mlp_variant!r} is not ported yet (ROADMAP "
            "open item 1.9, remaining architectures)")
    up = proj(x, p["w_up"])
    gate = proj(x, p["w_gate"])
    # silu as the JAX package evaluates it in bf16 (x * logistic(x), the
    # logistic as 1 / (1 + exp(-x))), every op rounded to bf16; a fused
    # f32 silu rounds once and differs in the last bf16 bit
    hid = gate * (1.0 / (1.0 + torch.exp(-gate))) * up
    return proj(hid, p["w_down"])


# ------------------------------------------------------------ KV page pool
# Page lifecycle: FREE -> HOT (per-token int8 + per-token-head scales, being
# appended) -> COLD (full; re-quantized to one scale per (page, head)) ->
# PACKED (COLD payload APack-encoded with the layer's activation tables).
# Pages that fill before the layer's tables are calibrated stay COLD.

PAGE_FREE, PAGE_HOT, PAGE_COLD, PAGE_PACKED = 0, 1, 2, 3
PAGE_STATE_NAMES = {PAGE_FREE: "FREE", PAGE_HOT: "HOT", PAGE_COLD: "COLD",
                    PAGE_PACKED: "PACKED"}

# The lifecycle transition table (the JAX package's, less the spill/evict/
# adopt/repack edges this slice does not port); every state-changing pool
# method validates its edge here before writing.
PAGE_TRANSITIONS = {
    "alloc": ((PAGE_FREE, PAGE_HOT),),
    "free":  ((PAGE_HOT, PAGE_FREE), (PAGE_COLD, PAGE_FREE),
              (PAGE_PACKED, PAGE_FREE)),
    "seal":  ((PAGE_HOT, PAGE_COLD),),
    "pack":  ((PAGE_COLD, PAGE_PACKED),),
}


class KVPagePool:
    """Block pool of fixed-size KV token pages: payload planes on
    ``device`` (the card unless the caller asks for the CPU), lifecycle
    metadata and the free list on the host.

    Kind axis: index 0 = K, 1 = V.  Unlike the JAX package, whose host
    numpy pool is mirrored onto the device at page events, the payload
    tensors here *are* the device store: the on-device append, the seal
    requantization and the encode kernel write them in place, and the
    fused attention kernel reads them.  The host keeps what the scheduler
    needs without touching the device: state, fill, free list, and each
    PACKED page's coded bit count (``packed_bits``, pulled once per pack)."""

    def __init__(self, num_pages: int, page_size: int, kv_heads: int,
                 head_dim: int, elems_per_stream: int = 128,
                 device=None):
        self.device = resolve(device)
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        n_vals = page_size * kv_heads * head_dim     # values per page per kind
        e = min(elems_per_stream, n_vals)
        while n_vals % e:                            # largest divisor <= target
            e -= 1
        self.elems_per_stream = e
        self.n_streams = n_vals // e
        self.sym_words = sym_capacity_words(e)
        self.ofs_words = ofs_capacity_words(e, 8)
        p, ps, h, dh, s = num_pages, page_size, kv_heads, head_dim, \
            self.n_streams

        def z(*shape, dtype):
            return torch.zeros(*shape, dtype=dtype, device=self.device)

        self.tok_q = z(2, p, ps, h, dh, dtype=torch.int8)
        self.tok_scale = z(2, p, ps, h, dtype=F32)
        self.cold_q = z(2, p, ps, h, dh, dtype=torch.int8)
        self.page_scale = z(2, p, h, dtype=F32)
        # u32 words held in int32 tensors (the kernels read uint32_t)
        self.sym = z(2, p, self.sym_words, s, dtype=torch.int32)
        self.ofs = z(2, p, self.ofs_words, s, dtype=torch.int32)
        self.sym_bits = z(2, p, s, dtype=torch.int32)
        self.ofs_bits = z(2, p, s, dtype=torch.int32)
        self.stored = z(2, p, s, dtype=torch.int32)
        self.fill = np.zeros(p, np.int32)
        self.state = np.full(p, PAGE_FREE, np.uint8)
        self.packed_bits = np.zeros(p, np.int64)     # sum of sym+ofs bits
        self.free_list: list[int] = list(range(p - 1, -1, -1))
        self.alloc_count = 0
        self.high_water = 0

    def _page_state(self, pid: int) -> str:
        st = int(self.state[pid])
        return (f"page {pid}: state={PAGE_STATE_NAMES.get(st, st)} "
                f"fill={int(self.fill[pid])}/{self.page_size}")

    def _require_transition(self, pid: int, edge: str, dst: int, *,
                            exc: type = ValueError,
                            detail: str | None = None) -> int:
        src = int(self.state[pid])
        if (src, dst) not in PAGE_TRANSITIONS[edge]:
            raise exc(
                f"{detail or f'illegal {edge}'}: "
                f"{PAGE_STATE_NAMES.get(src, src)}->"
                f"{PAGE_STATE_NAMES.get(dst, dst)} is not a declared page "
                f"transition ({self._page_state(pid)})")
        return src

    @property
    def free_count(self) -> int:
        return len(self.free_list)

    def alloc(self) -> int | None:
        if not self.free_list:
            return None
        pid = self.free_list.pop()
        self._require_transition(pid, "alloc", PAGE_HOT, exc=RuntimeError,
                                 detail="alloc from corrupt free list")
        self.state[pid] = PAGE_HOT
        self.fill[pid] = 0
        self.alloc_count += 1
        self.high_water = max(self.high_water,
                              self.num_pages - self.free_count)
        return pid

    def free(self, pids) -> None:
        """Return pages to the free list and scrub their payload, so a
        stale read of a recycled page is loud, not subtle."""
        pids = [int(p) for p in pids]
        for pid in pids:
            self._require_transition(pid, "free", PAGE_FREE,
                                     detail="double free of page")
        if not pids:
            return
        idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
        for t in (self.tok_q, self.tok_scale, self.cold_q, self.page_scale,
                  self.sym, self.ofs, self.sym_bits, self.ofs_bits,
                  self.stored):
            t[:, idx] = 0
        for pid in pids:
            self.state[pid] = PAGE_FREE
            self.fill[pid] = 0
            self.packed_bits[pid] = 0
            self.free_list.append(pid)

    def write_token(self, pid: int, kq, vq, ks, vs) -> int:
        """Append one token's [H, dh] int8 K/V and [H] scales (host append
        path).  Returns the in-page offset written."""
        off = self.note_device_write(pid)
        self.tok_q[0, pid, off] = torch.as_tensor(kq, device=self.device)
        self.tok_q[1, pid, off] = torch.as_tensor(vq, device=self.device)
        self.tok_scale[0, pid, off] = torch.as_tensor(ks, device=self.device)
        self.tok_scale[1, pid, off] = torch.as_tensor(vs, device=self.device)
        return off

    def note_device_write(self, pid: int) -> int:
        """Metadata half of a token append whose payload was written into
        the planes on the device: advance the fill count."""
        if self.state[pid] != PAGE_HOT:
            raise ValueError(
                f"write into non-HOT page ({self._page_state(pid)})")
        off = int(self.fill[pid])
        if off >= self.page_size:
            raise RuntimeError(
                f"write into overfull page ({self._page_state(pid)})")
        self.fill[pid] = off + 1
        return off

    def seal(self, pids: list, q2: torch.Tensor, scale2: torch.Tensor) -> None:
        """HOT -> COLD for full pages: store the page-requantized payload
        (``q2`` int8 [2, n, ps, H, dh], ``scale2`` f32 [2, n, H]) and drop
        the per-token copy."""
        for pid in pids:
            self._require_transition(pid, "seal", PAGE_COLD,
                                     detail="seal of non-full or non-HOT "
                                            "page")
            if self.fill[pid] != self.page_size:
                raise ValueError(f"seal of non-full or non-HOT page "
                                 f"({self._page_state(pid)})")
        idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
        self.cold_q[:, idx] = q2
        self.page_scale[:, idx] = scale2
        self.tok_q[:, idx] = 0
        self.tok_scale[:, idx] = 0
        self.state[pids] = PAGE_COLD

    def pack(self, pids: list, planes: tuple, bits_per_page) -> None:
        """COLD -> PACKED: store both kinds' planes (``planes`` = (sym [2,
        n, Ws, S], ofs [2, n, Wo, S], sym_bits [2, n, S], ofs_bits [2, n,
        S], stored [2, n, S])) and scrub the raw payload so a read that
        bypasses the decoder is visibly wrong.  ``bits_per_page``: each
        page's coded bits over both kinds (host ints)."""
        for pid in pids:
            self._require_transition(pid, "pack", PAGE_PACKED,
                                     detail="pack of non-COLD page")
        idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
        sym, ofs, sb, ob, st = planes
        self.sym[:, idx] = sym
        self.ofs[:, idx] = ofs
        self.sym_bits[:, idx] = sb
        self.ofs_bits[:, idx] = ob
        self.stored[:, idx] = st.to(torch.int32)
        self.cold_q[:, idx] = 0
        self.state[pids] = PAGE_PACKED
        self.packed_bits[pids] = bits_per_page

    # -------------------------------------------------------- accounting
    def dense_bytes(self, n_tokens: int) -> int:
        """What the dense int8 engine stores for ``n_tokens`` of one layer:
        int8 K+V plus per-token-head f32 scales."""
        h, dh = self.kv_heads, self.head_dim
        return 2 * (n_tokens * h * dh + n_tokens * h * 4)

    def page_bytes(self, pid: int) -> int:
        """Off-chip footprint of a page in its current state."""
        h, dh = self.kv_heads, self.head_dim
        st = self.state[pid]
        if st == PAGE_HOT:
            return self.dense_bytes(int(self.fill[pid]))
        if st == PAGE_COLD:
            return 2 * (self.page_size * h * dh + h * 4)
        if st == PAGE_PACKED:
            directory = 2 * self.n_streams * DIR_BITS_PER_STREAM
            return (int(self.packed_bits[pid]) + directory + 7) // 8 \
                + 2 * h * 4
        return 0
