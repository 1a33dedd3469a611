"""Model building blocks of the port: plain functions on tensors, params as
dicts of tensors, plus the KV page pool.

Port of the parts of ``repro/models/modules.py`` that serving runs:
``rms_norm`` :25, ``rope`` :31, ``_kv_quantize``/``_kv_dequantize``
:44/:54, ``PackedWeight`` :69, ``packed_proj`` :100 (with its K-split
over a mesh's model shards, ``ShardedPackedWeight``),
``proj`` :139, ``_mask`` :166 (causal or bidirectional), ``attention_full``
:175 and ``attention_step`` :267 (global and rolling layers),
``paged_attention_step`` :326 (with KV heads over a mesh's model
shards), ``init_attention_cache``
:436, ``init_mlp`` :449 and ``mlp`` :461 (swiglu, geglu, gelu, relu2),
``MOE_GROUP`` :480, ``init_moe`` :483 and ``moe`` :500 (with its
training aux losses), the RG-LRU recurrent block ``init_recurrent``
:553, ``_rglru_coeffs`` :571, ``recurrent_full`` :582, ``recurrent_step``
:628 and ``init_recurrent_cache`` :641, the mLSTM block ``init_mlstm``
:647, ``_mlstm_chunk`` :671, ``mlstm_full`` :718, ``mlstm_step`` :761 and
``init_mlstm_cache`` :788, the sLSTM block ``init_slstm`` :797,
``_slstm_cell`` :815, ``slstm_full`` :848, ``slstm_step`` :878 and
``init_slstm_cache`` :889 (their scans a chunk at a time, recomputed in
the backward pass: ``remat``), the page lifecycle
``PAGE_*``/``PAGE_TRANSITIONS`` :916-950, the integrity and spill tier
types ``PageIntegrityError`` :953, ``TransferDropped`` :969,
``SpillRecord`` :978, ``payload_crc`` :996 and ``HostSpillTier`` :1006,
and ``KVPagePool`` :1077 with per-shard page ranges and free lists
(``n_shards``, a mesh's data axis), ``evict`` :1208, ``spill``/``adopt``
:1221/:1251 and ``repack`` :1356.  ``ModelShards``/``tp_site`` run a training site
split over a mesh's model axis, where the reference constrains it:
attention heads (``constrain(..., "heads")`` :193-195, 228), the FFN
hidden (``mlp`` :463-475) and the RG-LRU width (:593-595).

dtype placement follows the JAX package exactly, since it decides the KV
bytes: activations and projections in bf16 (each weight cast to bf16 before
its product), norms, rope, attention scores, softmax and the MoE router in
f32.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core import quant
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


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A host array (or list) on ``device`` without waiting for the card:
    a copy from pageable memory synchronizes the stream, so on the card
    the array is staged in pinned memory and copied asynchronously, in
    stream order.  On the CPU it is ``torch.as_tensor``."""
    if device.type != "cuda":
        return torch.as_tensor(arr)
    host = torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()
    return host.to(device, non_blocking=True)


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

    @property
    def device(self) -> torch.device:
        """The device that holds the planes."""
        return self.cw.scale.device

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """f32 [M, K] @ the packed [K, N] weight -> f32 [M, N], through the
        fused decompress-matmul.  A subclass may compute the same product
        another way (a check's dense oracle) without touching this module."""
        return dm.compressed_matmul(x, self.cw)


@dataclasses.dataclass
class ShardedPackedWeight(PackedWeight):
    """A packed weight K-split over a mesh's model shards (``packed_proj``
    :113-135, row parallelism): ``parts`` are ``dm.split_k``'s contiguous
    K-tile ranges, each on its model shard's device; ``cw`` is the whole
    weight's ``dm.Layout`` (K, N, tile, coded size), no tensors, so each
    device holds only its K range.  ``matmul`` runs kernel 5 once a shard
    on its columns of x and sums the partial products in shard order
    (``sharding.psum``) onto x's device.  The sum is not the single-device
    kernel's kt-order sum bit for bit."""

    parts: list = dataclasses.field(default_factory=list)

    @property
    def device(self) -> torch.device:
        """Model shard 0's device (the data shard's lead)."""
        return self.parts[0].scale.device

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        from .sharding import psum
        k = self.parts[0].k
        ys = [dm.compressed_matmul(x[:, j * k:(j + 1) * k].to(
            cw.scale.device), cw) for j, cw in enumerate(self.parts)]
        return psum(ys, x.device)


def packed_proj(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Packed projection (``packed_proj`` :100): flatten x's trailing
    contraction axes into K, run the fused decompress-matmul in f32 (over
    the model shards' K ranges for a ``ShardedPackedWeight``), restore the
    output axes and cast back to x's dtype."""
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
    already in x's dtype is not copied).  A model shard's column-parallel
    weight in the sharded step (``ColumnShard``) takes the product its own
    way."""
    if isinstance(w, ColumnShard):
        return w.proj(x, n_contract)
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
    """``a @ b`` in a's dtype with f32 accumulation, b cast to a's dtype
    first as the reference casts each weight at its use.  On the card this is
    cuBLAS in bf16.  On the CPU the product runs in f32 and rounds once,
    which is how XLA's CPU backend evaluates the JAX package's bf16 dots;
    PyTorch's CPU bf16 GEMM rounds differently in the last bit, and that
    bit changes int8 KV values downstream."""
    if isinstance(b, ColumnShard):
        return b.matmul(a)
    b = b.to(a.dtype)
    if a.device.type == "cpu":
        return torch.matmul(a.to(F32), b.to(F32)).to(a.dtype)
    return torch.matmul(a, b)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D operands of one dtype as the unrounded f32
    product: on the card a bf16 GEMM with an f32 output, on the CPU the
    product of f32 casts (a bf16 product is exact in f32)."""
    if a.device.type == "cpu" or a.dtype == F32:
        return torch.mm(a.to(F32), b.to(F32))
    return torch.mm(a, b, out_dtype=F32)


class _ColumnProduct(torch.autograd.Function):
    """``a @ b`` [..., K] x [K, N] of a column-parallel projection
    (``ColumnShard``): the product is ``matmul``'s in a's dtype, saving
    the bf16 operands where autograd would keep f32 copies of the
    activations and weights (6.6 GB more peak at qwen3-1.7b's 28 layers on
    a one-card 2 x 2 mesh, NVIDIA H100 80GB HBM3), and a's gradient
    ``dy W^T`` goes to ``a32`` (the f32 copy of ``a``) unrounded, since one device contracts the whole
    output width and rounds it once, where a shard's partial rounded
    before the shard-order sum would round it once a shard (and once more
    a sum).  The weight's gradient rounds once to b's dtype."""

    @staticmethod
    def forward(ctx, a, b, a32):
        ctx.save_for_backward(a, b)
        return matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        a2, g2 = a.reshape(-1, a.shape[-1]), g.reshape(-1, g.shape[-1])
        ga = gb = None
        if ctx.needs_input_grad[2]:
            ga = _mm32(g2, b.t()).reshape(*g.shape[:-1], b.shape[0])
        if ctx.needs_input_grad[1]:
            gb = matmul(a2.t(), g2)
        return None, gb, ga


class ColumnShard:
    """A column-parallel weight (q/k/v, the FFN's gate and up, the RG-LRU's
    x and gate, the vocabulary-parallel head) of one model shard in the
    sharded train step, bound to the shard's copy of the site input: ``x``
    as the layer reads it and ``x32``, its f32 copy from
    ``sharding.broadcast``.  ``proj``/``matmul`` of ``x`` by it run
    ``_ColumnProduct`` on ``x32``, so the input's gradient reaches the
    shard-order sum in f32 and rounds once, as one device's does.  Any
    other input or contraction is refused: the weight belongs to that one
    input."""

    def __init__(self, w: torch.Tensor, x: torch.Tensor, x32: torch.Tensor):
        self.w, self.x, self.x32 = w, x, x32

    def matmul(self, a: torch.Tensor) -> torch.Tensor:
        return self.proj(a, 1)

    def proj(self, x: torch.Tensor, n_contract: int = 1) -> torch.Tensor:
        if x is not self.x or n_contract != 1:
            raise ValueError("a column shard multiplies the site input it "
                             "was bound to, contracting one axis")
        w2 = self.w.reshape(self.w.shape[0], -1).to(x.dtype)
        y = _ColumnProduct.apply(x, w2, self.x32)
        return y.reshape(*y.shape[:-1], *self.w.shape[1:])


# the column-parallel weights of the TP sites (``tp_site``)
COLUMN_KEYS = frozenset({"wq", "wk", "wv", "w_up", "w_gate", "w_x"})


def column_inputs(x: torch.Tensor, devices: list) -> list:
    """The shards' copies of a column-parallel site input ``x``: ``(xj,
    xj32)`` a device, ``xj32`` from ``sharding.broadcast`` of x's f32
    value (its gradient the shards' f32 sum in shard order, rounded once
    to x's dtype) and ``xj`` its cast back, the bf16 the layer reads."""
    from .sharding import broadcast
    return [(x32.to(x.dtype), x32)
            for x32 in broadcast(x.to(F32), devices)]


# ------------------------------------------------------- model shards
class ModelShards:
    """A site's params split over a mesh's model axis, for the sharded
    train step: ``parts[j]`` is model shard ``j``'s param dict on
    ``devices[j]`` (its block of heads, FFN hidden or recurrent
    channels: the column-parallel input projections' columns and the
    row-parallel output projection's rows), ``cfgs[j]`` the config of
    that block (its head counts); ``lead`` takes the summed output."""

    def __init__(self, parts: list, cfgs: list, devices: list, lead):
        self.parts, self.cfgs, self.devices, self.lead = \
            parts, cfgs, devices, lead


def tp_site(fn, p, x: torch.Tensor, cfg: ModelConfig, *,
            shard_kw: list | None = None, **kw):
    """``fn(p, x, cfg, **kw)``, a site function of ``ROW_SITES``
    (``attention_full``, ``attention_step``, ``recurrent_full`` or
    ``mlp``).  With ``ModelShards`` params its body (the site up to its
    row-parallel output projection) runs once a model shard on its block,
    with ``shard_kw[j]`` besides (e.g. the shard's cache); the shards'
    body outputs are gathered in shard order onto the lead device
    (``all_gather``) and multiplied there by the whole row-parallel
    weight, one product as on one device, so the residual is whole there.
    Partial products summed over the shards, even in f32, round otherwise
    than one device's product: on the card they held the 2 x 2 mesh's
    first step at a share of 0.9574 of qwen3-1.7b's params within lr / 100
    of one device's, against the one-device control's 0.9838, and the one
    product at 0.9837.  A layer's cache comes back as the shards' list.
    x reaches the shards through ``column_inputs``, its column-parallel
    projections through ``ColumnShard``: its gradient is the shards' f32
    sum in shard order, rounded once."""
    if not isinstance(p, ModelShards):
        return fn(p, x, cfg, **kw)
    from .sharding import all_gather
    body, key, nc = ROW_SITES[fn]
    outs = []
    for j, (pj, cj, (xj, x32)) in enumerate(zip(
            p.parts, p.cfgs, column_inputs(x, p.devices))):
        pj = {k: ColumnShard(w, xj, x32) if k in COLUMN_KEYS else w
              for k, w in pj.items()}
        outs.append(body(pj, xj, cj, **kw, **(shard_kw[j] if shard_kw
                                              else {})))
    pair = isinstance(outs[0], tuple)
    hs = [o[0] for o in outs] if pair else outs
    y = proj(all_gather(hs, hs[0].dim() - nc, p.lead),
             all_gather([pj[key] for pj in p.parts], 0, p.lead), nc)
    return (y, [o[1] for o in outs]) if pair else y


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


def _ring_cache(arr: torch.Tensor, w: int, t: int) -> torch.Tensor:
    """The rolling cache of one K or V tensor [B, S, H, dh] at the true end
    ``t`` (``attention_full`` :234-257): slot ``j`` holds the latest
    position ``p < t`` with ``p % w == j``, zeros where no such position
    exists.  One construction covers the reference's three branches
    (unpadded ``s >= w``, unpadded ``s < w`` and the bucketed ring): left-
    padding by ``w`` zeros and rolling the ``w`` positions before ``t`` by
    ``t % w`` gives all three bit for bit."""
    ap = torch.cat([arr.new_zeros(arr.shape[0], w, *arr.shape[2:]), arr], 1)
    return torch.roll(ap[:, t:t + w], t % w, dims=1)


def attention_full(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   local: bool = False, true_len: int | None = None):
    """Prefill attention of a global or rolling (``local``) layer, chunked
    over queries (``attention_full`` :175, mask ``_mask`` :166).  Returns
    ``(y [B, S, D], cache)``: every position for a global layer, the
    rolling ring of ``window`` slots at the true end ``true_len`` (the
    sequence end when None) for a local one.  The cache is int8 ``{k, v,
    k_scale, v_scale}`` when ``cfg.kv_int8``, else the unquantized
    ``{k, v}``."""
    out, cache = attention_heads(p, x, cfg, local=local, true_len=true_len)
    return proj(out, p["wo"], 2), cache


def attention_heads(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    local: bool = False, true_len: int | None = None):
    """``attention_full`` up to its output projection: ``(the heads'
    outputs [B, S, H, dh], cache)``."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    window = cfg.window_size if local else 0
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
        mask = (pos[None, :] <= qpos[:, None] if cfg.causal
                else torch.ones(c, s, dtype=torch.bool, device=x.device))
        if window > 0:
            mask &= pos[None, :] > qpos[:, None] - window
        scores = torch.where(mask, scores, NEG_INF)
        if cfg.logit_softcap > 0:
            cap = cfg.logit_softcap
            scores = cap * torch.tanh(scores / cap)
        w = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkgcs,bskd->bckgd", w, vf).to(x.dtype))
    out = torch.cat(outs, dim=1).reshape(b, s, h, dh)
    if local:
        t = s if true_len is None else int(true_len)
        k = _ring_cache(k, cfg.window_size, t)
        v = _ring_cache(v, cfg.window_size, t)
    if not cfg.kv_int8:
        return out, {"k": k, "v": v}
    qk, sk = kv_quantize(k)
    qv, sv = kv_quantize(v)
    return out, {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}


def attention_step(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                   cfg: ModelConfig, *, local: bool = False):
    """Single-token decode step of a global or rolling layer against a
    dense cache (``attention_step`` :267).  x [B, 1, D]; cache k/v [B, Sc,
    Hkv, dh], int8 with per-(position, head) ``k_scale``/``v_scale`` or in
    the cache dtype; pos [B], each slot's own position.

    A global layer writes slot ``pos`` and reads under ``index <= pos``; a
    rolling one writes the ring slot ``pos % Sc`` and reads the slots whose
    absolute position ``pos - ((pos - j) mod Sc)`` is in ``[0, pos]``.  The
    JAX function returns an updated copy; the port writes the cache's
    tensors in place, so a step holds one cache, and returns the same
    dict."""
    out, cache = attention_step_heads(p, x, cfg, cache=cache, pos=pos,
                                      local=local)
    return proj(out, p["wo"], 2), cache


def attention_step_heads(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                         cache: dict, pos: torch.Tensor,
                         local: bool = False):
    """``attention_step`` up to its output projection, the config third
    as ``tp_site`` calls a site's body: ``(the heads' outputs [B, 1, H,
    dh], cache)``."""
    b = x.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(b, device=x.device)
    sc = cache["k"].shape[1]
    slot = pos % sc if local else pos
    for f, val in step_entries(k, v, cache).items():
        cache[f][rows, slot] = val.to(cache[f].dtype)
    if "k_scale" in cache:
        kc = kv_dequantize(cache["k"], cache["k_scale"])
        vc = kv_dequantize(cache["v"], cache["v_scale"])
    else:
        kc, vc = cache["k"], cache["v"]
    idx = torch.arange(sc, device=x.device)[None, :]
    valid = step_valid(idx, pos, sc, local)
    scores = step_scores(cfg, q.reshape(b, hkv, h // hkv, dh).to(F32),
                         kc.to(F32), valid)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, vc.to(F32))
    return out.reshape(b, 1, h, dh).to(x.dtype), cache


def step_entries(k: torch.Tensor, v: torch.Tensor, cache: dict) -> dict:
    """The new token's cache entries from its K/V [B, 1, Hkv, dh]: int8
    with their scales when the cache holds ``k_scale``, else as they
    are."""
    if "k_scale" in cache:
        qk, sk = kv_quantize(k[:, 0])
        qv, sv = kv_quantize(v[:, 0])
        return {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    return {"k": k[:, 0], "v": v[:, 0]}


def step_valid(idx: torch.Tensor, pos: torch.Tensor, sc: int,
               local: bool) -> torch.Tensor:
    """Which cache slots ``idx`` [1, n] a decode step at ``pos`` [B]
    reads: ``index <= pos`` for a global layer; for a rolling one of
    ``sc`` slots those whose absolute position ``pos - ((pos - j) mod
    sc)`` is in ``[0, pos]``."""
    if local:
        abs_pos = pos[:, None] - torch.remainder(pos[:, None] - idx, sc)
        return (abs_pos >= 0) & (abs_pos <= pos[:, None])
    return idx <= pos[:, None]


def step_scores(cfg: ModelConfig, q: torch.Tensor, kc: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """A decode step's f32 scores [B, Hkv, G, n] of q [B, Hkv, G, dh]
    against cache keys kc [B, n, Hkv, dh], masked by ``valid`` [B, n] and
    soft-capped."""
    scores = torch.einsum("bkgd,bskd->bkgs", q, kc) * (cfg.head_dim ** -0.5)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    if cfg.logit_softcap > 0:
        scores = cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    return scores


def init_attention_cache(cfg: ModelConfig, batch: int, seq_len: int,
                         device, dtype=BF16, *, local: bool = False) -> dict:
    """Zero dense cache of an attention layer (``init_attention_cache``
    :436): ``seq_len`` positions for a global layer, ``min(window,
    seq_len)`` ring slots for a rolling one; int8 K/V with f32
    per-(position, head) scales when ``cfg.kv_int8``, else K/V in
    ``dtype``."""
    sc = min(cfg.window_size, seq_len) if local else seq_len
    shape = (batch, sc, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=F32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=F32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# apack: hot-path-root(traced)
def paged_attention_step(p: dict, x: torch.Tensor, planes,
                         meta: dict, pos: torch.Tensor, cfg: ModelConfig):
    """Single-token decode step of one global layer against the paged APack
    KV pool (``paged_attention_step`` :326).

    The fused kernel reads the layer's pages (``meta``: ``pid``/``tid``
    int32 [B, P], ``kmeta`` int32 [B, P, 2] of (state, t0), ``qw`` int32
    [B, 2] of (qpos, window)) and returns the unnormalized online-softmax
    state; the current token's self term is merged here, then normalized.
    Returns ``(y [B, 1, D], {k, v, k_scale, v_scale})``: the new token's
    quantized K/V for the on-device append.

    ``planes`` may be a data shard's list of model shards' planes
    (``model.DevicePoolPlanes.shards[d]``), each holding a block of the KV
    heads: the kernel then runs once a model shard on its heads' queries,
    with ``h0`` in its jobmeta, and the shards' ``(acc, m, l)`` are
    gathered in head order (``sharding.all_gather``) before the merge.
    The projections run once, here, as the reference runs them on every
    model shard alike."""
    if isinstance(planes, list) and len(planes) == 1:
        planes = planes[0]
    b = x.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // hkv
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    qk, sk = kv_quantize(k[:, 0])
    qv, sv = kv_quantize(v[:, 0])
    kd = kv_dequantize(qk, sk)                                 # [B, Hkv, dh]
    vd = kv_dequantize(qv, sv)
    first = planes[0] if isinstance(planes, list) else planes
    ps_sz = first["tok_k"].shape[1]
    n_streams = first["sym_k"].shape[2]
    # a PACKED page decodes every head, also where the planes hold a block
    n_steps = (ps_sz * hkv * dh) // max(n_streams, 1)
    if isinstance(planes, list):
        acc, m_run, l_run = _head_parallel_attention(
            q[:, 0].to(F32), meta, planes, n_steps, cfg)
    else:
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


def _head_parallel_attention(q: torch.Tensor, meta: dict, shards: list,
                             n_steps: int, cfg: ModelConfig):
    """Kernel 3 once a model shard (``paged_attention_step`` :360-389):
    shard ``j`` holds KV heads ``[j H/n, (j+1) H/n)`` of the dense planes
    and takes their query heads and ``h0 = j H/n``; the shards' unnormalized
    ``(acc, m, l)`` are gathered along heads, in shard order, onto q's
    device."""
    from .sharding import all_gather
    b, hq, dh = q.shape
    n = len(shards)
    hl = cfg.num_kv_heads // n
    ql = hq // n
    outs = []
    for j, pl in enumerate(shards):
        dev = pl["tok_k"].device
        mj = {k: meta[k].to(dev) for k in ("pid", "tid", "kmeta", "qw")}
        jm = torch.cat([mj["qw"], torch.full((b, 1), j * hl,
                                             dtype=mj["qw"].dtype,
                                             device=dev)], dim=1)
        outs.append(fused_page_attention(
            q[:, j * ql:(j + 1) * ql].to(dev).contiguous(), mj["pid"],
            mj["tid"], mj["kmeta"], jm, pl, n_steps=n_steps,
            softcap=float(cfg.logit_softcap), h_full=cfg.num_kv_heads))
    return tuple(all_gather([o[i] for o in outs], 1, q.device)
                 for i in range(3))


# --------------------------------------------------------------------- mlp
_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default ``approximate=True``, the tanh form)
    as the compiled JAX model evaluates it: op by op in x's dtype, every
    intermediate rounded (for bf16, each op computes in f32 and rounds),
    with the constants cast to x's dtype first as the reference does.  A
    fused f32 gelu rounds once and differs in the last bf16 bit."""
    def c(v):   # a fill on the device, not an upload (no stream wait)
        return torch.full((), v, dtype=x.dtype, device=x.device)
    inner = c(_SQRT_2_OVER_PI) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def _silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` as the JAX package evaluates it in bf16 (x *
    logistic(x), the logistic as 1 / (1 + exp(-x))), every op rounded to
    bf16; a fused f32 silu rounds once and differs in the last bf16 bit."""
    return gate * (1.0 / (1.0 + torch.exp(-gate))) * up


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The FFN (``mlp`` :461): gated swiglu or geglu, or ungated ``gelu``
    (gelu of the up projection) or ``relu2`` (squared ReLU, op by op in
    the activations' bf16), then the down projection."""
    return proj(mlp_hidden(p, x, cfg), p["w_down"])


def mlp_hidden(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``mlp`` up to its down projection: the hidden activations."""
    up = proj(x, p["w_up"])
    if cfg.mlp_variant == "swiglu":
        hid = _silu_mul(proj(x, p["w_gate"]), up)
    elif cfg.mlp_variant == "geglu":
        hid = gelu(proj(x, p["w_gate"])) * up
    elif cfg.mlp_variant == "gelu":
        hid = gelu(up)
    elif cfg.mlp_variant == "relu2":
        hid = torch.square(torch.relu(up))
    else:
        raise ValueError(cfg.mlp_variant)
    return hid


def init_mlp(cfg: ModelConfig, normal, d_ff: int | None = None) -> dict:
    """FFN params (``init_mlp`` :449): ``w_up`` [d, f], for the gated
    variants ``w_gate`` [d, f], and ``w_down`` [f, d], drawn in that order
    by ``normal(shape, scale)``."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": normal((d, f), d ** -0.5)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w_gate"] = normal((d, f), d ** -0.5)
    p["w_down"] = normal((f, d), f ** -0.5)
    return p


# --------------------------------------------------------------------- moe
MOE_GROUP = 1024     # tokens per dispatch group (``MOE_GROUP`` :480)


def init_moe(cfg: ModelConfig, normal, router_normal) -> dict:
    """Routed experts (``init_moe`` :483): the f32 ``router`` [d, E]
    (``router_normal``, always f32), stacked expert weights ``wi``/``wg``
    [E, d, f] and ``wo`` [E, f, d], and a swiglu ``shared`` expert of width
    ``moe_d_ff * n_shared_experts`` when the config has one."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": router_normal((d, e), d ** -0.5),
         "wi": normal((e, d, f), d ** -0.5),
         "wg": normal((e, d, f), d ** -0.5),
         "wo": normal((e, f, d), f ** -0.5)}
    if cfg.n_shared_experts:
        sub = dataclasses.replace(cfg, mlp_variant="swiglu")
        p["shared"] = init_mlp(sub, normal,
                               d_ff=f * cfg.n_shared_experts)
    return p


def moe_capacity(cfg: ModelConfig, tokens: int) -> tuple[int, int]:
    """(group size, expert capacity) of ``tokens`` routed tokens
    (``moe`` :506-514): the group is the largest divisor of the token count
    not above ``MOE_GROUP``; the capacity ``ceil(g k capacity_factor /
    E)``, clamped to [4, g]."""
    g = min(MOE_GROUP, tokens)
    while tokens % g:
        g -= 1
    cap = int(np.ceil(g * cfg.num_experts_per_tok * cfg.capacity_factor
                      / cfg.num_experts))
    return g, max(4, min(cap, g))


def router_probs(logits: torch.Tensor) -> torch.Tensor:
    """The router's softmax as ``jax.nn.softmax`` computes it in f32:
    ``exp(x - max) / sum``."""
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    return ex / ex.sum(-1, keepdim=True)


def moe_route(logits: torch.Tensor, k: int, cap: int):
    """Top-k token-choice routing with capacity dropping over groups
    (``moe.one_group`` :517-530), in f32: softmax of the router logits
    [N, G, E], the top ``k`` experts per token (ties to the lower index, as
    ``lax.top_k``), their weights renormalized, and the capacity position
    of each choice from the cumulative one-hot count, choice ``i`` after
    every token's choices ``< i``.  A choice past ``cap`` is dropped.
    Returns ``combine`` f32 [N, G, E, cap] (the kept weight at the token's
    (expert, position) slot, 0 elsewhere) and ``sel`` [N, G, k]."""
    n, g, e = logits.shape
    w, sel = torch.sort(router_probs(logits), dim=-1, descending=True,
                        stable=True)
    w, sel = w[..., :k], sel[..., :k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    slots = torch.arange(cap, device=logits.device, dtype=F32)
    counts = logits.new_zeros(n, 1, e)
    combine = logits.new_zeros(n, g, e, cap)
    for i in range(k):
        oh = torch.nn.functional.one_hot(sel[..., i], e).to(F32)
        pos = counts + torch.cumsum(oh, dim=1) - oh             # [N, G, E]
        keep = oh * (pos < cap)
        combine = combine + (w[..., i:i + 1] * keep)[..., None] \
            * (pos[..., None] == slots).to(F32)
        counts = counts + keep.sum(dim=1, keepdim=True)
    return combine, sel


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` in a's dtype with f32 accumulation (``matmul``'s
    rule), one product per leading index: each expert's own GEMM."""
    b = b.to(a.dtype)
    if a.device.type == "cpu":
        return torch.stack([matmul(a[i], b[i]) for i in range(a.shape[0])])
    return torch.bmm(a, b)


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Token-choice top-k MoE with capacity dropping (``moe`` :500).  x
    [B, S, D] regroups into dispatch groups (``moe_capacity``), routed by
    ``moe_route``; the one-hot dispatch and combine run in the activations'
    dtype, the experts as batched products ``ecd,edf->ecf`` (swiglu), and
    the shared expert, if any, is added after.  Every position routes,
    pad positions of a bucketed prefill and idle decode slots included, as
    in the reference.  Returns ``(y, aux)``: the training losses of
    :543-549, each a group mean then a mean over the groups, in f32 -- the
    Switch load balance ``E sum(frac_tokens frac_probs)`` over the first
    choices and the router z-loss ``mean(logsumexp(logits)^2)``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    g, cap = moe_capacity(cfg, b * s)
    xg = x.reshape(-1, g, d)                                   # [N, G, D]
    n = xg.shape[0]
    logits = torch.matmul(xg.to(F32), p["router"].to(F32))    # [N, G, E]
    combine, sel = moe_route(logits, k, cap)
    dispatch = (combine > 0).to(x.dtype)                       # [N, G, E, C]
    # [N, E*C, G] @ [N, G, D]: each (expert, slot) takes one token's row
    xin = _bmm(dispatch.reshape(n, g, e * cap).transpose(1, 2), xg)
    xin = xin.reshape(n, e, cap, d).transpose(0, 1).reshape(e, n * cap, d)
    h = _silu_mul(_bmm(xin, p["wg"]), _bmm(xin, p["wi"]))
    out = _bmm(h, p["wo"])                                     # [E, N*C, D]
    out = out.reshape(e, n, cap, d).transpose(0, 1).reshape(n, e * cap, d)
    y = _bmm(combine.to(x.dtype).reshape(n, g, e * cap), out)
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x, dataclasses.replace(
            cfg, mlp_variant="swiglu"))
    first = torch.nn.functional.one_hot(sel[..., 0], e).to(F32)
    lb = e * (first.mean(1) * router_probs(logits).mean(1)).sum(-1)
    z = torch.square(torch.logsumexp(logits, dim=-1)).mean(1)
    return y, {"load_balance": lb.mean(), "router_z": z.mean()}


# ------------------------------------------------------------------ RG-LRU
# params of the recurrent, mLSTM and sLSTM blocks the reference uses in
# f32 (the rest are cast to the activations' bf16 at their use)
RECURRENT_F32 = ("a_param", "w_input_gate", "w_a_gate", "w_if", "r", "b")


def init_recurrent(cfg: ModelConfig, generator: torch.Generator, device,
                   dtype) -> dict:
    """Griffin recurrent block params with the JAX init's distributions
    (``init_recurrent`` :553): two input branches, a width-4 temporal
    conv, the RG-LRU gates and ``a_param`` (f32, the softplus inverse of
    ``8 c`` for ``c`` uniform in [0.8, 0.9]), the output projection."""
    d = cfg.d_model
    w = cfg.lru_width or d

    def normal(shape, scale):
        x = torch.randn(*shape, generator=generator, device=device)
        return (x * scale).to(dtype)

    s = d ** -0.5
    c = 0.8 + 0.1 * torch.rand(w, generator=generator, device=device)
    return {"w_x": normal((d, w), s), "w_gate": normal((d, w), s),
            "w_out": normal((w, d), w ** -0.5),
            "conv_w": normal((4, w), 0.5),
            "a_param": torch.log(torch.exp(8.0 * c) - 1.0).to(F32),
            "w_input_gate": normal((w,), 0.1),
            "w_a_gate": normal((w,), 0.1)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))``, not PyTorch's thresholded ``log1p(exp(x))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _rglru_coeffs(p: dict, xw: torch.Tensor):
    """Per-step RG-LRU gates (``_rglru_coeffs`` :571), in f32: the decay
    ``a`` and the gated input ``beta * i * xw``.  ``sigmoid`` is XLA's
    ``logistic``; ``torch.sigmoid`` is the closest CPU twin (both differ
    from ``1 / (1 + exp(-x))`` in the last bit)."""
    xf = xw.to(F32)
    r = torch.sigmoid(xf * p["w_a_gate"].to(F32))
    i = torch.sigmoid(xf * p["w_input_gate"].to(F32))
    log_a = -8.0 * r * softplus(p["a_param"].to(F32))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    return a, beta * i * xf


def _scan_combine(a1, b1, a2, b2):
    """The RG-LRU scan's operator, ``(a1 a2, a2 b1 + b2)``; XLA's CPU
    backend contracts ``a2 * b1 + b2`` into one FMA, which ``addcmul``
    is on the CPU."""
    return a1 * a2, torch.addcmul(b2, a2, b1)


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``) along
    axis 1 in ``jax.lax.associative_scan``'s odd/even recursion, so that
    the f32 products and sums associate as the reference's do: combine
    adjacent pairs, scan those, then fill in the even positions.  Log
    depth in tensor ops; returns ``(prod a, h)``."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = linear_scan(*_scan_combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                                        a[:, 1::2], b[:, 1::2]))
    m = (n - 1) // 2
    ea, eb = _scan_combine(oa[:, :m], ob[:, :m], a[:, 2::2], b[:, 2::2])
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    for out, first, even, odd in ((out_a, a, ea, oa), (out_b, b, eb, ob)):
        out[:, 0] = first[:, 0]
        out[:, 2::2] = even
        out[:, 1::2] = odd
    return out_a, out_b


def _conv(hist: torch.Tensor, conv_w: torch.Tensor, s: int) -> torch.Tensor:
    """Causal width-4 temporal conv over ``hist`` [B, s + 3, W] (bf16):
    ``sum_i hist[:, i:i + s] * conv_w[i]``, summed left to right as the
    reference's Python ``sum``, returned in f32 for the gates.  Products
    and the first two sums round to bf16; the last sum does not, because
    the compiled reference feeds it straight to the gates' f32 cast and
    XLA drops that bf16 round trip."""
    w = conv_w.to(hist.dtype)
    out = hist[:, 0:s] * w[0] + hist[:, 1:s + 1] * w[1] \
        + hist[:, 2:s + 2] * w[2]
    return out.to(F32) + (hist[:, 3:s + 3] * w[3]).to(F32)


def recurrent_full(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   pad_mask: torch.Tensor | None = None,
                   true_len: int | None = None):
    """Griffin recurrent block over a full sequence (``recurrent_full``
    :582).  ``pad_mask`` ([S] bool, True past ``true_len``) makes pad steps
    inert (a = 1, input 0), so the final state is the unpadded one, and
    the conv history is the three inputs before ``true_len``.  Returns
    ``(y [B, S, D], {"h": f32 [B, W], "conv": f32 [B, 3, W]})``."""
    hid, cache = recurrent_hidden(p, x, cfg, pad_mask=pad_mask,
                                  true_len=true_len)
    return matmul(hid, p["w_out"]), cache


def recurrent_hidden(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     pad_mask: torch.Tensor | None = None,
                     true_len: int | None = None):
    """``recurrent_full`` up to its output projection: ``(the gated scan
    [B, S, W], cache)``."""
    b, s, _ = x.shape
    xw = matmul(x, p["w_x"])                                    # [B, S, W]
    gate = gelu(matmul(x, p["w_gate"]))
    xp = torch.cat([xw.new_zeros(b, 3, xw.shape[-1]), xw], 1)
    a, bx = _rglru_coeffs(p, _conv(xp, p["conv_w"], s))
    if pad_mask is not None:
        pad3 = pad_mask[None, :, None]
        a = torch.where(pad3, 1.0, a)
        bx = torch.where(pad3, 0.0, bx)
    _, h = linear_scan(a, bx)
    hid = h.to(x.dtype) * gate
    t = s if true_len is None else int(true_len)
    return hid, {"h": h[:, -1].to(F32), "conv": xp[:, t:t + 3].to(F32)}


# each TP site function's body up to its row-parallel output projection,
# that projection's weight and how many axes it contracts (``tp_site``)
ROW_SITES = {attention_full: (attention_heads, "wo", 2),
             attention_step: (attention_step_heads, "wo", 2),
             mlp: (mlp_hidden, "w_down", 1),
             recurrent_full: (recurrent_hidden, "w_out", 1)}


def recurrent_step(p: dict, x: torch.Tensor, cache: dict,
                   cfg: ModelConfig):
    """Single-token recurrent step (``recurrent_step`` :628): x [B, 1, D],
    cache ``{"h", "conv"}`` -> (y [B, 1, D], the new cache)."""
    xw = matmul(x[:, 0], p["w_x"])                              # [B, W]
    gate = gelu(matmul(x[:, 0], p["w_gate"]))
    hist = torch.cat([cache["conv"].to(xw.dtype), xw[:, None]], 1)
    a, bx = _rglru_coeffs(p, _conv(hist, p["conv_w"], 1)[:, 0])
    h = torch.addcmul(bx, a, cache["h"])
    y = matmul(h.to(x.dtype) * gate, p["w_out"])[:, None]
    return y, {"h": h, "conv": hist[:, 1:].to(F32)}


def init_recurrent_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """Zero recurrent state (``init_recurrent_cache`` :641)."""
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros(batch, w, dtype=F32, device=device),
            "conv": torch.zeros(batch, 3, w, dtype=F32, device=device)}


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    autograd records it (``jax.checkpoint``): ``torch.utils.checkpoint``
    without reentry, so closures over params take their gradients; a plain
    call when no tensor argument needs a gradient (serving)."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def chunk_of(s: int) -> int:
    """Largest chunk <= ``CHUNK`` dividing s (``_chunk_of`` :58)."""
    c = min(CHUNK, s)
    while s % c:
        c -= 1
    return c


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``, ``-softplus(-x) = min(x, 0) -
    log1p(exp(-|x|))``: exactly 0.0 at ``x = 1e30`` (a pad step's forget
    gate), and the same formula on both devices."""
    return torch.clamp_max(x, 0.0) - torch.log1p(torch.exp(-x.abs()))


# ------------------------------------------------------------------ mLSTM
def mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(F, H, dh): the up-projection width ``mlstm_proj_factor * d``, its
    heads and their width."""
    f = int(cfg.mlstm_proj_factor * cfg.d_model)
    return f, cfg.num_heads, f // cfg.num_heads


def init_mlstm(cfg: ModelConfig, normal, zeros) -> dict:
    """mLSTM block params with the JAX init's shapes and scales
    (``init_mlstm`` :647): the up, gate and down projections, per-head
    q/k/v maps [F, H, dh], the f32 input/forget gate map ``w_if`` [F, H,
    2] and the output norm, drawn in that order by ``normal(shape, scale[,
    dtype])``; ``zeros(shape[, dtype])`` makes the norm scale."""
    d = cfg.d_model
    f, h, dh = mlstm_dims(cfg)
    s = d ** -0.5
    return {"w_up": normal((d, f), s), "w_gate": normal((d, f), s),
            "w_down": normal((f, d), f ** -0.5),
            "wq": normal((f, h, dh), f ** -0.5),
            "wk": normal((f, h, dh), f ** -0.5),
            "wv": normal((f, h, dh), f ** -0.5),
            "w_if": normal((f, h, 2), f ** -0.5, F32),
            "out_norm": zeros(f)}


def _mlstm_chunk(q, k, v, i_gate, f_gate, c0, n0, m0):
    """One chunk of the mLSTM chunkwise-parallel form (``_mlstm_chunk``
    :671), in f32.  q, k, v [B, C, H, dh]; i, f [B, C, H] log-space
    gates; the state c0 [B, H, dh, dh], n0 [B, H, dh] and stabilizer m0
    [B, H] (true C = c exp(m)).  Returns (out [B, C, H, dh], c1, n1,
    m1)."""
    c, dh = q.shape[1], q.shape[3]
    logf = log_sigmoid(f_gate)
    lf_cum = torch.cumsum(logf, dim=1)                     # inclusive b_t
    # step s's weight at step t (s <= t): exp(b_t - b_s + i_s)
    logd = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] \
        + i_gate[:, None, :, :]                            # [B, T, S, H]
    tmask = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    logd = torch.where(tmask[None, :, :, None], logd, NEG_INF)
    # the carried state enters step t with weight exp(b_t + m0)
    logstate = lf_cum + m0[:, None, :]                     # [B, C, H]
    m = torch.maximum(logd.amax(2), logstate)
    dmat = torch.exp(logd - m[:, :, None, :])
    sstate = torch.exp(logstate - m)
    qf = q.to(F32) * (dh ** -0.5)
    kf, vf = k.to(F32), v.to(F32)
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * dmat
    num = torch.einsum("btsh,bshd->bthd", scores, vf) \
        + torch.einsum("bthd,bhde->bthe", qf, c0) * sstate[..., None]
    den_inter = torch.einsum("bthd,bhd->bth", qf, n0) * sstate
    den = torch.maximum(torch.abs(scores.sum(2) + den_inter),
                        torch.exp(-m))
    out = num / den[..., None]
    # the chunk's final state
    lf_tot = lf_cum[:, -1]                                 # [B, H]
    w_log = i_gate + (lf_tot[:, None] - lf_cum)            # [B, C, H]
    m1 = torch.maximum(lf_tot + m0, w_log.amax(1))
    w_state = torch.exp(lf_tot + m0 - m1)
    w_in = torch.exp(w_log - m1[:, None, :])
    c1 = c0 * w_state[..., None, None] + torch.einsum(
        "bshd,bshe->bhde", kf * w_in[..., None], vf)
    n1 = n0 * w_state[..., None] + torch.einsum("bshd,bsh->bhd", kf, w_in)
    return out, c1, n1, m1


def mlstm_full(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
               pad_mask: torch.Tensor | None = None):
    """mLSTM block over a full sequence (``mlstm_full`` :718): the
    chunkwise scan over ``chunk_of(S)``-step chunks from the empty state
    (``init_mlstm_cache``: the stabilizer at -1e30, as the decode path
    starts, or the ``exp(-m)`` bound would part), each chunk recomputed in
    the backward pass (``remat``).  ``pad_mask`` ([S] bool, True past the
    true end): pad steps take ``i = -1e30`` (no input) and ``f = +1e30``
    (``log_sigmoid`` exactly 0, no decay), so the state at the true end
    passes through the pad steps unchanged.  Returns ``(y [B, S, D],
    {"c", "n", "m"})``."""
    b, s, _ = x.shape
    f, h, dh = mlstm_dims(cfg)
    up = matmul(x, p["w_up"])                              # [B, S, F]
    gate = matmul(x, p["w_gate"])
    q, k, v = (proj(up, p[n]) for n in ("wq", "wk", "wv"))  # [B, S, H, dh]
    gates = proj(up.to(F32), p["w_if"])                    # [B, S, H, 2]
    i_gate, f_gate = gates[..., 0], gates[..., 1] + 3.0    # forget bias
    if pad_mask is not None:
        padh = pad_mask[None, :, None]
        i_gate = torch.where(padh, NEG_INF, i_gate)
        f_gate = torch.where(padh, -NEG_INF, f_gate)
    state = tuple(init_mlstm_cache(cfg, b, x.device).values())
    chunk = chunk_of(s)
    outs = []
    for t in range(0, s, chunk):
        sl = slice(t, t + chunk)
        out, *state = remat(_mlstm_chunk, q[:, sl], k[:, sl], v[:, sl],
                            i_gate[:, sl], f_gate[:, sl], *state)
        outs.append(out)
    out = torch.cat(outs, dim=1).reshape(b, s, f)
    out = rms_norm(out.to(x.dtype), p["out_norm"], cfg.norm_eps)
    y = matmul(_silu_mul(gate, out), p["w_down"])      # out * silu(gate)
    return y, dict(zip(("c", "n", "m"), state))


def mlstm_step(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """Single-token mLSTM step (``mlstm_step`` :761): x [B, 1, D], cache
    ``{"c", "n", "m"}`` -> (y [B, 1, D], the new cache)."""
    b = x.shape[0]
    f, h, dh = mlstm_dims(cfg)
    up = matmul(x[:, 0], p["w_up"])                        # [B, F]
    gate = matmul(x[:, 0], p["w_gate"])
    q, k, v = (proj(up, p[n]).to(F32) for n in ("wq", "wk", "wv"))
    gts = proj(up.to(F32), p["w_if"])                      # [B, H, 2]
    i_g, f_g = gts[..., 0], gts[..., 1] + 3.0
    logf = log_sigmoid(f_g)
    c0, n0, m0 = cache["c"], cache["n"], cache["m"]
    m1 = torch.maximum(logf + m0, i_g)
    wf = torch.exp(logf + m0 - m1)
    wi = torch.exp(i_g - m1)
    c1 = c0 * wf[..., None, None] \
        + k[..., :, None] * v[..., None, :] * wi[..., None, None]
    n1 = n0 * wf[..., None] + k * wi[..., None]
    qs = q * (dh ** -0.5)
    num = torch.einsum("bhd,bhde->bhe", qs, c1)
    den = torch.maximum(torch.abs((qs * n1).sum(-1)), torch.exp(-m1))
    out = (num / den[..., None]).reshape(b, f)
    out = rms_norm(out.to(x.dtype), p["out_norm"], cfg.norm_eps)
    y = matmul(_silu_mul(gate, out), p["w_down"])[:, None]
    return y, {"c": c1, "n": n1, "m": m1}


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """The empty mLSTM state (``init_mlstm_cache`` :788): zero c and n,
    the stabilizer m at -1e30."""
    _, h, dh = mlstm_dims(cfg)
    return {"c": torch.zeros(batch, h, dh, dh, dtype=F32, device=device),
            "n": torch.zeros(batch, h, dh, dtype=F32, device=device),
            "m": torch.full((batch, h), NEG_INF, dtype=F32, device=device)}


# ------------------------------------------------------------------ sLSTM
def init_slstm(cfg: ModelConfig, normal, zeros) -> dict:
    """sLSTM block params with the JAX init's shapes and scales
    (``init_slstm`` :797): the input map ``w_in`` [d, 4, d], the f32
    block-diagonal recurrence ``r`` [4, H, dh, dh] (one [dh, dh] a head and
    gate), the f32 bias ``b`` [4, d], the output norm, and the gelu-gated
    FFN ``w_up`` [d, 2, F] / ``w_down`` [F, d]."""
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    f = int(cfg.slstm_proj_factor * d)
    s = d ** -0.5
    return {"w_in": normal((d, 4, d), s),
            "r": normal((4, h, dh, dh), dh ** -0.5, F32),
            "b": zeros((4, d), F32),
            "out_norm": zeros(d),
            "w_up": normal((d, 2, f), s),
            "w_down": normal((f, d), f ** -0.5)}


def _slstm_cell(zx, state, p, h_heads, pad=None):
    """One sLSTM time step (``_slstm_cell`` :815), in f32.  zx [B, 4, D]
    are the input pre-activations (z, i, f, o); ``state`` (c, n, m, h).
    ``pad`` (0-d bool tensor): a pad step of a bucketed prefill is a no-op
    -- input gate -1e30, no decay, the output held at ``h``."""
    c, n, m, hprev = state
    b, _, d = zx.shape
    hh = hprev.reshape(b, h_heads, -1)
    rec = torch.einsum("ghde,bhd->bghe", p["r"], hh).reshape(b, 4, d)
    pre = zx.to(F32) + rec + p["b"][None]
    zt = torch.tanh(pre[:, 0])
    it = pre[:, 1]
    ot = torch.sigmoid(pre[:, 3])
    logf = log_sigmoid(pre[:, 2])
    if pad is not None:
        it = torch.where(pad, NEG_INF, it)
        logf = torch.where(pad, 0.0, logf)
    m1 = torch.maximum(logf + m, it)
    wi = torch.exp(it - m1)
    wf = torch.exp(logf + m - m1)
    c1 = wf * c + wi * zt
    n1 = wf * n + wi
    h1 = ot * (c1 / torch.clamp_min(n1, 1e-6))
    if pad is not None:
        h1 = torch.where(pad, hprev, h1)
    return c1, n1, m1, h1


def _slstm_chunk(p, h_heads, zx, pads, *state):
    """``zx.shape[1]`` sLSTM steps from ``state``: (c, n, m, h, the
    outputs [B, C, D])."""
    hs = []
    for t in range(zx.shape[1]):
        state = _slstm_cell(zx[:, t], state, p, h_heads,
                            None if pads is None else pads[t])
        hs.append(state[3])
    return (*state, torch.stack(hs, dim=1))


def slstm_full(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
               pad_mask: torch.Tensor | None = None):
    """sLSTM block over a full sequence (``slstm_full`` :848): the cell a
    step at a time (the reference's ``lax.scan``; here a loop, one launch
    of each op a step), in ``chunk_of(S)``-step chunks, each recomputed in
    the backward pass (``remat``); then the output norm and the gelu-gated
    FFN.  ``pad_mask``: pad steps are no-ops, so the state is the true
    end's.  Returns ``(y [B, S, D], {"c", "n", "m", "h"})``."""
    b, s, d = x.shape
    zx = proj(x, p["w_in"])                                # [B, S, 4, D]
    state = tuple(init_slstm_cache(cfg, b, x.device).values())
    chunk = chunk_of(s)
    hs = []
    for t in range(0, s, chunk):
        pads = None if pad_mask is None else pad_mask[t:t + chunk]
        *state, out = remat(_slstm_chunk, p, cfg.num_heads,
                            zx[:, t:t + chunk], pads, *state)
        hs.append(out)
    hseq = rms_norm(torch.cat(hs, dim=1).to(x.dtype), p["out_norm"],
                    cfg.norm_eps)
    up = proj(hseq, p["w_up"])                             # [B, S, 2, F]
    y = matmul(gelu(up[:, :, 0]) * up[:, :, 1], p["w_down"])
    return y, dict(zip(("c", "n", "m", "h"), state))


def slstm_step(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """Single-token sLSTM step (``slstm_step`` :878)."""
    zx = proj(x[:, 0], p["w_in"])                          # [B, 4, D]
    state = _slstm_cell(zx, (cache["c"], cache["n"], cache["m"],
                             cache["h"]), p, cfg.num_heads)
    hs = rms_norm(state[3].to(x.dtype), p["out_norm"], cfg.norm_eps)
    up = proj(hs, p["w_up"])                               # [B, 2, F]
    y = matmul(gelu(up[:, 0]) * up[:, 1], p["w_down"])[:, None]
    return y, dict(zip(("c", "n", "m", "h"), state))


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """The empty sLSTM state (``init_slstm_cache`` :889): zero c, n and h,
    the stabilizer m at -1e30."""
    d = cfg.d_model

    def z():
        return torch.zeros(batch, d, dtype=F32, device=device)
    return {"c": z(), "n": z(),
            "m": torch.full((batch, d), NEG_INF, dtype=F32, device=device),
            "h": z()}


# ------------------------------------------------------------ KV page pool
# Page lifecycle: FREE -> HOT (per-token int8 + per-token-head scales, being
# appended) -> COLD (full; re-quantized to one scale per (page, head)) ->
# PACKED (COLD payload APack-encoded with the layer's activation tables).
# Pages that fill before the layer's tables are calibrated stay COLD.

PAGE_FREE, PAGE_HOT, PAGE_COLD, PAGE_PACKED = 0, 1, 2, 3
PAGE_STATE_NAMES = {PAGE_FREE: "FREE", PAGE_HOT: "HOT", PAGE_COLD: "COLD",
                    PAGE_PACKED: "PACKED"}

# The lifecycle transition table (the JAX package's); every state-changing
# pool method validates its edge here before writing.  Rolling-window
# eviction frees only sealed pages: the newest tokens live in a HOT one.
# A spill frees a page of any live state into the host tier; an adopt
# brings one back through a fresh HOT slot.
PAGE_TRANSITIONS = {
    "alloc":  ((PAGE_FREE, PAGE_HOT),),
    "free":   ((PAGE_HOT, PAGE_FREE), (PAGE_COLD, PAGE_FREE),
               (PAGE_PACKED, PAGE_FREE)),
    "evict":  ((PAGE_COLD, PAGE_FREE), (PAGE_PACKED, PAGE_FREE)),
    "spill":  ((PAGE_HOT, PAGE_FREE), (PAGE_COLD, PAGE_FREE),
               (PAGE_PACKED, PAGE_FREE)),
    "adopt":  ((PAGE_HOT, PAGE_COLD), (PAGE_HOT, PAGE_PACKED)),
    "seal":   ((PAGE_HOT, PAGE_COLD),),
    "pack":   ((PAGE_COLD, PAGE_PACKED),),
    "repack": ((PAGE_PACKED, PAGE_PACKED),),
}


class PageIntegrityError(RuntimeError):
    """A KV page failed an integrity check (``PageIntegrityError`` :953): a
    checksum mismatch on unspill or re-pack, a SPILLED page on the read
    path, or a poisoned table generation.  Carries what the engine needs to
    fail the owning request only."""

    def __init__(self, msg: str, *, rid: int | None = None,
                 layer: int | None = None, pid: int | None = None,
                 handle: int | None = None):
        super().__init__(msg)
        self.rid = rid
        self.layer = layer
        self.pid = pid
        self.handle = handle


class TransferDropped(RuntimeError):
    """A host<->device transfer was dropped (fault injection)."""

    def __init__(self, msg: str, *, direction: str = "?"):
        super().__init__(msg)
        self.direction = direction


@dataclasses.dataclass
class SpillRecord:
    """One page's payload parked in the host spill tier (``SpillRecord``
    :978): ``state`` is the pool state before the spill, which picks the
    payload's layout at adopt; ``payload`` holds host numpy arrays in the
    JAX package's dtypes and keys (u32 words as ``uint32``, ``stored`` as
    ``bool``), so its CRC equals the JAX package's for the same page."""
    state: int
    fill: int
    layer: int
    gen: int                       # page_gen at spill time
    payload: dict
    comp_bytes: int                # pool footprint at spill time
    raw_bytes: int                 # dense-int8 equivalent
    crc: int = 0
    meta: dict = dataclasses.field(default_factory=dict)


def payload_crc(payload: dict) -> int:
    """CRC32 over a payload dict of numpy arrays in sorted-key order
    (``payload_crc`` :996)."""
    c = 0
    for k in sorted(payload):
        c = zlib.crc32(np.ascontiguousarray(payload[k]).tobytes(), c)
    return c & 0xFFFFFFFF


class HostSpillTier:
    """Host store of spilled KV pages (``HostSpillTier`` :1006): records
    keyed by an opaque handle, CRC stamped at ``put`` and checked at every
    ``get``; a mismatching record is quarantined (kept, never served
    again) and ``get`` raises ``PageIntegrityError``."""

    def __init__(self):
        self._records: dict[int, SpillRecord] = {}
        self.quarantined: dict[int, SpillRecord] = {}
        self._next_handle = 0
        self.live_bytes = 0
        self.put_count = 0
        self.get_count = 0
        self.integrity_failures = 0

    @property
    def live_count(self) -> int:
        return len(self._records)

    def live_gens(self) -> set[int]:
        """Table generations the parked records were coded under: they stay
        live for table-row compaction."""
        return {rec.gen for rec in self._records.values()}

    def put(self, rec: SpillRecord) -> int:
        rec.crc = payload_crc(rec.payload)
        handle = self._next_handle
        self._next_handle += 1
        self._records[handle] = rec
        self.live_bytes += rec.comp_bytes
        self.put_count += 1
        return handle

    def get(self, handle: int, *, verify: bool = True) -> SpillRecord:
        if handle not in self._records:
            raise KeyError(
                f"spill handle {handle} not live "
                f"(quarantined={handle in self.quarantined})")
        rec = self._records[handle]
        self.get_count += 1
        if verify and payload_crc(rec.payload) != rec.crc:
            self.quarantine(handle)
            raise PageIntegrityError(
                f"spilled page failed checksum on unspill (handle={handle}, "
                f"layer={rec.layer}, state="
                f"{PAGE_STATE_NAMES.get(rec.state, rec.state)}); "
                "record quarantined", handle=handle, layer=rec.layer)
        return rec

    def drop(self, handle: int) -> None:
        """Release a live record; quarantined records are kept."""
        rec = self._records.pop(handle, None)
        if rec is not None:
            self.live_bytes -= rec.comp_bytes

    def quarantine(self, handle: int) -> None:
        rec = self._records.pop(handle, None)
        if rec is None:
            return
        self.live_bytes -= rec.comp_bytes
        self.quarantined[handle] = rec
        self.integrity_failures += 1


# spill payload fields by pool state: (payload key, pool attribute, JAX
# numpy dtype); planes of u32 words are held in int32 tensors here.  The
# PACKED fields are also what a page's checksum covers.
SPILL_FIELDS = {
    PAGE_HOT: (("tok_q", "tok_q", np.int8),
               ("tok_scale", "tok_scale", np.float32)),
    PAGE_COLD: (("cold_q", "cold_q", np.int8),
                ("page_scale", "page_scale", np.float32)),
    PAGE_PACKED: (("sym", "sym", np.uint32), ("ofs", "ofs", np.uint32),
                  ("sym_bits", "sym_bits", np.int32),
                  ("ofs_bits", "ofs_bits", np.int32),
                  ("stored", "stored", np.bool_),
                  ("page_scale", "page_scale", np.float32)),
}


def payload_of(state: int, host: dict, j: int, prefix: str = "") -> dict:
    """Page ``j``'s payload from pulled [2, n, ...] arrays
    ``host[prefix + key]`` of its ``state``'s fields, in the JAX package's
    dtypes (``uint32`` words, ``bool`` flags)."""
    out = {}
    for key, _, dt in SPILL_FIELDS[state]:
        a = np.ascontiguousarray(host[prefix + key][:, j])
        out[key] = a.astype(bool) if dt is np.bool_ else a.view(dt)
    return out


def _requantize(tok_q: torch.Tensor, tok_scale: torch.Tensor):
    """A full page's per-token int8 [2, n, ps, H, dh] and scales [2, n, ps,
    H] requantized to one scale per (page, head): ``(q2, scale2)``.  Each
    head on its own, so a model shard requantizes its heads alone."""
    f = tok_q.to(F32) * tok_scale[..., None]
    # the reference divides on the host (numpy): a true division
    sc = quant.true_divide(torch.clamp_min(f.abs().amax(dim=(2, 4)), 1e-8),
                           127.0)
    q2 = torch.clamp(torch.round(f / sc[:, :, None, :, None]),
                     -127, 127).to(torch.int8)
    return q2, sc


class KVPagePool:
    """Block pool of fixed-size KV token pages: payload planes on
    ``device`` (the card unless the caller asks for the CPU), lifecycle
    metadata and the free lists on the host.

    Kind axis: index 0 = K, 1 = V.  Unlike the JAX package, whose host
    numpy pool is mirrored onto the device at page events, the payload
    tensors here *are* the device store: the on-device append, the seal
    requantization and the encode kernel write them in place, and the
    fused attention kernel reads them.  The host keeps what the scheduler
    needs without touching the device: state, fill, free lists, and each
    PACKED page's coded bit count (``packed_bits``, pulled once per pack).

    ``n_shards`` splits the page ids into contiguous ranges, shard ``s``
    owning ``[s * pages_per_shard, (s + 1) * pages_per_shard)`` with a free
    list of its own, each popping its lowest id first (``KVPagePool``
    :1083-1206; one shard is the single free list).  With a serving
    ``mesh`` (``launch.mesh``, its data axis of ``n_shards``) each page
    range lives on its data shard's devices, split as
    ``sharding.pool_spec`` says: the dense HOT/COLD payloads and the page
    scales' KV heads over the model shards, the PACKED planes whole on
    every model shard.  ``read``/``write`` move whole-head pages in and out
    of the shards; ``plane`` is an unsharded pool's whole tensor of a
    field, which the paths a mesh refuses (the materialize oracle, the
    dense-cache append) index by page id."""

    FIELDS = ("tok_q", "tok_scale", "cold_q", "page_scale", "sym", "ofs",
              "sym_bits", "ofs_bits", "stored")

    def __init__(self, num_pages: int, page_size: int, kv_heads: int,
                 head_dim: int, elems_per_stream: int = 128,
                 device=None, n_shards: int = 1, mesh=None):
        import types
        from repro_torch.launch.mesh import device_grid
        from . import sharding as shd
        if n_shards < 1 or num_pages % n_shards:
            raise ValueError(
                f"num_pages={num_pages} must split evenly over "
                f"n_shards={n_shards} contiguous page ranges")
        if mesh is None:
            self.device = resolve(device)
            self.devices = [[self.device]] * n_shards
        else:
            self.devices = device_grid(mesh)
            self.device = self.devices[0][0]
            if len(self.devices) != n_shards:
                raise ValueError(f"n_shards={n_shards} on a mesh of "
                                 f"{len(self.devices)} data shards")
        self.n_shards = n_shards
        self.n_model = len(self.devices[0])
        if kv_heads % self.n_model:
            raise ValueError(f"kv_heads={kv_heads} must divide over the "
                             f"{self.n_model}-way model axis")
        self.pages_per_shard = num_pages // n_shards
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
        i8, i32 = torch.int8, torch.int32
        # u32 words held in int32 tensors (the kernels read uint32_t)
        shapes = {"tok_q": ((2, p, ps, h, dh), i8),
                  "tok_scale": ((2, p, ps, h), F32),
                  "cold_q": ((2, p, ps, h, dh), i8),
                  "page_scale": ((2, p, h), F32),
                  "sym": ((2, p, self.sym_words, s), i32),
                  "ofs": ((2, p, self.ofs_words, s), i32),
                  "sym_bits": ((2, p, s), i32),
                  "ofs_bits": ((2, p, s), i32),
                  "stored": ((2, p, s), i32)}
        grid = types.SimpleNamespace(shape={"data": n_shards,
                                            "model": self.n_model})
        # the head axis of each field that splits over the model axis
        self._head_axis = {f: (shd.pool_spec(f).index("model")
                               if "model" in shd.pool_spec(f) else None)
                           for f in self.FIELDS}
        self._shapes = shapes
        self.parts = [[{f: torch.zeros(shd.local_shape(shd.pool_spec(f),
                                                       shape, grid),
                                       dtype=dt, device=dev)
                        for f, (shape, dt) in shapes.items()}
                       for dev in self.devices[sh]]
                      for sh in range(n_shards)]
        self.fill = np.zeros(p, np.int32)
        self.state = np.full(p, PAGE_FREE, np.uint8)
        self.packed_bits = np.zeros(p, np.int64)     # sum of sym+ofs bits
        pps = self.pages_per_shard
        self.free_lists: list[list[int]] = [
            list(range((sh + 1) * pps - 1, sh * pps - 1, -1))
            for sh in range(n_shards)]
        self.alloc_count = 0
        self.high_water = 0
        self.evict_count = 0                         # rolling-window evictions
        self.spill_count = 0                         # pages spilled to host
        self.unspill_count = 0                       # pages adopted back in

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

    # ------------------------------------------------------------ free lists
    @property
    def free_list(self) -> list[int]:
        """The single free list of an unsharded pool."""
        return self.free_lists[0]

    @property
    def free_count(self) -> int:
        return sum(len(fl) for fl in self.free_lists)

    def free_count_shard(self, shard: int) -> int:
        return len(self.free_lists[shard])

    def shard_of(self, pid: int) -> int:
        """The data shard that owns page ``pid``."""
        return pid // self.pages_per_shard

    def lead(self, shard: int) -> torch.device:
        """A data shard's lead device (its model shard 0)."""
        return self.devices[shard][0]

    # apack: allow-transfer(seal and re-pack events: the ids are host rows
    # that travel in index()'s groups beside their device ids; the upload
    # is to_device's pinned copy, no wait)
    def _idx(self, pids) -> torch.Tensor:
        """Page ids as a device index tensor, uploaded without a stream
        wait (``to_device``)."""
        return to_device(np.asarray(pids, np.int64), self.device)

    def alloc(self, shard: int = 0) -> int | None:
        fl = self.free_lists[shard]
        if not fl:
            return None
        pid = fl.pop()
        self._require_transition(pid, "alloc", PAGE_HOT, exc=RuntimeError,
                                 detail="alloc from corrupt free list")
        self.state[pid] = PAGE_HOT
        self.fill[pid] = 0
        self.alloc_count += 1
        self.high_water = max(self.high_water,
                              self.num_pages - self.free_count)
        return pid

    # ------------------------------------------------ payload by page id
    def index(self, pids) -> list:
        """The device index of pages ``pids`` for ``read``/``write``: per
        data shard holding some of them, ``(shard, rows, local ids on each
        model shard's device)``, ``rows`` their places in ``pids`` (None:
        all, in order).  One upload a device."""
        pids = np.asarray(pids, np.int64).reshape(-1)
        sh = pids // self.pages_per_shard
        shards = np.unique(sh)
        out = []
        for s in shards:
            rows = None if len(shards) == 1 else np.flatnonzero(sh == s)
            loc = pids - s * self.pages_per_shard if rows is None \
                else pids[rows] - s * self.pages_per_shard
            on: dict = {}
            out.append((int(s), rows, [on.setdefault(d, to_device(loc, d))
                                       for d in self.devices[s]]))
        return out

    def plane(self, field: str) -> torch.Tensor:
        """``field``'s whole tensor [2, num_pages, ...] of an unsharded
        pool (one data shard on one device), indexed by global page id; a
        sharded pool's pages go through ``index``/``read``/``write``."""
        if self.n_shards > 1 or self.n_model > 1:
            raise ValueError(
                f"a pool of {self.n_shards} data x {self.n_model} model "
                "shards has no whole plane; read its pages by id")
        return self.parts[0][0][field]

    def _models(self, field: str):
        """The model shards that hold ``field``'s values: each its head
        block of a split field, the first of a whole one (every model
        shard holds the same)."""
        return range(self.n_model) if self._head_axis[field] is not None \
            else range(1)

    def read(self, field: str, ix, device=None) -> torch.Tensor:
        """``field``'s pages at ``ix`` (``index``), every head, [2, n, ...]
        on ``device`` (the pool's first device when None)."""
        from .sharding import all_gather
        dev = self.device if device is None else device
        ax = self._head_axis[field]
        blocks = [(rows, all_gather([self.parts[s][j][field][:, loc[j]]
                                     for j in self._models(field)], ax,
                                    self.lead(s)))
                  for s, rows, loc in ix]
        if len(blocks) == 1:
            return blocks[0][1].to(dev)
        n = sum(len(r) for r, _ in blocks)
        shape, dt = self._shapes[field]
        out = torch.empty(2, n, *shape[2:], dtype=dt, device=dev)
        for rows, blk in blocks:
            out.index_copy_(1, to_device(rows, dev), blk.to(dev))
        return out

    def write(self, field: str, ix, value) -> None:
        """Write ``value`` (every head, [2, n, ...], or a number) into
        ``field``'s pages at ``ix``: each data shard its pages, each model
        shard its head block of a split field and all of a whole one."""
        ax = self._head_axis[field]
        hl = self.kv_heads // self.n_model
        for s, rows, loc in ix:
            v = value
            if torch.is_tensor(v) and rows is not None:
                v = v.index_select(1, to_device(rows, v.device))
            for j in range(self.n_model):
                dev = self.devices[s][j]
                if not torch.is_tensor(v):
                    # a scalar fills in place (no upload of it, no wait)
                    self.parts[s][j][field].index_fill_(1, loc[j], v)
                    continue
                vj = v
                if ax is not None and self.n_model > 1:
                    vj = v.narrow(ax, j * hl, hl)
                self.parts[s][j][field][:, loc[j]] = vj.to(dev)

    def free(self, pids) -> None:
        """Return pages to their shards' free lists and scrub their payload,
        so a stale read of a recycled page is loud, not subtle."""
        pids = [int(p) for p in pids]
        for pid in pids:
            self._require_transition(pid, "free", PAGE_FREE,
                                     detail="double free of page")
        if not pids:
            return
        ix = self.index(pids)
        for f in self.FIELDS:
            self.write(f, ix, 0)
        for pid in pids:
            self.state[pid] = PAGE_FREE
            self.fill[pid] = 0
            self.packed_bits[pid] = 0
            self.free_lists[self.shard_of(pid)].append(pid)

    def evict(self, pids) -> None:
        """Rolling-window eviction (``evict`` :1208): return sealed pages
        whose every token has left their layer's attention window.  HOT
        or FREE pages raise: an eviction policy that names one is
        corrupt."""
        pids = [int(p) for p in pids]
        for pid in pids:
            self._require_transition(
                pid, "evict", PAGE_FREE, exc=RuntimeError,
                detail="evict of live HOT (or already-FREE) page; rolling "
                       "eviction may only free sealed COLD/PACKED pages")
        self.free(pids)
        self.evict_count += len(pids)

    # ------------------------------------------------------------- spill
    def spill(self, pids, fetch) -> list[tuple[int, int, dict, int]]:
        """Copy pages' payloads out for the host spill tier and free their
        slots (``spill`` :1221), all pages in one pull: ``fetch`` takes a
        dict of device tensors and returns it as host numpy arrays in one
        transfer (the cache's accounted ``_fetch``).  Returns ``(state,
        fill, payload, comp_bytes)`` per page, in order: a HOT page's
        per-token planes, a COLD page's requantized payload, a PACKED
        page's APack planes and page scales, in the JAX package's dtypes.
        The slots return to their free lists in the order given."""
        pids = [int(p) for p in pids]
        states = [self._require_transition(pid, "spill", PAGE_FREE,
                                           detail="spill of FREE page")
                  for pid in pids]
        where: dict[int, list[int]] = {}
        for i, st in enumerate(states):
            where.setdefault(st, []).append(i)
        tree = {}
        for st, rows in where.items():
            ix = self.index([pids[i] for i in rows])
            for key, attr, _ in SPILL_FIELDS[st]:
                tree[f"{st}/{key}"] = self.read(attr, ix)
        host = fetch(tree)
        comp = self.page_bytes(np.asarray(pids, np.int64))
        out = [(st, int(self.fill[pid]),
                payload_of(st, host, where[st].index(i), f"{st}/"),
                int(comp[i]))
               for i, (pid, st) in enumerate(zip(pids, states))]
        self.free(pids)
        self.spill_count += len(pids)
        return out

    def adopt(self, items: list, put, shard: int = 0) -> list[int]:
        """Inverse of ``spill`` (``adopt`` :1251): allocate a fresh slot of
        ``shard`` for each ``(state, fill, payload)`` in order and restore
        the payload there, all pages in one upload (``put`` takes a dict of
        host arrays and returns it on the device in one transfer).  The
        slots generally differ from the ones the pages were spilled out
        of; owners rewrite their page-table entries.  Raises, adopting
        nothing, when the shard has too few free pages."""
        for st, _, _ in items:
            if st not in SPILL_FIELDS:
                raise ValueError(f"adopt of invalid spilled state {st}")
        if len(items) > self.free_count_shard(shard):
            raise RuntimeError(
                "no free page to unspill into — admission must re-reserve "
                "before readahead")
        pids = [self.alloc(shard) for _ in items]
        where: dict[int, list[int]] = {}
        for i, (st, fill, payload) in enumerate(items):
            pid = pids[i]
            if st != PAGE_HOT:
                self._require_transition(pid, "adopt", st)
                self.state[pid] = st
            self.fill[pid] = fill
            if st == PAGE_PACKED:
                self.packed_bits[pid] = int(
                    payload["sym_bits"].sum(dtype=np.int64)
                    + payload["ofs_bits"].sum(dtype=np.int64))
            where.setdefault(st, []).append(i)
        tree = {}
        for st, rows in where.items():
            for key, attr, dt in SPILL_FIELDS[st]:
                a = np.stack([items[i][2][key] for i in rows], axis=1)
                tree[f"{st}/{key}"] = (a.astype(np.int32) if dt is np.bool_
                                       else a.view(np.int32)
                                       if dt is np.uint32 else a)
        dev = put(tree)
        for st, rows in where.items():
            ix = self.index([pids[i] for i in rows])
            for key, attr, _ in SPILL_FIELDS[st]:
                self.write(attr, ix, dev[f"{st}/{key}"])
        self.unspill_count += len(items)
        return pids

    def write_token(self, pid: int, kq, vq, ks, vs) -> int:
        """Append one token's [H, dh] int8 K/V and [H] scales (host append
        path).  Returns the in-page offset written."""
        off = self.note_device_write(pid)
        s, loc = divmod(pid, self.pages_per_shard)
        hl = self.kv_heads // self.n_model
        for j, dev in enumerate(self.devices[s]):
            part, hs = self.parts[s][j], slice(j * hl, (j + 1) * hl)
            for kind, (q, sc) in enumerate(((kq, ks), (vq, vs))):
                part["tok_q"][kind, loc, off] = torch.as_tensor(
                    q, device=dev)[hs]
                part["tok_scale"][kind, loc, off] = torch.as_tensor(
                    sc, device=dev)[hs]
        return off

    def write_tokens(self, shard: int, dst, src, dead, stacked) -> None:
        """Prefill ingest into shard ``shard``'s HOT planes: token rows
        ``src`` of ``stacked`` (K, V int8 [N, H, dh], their scales [N, H],
        on one device) to the flat (page, offset) slots ``dst`` (global
        ``pid * page_size + offset``), zeros to the slots ``dead``; each
        model shard takes its heads.  One index upload a device."""
        ps = self.page_size
        base = shard * self.pages_per_shard * ps
        hl = self.kv_heads // self.n_model
        on: dict = {}
        for j, dev in enumerate(self.devices[shard]):
            if dev not in on:
                on[dev] = to_device(np.concatenate(
                    [dst - base, src, dead - base]), dev)
            idx = on[dev]
            ld_t, ls_t = idx[:len(dst)], idx[len(dst):len(dst) + len(src)]
            dd_t = idx[len(dst) + len(src):]
            part = self.parts[shard][j]
            for kind in (0, 1):
                q, sc = stacked[kind], stacked[2 + kind]
                if self.n_model > 1:
                    q = q[:, j * hl:(j + 1) * hl]
                    sc = sc[:, j * hl:(j + 1) * hl]
                q, sc = q.to(dev), sc.to(dev)
                qf = part["tok_q"][kind].view(-1, *part["tok_q"].shape[3:])
                sf = part["tok_scale"][kind].view(-1,
                                                  part["tok_scale"].shape[3])
                qf.index_copy_(0, ld_t, q.index_select(0, ls_t))
                sf.index_copy_(0, ld_t, sc.index_select(0, ls_t))
                if len(dead):
                    qf.index_fill_(0, dd_t, 0)
                    sf.index_fill_(0, dd_t, 0)

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

    def _check_seal(self, pids: list) -> None:
        for pid in pids:
            self._require_transition(pid, "seal", PAGE_COLD,
                                     detail="seal of non-full or non-HOT "
                                            "page")
            if self.fill[pid] != self.page_size:
                raise ValueError(f"seal of non-full or non-HOT page "
                                 f"({self._page_state(pid)})")

    def seal(self, pids: list) -> torch.Tensor:
        """HOT -> COLD for full pages, requantized where they lie: each
        model shard requantizes its own heads' tokens to one scale per
        (page, head), keeps the COLD payload and drops the per-token copy.
        Returns the requantized int8 payload, every head, [2, n, ps, H, dh]
        on the pool's first device (for the calibration histograms)."""
        from .sharding import all_gather
        self._check_seal(pids)
        blocks = []
        for s, rows, loc in self.index(pids):
            parts = []
            for j, part in enumerate(self.parts[s]):
                qj, scj = _requantize(part["tok_q"][:, loc[j]],
                                      part["tok_scale"][:, loc[j]])
                part["cold_q"][:, loc[j]] = qj
                part["page_scale"][:, loc[j]] = scj
                # index_fill_, not ``[:, loc] = 0``: a Python scalar stored
                # through a tensor index is uploaded as a tensor from
                # pageable memory, which waits for the stream
                part["tok_q"].index_fill_(1, loc[j], 0)
                part["tok_scale"].index_fill_(1, loc[j], 0)
                parts.append(qj)
            blocks.append((rows, all_gather(parts, 3, self.device)))
        self.state[pids] = PAGE_COLD
        if len(blocks) == 1:
            return blocks[0][1]
        q2 = torch.empty(2, len(pids), *blocks[0][1].shape[2:],
                         dtype=torch.int8, device=self.device)
        for rows, blk in blocks:
            q2.index_copy_(1, to_device(rows, self.device), blk)
        return q2

    def pack(self, pids: list, planes: tuple, bits_per_page) -> None:
        """COLD -> PACKED: store both kinds' planes (``planes`` = (sym [2,
        n, Ws, S], ofs [2, n, Wo, S], sym_bits [2, n, S], ofs_bits [2, n,
        S], stored [2, n, S])) on every model shard of their data shard and
        scrub the raw payload so a read that bypasses the decoder is
        visibly wrong.  ``bits_per_page``: each page's coded bits over both
        kinds (host ints)."""
        for pid in pids:
            self._require_transition(pid, "pack", PAGE_PACKED,
                                     detail="pack of non-COLD page")
        ix = self.index(pids)
        sym, ofs, sb, ob, st = planes
        self.write("sym", ix, sym)
        self.write("ofs", ix, ofs)
        self.write("sym_bits", ix, sb)
        self.write("ofs_bits", ix, ob)
        self.write("stored", ix, st.to(torch.int32))
        self.write("cold_q", ix, 0)
        self.state[pids] = PAGE_PACKED
        self.packed_bits[pids] = bits_per_page

    def repack(self, pids: list, planes: tuple, swap) -> None:
        """PACKED -> PACKED (``repack`` :1356): swap pages' planes for their
        re-encode under a newer table.  ``planes`` as for ``pack``;
        ``swap``, a bool device tensor [n], keeps the old planes of the
        pages where it is False (the size gate, decided on the device), so
        every page holds either its whole old or its whole new planes.
        The caller sets ``packed_bits`` of the swapped pages once it knows
        them."""
        for pid in pids:
            self._require_transition(pid, "repack", PAGE_PACKED,
                                     detail="repack of non-PACKED page")
        ix = self.index(pids)
        for f, new in zip(("sym", "ofs", "sym_bits", "ofs_bits", "stored"),
                          planes):
            m = swap.reshape(1, -1, *([1] * (new.dim() - 2)))
            old = self.read(f, ix, new.device)
            self.write(f, ix, torch.where(m, new.to(old.dtype), old))

    # -------------------------------------------------------- accounting
    def dense_bytes(self, n_tokens: int) -> int:
        """What the dense int8 engine stores for ``n_tokens`` of one layer:
        int8 K+V plus per-token-head f32 scales."""
        h, dh = self.kv_heads, self.head_dim
        return 2 * (n_tokens * h * dh + n_tokens * h * 4)

    def page_bytes(self, pids: np.ndarray) -> np.ndarray:
        """Off-chip footprint of each of ``pids`` in its current state
        (int64): a HOT page's dense tokens, a COLD page's int8 payload and
        page scales, a PACKED page's coded bits, stream directory and
        page scales."""
        h, dh = self.kv_heads, self.head_dim
        st = self.state[pids]
        out = np.zeros(len(pids), np.int64)
        hot = st == PAGE_HOT
        out[hot] = self.dense_bytes(self.fill[pids][hot].astype(np.int64))
        out[st == PAGE_COLD] = 2 * (self.page_size * h * dh + h * 4)
        packed = st == PAGE_PACKED
        directory = 2 * self.n_streams * DIR_BITS_PER_STREAM
        out[packed] = (self.packed_bits[pids][packed] + directory + 7) // 8 \
            + 2 * h * 4
        return out
