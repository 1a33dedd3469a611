"""Model assembly and the paged APack KV cache of the port.

Port of the serving parts of ``repro/models/model.py``: ``init_params``
:77, ``block_full`` :130, ``block_step`` :184 and ``block_step_paged``
:202, ``forward`` :273 (``true_len``/``last_only``), ``_head`` :310,
``_init_block_cache``/``init_cache`` :352/:366, ``decode_step`` :380,
``decode_step_paged`` :408, ``device_append`` :488,
``_pack_quantize``/``pack_weights`` :544/:562, ``extend_caches`` :820,
``prefill`` :844, ``DevicePoolPlanes`` :867 and ``PagedKVCache`` :944
(with ``append_step_tokens`` :1335, ``snapshot_state``/``restore_state``
:1865/:1898 and ``materialize`` :2465) for stacks of global attention
layers.

Layers are a Python list of per-layer param dicts where JAX scans a
stacked tree, and a dense decode cache is a list of per-layer dicts where
JAX stacks one per cycle position.  The page pool's payload lives on the
device (see ``modules.KVPagePool``): prefill ingest, the token append, the
seal requantization and the APack encode all write it there, so no page
payload crosses to the host.  What does cross is small and happens at page
events: the calibration histograms of a sealed page (until its layer's
tables exist), and the coded bit count and lossless check of each packed
page.  Not ported here: table refresh and re-pack, the host spill tier,
rolling (local) and recurrent layers and their state snapshots, and
meshes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.tables import TABLE_OVERHEAD_BITS, find_table
from repro_torch.device import resolve
from repro_torch.kernels import apack_decode, apack_encode
from repro_torch.kernels import decompress_matmul as dm
from repro_torch.kernels.paged_decode import (gather_bucket, gather_decode,
                                              page_bucket, table_row)

from . import modules as m
from .config import ModelConfig

F32 = torch.float32
BF16 = torch.bfloat16


def check_supported(cfg: ModelConfig) -> None:
    """Refuse, loudly, the layer kinds this slice does not port."""
    if cfg.prefix_pattern or any(k != "global" for k in cfg.cycle):
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {cfg.prefix_pattern + cfg.cycle} "
            "needs local/recurrent layers, not ported yet (ROADMAP open "
            "item 1.7, heterogeneous stacks)")
    if cfg.num_experts or cfg.frontend or cfg.parallel_block \
            or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: MoE, frontends, parallel blocks and untied heads "
            "are not ported yet (ROADMAP open item 1.9)")


# ------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params with the JAX init's distributions (``model.py:77``,
    ``modules.py:149-163, 449-458``): normal weights scaled by fan-in^-0.5,
    zero norm scales, in ``cfg.param_dtype``.  The numbers differ from
    ``jax.random``'s; tests that compare the two packages convert one
    tree with ``convert.params_from_numpy``."""
    check_supported(cfg)
    dev = resolve(device)
    dt = getattr(torch, cfg.param_dtype)
    d, h, hkv, dh, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)

    def normal(shape, scale):
        x = torch.randn(*shape, generator=generator, device=dev)
        return (x * scale).to(dt)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=dev)

    blocks = []
    for _ in range(cfg.num_layers):
        inner = {"wq": normal((d, h, dh), d ** -0.5),
                 "wk": normal((d, hkv, dh), d ** -0.5),
                 "wv": normal((d, hkv, dh), d ** -0.5),
                 "wo": normal((h, dh, d), d ** -0.5)}
        if cfg.qk_norm:
            inner["q_norm"] = zeros(dh)
            inner["k_norm"] = zeros(dh)
        blocks.append({"norm1": zeros(d), "inner": inner, "norm2": zeros(d),
                       "ffn": {"w_up": normal((d, f), d ** -0.5),
                               "w_gate": normal((d, f), d ** -0.5),
                               "w_down": normal((f, d), f ** -0.5)}})
    return {"embed": normal((cfg.vocab_size, d), d ** -0.5),
            "final_norm": zeros(d), "blocks": blocks}


def serving_params(params: dict) -> dict:
    """A copy for serving with every dense matrix in bf16, made once.  The
    JAX package casts each f32 weight to bf16 at its use
    (``modules.py:145``) and the embedding rows after the lookup; holding
    the bf16 copy gives the same values.  Norm scales stay f32, and packed
    weights (``pack_weights``) pass through as they are."""
    def conv(k, v):
        if isinstance(v, dict):
            return {kk: conv(kk, vv) for kk, vv in v.items()}
        if isinstance(v, m.PackedWeight) or "norm" in k:
            return v
        return v.to(BF16)
    return {"embed": params["embed"].to(BF16),
            "final_norm": params["final_norm"],
            "blocks": [conv("", b) for b in params["blocks"]]}


# --------------------------------------------------------- packed weights
def _pack_quantize(arr: torch.Tensor, n_contract: int):
    """Quantize a dense >= 2-D tensor with the serving convention
    (``quantize_symmetric(..., axis=-1)`` on the original shape, in f32),
    then fold it to the 2-D [K, N_flat] matmul view (``_pack_quantize``
    :544).  The per-last-axis scale is constant along every contracted
    (leading) axis, so tiling it across the flattened output axes is exact."""
    shape = tuple(arr.shape)
    q, qp = quant.quantize_symmetric(arr.to(F32), axis=-1)
    k = int(np.prod(shape[:n_contract]))
    nf = int(np.prod(shape[n_contract:]))
    sc = qp.scale.expand(shape).reshape(k, nf)[0].contiguous()
    return q.reshape(k, nf), sc


def pack_weights(cfg: ModelConfig, params: dict, *,
                 min_size: int | None = None,
                 tile_k: int | None = None) -> tuple[dict, dict]:
    """Convert each layer's large projection and FFN matrices to APack
    planes on the params' device (``modules.PackedWeight``), the live weight
    store for serving (``pack_weights`` :562).

    Packed sites: wq/wk/wv (contract d) and wo (contract h, dh), w_up/
    w_gate/w_down, each when it holds at least ``min_size`` elements;
    ``tile_k = min(512, K)`` unless given.  The tied head and the embedding
    stay dense.  Each layer gets its own weight-mode table.  ``params``
    must be the original (f32) tree, not ``serving_params``' bf16 copy: the
    quantization reads the original values and ``native_bytes`` counts
    their element size.

    Returns ``(packed_params, stats)`` with the JAX package's byte
    accounting.  It counts one packed tensor per scanned stack there, that
    is one per (site, cycle position), summed over the stack's layers."""
    if min_size is None:
        min_size = dm.DEFAULT_WEIGHT_MIN_SIZE
    stats = {"packed_tensors": 0, "native_bytes": 0, "int8_bytes": 0,
             "payload_bytes": 0, "slotted_bytes": 0, "scale_bytes": 0}

    def pack(w: torch.Tensor, n_contract: int, first: bool):
        q2, sc = _pack_quantize(w, n_contract)
        cw = dm.compress_quantized(q2, sc, tile_k or min(dm.DEFAULT_TILE_K,
                                                         q2.shape[0]))
        stats["packed_tensors"] += int(first)
        stats["native_bytes"] += w.numel() * w.element_size()
        stats["int8_bytes"] += w.numel()
        stats["payload_bytes"] += -(-cw.payload_bits // 8)
        stats["slotted_bytes"] += 4 * (cw.sym_plane.numel()
                                       + cw.ofs_plane.numel()
                                       + cw.stored.numel())
        stats["scale_bytes"] += 4 * cw.scale.numel()
        return m.PackedWeight(cw, tuple(w.shape), n_contract,
                              str(w.dtype).removeprefix("torch."))

    blocks = []
    for layer, blk in enumerate(params["blocks"]):
        first = layer < len(cfg.cycle)
        inner, ffn = dict(blk["inner"]), dict(blk["ffn"])
        for name, nc in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 2)):
            if inner[name].numel() >= min_size:
                inner[name] = pack(inner[name], nc, first)
        for name in ("w_up", "w_gate", "w_down"):
            if ffn[name].numel() >= min_size:
                ffn[name] = pack(ffn[name], 1, first)
        blocks.append({**blk, "inner": inner, "ffn": ffn})
    return {**params, "blocks": blocks}, stats


# ------------------------------------------------------------------ block
def _ffn_tail(cfg: ModelConfig, p: dict, h, inner):
    """Residual + FFN.  The residual keeps the bf16 sum; the norm reads
    the unrounded f32 sum, as the JAX package's compiled block does (XLA
    drops the bf16 round trip between the add and the norm's f32 cast)."""
    hf = h.to(F32) + inner.to(F32)
    hn = m.rms_norm(hf, p["norm2"], cfg.norm_eps).to(h.dtype)
    return hf.to(h.dtype) + m.mlp(p["ffn"], hn, cfg)


def block_full(cfg: ModelConfig, p: dict, h: torch.Tensor):
    """Full-sequence (prefill) block of a global layer: (h, cache)."""
    hn = m.rms_norm(h, p["norm1"], cfg.norm_eps)
    inner, cache = m.attention_full(p["inner"], hn, cfg)
    return _ffn_tail(cfg, p, h, inner), cache


def _head(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied-embedding LM head; logits in f32."""
    return m.matmul(h, params["embed"].t()).to(F32)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            last_only: bool = False, true_len: int | None = None):
    """Prefill forward.  Returns ``(logits, caches)`` with one int8 cache
    dict per layer.  ``true_len``: tokens are end-padded to a bucket and
    only the first ``true_len`` are real; ``last_only`` then takes the
    logits at ``true_len - 1`` (causal attention already keeps pad keys out
    of every real query)."""
    h = params["embed"][tokens].to(BF16)
    caches = []
    for p in params["blocks"]:
        h, cache = block_full(cfg, p, h)
        caches.append(cache)
    if last_only:
        t = h.shape[1] if true_len is None else int(true_len)
        h = h[:, t - 1:t]
    h = m.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, h), caches


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int | None = None):
    """Process a prompt (``prefill`` :844): last-position logits and the
    per-layer caches, padded to ``max_len`` positions when given."""
    logits, caches = forward(cfg, params, tokens, last_only=True)
    if max_len is not None:
        caches = extend_caches(cfg, caches, max_len)
    return logits, caches


# ------------------------------------------------------------ dense cache
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=BF16,
               device=None) -> list[dict]:
    """Zero dense decode cache, one dict per layer (``init_cache`` :366,
    ``_init_block_cache`` :352, global layers)."""
    check_supported(cfg)
    dev = resolve(device)
    return [m.init_attention_cache(cfg, batch, seq_len, dev, dtype)
            for _ in range(cfg.num_layers)]


def extend_caches(cfg: ModelConfig, caches: list, max_len: int) -> list:
    """Zero-pad prefill caches (position axis 1, length S) to decode
    capacity ``max_len`` (``extend_caches`` :820, global layers)."""
    def pad(x):
        if x.shape[1] >= max_len:
            return x
        y = x.new_zeros(x.shape[0], max_len, *x.shape[2:])
        y[:, :x.shape[1]] = x
        return y
    return [{f: pad(x) for f, x in c.items()} for c in caches]


def block_step(cfg: ModelConfig, p: dict, h: torch.Tensor, cache: dict,
               pos: torch.Tensor):
    """Single-token decode block of a global layer against its dense cache
    (``block_step`` :184): (h, cache written in place)."""
    hn = m.rms_norm(h, p["norm1"], cfg.norm_eps)
    inner, cache = m.attention_step(p["inner"], hn, cache, pos, cfg)
    return _ffn_tail(cfg, p, h, inner), cache


def decode_step(cfg: ModelConfig, params: dict, caches: list,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One decode step against the dense cache (``decode_step`` :380).
    tokens [B, 1], pos [B] -> (logits [B, 1, V], caches), each layer's
    cache written in place at slot ``pos``."""
    h = params["embed"][tokens].to(BF16)
    new = []
    for p, c in zip(params["blocks"], caches):
        h, c = block_step(cfg, p, h, c, pos)
        new.append(c)
    h = m.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, h), new


def block_step_paged(cfg: ModelConfig, p: dict, h: torch.Tensor,
                     planes: dict, meta: dict, pos: torch.Tensor):
    """Decode block against the paged KV pool: (h, new-token K/V)."""
    hn = m.rms_norm(h, p["norm1"], cfg.norm_eps)
    inner, new_kv = m.paged_attention_step(p["inner"], hn, planes, meta, pos,
                                           cfg)
    return _ffn_tail(cfg, p, h, inner), new_kv


def decode_step_paged(cfg: ModelConfig, params: dict, planes: dict,
                      meta: dict, tokens: torch.Tensor, pos: torch.Tensor):
    """One decode step with the KV cache in page form on the device.

    ``meta`` is ``PagedKVCache.step_meta``'s dict of per-layer stacks;
    tokens [B, 1], pos [B].  Returns ``(logits [B, 1, V], new_kv)`` where
    new_kv stacks every layer's quantized new-token K/V ([L, B, ...]) for
    ``device_append``."""
    h = params["embed"][tokens].to(BF16)
    news = []
    for layer, p in enumerate(params["blocks"]):
        lm = {k: meta[k][layer] for k in ("pid", "tid", "kmeta", "qw")}
        h, new = block_step_paged(cfg, p, h, planes, lm, pos)
        news.append(new)
    h = m.rms_norm(h, params["final_norm"], cfg.norm_eps)
    new_kv = {f: torch.stack([n[f] for n in news]) for f in news[0]}
    return _head(params, h), new_kv


def device_append(planes: dict, new_kv: dict, targets: dict) -> None:
    """On-device page append, in place: scatter each active (layer, slot)
    new-token K/V into the HOT token planes at the (page, offset) slots
    claimed by ``PagedKVCache.claim_append_targets``.  Idle slots are not
    in ``targets`` (the host builds the index lists), so nothing is
    dropped on the device and no mask needs a host round trip."""
    rows, pid, off = targets["row"], targets["pid"], targets["off"]
    for f, name in (("k", "tok_k"), ("v", "tok_v"), ("k_scale", "tok_sk"),
                    ("v_scale", "tok_sv")):
        x = new_kv[f]
        src = x.reshape(-1, *x.shape[2:])[rows]
        planes[name].index_put_((pid, off), src)


# ------------------------------------------------------- paged APack KV
class DevicePoolPlanes:
    """The fused kernel's view of the pool: kind-split views of the pool's
    device payload tensors plus the stacked activation tables
    (``DevicePoolPlanes`` :867).  The views share storage with the pool, so
    an append or a pack is visible without a sync step."""

    def __init__(self, pool: m.KVPagePool, n_tables: int):
        dev = pool.device
        self.planes: dict[str, torch.Tensor] = {
            "tok_k": pool.tok_q[0], "tok_v": pool.tok_q[1],
            "tok_sk": pool.tok_scale[0], "tok_sv": pool.tok_scale[1],
            "cold_k": pool.cold_q[0], "cold_v": pool.cold_q[1],
            "pscale_k": pool.page_scale[0], "pscale_v": pool.page_scale[1],
            "sym_k": pool.sym[0], "sym_v": pool.sym[1],
            "ofs_k": pool.ofs[0], "ofs_v": pool.ofs[1],
            "stored_k": pool.stored[0], "stored_v": pool.stored[1],
            "vm": torch.zeros(n_tables, 17, dtype=torch.int32, device=dev),
            "ol": torch.zeros(n_tables, 16, dtype=torch.int32, device=dev),
            "cum": torch.zeros(n_tables, 17, dtype=torch.int32, device=dev),
        }


class PagedKVCache:
    """Paged, APack-compressed KV cache for ``kv_cache_dtype="apack-int8"``
    on stacks of global attention layers (``PagedKVCache`` :944).

    Each request owns a per-layer list of page ids; token ``t`` lives at
    page ``t // page_size``, offset ``t % page_size``.  Each layer x {K, V}
    gets its own activation-mode table, calibrated from the histogram of
    the layer's first ``calib_pages`` sealed pages; pages sealed before
    that stay COLD and are packed the moment the table exists.  Reads go
    through the fused gather-decode attention kernel; ``traffic`` counts
    what they would move off-chip, compressed vs dense int8."""

    def __init__(self, cfg: ModelConfig, num_pages: int, *,
                 page_size: int = 16, calib_pages: int = 4,
                 elems_per_stream: int = 128, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve(device)
        self.page_size = page_size
        self.calib_pages = calib_pages
        self.n_layers = cfg.num_layers
        self.attn_layers = list(range(self.n_layers))
        self.pool = m.KVPagePool(num_pages, page_size, cfg.num_kv_heads,
                                 cfg.head_dim, elems_per_stream,
                                 device=self.device)
        self.tables: list[list] = [[None, None] for _ in range(self.n_layers)]
        self.hists = np.zeros((self.n_layers, 2, 256), np.int64)
        self.hist_pages = np.zeros((self.n_layers, 2), np.int32)
        self._cold: list[set[int]] = [set() for _ in range(self.n_layers)]
        self._packed: list[set[int]] = [set() for _ in range(self.n_layers)]
        self._table_stack = None
        self.page_tables: dict[int, list[list[int]]] = {}
        self.seq_len: dict[int, int] = {}
        self.traffic = {"kv_raw_bytes": 0, "kv_read_bytes": 0,
                        "kv_table_bytes": 0, "kv_pages_packed": 0,
                        "kv_raw_bytes_global": 0, "kv_read_bytes_global": 0}
        # host<->device accounting: every KV-path transfer goes through
        # _fetch/_put
        self.transfers = {"h2d_bytes": 0, "d2h_bytes": 0,
                          "h2d_calls": 0, "d2h_calls": 0}
        self.dev: DevicePoolPlanes | None = None
        self._tables_dirty = False

    # ------------------------------------------------------------ sizing
    def pages_per_seq(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def pages_needed(self, n_tokens: int) -> int:
        return self.pages_for_config(self.cfg, n_tokens, self.page_size)

    @staticmethod
    def pages_for_config(cfg: ModelConfig, n_tokens: int,
                         page_size: int) -> int:
        """Worst-case per-request page count: every global layer holds the
        full sequence."""
        return cfg.num_layers * -(-n_tokens // page_size)

    def kv_ratio(self) -> float | None:
        """Cumulative compressed-vs-raw KV read traffic (< 1.0 is a win);
        ``None`` before any read has moved a byte."""
        raw = self.traffic["kv_raw_bytes"]
        if raw == 0:
            return None
        return (self.traffic["kv_read_bytes"]
                + self.traffic["kv_table_bytes"]) / raw

    def stream_stats(self) -> dict:
        raw = self.traffic["kv_raw_bytes_global"]
        read = self.traffic["kv_read_bytes_global"]
        return {"global": {"raw_bytes": raw, "read_bytes": read,
                           "ratio": (read / raw) if raw else None}}

    # -------------------------------------------------------- transfers
    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """Device -> host with accounting (the seal pulls)."""
        out = t.cpu().numpy()
        self.transfers["d2h_calls"] += 1
        self.transfers["d2h_bytes"] += out.nbytes
        return out

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host -> device with accounting."""
        self.transfers["h2d_calls"] += 1
        self.transfers["h2d_bytes"] += arr.nbytes
        return torch.as_tensor(arr, device=self.device)

    # ----------------------------------------------------------- requests
    def add_request(self, rid: int) -> None:
        if rid in self.page_tables:
            raise ValueError(f"duplicate request id {rid}")
        self.page_tables[rid] = [[] for _ in range(self.n_layers)]
        self.seq_len[rid] = 0

    def release(self, rid: int) -> None:
        freed = []
        for layer, pids in enumerate(self.page_tables.pop(rid)):
            for pid in pids:
                self._cold[layer].discard(pid)
                self._packed[layer].discard(pid)
                freed.append(pid)
        self.pool.free(freed)
        del self.seq_len[rid]

    # ------------------------------------------------------------ appends
    def _claim_page(self, rid: int, layer: int, t: int) -> int:
        """Page that token ``t`` of (rid, layer) writes into, allocating a
        fresh one at page boundaries."""
        pids = self.page_tables[rid][layer]
        if t % self.page_size == 0:
            if t // self.page_size != len(pids):
                raise RuntimeError(
                    f"page-table desync for rid={rid} layer={layer}: token "
                    f"{t} vs live={len(pids)}")
            pid = self.pool.alloc()
            if pid is None:
                raise RuntimeError("page pool exhausted mid-flight "
                                   "(admission must reserve)")
            pids.append(pid)
        return pids[-1]

    def append_token(self, rid: int, kq, vq, ks, vs) -> None:
        """Host append of one token's KV for every layer.  kq/vq:
        [n_layers, H, dh] int8; ks/vs: [n_layers, H] f32."""
        t = self.seq_len[rid]
        events = []
        for layer in self.attn_layers:
            pid = self._claim_page(rid, layer, t)
            self.pool.write_token(pid, kq[layer], vq[layer], ks[layer],
                                  vs[layer])
            if int(self.pool.fill[pid]) == self.page_size:
                events.append((layer, pid))
        self.seq_len[rid] = t + 1
        self._seal(events)

    def ingest_prefill(self, rid: int, caches: list, s: int) -> None:
        """Chop a batch-1 prefill cache (one dict per layer, positions
        ``[0, s)`` real) into pages on the device, in token order; full
        pages seal in page order."""
        ps = self.page_size
        n = self.pages_per_seq(s)
        events = []
        pool = self.pool
        for layer in self.attn_layers:
            pids = [self._claim_page(rid, layer, i * ps) for i in range(n)]
            idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
            c = caches[layer]
            for kind, (q, sc) in enumerate(((c["k"], c["k_scale"]),
                                            (c["v"], c["v_scale"]))):
                qbuf = q.new_zeros(n * ps, *q.shape[2:])
                qbuf[:s] = q[0, :s]
                sbuf = sc.new_zeros(n * ps, *sc.shape[2:])
                sbuf[:s] = sc[0, :s]
                pool.tok_q[kind].index_copy_(
                    0, idx, qbuf.reshape(n, ps, *q.shape[2:]))
                pool.tok_scale[kind].index_copy_(
                    0, idx, sbuf.reshape(n, ps, *sc.shape[2:]))
            for i, pid in enumerate(pids):
                pool.fill[pid] = min(ps, s - i * ps)
                if pool.fill[pid] == ps:
                    events.append((layer, pid))
        self.seq_len[rid] = s
        self._seal(events)

    # ------------------------------------------------- seal/calibrate/pack
    def _seal(self, events: list) -> None:
        """Full HOT pages -> COLD (one scale per (page, head)), then
        calibrate or pack (``_seal`` :1477).  ``events`` are the (layer,
        pid) seals in the JAX package's order; they run as one batch on the
        device, and the host replays the per-page calibration logic in that
        order, so each layer's tables come from exactly the pages the
        sequential reference would have seen."""
        if not events:
            return
        pool = self.pool
        pids = [pid for _, pid in events]
        idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
        f = pool.tok_q[:, idx].to(F32) * pool.tok_scale[:, idx][..., None]
        sc = torch.clamp_min(f.abs().amax(dim=(2, 4)), 1e-8) / 127.0
        q2 = torch.clamp(torch.round(f / sc[:, :, None, :, None]),
                         -127, 127).to(torch.int8)
        pool.seal(pids, q2, sc)
        uncal = [i for i, (layer, _) in enumerate(events)
                 if self.tables[layer][0] is None]
        hist = None
        if uncal:
            u = quant.to_unsigned(q2[:, uncal]).reshape(2, len(uncal), -1)
            counts = torch.zeros(2, len(uncal), 256, dtype=torch.int64,
                                 device=self.device)
            counts.scatter_add_(2, u.long(), torch.ones_like(u, dtype=torch.int64))
            hist = self._fetch(counts)                   # [2, n_uncal, 256]
        to_pack = []
        row = {i: j for j, i in enumerate(uncal)}
        for i, (layer, pid) in enumerate(events):
            if self.tables[layer][0] is not None:
                to_pack.append((layer, pid))
                continue
            self._cold[layer].add(pid)
            for kind in (0, 1):
                self.hists[layer, kind] += hist[kind, row[i]]
                self.hist_pages[layer, kind] += 1
            if int(self.hist_pages[layer, 0]) >= self.calib_pages:
                for kind in (0, 1):
                    self.tables[layer][kind] = find_table(
                        self.hists[layer, kind], bits=8, is_activation=True)
                self._table_stack = None
                self._tables_dirty = True
                self.traffic["kv_table_bytes"] += 2 * TABLE_OVERHEAD_BITS // 8
                for cold_pid in sorted(self._cold[layer]):
                    to_pack.append((layer, cold_pid))
                self._cold[layer].clear()
        self._pack(to_pack)
        self._flush_tables()

    def _pack(self, items: list) -> None:
        """COLD -> PACKED through the encode kernel, both kinds of every
        page in one launch, each with its layer's table (``_pack`` :1531).
        The decode kernel then reads the new planes back and the pack
        raises unless they give the COLD payload, before it is scrubbed.
        One pull brings back each page's coded bit count and that check."""
        if not items:
            return
        pool = self.pool
        pids = [pid for _, pid in items]
        idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
        n, s, e = len(pids), pool.n_streams, pool.elems_per_stream
        vals = quant.to_unsigned(pool.cold_q[:, idx]).reshape(2, n, s, e)
        vm, ol, cm = self._tables_stacked()
        rows = np.array([[table_row(0, layer, kind, self.n_layers)
                          for layer, _ in items] for kind in (0, 1)])
        tabs = self._put(np.concatenate(
            [vm[rows], ol[rows], cm[rows]], axis=-1).astype(np.int32))
        vm_r, ol_r, cm_r = (tabs[..., :17].contiguous(),
                            tabs[..., 17:33].contiguous(),
                            tabs[..., 33:].contiguous())
        planes = apack_encode.encode(vals.contiguous(), vm_r, ol_r, cm_r,
                                     n_steps=e, bits=8)
        # lossless check before the COLD payload is scrubbed: decode the new
        # planes and count values that do not come back; the count rides
        # the same pull as the bit counts
        back = apack_decode.decode(planes[0], planes[1], planes[4],
                                   vm_r, ol_r, cm_r, n_steps=e, bits=8)
        bad = (back != vals).sum(dim=(0, 2, 3))
        pulled = self._fetch(torch.stack([
            planes[2].sum(dim=(0, 2), dtype=torch.int64)
            + planes[3].sum(dim=(0, 2), dtype=torch.int64), bad]))
        if pulled[1].any():
            raise RuntimeError(
                f"APack pack of pages {[p for p, b in zip(pids, pulled[1]) if b]}"
                " does not decode to its COLD payload")
        pool.pack(pids, planes, pulled[0])
        for layer, pid in items:
            self._cold[layer].discard(pid)
            self._packed[layer].add(pid)
        self.traffic["kv_pages_packed"] += n

    @property
    def n_table_rows(self) -> int:
        return 2 * self.n_layers

    def _tables_stacked(self):
        """np table arrays [2 * n_layers, ...] at row ``table_row(0, layer,
        kind)``; rows of uncalibrated layers stay zero and are never
        referenced (PACKED requires a table)."""
        if self._table_stack is None:
            rows = self.n_table_rows
            vm = np.zeros((rows, 17), np.int32)
            ol = np.zeros((rows, 16), np.int32)
            cm = np.zeros((rows, 17), np.int32)
            for layer in range(self.n_layers):
                for kind in (0, 1):
                    t = self.tables[layer][kind]
                    if t is not None:
                        r = table_row(0, layer, kind, self.n_layers)
                        vm[r], ol[r], cm[r] = t.as_arrays()
            self._table_stack = (vm, ol, cm)
        return self._table_stack

    # ---------------------------------------------- device-resident mode
    def enable_device_pool(self) -> None:
        """Expose the pool to the fused kernel (``enable_device_pool``
        :2079): kind-split plane views and the device table stack."""
        self.dev = DevicePoolPlanes(self.pool, max(2, self.n_table_rows))
        self._tables_dirty = True
        self._flush_tables()

    def _flush_tables(self) -> None:
        if self.dev is None or not self._tables_dirty:
            return
        vm, ol, cm = self._tables_stacked()
        d = self.dev.planes
        n = vm.shape[0]
        d["vm"][:n] = self._put(vm)
        d["ol"][:n] = self._put(ol)
        d["cum"][:n] = self._put(cm)
        self._tables_dirty = False

    def claim_append_targets(self, slot_rids: list) -> dict:
        """Host half of the on-device append: the (page, offset) each
        active (layer, slot) writes, as index tensors for ``device_append``
        (row = layer * B + slot into the stacked new-token K/V)."""
        b = len(slot_rids)
        rows, pids, offs = [], [], []
        for slot, rid in enumerate(slot_rids):
            if rid is None:
                continue
            t = self.seq_len[rid]
            for layer in self.attn_layers:
                rows.append(layer * b + slot)
                pids.append(self._claim_page(rid, layer, t))
                offs.append(t % self.page_size)
        buf = self._put(np.asarray([rows, pids, offs], np.int64))
        return {"row": buf[0], "pid": buf[1], "off": buf[2]}

    def note_appended(self, slot_rids: list) -> None:
        """Metadata half of the on-device append (``note_appended``
        :2254): advance fills and sequence lengths and seal the pages that
        just filled — their payload is already on the device."""
        events = []
        for slot, rid in enumerate(slot_rids):
            if rid is None:
                continue
            for layer in self.attn_layers:
                pid = self.page_tables[rid][layer][-1]
                self.pool.note_device_write(pid)
                if int(self.pool.fill[pid]) == self.page_size:
                    events.append((layer, pid))
            self.seq_len[rid] += 1
        self._seal(events)

    def append_step_tokens(self, caches: list, slot_rids: list,
                           positions) -> None:
        """Move what a dense decode step wrote back into pages
        (``append_step_tokens`` :1335, global layers): each active slot's
        token at ``positions[slot]`` of every layer's cache.  The JAX
        package pulls the tokens to the host and calls ``append_token`` per
        slot; here they stay on the device and take the fused path's
        append (``claim_append_targets``, ``device_append``,
        ``note_appended``), which claims the same pages in the same order
        and seals them in one batch with the same per-page calibration
        order."""
        b = len(slot_rids)
        pos = self._put(np.asarray(positions, np.int64))
        rows = torch.arange(b, device=self.device)
        new_kv = {f: torch.stack([c[f] for c in caches])[:, rows, pos]
                  for f in ("k", "v", "k_scale", "v_scale")}
        pool = self.pool
        planes = {"tok_k": pool.tok_q[0], "tok_v": pool.tok_q[1],
                  "tok_sk": pool.tok_scale[0], "tok_sv": pool.tok_scale[1]}
        device_append(planes, new_kv, self.claim_append_targets(slot_rids))
        self.note_appended(slot_rids)

    # ------------------------------------------------- state snapshots
    def snapshot_state(self, rid: int) -> dict:
        """Preemption checkpoint of a request's fixed-size recurrent states
        (``snapshot_state`` :1865).  Attention KV needs none: it already
        lives compressed in the page pool.  The stacks this slice serves
        hold global attention layers only (``check_supported`` refuses
        state layers), so the blob is always the empty one."""
        return {"manifest": [], "planes": None}

    def restore_state(self, rid: int, snap: dict) -> None:
        """Inverse of :meth:`snapshot_state` (``restore_state`` :1898)."""
        if snap["planes"] is not None or snap["manifest"]:
            raise NotImplementedError(
                "recurrent-state snapshots are not ported yet (ROADMAP open "
                "item 1.7, heterogeneous stacks)")

    # --------------------------------------------------- step metadata
    def meta_pages(self, max_len: int, slot_rids: list) -> int:
        """Page slots of the fused kernel's call: the power-of-two bucket
        over the busiest active slot's page count, capped at the full
        context (``meta_pages`` :2339)."""
        used = 1
        for rid in slot_rids:
            if rid is None or rid not in self.page_tables:
                continue
            for layer in self.attn_layers:
                used = max(used, len(self.page_tables[rid][layer]))
        return min(max(1, self.pages_per_seq(max_len)), page_bucket(used))

    def step_meta(self, slot_rids: list, max_len: int) -> dict:
        """Per-step page-table metadata (``step_meta`` :2362), stacked over
        layers: ``pid``/``tid``/``state``/``t0`` int32 [L, B, P], ``qw``
        int32 [L, B, 2] and the kernel's ``kmeta`` [L, B, P, 2] = (state,
        t0).  One upload per step; also accrues the read traffic."""
        b = len(slot_rids)
        pn = self.meta_pages(max_len, slot_rids)
        nl, ps = self.n_layers, self.page_size
        pid = np.zeros((nl, b, pn), np.int32)
        tid = np.broadcast_to(
            (2 * np.arange(nl, dtype=np.int32))[:, None, None],
            (nl, b, pn)).copy()
        kmeta = np.zeros((nl, b, pn, 2), np.int32)        # FREE: masked
        qw = np.zeros((nl, b, 2), np.int32)
        for slot, rid in enumerate(slot_rids):
            if rid is None:
                continue
            qw[:, slot, 0] = self.seq_len[rid]
            for layer in self.attn_layers:
                pids = self.page_tables[rid][layer]
                k = len(pids)
                pid[layer, slot, :k] = pids
                tid[layer, slot, :k] = table_row(0, layer, 0, nl)
                kmeta[layer, slot, :k, 0] = self.pool.state[pids]
                kmeta[layer, slot, :k, 1] = np.arange(k) * ps
        self._accrue_read_traffic(slot_rids)
        flat = self._put(np.concatenate([pid.ravel(), tid.ravel(),
                                         kmeta.ravel(), qw.ravel()]))
        n1 = pid.size
        out = {"pid": flat[:n1].view(nl, b, pn),
               "tid": flat[n1:2 * n1].view(nl, b, pn),
               "kmeta": flat[2 * n1:4 * n1].view(nl, b, pn, 2),
               "qw": flat[4 * n1:].view(nl, b, 2)}
        out["state"] = out["kmeta"][..., 0]
        out["t0"] = out["kmeta"][..., 1]
        return out

    def _accrue_read_traffic(self, slot_rids: list) -> None:
        """Charge the per-step KV read traffic: every page of every active
        slot, compressed as stored vs dense int8 (``_accrue_read_traffic``
        :2418, global layers)."""
        pool = self.pool
        raw = read = 0
        for rid in slot_rids:
            if rid is None:
                continue
            for layer in self.attn_layers:
                for pid in self.page_tables[rid][layer]:
                    n_tok = (int(pool.fill[pid])
                             if pool.state[pid] == m.PAGE_HOT
                             else self.page_size)
                    raw += pool.dense_bytes(n_tok)
                    read += pool.page_bytes(pid)
        self.traffic["kv_raw_bytes_global"] += raw
        self.traffic["kv_read_bytes_global"] += read
        self.traffic["kv_raw_bytes"] += raw
        self.traffic["kv_read_bytes"] += read

    # -------------------------------------------------------- materialize
    def _device_tables(self):
        """The stacked table pool on the device: the fused kernel's copy
        when the pool is exposed to it, else one upload."""
        if self.dev is not None:
            d = self.dev.planes
            return d["vm"], d["ol"], d["cum"]
        return tuple(self._put(t) for t in self._tables_stacked())

    def materialize(self, slot_rids: list, max_len: int, *,
                    decode=gather_decode) -> list[dict]:
        """Rebuild the dense int8 cache of the active batch from the pool,
        one dict per layer of ``k``/``v`` int8 [B, max_len, H, dh] and
        ``k_scale``/``v_scale`` f32 [B, max_len, H] (``materialize``
        :2465, global layers).  Also accrues the step's read traffic, as
        the fused path's ``step_meta`` does.

        Token ``t`` of a page lands at absolute position ``t0 + t``: HOT
        tokens with their per-token scales, COLD tokens with the page's
        scale per head, and PACKED pages decoded, all layers in one
        ``decode`` call per K/V kind (the gather-decode kernel), the page
        and table-row vectors padded to ``gather_bucket`` by repeating the
        last entry.  ``decode`` is there so a check can build the same
        cache through the plain version; the engine never passes it.

        The JAX package materializes from its host mirror and first pulls
        the device-resident HOT pages into it (``sync_hot_to_host``); this
        pool has no host mirror (``modules.KVPagePool``), so the cache is
        built on the device from the pool's own tensors, with a few batched
        index writes per step and no per-page copies."""
        pool = self.pool
        self._accrue_read_traffic(slot_rids)
        b, nl = len(slot_rids), self.n_layers
        h, dh, ps = pool.kv_heads, pool.head_dim, self.page_size
        kq = torch.zeros(2, nl, b, max_len, h, dh, dtype=torch.int8,
                         device=self.device)
        ks = torch.zeros(2, nl, b, max_len, h, dtype=F32, device=self.device)
        # one row per page: (state, layer, slot, t0, n_tok, pid, job), job
        # = the page's place in the gather list (PACKED pages only)
        pages, jobs = [], []
        for slot, rid in enumerate(slot_rids):
            if rid is None:
                continue
            for layer in self.attn_layers:
                for k_, pid in enumerate(self.page_tables[rid][layer]):
                    st = int(pool.state[pid])
                    n_tok = int(pool.fill[pid]) if st == m.PAGE_HOT else ps
                    t0 = k_ * ps
                    pages.append((st, layer, slot, t0,
                                  min(n_tok, max_len - t0), pid,
                                  len(jobs) if st == m.PAGE_PACKED else 0))
                    if st == m.PAGE_PACKED:
                        jobs.append((layer, pid))
        if pages:
            self._place(kq, ks, np.asarray(pages, np.int64), jobs, decode)
        return [{"k": kq[0, layer], "v": kq[1, layer],
                 "k_scale": ks[0, layer], "v_scale": ks[1, layer]}
                for layer in range(nl)]

    def _place(self, kq, ks, pages: np.ndarray, jobs: list, decode) -> None:
        """Write every token of ``pages`` into the dense cache: one upload
        of the token index rows, then per page state one gather and one
        index write for the values and one of each for the scales."""
        pool = self.pool
        n_tok = pages[:, 4]
        tok = np.repeat(pages, n_tok, axis=0)
        start = np.repeat(np.cumsum(n_tok) - n_tok, n_tok)
        off = np.arange(len(tok)) - start
        order = np.argsort(tok[:, 0], kind="stable")
        tok, off = tok[order], off[order]
        counts = np.bincount(tok[:, 0], minlength=4)
        # rows: layer, slot, position, pid, in-page offset, job
        idx = self._put(np.stack([tok[:, 1], tok[:, 2], tok[:, 3] + off,
                                  tok[:, 5], off, tok[:, 6]]))
        dec = None
        if jobs:
            dec = self._decode_jobs(jobs, decode)
        lo = 0
        for st in (m.PAGE_HOT, m.PAGE_COLD, m.PAGE_PACKED):
            hi = lo + int(counts[st])
            if hi == lo:
                continue
            layer, slot, posn, pid, o, job = idx[:, lo:hi]
            lo = hi
            if st == m.PAGE_HOT:
                q, sc = pool.tok_q[:, pid, o], pool.tok_scale[:, pid, o]
            elif st == m.PAGE_COLD:
                q, sc = pool.cold_q[:, pid, o], pool.page_scale[:, pid]
            else:
                q, sc = dec[:, job, o], pool.page_scale[:, pid]
            kq[:, layer, slot, posn] = q
            ks[:, layer, slot, posn] = sc

    def _decode_jobs(self, jobs: list, decode) -> torch.Tensor:
        """Decode every PACKED page of ``jobs`` ((layer, pid) pairs), both
        kinds, through ``decode``: int8 [2, n, ps, H, dh]."""
        pool = self.pool
        n = len(jobs)
        pad = (0, gather_bucket(n) - n)
        ids = np.array([[pid for _, pid in jobs]]
                       + [[table_row(0, layer, kind, self.n_layers)
                           for layer, _ in jobs] for kind in (0, 1)],
                       np.int32)
        ids = self._put(np.pad(ids, ((0, 0), pad), mode="edge"))
        vm, ol, cm = self._device_tables()
        out = [decode(pool.sym[kind], pool.ofs[kind], pool.stored[kind],
                      ids[0], vm, ol, cm, n_steps=pool.elems_per_stream,
                      table_idx=ids[1 + kind])[:n]
               for kind in (0, 1)]
        return quant.from_unsigned(torch.stack(out)).reshape(
            2, n, self.page_size, pool.kv_heads, pool.head_dim)
