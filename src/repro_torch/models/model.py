"""Model assembly and the paged APack KV cache of the port.

Port of the serving parts of ``repro/models/model.py``: ``_init_block``/
``init_params`` :52/:77, ``block_full`` :130, ``block_step`` :184 and
``block_step_paged`` :202, ``forward`` :273 (prefix layers, ``pad_mask``/
``true_len``/``last_only``), ``_head`` :310, ``_init_block_cache``/
``init_cache`` :352/:366, ``decode_step`` :380, ``decode_step_paged``
:408 (with the state store), ``init_state_store``/``states_from_step``
:457-486, ``device_append`` :488, ``_pack_quantize``/``pack_weights``
:544/:562, ``extend_caches`` :820, ``prefill`` :844, ``_layer_kinds``
:859, ``DevicePoolPlanes`` :867 and ``PagedKVCache`` :944 (with
``evict_rolled`` :1287, ``append_step_tokens`` :1335, ``ingest_prefill``
:1398, ``snapshot_state``/``restore_state`` :1865/:1898, the state store
:2304-2337, ``step_meta`` :2362 and ``materialize`` :2465) for stacks of
global and rolling attention layers and RG-LRU recurrent layers, prefix
or cycled.

Layers are a Python list of per-layer param dicts, prefix layers first,
where JAX scans one stacked tree per cycle position; a dense decode cache
and the state store are per-layer lists the same way.  The page pool's
payload lives on the device (see ``modules.KVPagePool``): prefill ingest,
the token append, the seal requantization and the APack encode all write
it there, so no page payload crosses to the host.  What does cross is
small and happens at page events: the calibration histograms of a sealed
page (until its layer's tables exist), and the coded bit count and
lossless check of each packed page.  Not ported here: mLSTM/sLSTM layers,
packed weights on stacks with rolling or recurrent layers, table refresh
and re-pack, the host spill tier, and meshes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import byteplane, quant
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


ATTN_KINDS = ("global", "local")
STATE_KINDS = ("recurrent",)


def check_supported(cfg: ModelConfig) -> None:
    """Refuse, loudly, the layer kinds and features the port does not
    serve yet."""
    kinds = set(cfg.prefix_pattern) | set(cfg.cycle)
    other = sorted(kinds - set(ATTN_KINDS) - set(STATE_KINDS))
    if other:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {other} are not ported yet (ROADMAP "
            "open item 1.9, remaining architectures)")
    if cfg.num_experts or cfg.frontend or cfg.parallel_block \
            or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: MoE, frontends, parallel blocks and untied heads "
            "are not ported yet (ROADMAP open item 1.9)")
    cfg.n_cycles          # the scanned layers must divide into cycles


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Kind of every network layer (``_layer_kinds`` :859): prefix layers
    first, then the cycle in layer order ``n_prefix + j * n_cycle + c``.
    ``params["blocks"]`` and every per-layer cache list follow it."""
    return list(cfg.prefix_pattern) + [
        cfg.cycle[c] for _ in range(cfg.n_cycles)
        for c in range(len(cfg.cycle))]


# ------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params with the JAX init's distributions (``_init_block``
    :52, ``init_params`` :77, ``modules.py:149-163, 449-458, 553``): normal
    weights scaled by fan-in^-0.5, zero norm scales, in
    ``cfg.param_dtype``; recurrent blocks as ``modules.init_recurrent``.
    One dict per network layer, prefix layers first.  The numbers differ
    from ``jax.random``'s; tests that compare the two packages convert one
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
    for kind in layer_kinds(cfg):
        if kind in ATTN_KINDS:
            inner = {"wq": normal((d, h, dh), d ** -0.5),
                     "wk": normal((d, hkv, dh), d ** -0.5),
                     "wv": normal((d, hkv, dh), d ** -0.5),
                     "wo": normal((h, dh, d), d ** -0.5)}
            if cfg.qk_norm:
                inner["q_norm"] = zeros(dh)
                inner["k_norm"] = zeros(dh)
        else:
            inner = m.init_recurrent(cfg, generator, dev, dt)
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
    the bf16 copy gives the same values.  Norm scales and the recurrent
    gates' f32 params (``modules.RECURRENT_F32``) stay as they are, and so
    do packed weights (``pack_weights``).  Idempotent: a tensor already in
    bf16 is not copied."""
    def conv(k, v):
        if isinstance(v, dict):
            return {kk: conv(kk, vv) for kk, vv in v.items()}
        if isinstance(v, m.PackedWeight) or "norm" in k \
                or k in m.RECURRENT_F32:
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
    store for serving (``pack_weights`` :562), on stacks of global
    attention layers.

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
    if cfg.prefix_pattern or any(k != "global" for k in cfg.cycle):
        raise NotImplementedError(
            f"{cfg.name}: packed weights (weights='apack-int8') on a stack "
            "with prefix, local or recurrent layers are not ported yet "
            "(ROADMAP open item 1.13, pack_weights by kind)")
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
    """Residual + FFN.  Returns the block's output twice: rounded to h's
    bf16, and as the unrounded f32 sum of its last add.  The residual
    keeps the bf16 sums; a norm that reads one reads the unrounded f32
    sum, as the JAX package's compiled block does (XLA drops the bf16
    round trip between the add and the norm's f32 cast): here the FFN's
    norm, and the next layer's ``norm1`` where the compiled reference
    fuses the two layers (``reads_unrounded``)."""
    hf = h.to(F32) + inner.to(F32)
    hn = m.rms_norm(hf, p["norm2"], cfg.norm_eps).to(h.dtype)
    out = hf.to(h.dtype).to(F32) + m.mlp(p["ffn"], hn, cfg).to(F32)
    return out.to(h.dtype), out


def reads_unrounded(cfg: ModelConfig, layer: int) -> bool:
    """Whether network layer ``layer``'s ``norm1`` reads the previous
    layer's unrounded output (``_ffn_tail``).  The reference scans its
    cycle: each iteration's carry is a materialized bf16 array, so the
    first layer of a cycle reads the rounded value; the other layers of a
    cycle, and prefix layers after the first, are fused with the layer
    before them."""
    n_prefix = len(cfg.prefix_pattern)
    if layer < n_prefix:
        return layer > 0
    return (layer - n_prefix) % len(cfg.cycle) != 0


def _norm1(cfg: ModelConfig, p: dict, h, hx):
    x = h if hx is None else hx
    return m.rms_norm(x, p["norm1"], cfg.norm_eps).to(h.dtype)


def block_full(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor, *,
               hx=None, pad_mask=None, true_len: int | None = None):
    """Full-sequence (prefill) block of any served kind (``block_full``
    :130): (h, unrounded h, cache); ``hx``, when given, is the unrounded
    input its norm reads.  ``pad_mask``/``true_len``: the bucketed
    prefill, where rolling rings and recurrent states stop at the true
    end."""
    hn = _norm1(cfg, p, h, hx)
    if kind in ATTN_KINDS:
        inner, cache = m.attention_full(p["inner"], hn, cfg,
                                        local=kind == "local",
                                        true_len=true_len)
    else:
        inner, cache = m.recurrent_full(p["inner"], hn, cfg,
                                        pad_mask=pad_mask, true_len=true_len)
    return (*_ffn_tail(cfg, p, h, inner), cache)


def _head(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied-embedding LM head; logits in f32."""
    return m.matmul(h, params["embed"].t()).to(F32)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            last_only: bool = False, true_len: int | None = None):
    """Prefill forward (``forward`` :273).  Returns ``(logits, caches)``
    with one cache dict per network layer.  ``true_len``: tokens are
    end-padded to a bucket and only the first ``true_len`` are real; the
    rolling rings and recurrent states are taken at the true end, pad
    steps are inert in the recurrent scans (``pad_mask``), and
    ``last_only`` takes the logits at ``true_len - 1`` (causal attention
    already keeps pad keys out of every real query)."""
    h = params["embed"][tokens].to(BF16)
    pad_mask = None
    if true_len is not None:
        pad_mask = torch.arange(h.shape[1], device=h.device) >= true_len
    caches, hx = [], None
    for layer, (kind, p) in enumerate(zip(layer_kinds(cfg),
                                          params["blocks"])):
        h, hx, cache = block_full(
            cfg, kind, p, h, hx=hx if reads_unrounded(cfg, layer) else None,
            pad_mask=pad_mask, true_len=true_len)
        caches.append(cache)
    if last_only:
        t = h.shape[1] if true_len is None else int(true_len)
        h = h[:, t - 1:t]
    h = m.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, h), caches


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int | None = None):
    """Process a prompt (``prefill`` :844): last-position logits and the
    per-layer caches, global ones padded to ``max_len`` positions when
    given."""
    logits, caches = forward(cfg, params, tokens, last_only=True)
    if max_len is not None:
        caches = extend_caches(cfg, caches, max_len)
    return logits, caches


# ------------------------------------------------------------ dense cache
def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                      dtype, device) -> dict:
    if kind in ATTN_KINDS:
        return m.init_attention_cache(cfg, batch, seq_len, device, dtype,
                                      local=kind == "local")
    return m.init_recurrent_cache(cfg, batch, device)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=BF16,
               device=None) -> list[dict]:
    """Zero dense decode cache, one dict per network layer (``init_cache``
    :366, ``_init_block_cache`` :352): ``seq_len`` positions for a global
    layer, the ring for a rolling one, the fixed state for a recurrent
    one."""
    check_supported(cfg)
    dev = resolve(device)
    return [_init_block_cache(cfg, kind, batch, seq_len, dtype, dev)
            for kind in layer_kinds(cfg)]


def extend_caches(cfg: ModelConfig, caches: list, max_len: int) -> list:
    """Zero-pad global-layer prefill caches (position axis 1, length S) to
    decode capacity ``max_len`` (``extend_caches`` :820); rings and
    recurrent states are fixed-size and pass through."""
    def pad(x):
        if x.shape[1] >= max_len:
            return x
        y = x.new_zeros(x.shape[0], max_len, *x.shape[2:])
        y[:, :x.shape[1]] = x
        return y
    return [{f: pad(x) for f, x in c.items()} if kind == "global" else c
            for kind, c in zip(layer_kinds(cfg), caches)]


def block_step(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor,
               cache: dict, pos: torch.Tensor, hx=None):
    """Single-token decode block against a dense cache (``block_step``
    :184): (h, unrounded h, cache), attention caches written in place, a
    recurrent layer's state replaced."""
    hn = _norm1(cfg, p, h, hx)
    if kind in ATTN_KINDS:
        inner, cache = m.attention_step(p["inner"], hn, cache, pos, cfg,
                                        local=kind == "local")
    else:
        inner, cache = m.recurrent_step(p["inner"], hn, cache, cfg)
    return (*_ffn_tail(cfg, p, h, inner), cache)


def decode_step(cfg: ModelConfig, params: dict, caches: list,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One decode step against the dense cache (``decode_step`` :380).
    tokens [B, 1], pos [B] -> (logits [B, 1, V], caches), each attention
    layer's cache written in place at slot ``pos`` (``pos % ring`` for a
    rolling one)."""
    h = params["embed"][tokens].to(BF16)
    new, hx = [], None
    for layer, (kind, p, c) in enumerate(zip(layer_kinds(cfg),
                                             params["blocks"], caches)):
        h, hx, c = block_step(cfg, kind, p, h, c, pos,
                              hx if reads_unrounded(cfg, layer) else None)
        new.append(c)
    h = m.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, h), new


def block_step_paged(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor,
                     planes: dict, meta: dict, state: dict | None,
                     pos: torch.Tensor, hx=None):
    """Decode block against the paged KV pool (``block_step_paged`` :202):
    an attention layer reads its pages through the fused kernel and
    returns its new-token K/V; a recurrent layer steps its state from the
    device state store.  Returns (h, unrounded h, new K/V or new
    state)."""
    if kind not in ATTN_KINDS:
        return block_step(cfg, kind, p, h, state, pos, hx)
    hn = _norm1(cfg, p, h, hx)
    inner, new_kv = m.paged_attention_step(p["inner"], hn, planes, meta, pos,
                                           cfg)
    return (*_ffn_tail(cfg, p, h, inner), new_kv)


def decode_step_paged(cfg: ModelConfig, params: dict, planes: dict,
                      meta: dict, states: list, tokens: torch.Tensor,
                      pos: torch.Tensor):
    """One decode step with the KV cache in page form on the device
    (``decode_step_paged`` :408).

    ``meta`` is ``PagedKVCache.step_meta``'s dict of stacks over the
    attention layers, in layer order; ``states`` the device state store
    (``init_state_store``): one state dict per recurrent layer, None at
    attention layers.  tokens [B, 1], pos [B].  Returns ``(logits [B, 1,
    V], new_kv, new_states)``: new_kv stacks every attention layer's
    quantized new-token K/V ([A, B, ...]) for ``device_append``, and
    new_states is the state store after the step (``states_from_step``
    :457)."""
    h = params["embed"][tokens].to(BF16)
    news, new_states, hx = [], [], None
    i = 0
    for layer, (kind, p, st) in enumerate(zip(layer_kinds(cfg),
                                              params["blocks"], states)):
        lm = None
        if kind in ATTN_KINDS:
            lm = {k: meta[k][i] for k in ("pid", "tid", "kmeta", "qw")}
            i += 1
        h, hx, new = block_step_paged(
            cfg, kind, p, h, planes, lm, st, pos,
            hx if reads_unrounded(cfg, layer) else None)
        if kind in ATTN_KINDS:
            news.append(new)
            new_states.append(None)
        else:
            new_states.append(new)
    h = m.rms_norm(h, params["final_norm"], cfg.norm_eps)
    new_kv = ({f: torch.stack([n[f] for n in news]) for f in news[0]}
              if news else {})
    return _head(params, h), new_kv, new_states


def init_state_store(cfg: ModelConfig, batch: int, device=None) -> list:
    """Device store of the recurrent layers' states (``init_state_store``
    :457): a zero state per recurrent layer, None at attention layers
    (their KV lives in the page pool)."""
    dev = resolve(device)
    return [None if kind in ATTN_KINDS
            else m.init_recurrent_cache(cfg, batch, dev)
            for kind in layer_kinds(cfg)]


def device_append(planes: dict, new_kv: dict, targets: dict) -> None:
    """On-device page append (``device_append`` :488), in place: scatter
    each active (attention layer, slot) new-token K/V into the HOT token
    planes at the (page, offset) slots claimed by
    ``PagedKVCache.claim_append_targets``.  Idle slots are not in
    ``targets`` (the host builds the index lists), so nothing is dropped
    on the device and no mask needs a host round trip."""
    if not new_kv:
        return
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
    (``PagedKVCache`` :944), over stacks of global and rolling (``local``)
    attention layers and recurrent layers, prefix or cycled.

    Each request owns a per-layer list of page ids; token ``t`` of a
    global layer lives at page ``t // page_size``, offset ``t %
    page_size``.  A rolling layer keeps the same layout past its
    ``page_base`` (pages that have rolled out of the window return to the
    pool, ``evict_rolled``), so it holds at most ``window_pages`` pages.
    A recurrent layer's fixed-size state stays dense (``states``, or the
    device state store in fused mode) and is APack-coded only at
    snapshots (``snapshot_state``).  Each attention layer x {K, V} gets its
    own activation-mode table, calibrated from the histogram of the
    layer's first ``calib_pages`` sealed pages; pages sealed before that
    stay COLD and are packed the moment the table exists.  Reads go
    through the fused gather-decode attention kernel; ``traffic`` counts
    what they would move off-chip, compressed vs dense int8, per stream
    kind."""

    def __init__(self, cfg: ModelConfig, num_pages: int, *,
                 page_size: int = 16, calib_pages: int = 4,
                 elems_per_stream: int = 128, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve(device)
        self.page_size = page_size
        self.calib_pages = calib_pages
        self.layer_kinds = layer_kinds(cfg)
        self.n_layers = len(self.layer_kinds)
        self.attn_layers = [i for i, k in enumerate(self.layer_kinds)
                            if k in ATTN_KINDS]
        self.local_layers = [i for i, k in enumerate(self.layer_kinds)
                             if k == "local"]
        self.state_layers = [i for i, k in enumerate(self.layer_kinds)
                             if k in STATE_KINDS]
        self.window = cfg.window_size
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
        self.page_base: dict[int, list[int]] = {}     # evicted-page count
        # rid -> {state layer -> {"h", "conv"}} (device tensors, no batch)
        self.states: dict[int, dict[int, dict]] = {}
        self.seq_len: dict[int, int] = {}
        self.traffic = {"kv_raw_bytes": 0, "kv_read_bytes": 0,
                        "kv_table_bytes": 0, "kv_pages_packed": 0,
                        "kv_raw_bytes_global": 0, "kv_read_bytes_global": 0,
                        "kv_raw_bytes_local": 0, "kv_read_bytes_local": 0,
                        "state_raw_bytes": 0, "state_snapshot_bytes": 0,
                        "state_snapshots": 0}
        # host<->device accounting: every KV-path transfer goes through
        # _fetch/_put
        self.transfers = {"h2d_bytes": 0, "d2h_bytes": 0,
                          "h2d_calls": 0, "d2h_calls": 0}
        self.dev: DevicePoolPlanes | None = None
        self.dev_states: list | None = None
        self._tables_dirty = False

    # ------------------------------------------------------------ sizing
    def pages_per_seq(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def window_pages(self) -> int:
        """Most live pages of a rolling layer: the window can straddle one
        more page boundary than ``ceil(window / page_size)`` covers."""
        return -(-self.window // self.page_size) + 1

    def pages_needed(self, n_tokens: int) -> int:
        return self.pages_for_config(self.cfg, n_tokens, self.page_size)

    @staticmethod
    def pages_for_config(cfg: ModelConfig, n_tokens: int,
                         page_size: int) -> int:
        """Worst-case per-request page count (``pages_for_config`` :1135):
        a global layer holds the full sequence, a rolling one at most
        ``window_pages``, a recurrent one none."""
        full = -(-n_tokens // page_size)
        rolling = min(full, -(-cfg.window_size // page_size) + 1)
        kinds = layer_kinds(cfg)
        return full * kinds.count("global") + rolling * kinds.count("local")

    def _ring(self, max_len: int) -> int:
        """A rolling layer's dense-cache width (``_ring`` :1331, as
        ``init_attention_cache``)."""
        return min(self.window, max_len)

    def kv_ratio(self) -> float | None:
        """Cumulative compressed-vs-raw KV read traffic (< 1.0 is a win);
        ``None`` before any read has moved a byte."""
        raw = self.traffic["kv_raw_bytes"]
        if raw == 0:
            return None
        return (self.traffic["kv_read_bytes"]
                + self.traffic["kv_table_bytes"]) / raw

    def stream_stats(self) -> dict:
        """Per-stream accounting (``stream_stats`` :1166): global and
        rolling KV reads, recurrent-state snapshot bytes.  Stream ratios
        are payload-only (table bytes count once, in ``kv_ratio``)."""
        out = {}
        for kind in ("global", "local"):
            raw = self.traffic[f"kv_raw_bytes_{kind}"]
            read = self.traffic[f"kv_read_bytes_{kind}"]
            out[kind] = {"raw_bytes": raw, "read_bytes": read,
                         "ratio": (read / raw) if raw else None}
        raw = self.traffic["state_raw_bytes"]
        comp = self.traffic["state_snapshot_bytes"]
        out["state"] = {"raw_bytes": raw, "snapshot_bytes": comp,
                        "snapshots": self.traffic["state_snapshots"],
                        "ratio": (comp / raw) if raw else None}
        return out

    # -------------------------------------------------------- transfers
    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """Device -> host with accounting (the seal pulls)."""
        out = t.cpu().numpy()
        self.transfers["d2h_calls"] += 1
        self.transfers["d2h_bytes"] += out.nbytes
        return out

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host -> device with accounting."""
        self._count_put(arr)
        return torch.as_tensor(arr, device=self.device)

    def _count_put(self, arr: np.ndarray) -> None:
        """Account an upload that a kernel wrapper makes itself."""
        self.transfers["h2d_calls"] += 1
        self.transfers["h2d_bytes"] += arr.nbytes

    # ----------------------------------------------------------- requests
    def add_request(self, rid: int) -> None:
        if rid in self.page_tables:
            raise ValueError(f"duplicate request id {rid}")
        self.page_tables[rid] = [[] for _ in range(self.n_layers)]
        self.page_base[rid] = [0] * self.n_layers
        self.states[rid] = {}
        self.seq_len[rid] = 0

    def release(self, rid: int) -> None:
        freed = []
        for layer, pids in enumerate(self.page_tables.pop(rid)):
            for pid in pids:
                self._cold[layer].discard(pid)
                self._packed[layer].discard(pid)
                freed.append(pid)
        self.pool.free(freed)
        del self.page_base[rid]
        del self.states[rid]
        del self.seq_len[rid]

    # ------------------------------------------------------------ appends
    def _claim_page(self, rid: int, layer: int, t: int) -> int:
        """Page that token ``t`` of (rid, layer) writes into, allocating a
        fresh one at page boundaries."""
        pids = self.page_tables[rid][layer]
        if t % self.page_size == 0:
            base = self.page_base[rid][layer]
            if t // self.page_size != base + len(pids):
                raise RuntimeError(
                    f"page-table desync for rid={rid} layer={layer}: token "
                    f"{t} vs base={base} live={len(pids)}")
            pid = self.pool.alloc()
            if pid is None:
                raise RuntimeError("page pool exhausted mid-flight "
                                   "(admission must reserve)")
            pids.append(pid)
        return pids[-1]

    def append_token(self, rid: int, kq, vq, ks, vs) -> None:
        """Host append of one token's KV for every attention layer, then
        rolling eviction (``append_token`` :1272).  kq/vq: [n_layers, H,
        dh] int8; ks/vs: [n_layers, H] f32; rows of recurrent layers are
        ignored."""
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
        self.evict_rolled(rid)

    def evict_rolled(self, rid: int) -> None:
        """Rolling-window eviction (``evict_rolled`` :1287): free every
        rolling-layer page whose tokens have all left the window.  With the
        next decode position at ``qpos = seq_len`` the mask keeps ``kpos >
        qpos - window``, so page ``p`` is dead once ``(p + 1) * ps - 1 <=
        qpos - window``; only the oldest live pages can die, and they are
        sealed.  All of a call's pages return in one pool call, in layer
        and page order."""
        qpos = self.seq_len[rid]
        ps = self.page_size
        gone = []
        for layer in self.local_layers:
            pids = self.page_tables[rid][layer]
            base = self.page_base[rid][layer]
            dead = 0
            while dead < len(pids) and \
                    (base + dead + 1) * ps - 1 <= qpos - self.window:
                dead += 1
            if not dead:
                continue
            for pid in pids[:dead]:
                self._cold[layer].discard(pid)
                self._packed[layer].discard(pid)
                gone.append(pid)
            del pids[:dead]
            self.page_base[rid][layer] = base + dead
        if gone:
            self.pool.evict(gone)

    def ingest_prefill(self, rid: int, caches: list, s: int) -> None:
        """Chop a batch-1 prefill cache (one dict per layer, positions
        ``[0, s)`` real) into pages on the device, in token order; full
        pages seal in page order (``ingest_prefill`` :1398-1475).

        A rolling layer's cache is the ring of its last ``window``
        positions: pages that have wholly rolled out are skipped
        (``page_base`` starts past them), and positions of the first kept
        page older than the window ingest as zeros, which count in the
        page's fill, seal scale and calibration histogram as in the
        reference.  A recurrent layer stores its final state.  Then the
        rolled-out pages are evicted."""
        ps = self.page_size
        events = []
        pool = self.pool
        for layer in self.attn_layers:
            c = caches[layer]
            if self.layer_kinds[layer] == "local":
                w = c["k"].shape[1]                  # ring width == window
                first = max(0, s - w) // ps
            else:
                w, first = None, 0
            self.page_base[rid][layer] = first
            n = self.pages_per_seq(s) - first
            t0 = first * ps
            pids = [self._claim_page(rid, layer, t0 + i * ps)
                    for i in range(n)]
            idx = torch.as_tensor(pids, dtype=torch.long, device=self.device)
            t = torch.arange(t0, s, device=self.device)
            if w is None:
                src, dst = t, t - t0
            else:
                live = t >= s - w
                src, dst = t[live] % w, t[live] - t0
            for kind, (q, sc) in enumerate(((c["k"], c["k_scale"]),
                                            (c["v"], c["v_scale"]))):
                qbuf = q.new_zeros(n * ps, *q.shape[2:])
                qbuf[dst] = q[0, src]
                sbuf = sc.new_zeros(n * ps, *sc.shape[2:])
                sbuf[dst] = sc[0, src]
                pool.tok_q[kind].index_copy_(
                    0, idx, qbuf.reshape(n, ps, *q.shape[2:]))
                pool.tok_scale[kind].index_copy_(
                    0, idx, sbuf.reshape(n, ps, *sc.shape[2:]))
            for i, pid in enumerate(pids):
                pool.fill[pid] = min(ps, s - t0 - i * ps)
                if pool.fill[pid] == ps:
                    events.append((layer, pid))
        for layer in self.state_layers:
            self.states[rid][layer] = {f: x[0] for f, x in
                                       caches[layer].items()}
        self.seq_len[rid] = s
        self._seal(events)
        self.evict_rolled(rid)

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
        # the reference divides on the host (numpy): a true division
        sc = quant.true_divide(torch.clamp_min(f.abs().amax(dim=(2, 4)),
                                               1e-8), 127.0)
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
        kind)``; rows of uncalibrated and recurrent layers stay zero and
        are never referenced (PACKED requires a table)."""
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
    def enable_device_pool(self, max_batch: int | None = None) -> None:
        """Expose the pool to the fused kernel (``enable_device_pool``
        :2079): kind-split plane views and the device table stack; with
        ``max_batch``, also the device state store of the recurrent layers
        (``init_state_store``), which the fused step carries."""
        self.dev = DevicePoolPlanes(self.pool, max(2, self.n_table_rows))
        if max_batch is not None:
            self.dev_states = init_state_store(self.cfg, max_batch,
                                               self.device)
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
        active (attention layer, slot) writes, as index tensors for
        ``device_append`` (row = i * B + slot into the new-token K/V
        stacked over the attention layers, i the layer's place among
        them)."""
        b = len(slot_rids)
        rows, pids, offs = [], [], []
        for slot, rid in enumerate(slot_rids):
            if rid is None:
                continue
            t = self.seq_len[rid]
            for i, layer in enumerate(self.attn_layers):
                rows.append(i * b + slot)
                pids.append(self._claim_page(rid, layer, t))
                offs.append(t % self.page_size)
        buf = self._put(np.asarray([rows, pids, offs], np.int64))
        return {"row": buf[0], "pid": buf[1], "off": buf[2]}

    def note_appended(self, slot_rids: list) -> None:
        """Metadata half of the on-device append (``note_appended``
        :2254): advance fills and sequence lengths, seal the pages that
        just filled (their payload is already on the device) and evict
        rolled-out pages.  Seals batch over the step's slots; with rolling
        layers they run per slot, before that slot's eviction, as the
        reference orders them (a calibration there may pack a page that a
        later slot's eviction frees)."""
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
            if self.local_layers:
                self._seal(events)
                events = []
                self.evict_rolled(rid)
        self._seal(events)

    def append_step_tokens(self, caches: list, slot_rids: list,
                           positions) -> None:
        """Move what a dense decode step wrote back into pages
        (``append_step_tokens`` :1335): each active slot's token at
        ``positions[slot]`` (ring slot ``pos % ring`` on a rolling layer)
        of every attention layer's cache, and the whole new state of every
        recurrent layer.  The JAX package pulls the tokens to the host and
        calls ``append_token`` per slot; here they stay on the device and
        take the fused path's append (``claim_append_targets``,
        ``device_append``, ``note_appended``), which claims the same pages
        in the same order and seals them with the same calibration
        order."""
        b = len(slot_rids)
        pos = self._put(np.asarray(positions, np.int64))
        rows = torch.arange(b, device=self.device)
        new_kv = {}
        if self.attn_layers:
            slots = [pos % caches[layer]["k"].shape[1]
                     if self.layer_kinds[layer] == "local" else pos
                     for layer in self.attn_layers]
            new_kv = {f: torch.stack([caches[layer][f][rows, sl] for layer, sl
                                      in zip(self.attn_layers, slots)])
                      for f in ("k", "v", "k_scale", "v_scale")}
        pool = self.pool
        planes = {"tok_k": pool.tok_q[0], "tok_v": pool.tok_q[1],
                  "tok_sk": pool.tok_scale[0], "tok_sv": pool.tok_scale[1]}
        device_append(planes, new_kv, self.claim_append_targets(slot_rids))
        for slot, rid in enumerate(slot_rids):
            if rid is None:
                continue
            for layer in self.state_layers:
                self.states[rid][layer] = {
                    f: x[slot].clone() for f, x in caches[layer].items()}
        self.note_appended(slot_rids)

    # ------------------------------------------- device-resident states
    def read_state_slot(self, slot: int) -> dict:
        """One slot's recurrent states from the device store
        (``read_state_slot`` :2304), copied: a preemption boundary, never
        the steady-state step."""
        return {layer: {f: x[slot].clone()
                        for f, x in self.dev_states[layer].items()}
                for layer in self.state_layers}

    def write_state_slot(self, slot: int, rid: int) -> None:
        """Write ``states[rid]`` (prefill ingest or snapshot restore) into
        the device store at ``slot`` (``write_state_slot`` :2316)."""
        for layer in self.state_layers:
            st = self.states[rid].get(layer)
            if st is None:
                raise RuntimeError(
                    f"request {rid} has no state for layer {layer} "
                    "(prefill not ingested?)")
            for f, v in st.items():
                self.dev_states[layer][f][slot] = v

    def _pull_states(self, slot_rids: list) -> None:
        """Bring the device store's states of the active slots into
        ``states`` (``_pull_states`` :2332)."""
        if self.dev_states is None or not self.state_layers:
            return
        for slot, rid in enumerate(slot_rids):
            if rid is not None and rid in self.states:
                self.states[rid] = self.read_state_slot(slot)

    # ------------------------------------------------- state snapshots
    def snapshot_state(self, rid: int) -> dict:
        """Preemption checkpoint of a request's recurrent states
        (``snapshot_state`` :1865): every state layer's fields, in layer
        and sorted-field order, flattened into one f32 stream coded by
        ``byteplane.compress_float(table_mode="weight")`` (the f32 byte
        planes through the encode kernel on the card; the state is fully
        profiled, so weight-mode tables need no slack).  Attention KV
        needs none: it already lives compressed in the page pool."""
        manifest: list[tuple[int, str, tuple[int, ...]]] = []
        parts: list[torch.Tensor] = []
        for layer in self.state_layers:
            st = self.states[rid].get(layer)
            if st is None:
                raise RuntimeError(
                    f"request {rid} has no state for layer {layer} "
                    "(prefill not ingested?)")
            for f in sorted(st):
                arr = st[f].to(F32).contiguous()
                manifest.append((layer, f, tuple(arr.shape)))
                parts.append(arr.reshape(-1))
        if not parts:
            return {"manifest": [], "planes": None}
        flat = torch.cat(parts)
        planes = byteplane.compress_float(flat, table_mode="weight")
        self.traffic["state_raw_bytes"] += flat.numel() * 4
        self.traffic["state_snapshot_bytes"] += planes.total_bits // 8
        self.traffic["state_snapshots"] += 1
        return {"manifest": manifest, "planes": planes}

    def restore_state(self, rid: int, snap: dict) -> None:
        """Decode a ``snapshot_state`` blob back into ``states[rid]``, bit
        for bit (``restore_state`` :1898; the decode kernel on the
        card)."""
        if snap["planes"] is None:
            return
        flat = byteplane.decompress_float(snap["planes"], device=self.device)
        off = 0
        for layer, f, shape in snap["manifest"]:
            n = int(np.prod(shape))
            self.states[rid].setdefault(layer, {})[f] = \
                flat[off:off + n].reshape(shape).clone()
            off += n

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
        the attention layers: ``pid``/``tid``/``state``/``t0`` int32 [A, B,
        P], ``qw`` int32 [A, B, 2] = (qpos, window), the window being
        ``_ring(max_len)`` on a rolling layer and 0 on a global one, and
        the kernel's ``kmeta`` [A, B, P, 2] = (state, t0), ``t0`` counting
        from the layer's ``page_base``.  One upload per step; also accrues
        the read traffic."""
        b = len(slot_rids)
        pn = self.meta_pages(max_len, slot_rids)
        na, nl, ps = len(self.attn_layers), self.n_layers, self.page_size
        ring = self._ring(max_len)
        pid = np.zeros((na, b, pn), np.int32)
        tid = np.broadcast_to(
            (2 * np.asarray(self.attn_layers, np.int32))[:, None, None],
            (na, b, pn)).copy()
        kmeta = np.zeros((na, b, pn, 2), np.int32)        # FREE: masked
        qw = np.zeros((na, b, 2), np.int32)
        for slot, rid in enumerate(slot_rids):
            if rid is None:
                continue
            qw[:, slot, 0] = self.seq_len[rid]
            for i, layer in enumerate(self.attn_layers):
                pids = self.page_tables[rid][layer]
                k = len(pids)
                base = self.page_base[rid][layer]
                pid[i, slot, :k] = pids
                tid[i, slot, :k] = table_row(0, layer, 0, nl)
                kmeta[i, slot, :k, 0] = self.pool.state[pids]
                kmeta[i, slot, :k, 1] = (base + np.arange(k)) * ps
                if self.layer_kinds[layer] == "local":
                    qw[i, slot, 1] = ring
        self._accrue_read_traffic(slot_rids, max_len)
        flat = self._put(np.concatenate([pid.ravel(), tid.ravel(),
                                         kmeta.ravel(), qw.ravel()]))
        n1 = pid.size
        out = {"pid": flat[:n1].view(na, b, pn),
               "tid": flat[n1:2 * n1].view(na, b, pn),
               "kmeta": flat[2 * n1:4 * n1].view(na, b, pn, 2),
               "qw": flat[4 * n1:].view(na, b, 2)}
        out["state"] = out["kmeta"][..., 0]
        out["t0"] = out["kmeta"][..., 1]
        return out

    def _accrue_read_traffic(self, slot_rids: list, max_len: int) -> None:
        """Charge the per-step KV read traffic (``_accrue_read_traffic``
        :2418): every page of every active slot, compressed as stored vs
        dense int8, per stream kind.  A rolling layer's partly rolled-out
        page charges only its live token range, ``ceil(bytes * live /
        tokens)``."""
        pool, ps = self.pool, self.page_size
        ring = self._ring(max_len)
        raw = {"global": 0, "local": 0}
        read = {"global": 0, "local": 0}
        for rid in slot_rids:
            if rid is None:
                continue
            qpos = self.seq_len[rid]
            for layer in self.attn_layers:
                pids = np.asarray(self.page_tables[rid][layer], np.int64)
                if not len(pids):
                    continue
                kind = self.layer_kinds[layer]
                n_tok = np.where(pool.state[pids] == m.PAGE_HOT,
                                 pool.fill[pids], ps).astype(np.int64)
                charged = pool.page_bytes(pids)
                if kind == "local":
                    t0 = (self.page_base[rid][layer]
                          + np.arange(len(pids))) * ps
                    lo = np.maximum(t0, qpos - ring)
                    n_live = np.clip(t0 + n_tok - lo, 0, n_tok)
                    part = n_live < n_tok
                    charged = np.where(part, -(-charged * n_live
                                               // np.maximum(n_tok, 1)),
                                       charged)
                else:
                    n_live = n_tok
                raw[kind] += int(pool.dense_bytes(n_live).sum())
                read[kind] += int(charged.sum())
        for kind in ("global", "local"):
            self.traffic[f"kv_raw_bytes_{kind}"] += raw[kind]
            self.traffic[f"kv_read_bytes_{kind}"] += read[kind]
        self.traffic["kv_raw_bytes"] += raw["global"] + raw["local"]
        self.traffic["kv_read_bytes"] += read["global"] + read["local"]

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
        """Rebuild the dense cache of the active batch from the pool, one
        dict per network layer (``materialize`` :2465): for an attention
        layer ``k``/``v`` int8 [B, span, H, dh] and ``k_scale``/
        ``v_scale`` f32 [B, span, H], span ``max_len`` on a global layer and
        ``_ring(max_len)`` on a rolling one; for a recurrent layer its
        state ``{"h", "conv"}`` stacked over the slots (zeros, the init
        state, for an idle slot).  Also accrues the step's read traffic, as
        the fused path's ``step_meta`` does.

        Token ``t`` of a page lands at position ``t`` of a global layer and
        ring slot ``t % ring`` of a rolling one, where only the live
        positions ``t >= qpos - ring`` are placed: HOT tokens with their
        per-token scales, COLD tokens with the page's scale per head, and
        PACKED pages decoded, all layers in one ``decode`` call per K/V
        kind (the gather-decode kernel), the page and table-row vectors
        padded to ``gather_bucket`` by repeating the last entry.
        ``decode`` is there so a check can build the same cache through
        the plain version; the engine never passes it.  In fused mode the
        states come from the device store first (``_pull_states``).

        The JAX package materializes from its host mirror and first pulls
        the device-resident HOT pages into it (``sync_hot_to_host``); this
        pool has no host mirror (``modules.KVPagePool``), so the cache is
        built on the device from the pool's own tensors, with a few batched
        index writes per step and no per-page copies."""
        pool = self.pool
        self._pull_states(slot_rids)
        self._accrue_read_traffic(slot_rids, max_len)
        b, na = len(slot_rids), len(self.attn_layers)
        h, dh, ps = pool.kv_heads, pool.head_dim, self.page_size
        ring = self._ring(max_len)
        span = max_len if "global" in self.layer_kinds else ring
        kq = torch.zeros(2, na, b, span, h, dh, dtype=torch.int8,
                         device=self.device)
        ks = torch.zeros(2, na, b, span, h, dtype=F32, device=self.device)
        # one row per page: (state, attention index, slot, t0, n_tok, pid,
        # job, ring (0: global), qpos), job = the page's place in the
        # gather list (PACKED pages only)
        pages, jobs = [], []
        for slot, rid in enumerate(slot_rids):
            if rid is None:
                continue
            qpos = self.seq_len[rid]
            for i, layer in enumerate(self.attn_layers):
                local = self.layer_kinds[layer] == "local"
                base = self.page_base[rid][layer]
                for k_, pid in enumerate(self.page_tables[rid][layer]):
                    st = int(pool.state[pid])
                    n_tok = int(pool.fill[pid]) if st == m.PAGE_HOT else ps
                    t0 = (base + k_) * ps
                    if not local:
                        n_tok = min(n_tok, max_len - t0)
                    pages.append((st, i, slot, t0, n_tok, pid,
                                  len(jobs) if st == m.PAGE_PACKED else 0,
                                  ring if local else 0, qpos))
                    if st == m.PAGE_PACKED:
                        jobs.append((layer, pid))
        if pages:
            self._place(kq, ks, np.asarray(pages, np.int64), jobs, decode)
        out = []
        i = 0
        for layer, kind in enumerate(self.layer_kinds):
            if kind in ATTN_KINDS:
                n = span if kind == "global" else ring
                out.append({"k": kq[0, i, :, :n], "v": kq[1, i, :, :n],
                            "k_scale": ks[0, i, :, :n],
                            "v_scale": ks[1, i, :, :n]})
                i += 1
            else:
                out.append(self._state_leaves(layer, slot_rids))
        return out

    def _state_leaves(self, layer: int, slot_rids: list) -> dict:
        """A recurrent layer's states stacked over the slots, the init
        (zero) state where a slot is idle or has none."""
        zero = m.init_recurrent_cache(self.cfg, 1, self.device)
        rows = {f: [] for f in zero}
        for rid in slot_rids:
            st = self.states[rid].get(layer) if rid is not None else None
            for f, z in zero.items():
                rows[f].append(st[f] if st is not None else z[0])
        return {f: torch.stack(v) for f, v in rows.items()}

    def _place(self, kq, ks, pages: np.ndarray, jobs: list, decode) -> None:
        """Write every live token of ``pages`` into the dense cache: one
        upload of the token index rows, then per page state one gather and
        one index write for the values and one of each for the scales."""
        pool = self.pool
        n_tok = pages[:, 4]
        tok = np.repeat(pages, n_tok, axis=0)
        start = np.repeat(np.cumsum(n_tok) - n_tok, n_tok)
        off = np.arange(len(tok)) - start
        posn = tok[:, 3] + off
        ring = tok[:, 7]
        rolling = ring > 0
        keep = ~rolling | (posn >= tok[:, 8] - ring)
        posn = np.where(rolling, posn % np.maximum(ring, 1), posn)
        tok, off, posn = tok[keep], off[keep], posn[keep]
        order = np.argsort(tok[:, 0], kind="stable")
        tok, off, posn = tok[order], off[order], posn[order]
        counts = np.bincount(tok[:, 0], minlength=4)
        # rows: attention index, slot, position, pid, in-page offset, job
        idx = self._put(np.stack([tok[:, 1], tok[:, 2], posn,
                                  tok[:, 5], off, tok[:, 6]]))
        dec = None
        if jobs:
            dec = self._decode_jobs(jobs, decode)
        lo = 0
        for st in (m.PAGE_HOT, m.PAGE_COLD, m.PAGE_PACKED):
            hi = lo + int(counts[st])
            if hi == lo:
                continue
            layer, slot, posn_, pid, o, job = idx[:, lo:hi]
            lo = hi
            if st == m.PAGE_HOT:
                q, sc = pool.tok_q[:, pid, o], pool.tok_scale[:, pid, o]
            elif st == m.PAGE_COLD:
                q, sc = pool.cold_q[:, pid, o], pool.page_scale[:, pid]
            else:
                q, sc = dec[:, job, o], pool.page_scale[:, pid]
            kq[:, layer, slot, posn_] = q
            ks[:, layer, slot, posn_] = sc

    def _decode_jobs(self, jobs: list, decode) -> torch.Tensor:
        """Decode every PACKED page of ``jobs`` ((layer, pid) pairs), both
        kinds, through ``decode``: int8 [2, n, ps, H, dh].  The page and
        table ids go to ``decode`` as host arrays, which the gather wrapper
        range-checks on the host and uploads without waiting for the card
        (``kernels/paged_decode.gather_decode``)."""
        pool = self.pool
        n = len(jobs)
        pad = (0, gather_bucket(n) - n)
        ids = np.array([[pid for _, pid in jobs]]
                       + [[table_row(0, layer, kind, self.n_layers)
                           for layer, _ in jobs] for kind in (0, 1)],
                       np.int32)
        ids = np.pad(ids, ((0, 0), pad), mode="edge")
        vm, ol, cm = self._device_tables()
        out = []
        for kind in (0, 1):
            self._count_put(ids[[0, 1 + kind]])     # the wrapper's upload
            out.append(decode(pool.sym[kind], pool.ofs[kind],
                              pool.stored[kind], ids[0], vm, ol, cm,
                              n_steps=pool.elems_per_stream,
                              table_idx=ids[1 + kind])[:n])
        return quant.from_unsigned(torch.stack(out)).reshape(
            2, n, self.page_size, pool.kv_heads, pool.head_dim)
