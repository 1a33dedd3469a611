"""Model assembly and the paged APack KV cache of the port.

Port of the serving parts of ``repro/models/model.py``: ``_init_block``/
``init_params`` :52/:77 (untied head, an MoE config's dense prefix
layers), ``exact_param_count`` :112, ``_ffn`` :123, ``block_full`` :130
(sequential and parallel blocks), ``_join_block`` :170, ``block_step``
:184 and ``block_step_paged`` :202, ``embed_inputs`` :224 (the stub vision
and audio frontends), ``forward`` :273 (prefix layers, ``pad_mask``/
``true_len``/``last_only``), ``_head`` :310 (tied or untied),
``_init_block_cache``/``init_cache`` :352/:366, ``decode_step`` :380,
``decode_step_paged`` :408 (with the state store), ``init_state_store``/
``states_from_step`` :457-486, ``device_append`` :488,
``_pack_quantize``/``pack_weights`` :544/:562, ``extend_caches`` :820,
``prefill`` :844, ``_layer_kinds`` :859, ``DevicePoolPlanes`` :867 (with
``ensure_table_capacity`` :925) and ``PagedKVCache`` :944 (with
``evict_rolled`` :1287, ``append_step_tokens`` :1335, ``ingest_prefill``
:1398, the drift sketch, generation-versioned table rows, refresh and
re-pack :1477-1862, ``snapshot_state``/``restore_state`` :1865/:1898, the
host spill tier :1913-2036, the transfer guard :2039, the state store
:2304-2337, ``step_meta`` :2362 and ``materialize`` :2465) for stacks of
global and rolling attention layers and RG-LRU recurrent, mLSTM and sLSTM
layers, prefix or cycled, with dense (swiglu, geglu, gelu, relu2) or top-k
MoE FFNs or none.

Layers are a Python list of per-layer param dicts, prefix layers first,
where JAX scans one stacked tree per cycle position; a dense decode cache
and the state store are per-layer lists the same way.  The page pool's
payload lives on the device (see ``modules.KVPagePool``): prefill ingest,
the token append, the seal requantization and the APack encode all write
it there, so no page payload crosses to the host.  What does cross is
small and happens at page events: the calibration histograms of a sealed
page (until its layer's tables exist), and the coded bit count and
lossless check of each packed page, and the drift sketch of pages sealed
after calibration; a re-pack's verdicts and bit counts; a spilled
request's pages.  An encoder (hubert-xlarge) forwards only; its decode
entry points refuse it (``check_decoder``).  The training forward
(``forward_train``, ``forward`` :273 without caches, with the MoE aux
losses and ``remat`` per cycle) runs the same layers (``_layers``), and
``loss_fn`` :322 scores it.  Serving on a mesh: ``mesh_axis_sizes``
:682, ``packed_param_specs`` :656, ``_localize_meta``/
``_localize_targets`` :688/:708 (``PagedKVCache.step_meta_sharded``/
``claim_append_targets_sharded``), ``_state_specs`` :739 (the state
store split by batch, ``enable_device_pool``), ``build_sharded_step`` :750, ``device_append``'s head blocks :527-532 and
``PagedKVCache(mesh=)``'s per-shard pool and requests (``request_shard``
:1030); one controller drives every shard's tensors.  Training on a mesh
(``sharded_loss``, the reference's ``forward`` + ``loss_fn`` under
``jax.jit(..., in_shardings=...)``): each data group's rows, each layer's
weights gathered over fsdp where it runs (no remat), the TP sites over
the model axis (``_layer_view``), the vocabulary-parallel head and loss
(``vocab_parallel_sums``).  The reference's prefill and dense-cache decode
cells on that mesh (``launch/specs.py:153-180``): ``sharded_prefill`` and
``sharded_decode_step``, from the same pieces.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import byteplane, quant
from repro_torch.core.tables import (TABLE_OVERHEAD_BITS,
                                     expected_bits_per_value, find_table)
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
# layers whose decode state is a fixed-size tensor set, not pages: RG-LRU
# recurrent, mLSTM and sLSTM (``STATE_KINDS`` :856)
STATE_KINDS = ("recurrent", "mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse, loudly, a layer kind that no architecture has."""
    kinds = set(cfg.prefix_pattern) | set(cfg.cycle)
    other = sorted(kinds - set(ATTN_KINDS) - set(STATE_KINDS))
    if other:
        raise ValueError(f"{cfg.name}: unknown layer kinds {other}; the "
                         f"kinds are {ATTN_KINDS + STATE_KINDS}")
    cfg.n_cycles          # the scanned layers must divide into cycles


def check_decoder(cfg: ModelConfig) -> None:
    """Refuse an encoder where a decode path is asked for (the engine, the
    paged cache, the dense decode cache): an encoder forwards only."""
    check_supported(cfg)
    if cfg.is_encoder:
        raise ValueError(
            f"{cfg.name} is an encoder (family 'encoder', causal=False): "
            "it has no decode path, so it forwards only (model.forward) "
            "and cannot be served")


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
    :52, ``init_params`` :77, ``modules.py:149-163, 449-458, 483-497,
    553``): normal weights scaled by fan-in^-0.5, zero norm scales, in
    ``cfg.param_dtype`` (the MoE router in f32); recurrent blocks as
    ``modules.init_recurrent``; ``unembed`` [d, V] when the head is untied.
    One dict per network layer, prefix layers first; a prefix layer of an
    MoE config has the dense FFN.  The numbers differ from
    ``jax.random``'s; tests that compare the two packages convert one tree
    with ``convert.params_from_numpy``.  ``device="meta"`` builds the
    shapes only (``exact_param_count``)."""
    check_supported(cfg)
    dev = resolve(device)
    dt = getattr(torch, cfg.param_dtype)
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim

    def normal(shape, scale, dtype=dt):
        x = torch.randn(*shape, generator=generator, device=dev)
        return (x * scale).to(dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    blocks = []
    for layer, kind in enumerate(layer_kinds(cfg)):
        if kind in ATTN_KINDS:
            inner = {"wq": normal((d, h, dh), d ** -0.5),
                     "wk": normal((d, hkv, dh), d ** -0.5),
                     "wv": normal((d, hkv, dh), d ** -0.5),
                     "wo": normal((h, dh, d), d ** -0.5)}
            if cfg.qk_norm:
                inner["q_norm"] = zeros(dh)
                inner["k_norm"] = zeros(dh)
        elif kind == "recurrent":
            inner = m.init_recurrent(cfg, generator, dev, dt)
        elif kind == "mlstm":
            inner = m.init_mlstm(cfg, normal, zeros)
        else:
            inner = m.init_slstm(cfg, normal, zeros)
        blk = {"norm1": zeros(d), "inner": inner}
        blocks.append(blk)
        if kind in ("mlstm", "slstm"):      # no norm2 and no FFN (:70)
            continue
        blk["norm2"] = zeros(d)
        # an MoE config's prefix layers take the dense FFN (``dense_cfg``)
        if cfg.num_experts and layer >= len(cfg.prefix_pattern):
            blk["ffn"] = m.init_moe(cfg, normal, lambda shape, scale: normal(
                shape, scale, F32))
        elif cfg.d_ff > 0:
            blk["ffn"] = m.init_mlp(cfg, normal)
    params = {"embed": normal((cfg.vocab_size, d), d ** -0.5),
              "final_norm": zeros(d), "blocks": blocks}
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, cfg.vocab_size), d ** -0.5)
    return params


def exact_param_count(cfg: ModelConfig) -> int:
    """Parameter count of the tree ``init_params`` builds
    (``exact_param_count`` :112), from its shapes on the ``meta`` device:
    nothing is allocated."""
    params = init_params(cfg, torch.Generator(), "meta")

    def count(x):
        if isinstance(x, dict):
            return sum(count(v) for v in x.values())
        if isinstance(x, list):
            return sum(count(v) for v in x)
        return x.numel()
    return count(params)


def serving_params(params: dict) -> dict:
    """A copy for serving with every dense matrix in bf16, made once.  The
    JAX package casts each f32 weight to bf16 at its use
    (``modules.py:145``) and the embedding rows after the lookup; holding
    the bf16 copy gives the same values.  Norm scales, the recurrent
    gates' f32 params (``modules.RECURRENT_F32``) and the MoE router (used
    in f32) stay as they are, and so do packed weights (``pack_weights``).
    Idempotent: a tensor already in bf16 is not copied."""
    def conv(k, v):
        if isinstance(v, dict):
            return {kk: conv(kk, vv) for kk, vv in v.items()}
        if isinstance(v, list):
            return [conv(k, vv) for vv in v]
        if isinstance(v, m.PackedWeight) or "norm" in k \
                or k in m.RECURRENT_F32 or k == "router":
            return v
        return v.to(BF16)
    return {k: conv(k, v) for k, v in params.items()}


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
    store for serving (``pack_weights`` :562), by layer kind.

    Packed sites: wq/wk/wv (contract d) and wo (contract h, dh) of global
    and rolling attention layers, w_up/w_gate/w_down of every dense FFN,
    recurrent and prefix layers included (an MoE config's prefix layers
    too), and the untied head ``unembed`` (contract d), each when one
    layer's tensor holds at least ``min_size`` elements; ``tile_k =
    min(512, K)`` unless given.  The recurrent block's own matrices, a
    routed FFN (router and expert stacks), the tied head and the embedding
    stay dense.  Each layer gets its own weight-mode table.
    ``params`` must be the original (f32) tree, not ``serving_params``'
    bf16 copy: the quantization reads the original values and
    ``native_bytes`` counts their element size.

    Returns ``(packed_params, stats)`` with the JAX package's byte
    accounting.  It counts one packed tensor per scanned stack, that is
    one per (site, cycle position), summed over the stack's layers, and
    one per tensor of a prefix layer, which the JAX package does not
    stack."""
    if min_size is None:
        min_size = dm.DEFAULT_WEIGHT_MIN_SIZE
    stats = {"packed_tensors": 0, "native_bytes": 0, "int8_bytes": 0,
             "payload_bytes": 0, "slotted_bytes": 0, "scale_bytes": 0}
    n_prefix, n_cycle = len(cfg.prefix_pattern), len(cfg.cycle)

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
    for layer, (kind, blk) in enumerate(zip(layer_kinds(cfg),
                                            params["blocks"])):
        # a prefix layer is its own tensor; a cycle position's stack counts
        # once, at its first layer
        first = layer < n_prefix + n_cycle
        out = dict(blk)
        if kind in ATTN_KINDS:
            inner = out["inner"] = dict(blk["inner"])
            for name, nc in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 2)):
                if inner[name].numel() >= min_size:
                    inner[name] = pack(inner[name], nc, first)
        if "ffn" in blk and "router" not in blk["ffn"]:
            ffn = out["ffn"] = dict(blk["ffn"])
            for name in ("w_up", "w_gate", "w_down"):
                if name in ffn and ffn[name].numel() >= min_size:
                    ffn[name] = pack(ffn[name], 1, first)
        blocks.append(out)
    packed = {**params, "blocks": blocks}
    if "unembed" in params and params["unembed"].numel() >= min_size:
        packed["unembed"] = pack(params["unembed"], 1, True)
    return packed, stats


# ------------------------------------------------------------------ block
def _ffn(cfg: ModelConfig, p: dict, x):
    """The block's FFN (``_ffn`` :123) and its aux losses: the routed MoE
    where the layer has a router, else the dense MLP (no aux)."""
    if isinstance(p["ffn"], dict) and "router" in p["ffn"]:
        return m.moe(p["ffn"], x, cfg)
    return m.tp_site(m.mlp, p["ffn"], x, cfg), {}


def _ffn_tail(cfg: ModelConfig, p: dict, h, inner, hn):
    """Residual + FFN (``block_full`` :155-166, ``_join_block`` :170).
    Returns the block's output twice, rounded to h's bf16 and as the
    unrounded f32 sum of its last add, and the FFN's aux losses.  A block
    without an FFN (mLSTM, sLSTM) returns ``h + inner``.  The residual
    keeps the bf16 sums; a norm that reads one reads the unrounded f32
    sum, as the JAX
    package's compiled block does (XLA drops the bf16 round trip between
    the add and the norm's f32 cast): here the FFN's norm, and the next
    layer's ``norm1`` where the compiled reference fuses the two layers
    (``reads_unrounded``).  A parallel block's FFN reads ``hn``, the
    block's own ``norm1`` output, and adds beside the attention:
    ``h + inner + ffn(hn)``."""
    hf = h.to(F32) + inner.to(F32)
    if "ffn" not in p:
        return hf.to(h.dtype), hf, {}
    x = hn if cfg.parallel_block else m.rms_norm(
        hf, p["norm2"], cfg.norm_eps).to(h.dtype)
    f, aux = _ffn(cfg, p, x)
    out = hf.to(h.dtype).to(F32) + f.to(F32)
    return out.to(h.dtype), out, aux


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
    """Full-sequence (prefill and training) block of any kind
    (``block_full`` :130): (h, unrounded h, cache, aux); ``hx``, when
    given, is the unrounded input its norm reads.  ``pad_mask``/
    ``true_len``: the bucketed prefill, where rolling rings and the
    recurrent, mLSTM and sLSTM states stop at the true end."""
    hn = _norm1(cfg, p, h, hx)
    if kind in ATTN_KINDS:
        inner, cache = m.tp_site(m.attention_full, p["inner"], hn, cfg,
                                 local=kind == "local", true_len=true_len)
    elif kind == "recurrent":
        inner, cache = m.tp_site(m.recurrent_full, p["inner"], hn, cfg,
                                 pad_mask=pad_mask, true_len=true_len)
    elif kind == "mlstm":
        inner, cache = m.mlstm_full(p["inner"], hn, cfg, pad_mask=pad_mask)
    else:
        inner, cache = m.slstm_full(p["inner"], hn, cfg, pad_mask=pad_mask)
    h, hf, aux = _ffn_tail(cfg, p, h, inner, hn)
    return h, hf, cache, aux


def _head(params: dict, h: torch.Tensor) -> torch.Tensor:
    """LM head (``_head`` :310), logits in f32: the untied ``unembed``
    [d, V] through ``proj`` (kernel 5 when packed), else the tied
    embedding, both products in h's bf16."""
    if "unembed" in params:
        return m.proj(h, params["unembed"]).to(F32)
    return m.matmul(h, params["embed"].t()).to(F32)


def _embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Token embeddings in bf16, times ``sqrt(d_model)`` (cast to bf16
    first, the product in bf16) for a vision config: the gemma scale of
    ``embed_inputs`` :236, ``decode_step`` :384 and ``decode_step_paged``
    :431."""
    h = params["embed"][tokens].to(BF16)
    if cfg.frontend == "vision":
        h = h * torch.full((), cfg.d_model ** 0.5, dtype=BF16,
                           device=h.device)
    return h


def embed_inputs(cfg: ModelConfig, params: dict, tokens=None, *,
                 patch_embeds=None, frame_embeds=None) -> torch.Tensor:
    """tokens (and the stub frontends' embeddings) -> [B, S, D] bf16
    hidden states (``embed_inputs`` :224): an audio config takes
    ``frame_embeds`` [B, S, D] alone, cast to bf16; a vision config puts
    ``patch_embeds`` [B, P, D] (cast to bf16), when given, before its
    scaled token embeddings."""
    if cfg.frontend == "audio":
        if frame_embeds is None:
            raise ValueError(f"{cfg.name}: an audio config takes "
                             "frame_embeds, not tokens")
        return frame_embeds.to(BF16)
    h = _embed_tokens(cfg, params, tokens)
    if cfg.frontend == "vision" and patch_embeds is not None:
        h = torch.cat([patch_embeds.to(BF16), h], dim=1)
    return h


def _layers(cfg: ModelConfig, params: dict, h: torch.Tensor, *,
            collect_cache: bool = True, pad_mask=None,
            true_len: int | None = None, remat: bool = True):
    """The layer stack over [B, S, D] hiddens, shared by the serving and
    the training forward: the prefix layers, then the cycles (the JAX
    package's ``_scan_blocks`` :244).  Returns ``(h, caches, aux)``: one
    cache per layer when ``collect_cache`` (prefill; training collects
    none), and the MoE aux losses summed layer by layer in the
    reference's carry order.  Under autograd each cycle is recomputed in
    the backward pass (``modules.remat``: ``jax.checkpoint`` with
    ``nothing_saveable``) unless ``remat`` is False.

    The reference wraps each cycle's input in ``_residual_barrier``, an
    XLA scheduling barrier with an identity gradient; it needs no
    counterpart here.  What it implies for the values -- the first layer
    of a cycle reads the rounded bf16 carry -- is ``reads_unrounded``."""
    kinds = layer_kinds(cfg)
    n_prefix, n_cycle = len(cfg.prefix_pattern), len(cfg.cycle)

    def run(lo, hi, h, lb, rz):
        caches, hx = [], None
        for layer in range(lo, hi):
            h, hx, cache, aux = block_full(
                cfg, kinds[layer], params["blocks"][layer], h,
                hx=hx if reads_unrounded(cfg, layer) else None,
                pad_mask=pad_mask, true_len=true_len)
            if collect_cache:
                caches.append(cache)
            lb = lb + aux.get("load_balance", 0.0)
            rz = rz + aux.get("router_z", 0.0)
        return h, caches, lb, rz

    h, caches, _, _ = run(0, n_prefix, h, 0.0, 0.0)
    lb = rz = 0.0
    for lo in range(n_prefix, len(kinds), n_cycle):
        h, more, lb, rz = (m.remat(run, lo, lo + n_cycle, h, lb, rz)
                           if remat else run(lo, lo + n_cycle, h, lb, rz))
        caches += more
    return h, caches, {"load_balance": lb, "router_z": rz}


def forward(cfg: ModelConfig, params: dict, tokens=None, *,
            patch_embeds=None, frame_embeds=None, last_only: bool = False,
            true_len: int | None = None):
    """Prefill forward (``forward`` :273).  Returns ``(logits, caches)``
    with one cache dict per network layer.  ``patch_embeds`` /
    ``frame_embeds``: the stub frontends' inputs (``embed_inputs``).
    ``true_len``: tokens are end-padded to a bucket and only the first
    ``true_len`` are real; the rolling rings and recurrent states are taken
    at the true end, pad steps are inert in the recurrent scans
    (``pad_mask``), and ``last_only`` takes the logits at ``true_len - 1``
    (causal attention already keeps pad keys out of every real query)."""
    h = embed_inputs(cfg, params, tokens, patch_embeds=patch_embeds,
                     frame_embeds=frame_embeds)
    pad_mask = None
    if true_len is not None:
        pad_mask = torch.arange(h.shape[1], device=h.device) >= true_len
    h, caches, _ = _layers(cfg, params, h, pad_mask=pad_mask,
                           true_len=true_len)
    if last_only:
        t = h.shape[1] if true_len is None else int(true_len)
        h = h[:, t - 1:t]
    h = m.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, h), caches


def forward_train(cfg: ModelConfig, params: dict, tokens=None, *,
                  patch_embeds=None, frame_embeds=None):
    """Training forward (``forward`` :273 with ``collect_cache=False``):
    the serving forward's layers and bf16 rounding points, no caches kept,
    each cycle recomputed in the backward pass (``remat``).
    Differentiable with ``torch.autograd``.  Returns ``(logits [B, S, V]
    f32, aux)``, aux the MoE losses summed over the layers (0.0 without
    MoE) for ``loss_fn``."""
    h = embed_inputs(cfg, params, tokens, patch_embeds=patch_embeds,
                     frame_embeds=frame_embeds)
    h, _, aux = _layers(cfg, params, h, collect_cache=False)
    h = m.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, h), aux


def _scored(cfg: ModelConfig, logits: torch.Tensor, batch: dict):
    """``(logits, targets, mask)`` of ``loss_fn`` :322: a causal LM's
    logits at every position but the last (after a vision config's image
    prefix, which predicts nothing), each scored against the next token
    under ``loss_mask``; an encoder's every frame against its ``labels``.
    ``logits`` may be a vocabulary block of the whole."""
    if cfg.is_encoder:
        targets = batch["labels"]
        mask = torch.ones(targets.shape, dtype=F32, device=logits.device)
        return logits, targets, mask
    tok = batch["tokens"]
    lm = batch.get("loss_mask")
    mask = (torch.ones(tok.shape, dtype=F32, device=logits.device)
            if lm is None else lm.to(F32))[:, 1:]
    n_img = logits.shape[1] - tok.shape[1]
    if n_img > 0:
        logits = logits[:, n_img:]
    return logits[:, :-1], tok[:, 1:], mask


def loss_fn(cfg: ModelConfig, logits: torch.Tensor, batch: dict,
            aux: dict | None = None) -> torch.Tensor:
    """Masked cross entropy in f32 (``loss_fn`` :322): next-token for a
    causal LM (``batch["tokens"]``, an optional ``loss_mask``; a vision
    config's image prefix predicts nothing), per-frame ``labels`` for an
    encoder; plus the z-loss ``1e-4 mean(lse^2)`` and, with ``aux``, the
    MoE losses at 0.01 (load balance) and 0.001 (router z).  The target
    logit is a gather where the reference contracts a one-hot: for a
    finite row both give the same value."""
    logits, targets, mask = _scored(cfg, logits, batch)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets[..., None].long())[..., 0]
    denom = torch.clamp_min(mask.sum(), 1.0)
    nll = ((lse - ll) * mask).sum() / denom
    z_loss = 1e-4 * torch.square(lse * mask).sum() / denom
    return _with_aux(nll + z_loss, aux)


def _with_aux(total, aux: dict | None):
    if aux:
        total = total + 0.01 * aux.get("load_balance", 0.0) \
            + 0.001 * aux.get("router_z", 0.0)
    return total


def vocab_parallel_sums(cfg: ModelConfig, parts: list, batch: dict,
                        lead) -> tuple:
    """``loss_fn``'s sums over one data shard's rows from its logits split
    over the model shards' vocabulary blocks (``parts``, contiguous, in
    order, each on its own device): ``pmax`` of the blocks' row maxima,
    ``psum`` of their exponentials (``lse = max + log sum``) and of the
    target logit, which lies in one block.  Returns ``(sum of masked nll,
    sum of masked lse^2, sum of the mask)`` on ``lead``."""
    from .sharding import pmax, psum
    scored = [_scored(cfg, lg, batch) for lg in parts]
    targets, mask = scored[0][1].to(lead), scored[0][2].to(lead)
    mx = pmax([lg.detach().amax(-1) for lg, _, _ in scored], lead)
    sums, tls, off = [], [], 0
    for lg, _, _ in scored:
        dev, w = lg.device, lg.shape[-1]
        sums.append(torch.exp(lg - mx.to(dev)[..., None]).sum(-1))
        t = targets.to(dev).long() - off
        inside = (t >= 0) & (t < w)
        got = lg.gather(-1, t.clamp(0, w - 1)[..., None])[..., 0]
        tls.append(torch.where(inside, got, torch.zeros_like(got)))
        off += w
    lse = mx + torch.log(psum(sums, lead))
    ll = psum(tls, lead)
    return (((lse - ll) * mask).sum(), torch.square(lse * mask).sum(),
            mask.sum())


# ------------------------------------------------- sharded training
def _model_split(leaf, dim: int, n: int) -> bool:
    """Whether ``leaf``'s storage splits dimension ``dim`` over the model
    axis of ``n`` shards (``n > 1``; ``fit_spec`` kept the split)."""
    return n > 1 and leaf.spec[dim % leaf.ndim] == "model"


def _take(leaf, device, dim: int | None = None, j: int = 0, n: int = 1):
    """A ``sharding.Sharded`` leaf on ``device``, whole, or its ``j``-th of
    ``n`` equal blocks along ``dim``: where its storage splits ``dim``
    over ``model`` that is model shard ``j``'s blocks gathered over the
    other split dimensions (``all_gather`` over fsdp), else a slice of the
    whole."""
    if dim is None or n == 1:
        return leaf.gather(device)
    dim %= leaf.ndim
    if _model_split(leaf, dim, n):
        k = leaf.mesh.axis_names.index("model")
        return leaf.assemble(device, [i for i in leaf.owners if i[k] == j])
    size = leaf.shape[dim] // n
    return leaf.gather(device).narrow(dim, j * size, size)


# Each TP site: the leaves whose storage must split over the model axis
# for the site to split (``fit_spec`` keeps it), and the dimension each
# leaf's model-shard block splits along (a leaf not listed is whole on
# every model shard).
_TP_SITES = {
    "attention": (("wq", "wk"), {"wq": 1, "wk": 1, "wv": 1, "wo": 0}),
    "recurrent": (("w_x",), {"w_x": -1, "w_gate": -1, "conv_w": -1,
                             "a_param": 0, "w_input_gate": 0,
                             "w_a_gate": 0, "w_out": 0}),
    "mlp": (("w_up",), {"w_up": -1, "w_gate": -1, "w_down": 0}),
}


def _whole(tree, device):
    if isinstance(tree, dict):
        return {k: _whole(v, device) for k, v in tree.items()}
    return tree.gather(device)


def _site(cfg: ModelConfig, site: str, p: dict, devs: list, lead):
    """A TP site's ``ModelShards`` over ``devs`` (its model shards), or its
    whole params on ``lead`` where the storage does not split it over the
    model axis (``fit_spec`` dropped the split: e.g. 2 KV heads on a
    4-way model axis)."""
    n = len(devs)
    keys, dims = _TP_SITES[site]
    if not all(_model_split(p[k], dims[k], n) for k in keys):
        return _whole(p, lead)
    sub = cfg
    if site == "attention":
        sub = dataclasses.replace(cfg, num_heads=cfg.num_heads // n,
                                  num_kv_heads=cfg.num_kv_heads // n)
    parts = [{k: _take(v, devs[j], dims.get(k), j, n) for k, v in p.items()}
             for j in range(n)]
    return m.ModelShards(parts, [sub] * n, devs, lead)


_ALL_SITES = frozenset(_TP_SITES)


def _layer_view(cfg: ModelConfig, kind: str, blk: dict, devs: list, lead,
                sites=_ALL_SITES):
    """One layer's params for a data shard: the TP sites of ``sites``
    (attention heads, RG-LRU width, dense FFN hidden) as ``ModelShards``
    where the storage splits them over the model axis; the norms, the MoE,
    mLSTM and sLSTM layers and any other site whole on the data shard's
    lead device (item 1.10c)."""
    out = {}
    for key, sub in blk.items():
        site = ("attention" if key == "inner" and kind in ATTN_KINDS else
                "recurrent" if key == "inner" and kind == "recurrent" else
                "mlp" if key == "ffn" and "router" not in sub else None)
        out[key] = (_whole(sub, lead) if site not in sites
                    else _site(cfg, site, sub, devs, lead))
    return out


class _LayerViews:
    """``params["blocks"]`` of a data shard's view, each layer gathered
    when ``_layers`` reads it (the reference's per-layer FSDP
    all-gather)."""

    def __init__(self, cfg: ModelConfig, blocks: list, devs: list, lead):
        self.cfg, self.blocks, self.devs, self.lead = cfg, blocks, devs, \
            lead
        self.kinds = layer_kinds(cfg)

    def __len__(self):
        return len(self.blocks)

    def __getitem__(self, layer: int) -> dict:
        return _layer_view(self.cfg, self.kinds[layer], self.blocks[layer],
                           self.devs, self.lead)


def _head_parts(params: dict, h: torch.Tensor, devs: list) -> list:
    """The LM head (``_head`` :310) vocabulary-parallel (``constrain(...,
    "logits")``): model shard ``j`` multiplies by its block of the
    vocabulary, the tied ``embed``'s rows or the untied ``unembed``'s
    columns, gathered over fsdp; f32 logits [B, S, V / n] each on its
    device.  One block, whole, where the vocabulary does not divide."""
    n = len(devs)
    w = params.get("unembed", params["embed"])
    vdim = 1 if "unembed" in params else 0
    if w.shape[vdim] % n:
        devs, n = devs[:1], 1
    out = []
    for j, (dev, (hj, h32)) in enumerate(zip(devs,
                                             m.column_inputs(h, devs))):
        wj = _take(w, dev, vdim, j, n)
        col = m.ColumnShard(wj if vdim else wj.t(), hj, h32)
        out.append(m.matmul(hj, col).to(F32))
    return out


def sharded_loss(cfg: ModelConfig, params: dict, rows: list,
                 grid: list) -> torch.Tensor:
    """The training loss of ``forward_train`` + ``loss_fn`` on a mesh
    (the reference's ``jax.jit(step, in_shardings=...)`` under
    ``mesh_context``), one controller driving every shard.

    ``params`` is a tree of ``sharding.Sharded`` leaves (placed by
    ``param_shardings``; autograd leaves as owner blocks); ``rows[k]`` the
    batch rows of data group ``k`` on its lead device; ``grid[k]`` that
    group's devices by model shard.  Each group embeds its rows (the
    embedding gathered whole), runs the layers with each layer's weights
    gathered over fsdp where it uses them, the TP sites once a model
    shard and the partial outputs summed (``psum``), so the residual is
    whole on the group's lead device, then the vocabulary-parallel head
    and loss.  The cycles are not recomputed in the backward pass: each
    layer's gathered weights (in their bf16 casts) stay for it.  The masked sums of every group add in group order on group
    0's lead device, over the global mask count: the mean over all rows.
    An MoE config runs one group (``train_step``), so that its dispatch
    groups, capacity and aux losses are the reference's."""
    lead0 = grid[0][0]
    terms, aux = [], None
    for devs, batch in zip(grid, rows):
        lead = devs[0]
        h = embed_inputs(cfg, {"embed": params["embed"].gather(lead)},
                         batch.get("tokens"),
                         patch_embeds=batch.get("patch_embeds"),
                         frame_embeds=batch.get("frame_embeds"))
        view = {"blocks": _LayerViews(cfg, params["blocks"], devs, lead)}
        # no remat of the cycles: autograd runs each card's backward on a
        # thread of its own, and a checkpointed cycle spanning cards
        # recomputed out of order on four (its saved tensors mismatched)
        h, _, aux = _layers(cfg, view, h, collect_cache=False, remat=False)
        h = m.rms_norm(h, params["final_norm"].gather(lead), cfg.norm_eps)
        terms.append(vocab_parallel_sums(
            cfg, _head_parts(params, h, devs), batch, lead))
    from .sharding import psum
    nll, z, count = (psum([t[i] for t in terms], lead0) for i in range(3))
    denom = torch.clamp_min(count, 1.0)
    total = nll / denom + 1e-4 * z / denom
    return _with_aux(total, aux)


# ------------------------------------- prefill and decode on a mesh
def _groups(mesh) -> list:
    """``(coords, devices)`` of each data group of a training mesh
    (``train_grid``): its mesh coordinates and devices by model shard."""
    from repro_torch.launch.mesh import train_grid
    return [(row, [mesh.devices[c] for c in row]) for row in train_grid(mesh)]


def _split_rows(leaf) -> bool:
    """Whether a placed batch leaf's rows split over the data groups."""
    return leaf.spec[0] is not None if leaf.spec else False


def _group_rows(cfg: ModelConfig, mesh, batch: dict) -> list:
    """``(coords, devices, rows)`` of each data group that runs: ``rows``
    its block of each placed batch leaf (the batch's rows of the group,
    every row where they do not split) on its lead device, and ``"rows"``
    their ``(start, count)``.  An MoE config runs one group on every row,
    gathered on its lead (``train_step.grads``)."""
    groups = _groups(mesh)
    if cfg.num_experts:
        coords, devs = groups[0]
        out = {k: v.gather(devs[0]) if v.ndim and _split_rows(v)
               else v.blocks[coords[0]] for k, v in batch.items()}
        n = next(v.shape[0] for v in batch.values() if v.ndim)
        return [(coords, devs, {**out, "rows": (0, n)})]
    out = []
    for coords, devs in groups:
        b = {k: v.blocks[coords[0]] for k, v in batch.items()}
        first = next(k for k, v in batch.items() if v.ndim)
        rows = batch[first].slices(coords[0])[0]
        out.append((coords, devs, {**b, "rows": rows}))
    return out


def sharded_prefill(cfg: ModelConfig, params: dict, batch: dict, mesh):
    """The reference's prefill cell (``prefill`` :844 under
    ``jax.jit(..., in_shardings=param_shardings)``, ``specs.py:153-166``)
    on a training mesh, one controller driving every shard: each data
    group embeds its rows of ``batch`` (``batch_shardings``; every group
    the whole batch where its rows do not split, as a replicated batch
    runs; an MoE config one group on every row, ``_group_rows``), runs the layers as ``sharded_loss`` does (each layer's weights
    gathered over fsdp where it runs, the TP sites over the model shards,
    ``tp_site``), and takes the vocabulary-parallel head at the last
    position.  Returns ``(logits [B, 1, V] f32`` on the mesh's first
    device, ``caches)``: ``caches[g][layer]`` data group ``g``'s cache of
    the layer where it was made, a dict on the group's lead device (a site
    run whole) or the model shards' list of dicts (a split site: KV heads
    or RG-LRU channels), kept there (``gather_prefill_caches``)."""
    from .sharding import all_gather
    logits, caches = [], []
    for coords, devs, b in _group_rows(cfg, mesh, batch):
        lead = devs[0]
        h = embed_inputs(cfg, {"embed": params["embed"].gather(lead)},
                         b.get("tokens"), patch_embeds=b.get("patch_embeds"),
                         frame_embeds=b.get("frame_embeds"))
        view = {"blocks": _LayerViews(cfg, params["blocks"], devs, lead)}
        h, cache, _ = _layers(cfg, view, h, remat=False)
        h = m.rms_norm(h[:, -1:], params["final_norm"].gather(lead),
                       cfg.norm_eps)
        logits.append(all_gather(_head_parts(params, h, devs), -1, lead))
        caches.append(cache)
    if not _split_rows(next(iter(batch.values()))) or cfg.num_experts:
        logits = logits[:1]
    return all_gather(logits, 0, mesh.devices.flat[0]), caches


def gather_prefill_caches(caches: list, device, split: bool = True) -> list:
    """``sharded_prefill``'s caches as one device's (``prefill``): each
    layer's model shards joined along the KV heads or the RG-LRU channels
    and the data groups along the batch (group 0's alone where the rows
    do not split, ``split`` False), on ``device``."""
    groups = caches if split and len(caches) > 1 else caches[:1]
    out = []
    for layer in range(len(groups[0])):
        parts = []
        for g in groups:
            c = g[layer]
            if isinstance(c, list):
                c = {f: torch.cat([s[f].to(device) for s in c],
                                  dim=-1 if f in ("h", "conv") else 2)
                     for f in c[0]}
            parts.append({f: t.to(device) for f, t in c.items()})
        out.append({f: torch.cat([c[f] for c in parts], 0)
                    for f in parts[0]})
    return out


def _rows_of(leaf, idx: tuple) -> tuple:
    return leaf.slices(idx)[0]


def _meets(span: tuple, rows: tuple) -> bool:
    return span[0] < rows[0] + rows[1] and rows[0] < span[0] + span[1]


def _group_whole(leaf, coords: list, lead, rows: tuple) -> torch.Tensor:
    """A data group's rows ``rows`` = ``(start, count)`` of a placed cache
    leaf, whole on ``lead``: the blocks that hold those rows, a replica on
    the group's own devices where there is one, gathered there
    (``all_gather``), and the rows cut out."""
    from .sharding import _assemble, books
    mine = {leaf.owner_of(c): c for c in reversed(coords)}
    pieces = {}
    for o in leaf.owners:
        if _meets(_rows_of(leaf, o), rows):
            pieces[tuple(s for s, _ in leaf.slices(o))] = \
                leaf.blocks[mine.get(o, o)]
    whole = books("all-gather")(_assemble)(pieces, lead)
    r0 = min(s[0] for s in pieces)
    if whole.shape[0] != rows[1]:
        whole = whole.narrow(0, rows[0] - r0, rows[1])
    return whole


def _write_rows(leaf, new: torch.Tensor, rows: tuple) -> None:
    """Write rows ``rows`` of a cache leaf (``new``: those rows, whole in
    every other dimension) into every block that holds them, replicas
    included, each its part (copies, ``scatter``); a block that is
    ``new`` itself is left as it is."""
    from .sharding import books

    @books("scatter")
    def write():
        done = set()
        for idx in np.ndindex(*leaf.mesh.devices.shape):
            blk = leaf.blocks[idx]
            sl = leaf.slices(idx)
            if id(blk) in done or blk is new or not _meets(sl[0], rows):
                continue
            done.add(id(blk))
            lo = max(sl[0][0], rows[0])
            hi = min(sl[0][0] + sl[0][1], rows[0] + rows[1])
            dst = blk.narrow(0, lo - sl[0][0], hi - lo)
            src = new.narrow(0, lo - rows[0], hi - lo)
            for d in range(1, new.dim()):
                src = src.narrow(d, sl[d][0], sl[d][1])
            dst.copy_(src)
    write()


def _split_k_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       cache: dict, coords: list, devs: list, lead,
                       pos: torch.Tensor, local: bool) -> torch.Tensor:
    """``attention_step`` over a cache whose positions split over the
    model shards (``cache_shardings``' split-K layout): the projections on
    the lead device, the new token's K/V written into the shard that holds
    its slot, each shard's softmax partials (``max``, ``sum``, weighted V)
    over its positions on its device, combined on the lead (``pmax``,
    ``psum``), then the output projection.  x [b, 1, D], pos [b]."""
    from .sharding import broadcast, pmax, psum
    b = x.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = m._qkv(p, x, cfg, pos[:, None])
    new = m.step_entries(k, v, cache)
    sc = cache["k"].shape[1]
    slot = pos % sc if local else pos
    qs = broadcast(q[:, 0].reshape(b, hkv, h // hkv, dh).to(F32), devs)
    parts = []
    for j, dev in enumerate(devs):
        blk = {f: c.blocks[coords[j]] for f, c in cache.items()}
        off, ln = cache["k"].slices(coords[j])[1]
        sj, pj = slot.to(dev), pos.to(dev)
        inside = (sj >= off) & (sj < off + ln)
        at = (sj - off).clamp(0, ln - 1)
        rows = torch.arange(b, device=dev)
        for f, val in new.items():
            cur = blk[f][rows, at]
            keep = inside.reshape(b, *([1] * (cur.dim() - 1)))
            blk[f][rows, at] = torch.where(keep, val.to(dev).to(cur.dtype),
                                           cur)
        if "k_scale" in blk:
            kc = m.kv_dequantize(blk["k"], blk["k_scale"])
            vc = m.kv_dequantize(blk["v"], blk["v_scale"])
        else:
            kc, vc = blk["k"].to(F32), blk["v"].to(F32)
        idx = (off + torch.arange(ln, device=dev))[None, :]
        s = m.step_scores(cfg, qs[j], kc, m.step_valid(idx, pj, sc, local))
        mx = s.amax(-1)
        e = torch.exp(s - mx[..., None])
        parts.append((mx, e.sum(-1), torch.einsum("bkgs,bskd->bkgd", e, vc)))
    mx = pmax([pt[0] for pt in parts], lead)
    w = [torch.exp(pt[0] - mx.to(pt[0].device)) for pt in parts]
    den = psum([pt[1] * wj for pt, wj in zip(parts, w)], lead)
    acc = psum([pt[2] * wj[..., None] for pt, wj in zip(parts, w)], lead)
    out = acc / den[..., None]
    return m.proj(out.reshape(b, 1, h, dh).to(x.dtype), p["wo"], 2)


def _decode_layout(cache: dict, n: int) -> str:
    """How a layer's placed decode cache splits over the ``n`` model
    shards (``cache_shardings``): ``heads``, ``sequence`` (split-K) or
    ``whole`` (neither, or a state)."""
    k = cache.get("k")
    if k is None or n == 1:
        return "whole"
    if _model_split(k, 2, n):
        return "heads"
    if _model_split(k, 1, n):
        return "sequence"
    return "whole"


def sharded_decode_step(cfg: ModelConfig, params: dict, caches: list,
                        tokens, pos, mesh):
    """The reference's decode cell (``decode_step`` :380 under
    ``jax.jit`` with ``param_shardings`` and ``cache_shardings``,
    ``specs.py:168-180``) on a training mesh, one controller driving
    every shard.  ``caches``: one dict a layer of ``Sharded`` leaves
    placed by ``cache_shardings``; ``tokens`` [B, 1] placed by
    ``batch_shardings``; ``pos`` a placed scalar (every row's position) or
    [B] placed as the batch.  Each data group takes its rows (every group
    the whole batch where they do not split) and runs the layers of
    ``decode_step`` with each layer's weights gathered where it runs:

    - an attention layer whose cache splits its KV heads over the model
      shards runs ``attention_step`` once a shard on its heads and cache
      block (``tp_site``);
    - one whose cache splits its positions runs split-K
      (``_split_k_attention``);
    - any other layout, and every RG-LRU, mLSTM and sLSTM state, runs
      whole on the group's lead device on the group's rows gathered there
      (``_group_whole``), written back to every block that holds them
      once every group has run (``_write_rows``: a group whose rows
      another's replicate reads the state from before the step);
    - the dense FFN over the model shards, the MoE whole on the lead; the
      vocabulary-parallel head.

    An MoE config runs every row in data group 0, as ``train_step``
    does, so that its dispatch groups and capacity are the reference's.
    The caches are written in place.  Returns ``(logits [B, 1, V] f32`` on
    the mesh's first device, ``caches)``."""
    from .sharding import all_gather
    check_decoder(cfg)
    kinds = layer_kinds(cfg)
    logits, writes = [], []
    for coords, devs, b_g in _group_rows(cfg, mesh,
                                         {"tokens": tokens, "pos": pos}):
        lead = devs[0]
        tok = b_g["tokens"]
        b = tok.shape[0]
        rows = b_g["rows"]
        p0 = b_g["pos"]
        pos_g = p0.expand(b) if p0.dim() == 0 else p0
        h = _embed_tokens(cfg, {"embed": params["embed"].gather(lead)}, tok)
        hx = None
        for layer, kind in enumerate(kinds):
            cache = caches[layer]
            # an MoE config's one group holds every row: its caches whole
            layout = ("whole" if cfg.num_experts
                      else _decode_layout(cache, len(devs)))
            sites = {"mlp", "attention"} if layout == "heads" else {"mlp"}
            p = _layer_view(cfg, kind, params["blocks"][layer], devs, lead,
                            sites)
            hn = _norm1(cfg, p, h, hx if reads_unrounded(cfg, layer)
                        else None)
            local = kind == "local"
            if layout == "heads" and isinstance(p["inner"], m.ModelShards):
                inner, _ = m.tp_site(
                    m.attention_step, p["inner"], hn, cfg, local=local,
                    shard_kw=[{"cache": {f: c.blocks[coords[j]]
                                         for f, c in cache.items()},
                               "pos": pos_g.to(devs[j])}
                              for j in range(len(devs))])
            elif layout == "sequence":
                inner = _split_k_attention(cfg, p["inner"], hn, cache,
                                           coords, devs, lead, pos_g, local)
            else:
                whole = {f: _group_whole(c, coords, lead, rows)
                         for f, c in cache.items()}
                if kind in ATTN_KINDS:
                    inner, new = m.attention_step(p["inner"], hn, whole,
                                                  pos_g, cfg, local=local)
                else:
                    step = {"recurrent": m.recurrent_step,
                            "mlstm": m.mlstm_step,
                            "slstm": m.slstm_step}[kind]
                    inner, new = step(p["inner"], hn, whole, cfg)
                writes += [(c, new[f], rows) for f, c in cache.items()]
            h, hx, _ = _ffn_tail(cfg, p, h, inner, hn)
        h = m.rms_norm(h, params["final_norm"].gather(lead), cfg.norm_eps)
        logits.append(all_gather(_head_parts(params, h, devs), -1, lead))
    for c, new, rows in writes:
        _write_rows(c, new, rows)
    if not _split_rows(tokens) or cfg.num_experts:
        logits = logits[:1]
    return all_gather(logits, 0, mesh.devices.flat[0]), caches


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
def init_state(cfg: ModelConfig, kind: str, batch: int, device) -> dict:
    """The empty decode state of a state layer (``_init_block_cache``
    :352): RG-LRU ``{"h", "conv"}``, mLSTM ``{"c", "n", "m"}`` or sLSTM
    ``{"c", "n", "m", "h"}``, the xLSTM stabilizers at -1e30."""
    init = {"recurrent": m.init_recurrent_cache,
            "mlstm": m.init_mlstm_cache, "slstm": m.init_slstm_cache}[kind]
    return init(cfg, batch, device)


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                      dtype, device) -> dict:
    if kind in ATTN_KINDS:
        return m.init_attention_cache(cfg, batch, seq_len, device, dtype,
                                      local=kind == "local")
    return init_state(cfg, kind, batch, device)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=BF16,
               device=None) -> list[dict]:
    """Zero dense decode cache, one dict per network layer (``init_cache``
    :366, ``_init_block_cache`` :352): ``seq_len`` positions for a global
    layer, the ring for a rolling one, the fixed state for a recurrent
    one."""
    check_decoder(cfg)
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
    state layer's state replaced."""
    hn = _norm1(cfg, p, h, hx)
    if kind in ATTN_KINDS:
        inner, cache = m.attention_step(p["inner"], hn, cache, pos, cfg,
                                        local=kind == "local")
    else:
        step = {"recurrent": m.recurrent_step, "mlstm": m.mlstm_step,
                "slstm": m.slstm_step}[kind]
        inner, cache = step(p["inner"], hn, cache, cfg)
    return (*_ffn_tail(cfg, p, h, inner, hn)[:2], cache)


def decode_step(cfg: ModelConfig, params: dict, caches: list,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One decode step against the dense cache (``decode_step`` :380).
    tokens [B, 1], pos [B] -> (logits [B, 1, V], caches), each attention
    layer's cache written in place at slot ``pos`` (``pos % ring`` for a
    rolling one)."""
    h = _embed_tokens(cfg, params, tokens)
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
    return (*_ffn_tail(cfg, p, h, inner, hn)[:2], new_kv)


# apack: hot-path-root(traced)
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
    h = _embed_tokens(cfg, params, tokens)
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
    return [None if kind in ATTN_KINDS else init_state(cfg, kind, batch, dev)
            for kind in layer_kinds(cfg)]


def device_append(planes, new_kv: dict, targets: dict) -> None:
    """On-device page append (``device_append`` :488), in place: scatter
    each active (attention layer, slot) new-token K/V into the HOT token
    planes at the (page, offset) slots claimed by
    ``PagedKVCache.claim_append_targets``.  Idle slots are not in
    ``targets`` (the host builds the index lists), so nothing is dropped
    on the device and no mask needs a host round trip.  ``planes`` may be
    a data shard's list of model shards' planes (``DevicePoolPlanes.
    shards[d]``), whose token planes hold a KV-head block each: each takes
    its block of the new K/V (:527-532), on its device."""
    if not new_kv:
        return
    shards = planes if isinstance(planes, list) else [planes]
    hl = shards[0]["tok_k"].shape[2]
    rows, pid, off = targets["row"], targets["pid"], targets["off"]
    for f, name in (("k", "tok_k"), ("v", "tok_v"), ("k_scale", "tok_sk"),
                    ("v_scale", "tok_sv")):
        x = new_kv[f]
        src = x.reshape(-1, *x.shape[2:])[rows]
        for j, pl in enumerate(shards):
            dev = pl[name].device
            part = src if len(shards) == 1 \
                else src[:, j * hl:(j + 1) * hl].to(dev)
            pl[name].index_put_((pid.to(dev), off.to(dev)), part)


# ------------------------------------------------ mesh-sharded decode step
def mesh_axis_sizes(mesh) -> tuple[int, int]:
    """(n_data, n_model) of a serving mesh (``mesh_axis_sizes`` :682);
    absent axes count as 1."""
    shape = dict(mesh.shape)
    return int(shape.get("data", 1)), int(shape.get("model", 1))


def packed_param_specs(params: dict, n_model: int) -> dict:
    """The param tree's specs for the mesh step (``packed_param_specs``
    :656): a dense leaf replicates (``()``); a ``PackedWeight`` gets the
    specs of its leaves in ``sharding.PACKED_LEAF_KINDS`` order, its
    stream planes K-split over "model" where the layout divides
    (``dm.k_splittable``: K unpadded, the K tiles dividing evenly), else
    replicated."""
    from . import sharding as shd

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [one(v) for v in x]
        if isinstance(x, m.PackedWeight):
            cw = x.cw
            return shd.packed_leaf_pspecs(
                [cw.sym_plane, cw.ofs_plane, cw.stored, cw.v_min, cw.ol,
                 cw.cum, cw.scale], splittable=dm.k_splittable(cw, n_model))
        return ()
    return one(params)


def _spread(t: torch.Tensor, devices: list) -> list:
    """``t`` on each of ``devices``, one copy a device (``t`` itself where
    it lies there already)."""
    on: dict = {}
    for dev in devices:
        if dev not in on:
            on[dev] = t.to(dev)
    return [on[dev] for dev in devices]


def _spread_cw(cw: dm.CompressedLinear, devices: list) -> list:
    """``cw`` on each of ``devices``, its tensors spread as ``_spread``
    does."""
    import dataclasses
    fields = {f.name: _spread(getattr(cw, f.name), devices)
              for f in dataclasses.fields(cw)
              if torch.is_tensor(getattr(cw, f.name))}
    return [dataclasses.replace(cw, **{k: v[i] for k, v in fields.items()})
            for i in range(len(devices))]


def shard_params(params: dict, grid: list) -> list[dict]:
    """Every data shard's params for the mesh step, ``grid`` the mesh's
    devices by [data shard][model shard]: dense leaves on each data
    shard's lead device (every model shard's replicated work runs once
    there); each ``PackedWeight`` K-split over the model shards where
    ``packed_param_specs`` splits it (``modules.ShardedPackedWeight``:
    ``dm.split_k`` once a weight, part ``j`` on model shard ``j``'s
    device, the whole weight kept only as its ``dm.Layout``), else whole
    on the lead devices.  A tensor goes to a device once and is shared by
    the data shards there, and left where it lies already, so a mesh on
    one card holds each weight once."""
    n_data, n_model = len(grid), len(grid[0])
    leads = [row[0] for row in grid]

    def one(x) -> list:             # the leaf of each data shard
        if isinstance(x, dict):
            kids = {k: one(v) for k, v in x.items()}
            return [{k: v[d] for k, v in kids.items()} for d in range(n_data)]
        if isinstance(x, list):
            kids = [one(v) for v in x]
            return [[v[d] for v in kids] for d in range(n_data)]
        if isinstance(x, m.PackedWeight):
            meta = (x.shape, x.n_contract, x.dtype)
            if not any("model" in spec
                       for spec in packed_param_specs(x, n_model)):
                return [m.PackedWeight(cw, *meta)
                        for cw in _spread_cw(x.cw, leads)]
            parts = [_spread_cw(p, [row[j] for row in grid])
                     for j, p in enumerate(dm.split_k(x.cw, n_model))]
            layout = dm.Layout.of(x.cw)
            return [m.ShardedPackedWeight(layout, *meta,
                                          [parts[j][d]
                                           for j in range(n_model)])
                    for d in range(n_data)]
        if torch.is_tensor(x):
            return _spread(x, leads)
        return [x] * n_data
    return one(params)


def build_sharded_step(cfg: ModelConfig, mesh, *, params: dict):
    """The mesh-sharded fused decode step (``build_sharded_step`` :750):
    decode, on-device append and argmax over every data shard.

    Jobs are data-parallel over "data": each data shard decodes its slots'
    rows against its own page range and state store, on its lead device
    (``shard_params``: the projections, norms, FFN and head, which the
    reference computes alike on every model shard, run once a data
    shard).  The model axis fans out at the two sharded sites only, each
    followed at once by its collective: kernel 3 once a model shard on its
    KV-head block, then ``all_gather`` of ``(acc, m, l)`` in head order
    (``modules.paged_attention_step``); and kernel 5 once a model shard on
    its K-tile range, then ``psum`` of the partials in shard order
    (``modules.ShardedPackedWeight``).

    Returns ``step(planes, states, metas, tokens, pos, targets) -> (toks,
    logits, planes', states')``, every argument a list by data shard:
    ``planes`` ``DevicePoolPlanes.shards``, ``states`` the shards' state
    stores, ``metas``/``targets`` from ``PagedKVCache.step_meta_sharded``/
    ``claim_append_targets_sharded`` (claimed before the step, as the
    reference claims them: a freshly claimed page is HOT with no token, so
    every key slot it covers is masked), tokens [B/n, 1] and positions
    [B/n] on each lead device.  ``toks`` is every slot's greedy token,
    gathered onto data shard 0's lead device for the step's one pull;
    ``logits`` the shards' [B/n, 1, V].  ``step.params`` holds the shards'
    params."""
    from repro_torch.launch.mesh import device_grid
    from .sharding import all_gather
    n_data, n_model = mesh_axis_sizes(mesh)
    if n_model > 1 and cfg.num_kv_heads % n_model:
        raise ValueError(
            f"num_kv_heads={cfg.num_kv_heads} must divide over the "
            f"{n_model}-way model axis for tensor-parallel paged decode")
    grid = device_grid(mesh)
    sharded = shard_params(params, grid)

    def step(planes, states, metas, tokens, pos, targets):
        toks, logits = [], []
        for d in range(n_data):
            lg, new_kv, states[d] = decode_step_paged(
                cfg, sharded[d], planes[d], metas[d], states[d], tokens[d],
                pos[d])
            device_append(planes[d], new_kv, targets[d])
            toks.append(lg[:, 0].argmax(dim=-1))
            logits.append(lg)
        return all_gather(toks, 0, grid[0][0]), logits, planes, states

    step.params = sharded
    return step


# ------------------------------------------------------- paged APack KV
def _pack_bytes(tree: dict):
    """The arrays or tensors of ``tree`` (sorted keys) as one flat uint8
    buffer of the same kind, each part padded to 8 bytes."""
    parts = []
    for k in sorted(tree):
        x = tree[k]
        if isinstance(x, np.ndarray):
            b = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
            parts += [b, np.zeros(-b.size % 8, np.uint8)]
        else:
            b = x.contiguous().reshape(-1).view(torch.uint8)
            parts += [b, b.new_zeros(-b.numel() % 8)]
    if parts and isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)
    return torch.cat(parts)


def _unpack_bytes(like: dict, buf):
    """Split a ``_pack_bytes`` buffer back into ``like``'s shapes and dtypes
    (numpy arrays from a numpy buffer, tensors from a tensor).  Returns
    ``(tree, bytes)``."""
    out, off = {}, 0
    for k in sorted(like):
        x = like[k]
        if isinstance(x, np.ndarray):
            nb, shape = x.nbytes, x.shape
            tdt = torch.from_numpy(np.zeros(0, x.dtype)).dtype
            ndt = x.dtype
        else:
            nb, shape = x.numel() * x.element_size(), tuple(x.shape)
            tdt = x.dtype
            ndt = torch.zeros(0, dtype=x.dtype).numpy().dtype
        part = buf[off:off + nb]
        out[k] = (part.view(ndt).reshape(shape) if isinstance(buf, np.ndarray)
                  else part.view(tdt).reshape(shape))
        off += nb + (-nb % 8)
    return out, off


def _plane_tree(planes, page_scale) -> dict:
    """A batch of pages' planes (sym, ofs, sym_bits, ofs_bits, stored, each
    [2, n, ...]) and page scales [2, n, H] to pull for their checksums,
    under the PACKED payload's keys."""
    return {f"crc/{key}": t for (key, _, _), t in
            zip(m.SPILL_FIELDS[m.PAGE_PACKED], (*planes, page_scale))}


def _page_crc(pulled: dict, i: int) -> int:
    """``payload_crc`` of page ``i`` of a pulled ``_plane_tree``, over the
    JAX package's keys and dtypes (``_plane_crc`` :1559)."""
    return m.payload_crc(m.payload_of(m.PAGE_PACKED, pulled, i, "crc/"))


class DevicePoolPlanes:
    """The fused kernel's view of the pool: kind-split views of the pool's
    device payload tensors plus the stacked activation tables
    (``DevicePoolPlanes`` :867).  The views share storage with the pool, so
    an append or a pack is visible without a sync step.

    Under a mesh, ``shards[d][j]`` is that view of data shard ``d``'s page
    range on model shard ``j`` (``sharding.plane_pspecs``: its KV-head
    block of the dense planes, whole PACKED planes, replicated tables, one
    table copy a device); ``planes`` is ``shards[0][0]``, the whole pool
    without one."""

    def __init__(self, pool: m.KVPagePool, n_tables: int):
        self.n_tables = n_tables
        self.tables: dict = {}          # device -> {vm, ol, cum}
        # the views' keys into ``tables``: the pool's devices, not their
        # tensors' (a device may be named in more than one way)
        self.devices = pool.devices
        self.shards = [[self._views(part, dev)
                        for part, dev in zip(pool.parts[s], pool.devices[s])]
                       for s in range(pool.n_shards)]
        self.planes: dict[str, torch.Tensor] = self.shards[0][0]

    def _table_planes(self, dev) -> dict:
        if dev not in self.tables:
            n = self.n_tables
            self.tables[dev] = {
                "vm": torch.zeros(n, 17, dtype=torch.int32, device=dev),
                "ol": torch.zeros(n, 16, dtype=torch.int32, device=dev),
                "cum": torch.zeros(n, 17, dtype=torch.int32, device=dev)}
        return self.tables[dev]

    def _views(self, part: dict, dev) -> dict:
        return {"tok_k": part["tok_q"][0], "tok_v": part["tok_q"][1],
                "tok_sk": part["tok_scale"][0], "tok_sv": part["tok_scale"][1],
                "cold_k": part["cold_q"][0], "cold_v": part["cold_q"][1],
                "pscale_k": part["page_scale"][0],
                "pscale_v": part["page_scale"][1],
                "sym_k": part["sym"][0], "sym_v": part["sym"][1],
                "ofs_k": part["ofs"][0], "ofs_v": part["ofs"][1],
                "stored_k": part["stored"][0], "stored_v": part["stored"][1],
                **self._table_planes(dev)}

    def ensure_table_capacity(self, n_rows: int) -> bool:
        """Grow the table planes to hold ``n_rows`` rows, doubling
        (``ensure_table_capacity`` :925): a refresh that adds a generation
        block past the capacity reallocates them, an event and never a
        step.  Returns True if reallocated; the caller then uploads every
        row."""
        if n_rows <= self.n_tables:
            return False
        cap = self.n_tables
        while cap < n_rows:
            cap *= 2
        self.n_tables = cap
        for dev, tabs in self.tables.items():
            for name, width in (("vm", 17), ("ol", 16), ("cum", 17)):
                tabs[name] = torch.zeros(cap, width, dtype=torch.int32,
                                         device=dev)
        for row, devs in zip(self.shards, self.devices):
            for pl, dev in zip(row, devs):
                pl.update(self.tables[dev])
        return True


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
    stay COLD and are packed the moment the table exists.  A refresh fits
    new tables to the pages sealed since, under a new generation, and
    re-packs the layer's pages in budgeted batches; a page decodes with the
    generation it was coded under until then.  A preempted request's pages
    can be parked in the host spill tier (``spill_request``) and read back,
    CRC-checked (``unspill_request``).  Reads go through the fused
    gather-decode attention kernel; ``traffic`` counts what they would move
    off-chip, compressed vs dense int8, per stream kind, and the re-pack,
    spill and readahead streams apart."""

    def __init__(self, cfg: ModelConfig, num_pages: int, *,
                 page_size: int = 16, calib_pages: int = 4,
                 elems_per_stream: int = 128,
                 refresh_every_pages: int | None = None,
                 refresh_threshold: float = 0.15,
                 refresh_min_pages: int = 4,
                 verify_on_repack: bool = False,
                 transfer_retries: int = 2,
                 drift_sketch: bool = True, device=None, mesh=None):
        check_decoder(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.page_size = page_size
        self.calib_pages = calib_pages
        # table refresh (``__init__`` :998-1008): a layer's tables refresh
        # when its drift sketch's expected coded size regresses
        # ``refresh_threshold`` past the calibration-time expectation, or
        # every ``refresh_every_pages`` sealed pages, once
        # ``refresh_min_pages`` pages of sketch exist; checked only when
        # ``maybe_refresh``/``refresh_step`` is called.  ``drift_sketch``:
        # whether the pages sealed after calibration feed the sketch (their
        # histograms ride the pack's pull); the engine turns it on with
        # ``kv_refresh``.
        self.refresh_every_pages = refresh_every_pages
        self.refresh_threshold = refresh_threshold
        self.refresh_min_pages = refresh_min_pages
        self.drift_sketch = drift_sketch
        self.layer_kinds = layer_kinds(cfg)
        self.n_layers = len(self.layer_kinds)
        self.attn_layers = [i for i, k in enumerate(self.layer_kinds)
                            if k in ATTN_KINDS]
        self.local_layers = [i for i, k in enumerate(self.layer_kinds)
                             if k == "local"]
        self.state_layers = [i for i, k in enumerate(self.layer_kinds)
                             if k in STATE_KINDS]
        self.window = cfg.window_size
        # under a mesh each data shard owns a contiguous page range
        self.n_shards = 1 if mesh is None else mesh_axis_sizes(mesh)[0]
        self.pool = m.KVPagePool(num_pages, page_size, cfg.num_kv_heads,
                                 cfg.head_dim, elems_per_stream,
                                 device=device, n_shards=self.n_shards,
                                 mesh=mesh)
        # the controller's device: the whole pool's, or data shard 0's lead
        # device under a mesh
        self.device = self.pool.device
        # mesh-sharded serving (``__init__`` :1024-1030): every request is
        # bound to one data shard's page range at admission, and its pages
        # come from that shard's free list only
        self.request_shard: dict[int, int] = {}
        self.tables: list[list] = [[None, None] for _ in range(self.n_layers)]
        self.hists = np.zeros((self.n_layers, 2, 256), np.int64)
        self.hist_pages = np.zeros((self.n_layers, 2), np.int32)
        self._cold: list[set[int]] = [set() for _ in range(self.n_layers)]
        self._packed: list[set[int]] = [set() for _ in range(self.n_layers)]
        self._table_stack = None
        # generation-versioned tables: ``tables`` is the current generation,
        # each refresh snapshots the previous set, and a PACKED page decodes
        # with the generation it was coded under (``page_gen``) through the
        # compacted row-block map ``gen_rows``
        self.generation = 0
        self._gen_snapshots: list[list[list]] = []
        self.gen_rows: dict[int, int] = {0: 0}
        self.table_gen = np.zeros(self.n_layers, np.int32)
        self.page_gen = np.zeros(num_pages, np.int32)
        # a PACKED page's plane checksum (stamped where its planes reach
        # the host: a pack with ``verify_on_repack``, a re-pack, an unspill)
        # and the read clock of its last read, the cold-first spill key
        self.page_crc = np.zeros(num_pages, np.uint32)
        self.page_last_read = np.zeros(num_pages, np.int64)
        self._read_clock = 0
        self.verify_on_repack = verify_on_repack
        # host spill tier: pages of preempted requests parked off-pool; a
        # page-table entry ``-handle - 1`` is SPILLED
        self.spill_tier = m.HostSpillTier()
        # fault injection (``serve/faults.py``) and bounded transfer retry
        self.faults = None
        self.transfer_retries = transfer_retries
        # drift monitor: per-(layer, K/V) histogram of pages sealed since the
        # layer's last (re)calibration, and the bits per value its current
        # table promised on the histogram it was fitted to
        self.drift_hists = np.zeros((self.n_layers, 2, 256), np.int64)
        self.drift_pages = np.zeros(self.n_layers, np.int32)
        self.calib_bits = np.zeros((self.n_layers, 2), np.float64)
        self._drift_changed: set[int] = set()
        self._repack_queue: deque[tuple[int, int]] = deque()
        self.page_tables: dict[int, list[list[int]]] = {}
        self.page_base: dict[int, list[int]] = {}     # evicted-page count
        # rid -> {state layer -> its state dict} (device tensors, no batch)
        self.states: dict[int, dict[int, dict]] = {}
        self.seq_len: dict[int, int] = {}
        self.traffic = {"kv_raw_bytes": 0, "kv_read_bytes": 0,
                        "kv_table_bytes": 0, "kv_pages_packed": 0,
                        "kv_raw_bytes_global": 0, "kv_read_bytes_global": 0,
                        "kv_raw_bytes_local": 0, "kv_read_bytes_local": 0,
                        "state_raw_bytes": 0, "state_snapshot_bytes": 0,
                        "state_snapshots": 0,
                        # re-pack, spill and readahead: streams of their own,
                        # never folded into the attention-read ratios
                        "kv_repack_read_bytes": 0, "kv_repack_write_bytes": 0,
                        "kv_repack_pages": 0, "kv_repack_kept": 0,
                        "kv_refresh_count": 0,
                        "kv_spill_bytes": 0, "kv_spill_raw_bytes": 0,
                        "kv_spill_pages": 0, "kv_spill_calls": 0,
                        "kv_readahead_bytes": 0, "kv_readahead_pages": 0,
                        "kv_readahead_calls": 0,
                        "kv_integrity_failures": 0, "kv_quarantined_pages": 0,
                        "kv_transfer_drops": 0, "kv_transfer_retries": 0}
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
        out["repack"] = {
            "read_bytes": self.traffic["kv_repack_read_bytes"],
            "write_bytes": self.traffic["kv_repack_write_bytes"],
            "pages": self.traffic["kv_repack_pages"],
            "kept": self.traffic["kv_repack_kept"],
            "refreshes": self.traffic["kv_refresh_count"],
            "generation": self.generation,
            "pending": len(self._repack_queue)}
        sp, spraw = (self.traffic["kv_spill_bytes"],
                     self.traffic["kv_spill_raw_bytes"])
        out["spill"] = {
            "spill_bytes": sp, "raw_bytes": spraw,
            "ratio": (sp / spraw) if spraw else None,
            "pages": self.traffic["kv_spill_pages"],
            "calls": self.traffic["kv_spill_calls"],
            "readahead_bytes": self.traffic["kv_readahead_bytes"],
            "readahead_pages": self.traffic["kv_readahead_pages"],
            "readahead_calls": self.traffic["kv_readahead_calls"],
            "live_records": self.spill_tier.live_count,
            "live_bytes": self.spill_tier.live_bytes,
            "integrity_failures": self.traffic["kv_integrity_failures"],
            "quarantined": self.traffic["kv_quarantined_pages"]}
        return out


    # -------------------------------------------------------- transfers
    def _transfer_guard(self, direction: str) -> None:
        """Fault-injection hook on the host<->device boundary
        (``_transfer_guard`` :2039): a dropped transfer is retried up to
        ``transfer_retries`` times, each drop and retry counted, before the
        failure propagates."""
        if self.faults is None:
            return
        for attempt in range(self.transfer_retries + 1):
            try:
                self.faults.check_transfer(direction)
                if attempt:
                    self.traffic["kv_transfer_retries"] += attempt
                return
            except m.TransferDropped:
                self.traffic["kv_transfer_drops"] += 1
                if attempt == self.transfer_retries:
                    raise

    # apack: allow-transfer(sole accounted d2h funnel: every pull of the
    # serving path (the async step's tokens, seal bit counts, re-pack verdicts,
    # spills, prefill first tokens) rides this wrapper and counts in
    # transfers['d2h_calls'])
    def _fetch(self, t):
        """Device -> host with accounting, one call: a tensor comes back as
        a numpy array, a dict of tensors as a dict of arrays, moved as one
        byte buffer (``_fetch`` :2058)."""
        self._transfer_guard("d2h")
        if isinstance(t, torch.Tensor):
            out = t.cpu().numpy()
            nb = out.nbytes
        else:
            out, nb = _unpack_bytes(t, _pack_bytes(t).cpu().numpy())
        self.transfers["d2h_calls"] += 1
        self.transfers["d2h_bytes"] += nb
        return out

    def _put(self, arr):
        """Host -> device with accounting, one call: a numpy array, or a
        dict of them moved as one byte buffer, from pinned memory without
        a stream wait either way (``_put`` :2070)."""
        self._transfer_guard("h2d")
        self._count_put(arr)
        if isinstance(arr, np.ndarray):
            return m.to_device(arr, self.device)
        host = torch.from_numpy(_pack_bytes(arr))
        if self.device.type == "cuda":
            host = host.pin_memory()
        out, _ = _unpack_bytes(arr, host.to(self.device, non_blocking=True))
        return out

    def _put_to(self, arr: np.ndarray, device) -> torch.Tensor:
        """``_put`` of one array to ``device`` (a data shard's lead
        device)."""
        self._transfer_guard("h2d")
        self._count_put(arr)
        return m.to_device(arr, device)

    def _count_put(self, arr) -> None:
        """Account an upload that a kernel wrapper makes itself."""
        self.transfers["h2d_calls"] += 1
        self.transfers["h2d_bytes"] += (
            arr.nbytes if isinstance(arr, np.ndarray)
            else sum(a.nbytes for a in arr.values()))

    # ----------------------------------------------------------- requests
    def add_request(self, rid: int, shard: int = 0) -> None:
        """Start a request, bound to data shard ``shard``'s page range
        (``add_request`` :1212)."""
        if rid in self.page_tables:
            raise ValueError(f"duplicate request id {rid}")
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"(pool has {self.n_shards})")
        self.request_shard[rid] = shard
        self.page_tables[rid] = [[] for _ in range(self.n_layers)]
        self.page_base[rid] = [0] * self.n_layers
        self.states[rid] = {}
        self.seq_len[rid] = 0

    def release(self, rid: int) -> None:
        """Free a request's pages in layer and page order and drop its
        spilled records (``release`` :1224)."""
        freed = []
        for layer, pids in enumerate(self.page_tables.pop(rid)):
            for pid in pids:
                if pid < 0:                       # SPILLED: in the tier only
                    self.spill_tier.drop(-pid - 1)
                    continue
                self._cold[layer].discard(pid)
                self._packed[layer].discard(pid)
                freed.append(pid)
        self.page_gen[freed] = 0
        self.page_crc[freed] = 0
        self.page_last_read[freed] = 0
        self.pool.free(freed)
        del self.page_base[rid]
        del self.states[rid]
        del self.seq_len[rid]
        self.request_shard.pop(rid, None)

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
            shard = self.request_shard.get(rid, 0)
            pid = self.pool.alloc(shard)
            if pid is None:
                raise RuntimeError(
                    "page pool exhausted mid-flight (admission must reserve)"
                    if self.n_shards == 1 else
                    f"page shard {shard} exhausted mid-flight (admission "
                    "must reserve per shard)")
            pids.append(pid)
        if pids[-1] < 0:
            raise m.PageIntegrityError(
                f"append into SPILLED page of rid={rid} layer={layer} — "
                "readahead must restore the request before it decodes",
                rid=rid, layer=layer)
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
        sealed (or spilled: their record is dropped).  All of a call's
        pages return in one pool call, in layer and page order."""
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
                if pid < 0:
                    self.spill_tier.drop(-pid - 1)
                    continue
                self._cold[layer].discard(pid)
                self._packed[layer].discard(pid)
                self.page_gen[pid] = 0
                self.page_crc[pid] = 0
                gone.append(pid)
            del pids[:dead]
            self.page_base[rid][layer] = base + dead
        if gone:
            self.pool.evict(gone)

    def ingest_prefill(self, rid: int, caches: list, s: int) -> None:
        """Chop a batch-1 prefill cache (one dict per layer, positions
        ``[0, s)`` real) into pages on the device, in token order
        (``ingest_prefill`` :1398): the wrapper over the resumable chunk
        API (``prefill_host_view`` -> ``ingest_prefill_chunk`` ->
        ``finish_prefill``) that the async engine spreads over decode
        steps."""
        view = self.prefill_host_view(caches)
        self.ingest_prefill_chunk(rid, view, 0, s, s)
        self.finish_prefill(rid, view, s)

    def prefill_host_view(self, caches: list) -> dict:
        """One request's prefill cache as the chunked ingest reads it
        (``prefill_host_view`` :1417): an attention layer as ``(k, v,
        k_scale, v_scale)`` [S or window, H(, dh)], a recurrent layer as its
        field dict, the batch axis dropped.  The reference pulls the cache
        to the host here; the port's pool is the device store, so the view
        is the forward's device caches, held until the last chunk, and
        nothing moves."""
        view: dict = {}
        for layer in self.attn_layers:
            c = caches[layer]
            view[layer] = tuple(c[f][0] for f in ("k", "v", "k_scale",
                                                  "v_scale"))
        for layer in self.state_layers:
            view[layer] = {f: x[0] for f, x in caches[layer].items()}
        if self.attn_layers:
            # the attention layers' rows end to end, so that a chunk is
            # one gather a plane whatever the depth
            view["stacked"] = tuple(
                torch.cat([view[layer][i] for layer in self.attn_layers])
                for i in range(4))
        return view

    def ingest_prefill_chunk(self, rid: int, view: dict, t0: int, t1: int,
                             s: int, *, seal: bool = True) -> list:
        """Ingest prompt positions ``[t0, t1)`` of an ``s``-token prefill
        from ``view`` (``ingest_prefill_chunk`` :1440), all layers in one
        upload of host-computed indices and one copy a plane.  Resumable:
        pages, fills and seals come out as one monolithic call gives them.

        A rolling layer's view is the ring of its last ``window``
        positions: pages that have wholly rolled out are skipped
        (``page_base`` starts past them), and positions of the first kept
        page older than the window ingest as zeros, which count in the
        page's fill, seal scale and calibration histogram as in the
        reference.  Returns the ``(layer, pid)`` pages that filled, in the
        reference's seal order (layer-major, token order); they are sealed
        here unless ``seal`` is False, when the caller seals them later
        with ``_seal`` (the async engine, after its step's pull)."""
        ps = self.page_size
        pool = self.pool
        events = []
        live_dst, live_src, dead_dst = [], [], []
        n_src = 0            # the layer's first row in view["stacked"]
        for layer in self.attn_layers:
            k = view[layer][0]
            rows = k.shape[0]
            if self.layer_kinds[layer] == "local":
                first = max(0, s - rows) // ps      # ring width == window
                self.page_base[rid][layer] = first
                oldest = s - rows                   # older: zeros
            else:
                first, oldest = 0, 0
            lo = max(t0, first * ps)
            if lo < t1:
                for p in range(lo // ps, (t1 - 1) // ps + 1):
                    pid = self._claim_page(rid, layer, max(lo, p * ps))
                    a, b = max(lo, p * ps), min(t1, (p + 1) * ps)
                    t = np.arange(a, b)
                    dst = pid * ps + t % ps
                    live = t >= oldest
                    live_dst.append(dst[live])
                    live_src.append(n_src + t[live] % rows)
                    dead_dst.append(dst[~live])
                    pool.fill[pid] = min(ps, t1 - p * ps)
                    if b == (p + 1) * ps:
                        events.append((layer, pid))
            n_src += rows
        if live_dst or dead_dst:
            pool.write_tokens(
                self.request_shard.get(rid, 0),
                np.concatenate(live_dst or [np.zeros(0, np.int64)]),
                np.concatenate(live_src or [np.zeros(0, np.int64)]),
                np.concatenate(dead_dst or [np.zeros(0, np.int64)]),
                view["stacked"])
        if seal:
            self._seal(events)
        return events

    def finish_prefill(self, rid: int, view: dict, s: int) -> None:
        """Last-chunk bookkeeping (``finish_prefill`` :1468): store the
        recurrent layers' final states, stamp the sequence length, evict
        the rolled-out pages.  Runs after the chunks' seals."""
        for layer in self.state_layers:
            self.states[rid][layer] = dict(view[layer])
        self.seq_len[rid] = s
        self.evict_rolled(rid)

    # ------------------------------------------------- seal/calibrate/pack
    def _seal(self, events: list) -> None:
        """Full HOT pages -> COLD (one scale per (page, head)), then
        calibrate or pack (``_seal`` :1477).  ``events`` are the (layer,
        pid) seals in the JAX package's order; they run as one batch on the
        device, and the host replays the per-page calibration logic in that
        order, so each layer's tables come from exactly the pages the
        sequential reference would have seen.  A page sealed after its
        layer calibrated feeds the layer's drift sketch (with
        ``drift_sketch``): its histogram rides the pack's pull, or the
        calibration pull when the layer calibrated earlier in the batch."""
        if not events:
            return
        # HOT -> COLD where the pages lie (each model shard its heads)
        q2 = self.pool.seal([pid for _, pid in events])
        cal = [self.tables[layer][0] is not None for layer, _ in events]
        uncal = [i for i, c in enumerate(cal) if not c]
        sketch = ([i for i, c in enumerate(cal) if c]
                  if self.drift_sketch else [])

        def histograms(rows):
            u = quant.to_unsigned(q2[:, rows]).reshape(2, len(rows), -1)
            counts = torch.zeros(2, len(rows), 256, dtype=torch.int64,
                                 device=self.device)
            counts.scatter_add_(2, u.long(),
                                torch.ones_like(u, dtype=torch.int64))
            return counts
        hist = self._fetch(histograms(uncal)) if uncal else None
        to_pack, sketched = [], []
        row = {i: j for j, i in enumerate(uncal)}
        for i, (layer, pid) in enumerate(events):
            if self.tables[layer][0] is not None:
                to_pack.append((layer, pid))
                if self.drift_sketch:
                    sketched.append((i, layer))
                continue
            self._cold[layer].add(pid)
            for kind in (0, 1):
                self.hists[layer, kind] += hist[kind, row[i]]
                self.hist_pages[layer, kind] += 1
            if int(self.hist_pages[layer, 0]) >= self.calib_pages:
                for kind in (0, 1):
                    self.tables[layer][kind] = find_table(
                        self.hists[layer, kind], bits=8, is_activation=True)
                    self.calib_bits[layer, kind] = expected_bits_per_value(
                        self.hists[layer, kind], self.tables[layer][kind])
                # a late-calibrating layer installs into the current
                # generation
                self.table_gen[layer] = self.generation
                self._table_stack = None
                self._tables_dirty = True
                self.traffic["kv_table_bytes"] += 2 * TABLE_OVERHEAD_BITS // 8
                for cold_pid in sorted(self._cold[layer]):
                    to_pack.append((layer, cold_pid))
                self._cold[layer].clear()
        extra = self._pack(to_pack, histograms(sketch) if sketch else None)
        srow = {i: j for j, i in enumerate(sketch)}
        for i, layer in sketched:
            h = hist[:, row[i]] if i in row else extra[:, srow[i]]
            self.drift_hists[layer] += h
            self.drift_pages[layer] += 1
            self._drift_changed.add(layer)
        self._flush_tables()

    def _table_rows(self, rows: np.ndarray):
        """Upload the stacked tables' ``rows`` (any shape) in one call:
        ``(v_min, ol, cum)`` int32 [..., 17 | 16 | 17]."""
        vm, ol, cm = self._tables_stacked()
        tabs = self._put(np.concatenate([vm[rows], ol[rows], cm[rows]],
                                        axis=-1).astype(np.int32))
        return (tabs[..., :17].contiguous(), tabs[..., 17:33].contiguous(),
                tabs[..., 33:].contiguous())

    def _pack(self, items: list, extra=None):
        """COLD -> PACKED through the encode kernel, both kinds of every
        page in one launch, each with its layer's current table
        (``_pack`` :1531), and each page stamped with that table's
        generation.  The decode kernel then reads the new planes back and
        the pack raises unless they give the COLD payload, before it is
        scrubbed.  One pull brings back each page's coded bit count and
        that check, ``extra`` (an int64 device tensor, returned as a host
        array) and, with ``verify_on_repack``, the new planes, whose
        checksum becomes the page's ``page_crc``.

        Under a mesh each data shard packs its own pages on its lead
        device (``_pack`` :1323): their COLD head blocks gathered there,
        encoded and decode-checked once, the planes then written to every
        model shard of that data shard; the counts of all shards come back
        in the one pull."""
        if not items:
            return None
        pool = self.pool
        pids = [pid for _, pid in items]
        n, s, e = len(pids), pool.n_streams, pool.elems_per_stream
        rows = np.array([[self._row(int(self.table_gen[layer]), layer, kind)
                          for layer, _ in items] for kind in (0, 1)])
        vm_r, ol_r, cm_r = self._table_rows(rows)
        packs, bits_at, bad_at = [], [], []
        groups = pool.index(pids)
        for group in groups:
            shard, at, _ = group
            g_pids = pids if at is None else [pids[i] for i in at]
            dev = pool.lead(shard)
            ix = [group]
            vals = quant.to_unsigned(pool.read("cold_q", ix, dev)).reshape(
                2, len(g_pids), s, e)
            tabs = [(t if at is None else t[:, self.pool._idx(at)]).to(dev)
                    for t in (vm_r, ol_r, cm_r)]
            planes = apack_encode.encode(vals.contiguous(), *tabs,
                                         n_steps=e, bits=8)
            # lossless check before the COLD payload is scrubbed: decode
            # the new planes and count values that do not come back; the
            # count rides the same pull as the bit counts
            back = apack_decode.decode(planes[0], planes[1], planes[4],
                                       *tabs, n_steps=e, bits=8)
            bad_at.append((at, (back != vals).sum(dim=(0, 2, 3))))
            bits_at.append((at, planes[2].sum(dim=(0, 2), dtype=torch.int64)
                            + planes[3].sum(dim=(0, 2), dtype=torch.int64)))
            packs.append((at, g_pids, ix, planes))
        counts = [self._in_order(bits_at, n), self._in_order(bad_at, n)]
        if extra is not None:
            counts.append(extra.reshape(-1))
        tree = {"counts": torch.cat(counts)}
        if self.verify_on_repack:
            tree.update(_plane_tree(
                self._planes_in_order([(at, pl) for at, _, _, pl in packs],
                                      n),
                pool.read("page_scale", groups)))
        pulled = self._fetch(tree)
        c = pulled["counts"]
        bits, bad = c[:n], c[n:2 * n]
        if bad.any():
            raise RuntimeError(
                f"APack pack of pages {[p for p, b in zip(pids, bad) if b]}"
                " does not decode to its COLD payload")
        for at, g_pids, _, planes in packs:
            pool.pack(g_pids, planes, bits if at is None else bits[at])
        for i, (layer, pid) in enumerate(items):
            self._cold[layer].discard(pid)
            self._packed[layer].add(pid)
            self.page_gen[pid] = int(self.table_gen[layer])
            if self.verify_on_repack:
                self.page_crc[pid] = _page_crc(pulled, i)
        self.traffic["kv_pages_packed"] += n
        if extra is None:
            return None
        return c[2 * n:].reshape(extra.shape)

    def _in_order(self, parts: list, n: int, dim: int = 0) -> torch.Tensor:
        """Per-shard results ``(places, tensor)`` (``KVPagePool.index``'s
        groups), each with its pages along ``dim``, as one tensor with
        ``n`` pages in their order, on the controller's device."""
        if len(parts) == 1 and parts[0][0] is None:
            return parts[0][1].to(self.device)
        t0 = parts[0][1]
        shape = list(t0.shape)
        shape[dim] = n
        out = torch.empty(shape, dtype=t0.dtype, device=self.device)
        for at, t in parts:
            out.index_copy_(dim, self.pool._idx(at), t.to(self.device))
        return out

    def _planes_in_order(self, parts: list, n: int) -> tuple:
        """Per-shard planes ``(places, (sym, ofs, sym_bits, ofs_bits,
        stored))``, each [2, m, ...], as the batch's planes in page
        order."""
        return tuple(self._in_order([(at, pl[k]) for at, pl in parts], n, 1)
                     for k in range(5))

    def _plane_crc(self, pids: list) -> list[int]:
        """Checksums of PACKED pages' planes and page scales as they lie in
        the pool (``_plane_crc`` :1559), one pull for all of them."""
        p = self.pool
        ix = p.index(pids)
        pulled = self._fetch(_plane_tree(
            tuple(p.read(f, ix) for f in ("sym", "ofs", "sym_bits",
                                          "ofs_bits", "stored")),
            p.read("page_scale", ix)))
        return [_page_crc(pulled, i) for i in range(len(pids))]

    # ------------------------------------------------ generation-versioned
    @property
    def n_table_rows(self) -> int:
        """Rows of the stacked table pool: one ``2 * n_layers`` block per
        live generation (``n_table_rows`` :1571)."""
        return 2 * self.n_layers * (max(self.gen_rows.values()) + 1)

    def _row(self, gen: int, layer: int, kind: int) -> int:
        """Stacked-pool row of ``(gen, layer, kind)`` through the compacted
        ``gen_rows`` map (``_row`` :1577), the only way table ids reach the
        kernels."""
        return table_row(self.gen_rows[gen], layer, kind, self.n_layers)

    def _checked_gen(self, pid: int, rid, layer: int) -> int:
        """A page's table generation, validated against the live
        ``gen_rows`` map (``_checked_gen`` :1584): a poisoned generation
        fails its request with ``PageIntegrityError``."""
        gen = int(self.page_gen[pid])
        if gen not in self.gen_rows:
            self.traffic["kv_integrity_failures"] += 1
            raise m.PageIntegrityError(
                f"page {pid} of rid={rid} layer={layer} carries "
                f"poisoned table generation {gen} (live: "
                f"{sorted(self.gen_rows)}) — refusing to decode "
                "with an out-of-pool table row",
                rid=rid, layer=layer, pid=pid)
        return gen

    def _k_rows(self, pids, rid, layer: int) -> np.ndarray:
        """K rows (``_row(gen, layer, 0)``) of a request's pages, each
        generation checked as ``_checked_gen`` does, vectorized for the
        per-step paths."""
        gens = self.page_gen[np.asarray(pids, np.int64)].astype(np.int64)
        top = max(self.gen_rows)
        slot = np.full(top + 2, -1, np.int64)
        for g, r in self.gen_rows.items():
            slot[g] = r
        bad = (gens < 0) | (gens > top) | (slot[np.clip(gens, 0, top + 1)] < 0)
        if bad.any():
            self._checked_gen(int(np.asarray(pids)[bad.argmax()]), rid, layer)
        return (slot[gens] * self.n_layers + layer) * 2

    def _table_at(self, gen: int, layer: int, kind: int):
        """The table a page packed at generation ``gen`` was coded with
        (``_table_at`` :1604)."""
        if gen < len(self._gen_snapshots):
            return self._gen_snapshots[gen][layer][kind]
        return self.tables[layer][kind]

    def _live_generations(self) -> set[int]:
        """Generations that keep a row block (``_live_generations``
        :1610): 0, the current one, those of resident PACKED pages and
        those of spilled records."""
        live = {0, self.generation}
        for packed in self._packed:
            for pid in packed:
                live.add(int(self.page_gen[pid]))
        live |= {int(g) for g in self.spill_tier.live_gens()}
        return live

    def compact_table_rows(self) -> int:
        """Reclaim the row blocks of dead generations and renumber the live
        ones onto contiguous slots (``compact_table_rows`` :1624).  Returns
        the rows reclaimed; on a change the stack rebuilds and the device
        copy is uploaded again at the next flush."""
        live = self._live_generations()
        kept = sorted(g for g in self.gen_rows if g in live)
        new_rows = {g: i for i, g in enumerate(kept)}
        if new_rows == self.gen_rows:
            return 0
        reclaimed = 2 * self.n_layers * (
            max(self.gen_rows.values()) - max(new_rows.values()))
        self.gen_rows = new_rows
        self._table_stack = None
        self._tables_dirty = True
        return reclaimed

    def _tables_stacked(self):
        """np table arrays [n_live_gens * 2 * n_layers, ...], row
        ``_row(gen, layer, kind)`` (``_tables_stacked`` :1646): the current
        generation's block holds ``tables``, earlier live blocks the
        refresh snapshots (copy-forward).  Rows of uncalibrated and
        recurrent layers stay zero and are never referenced (PACKED
        requires a table)."""
        if self._table_stack is None:
            rows = self.n_table_rows
            vm = np.zeros((rows, 17), np.int32)
            ol = np.zeros((rows, 16), np.int32)
            cm = np.zeros((rows, 17), np.int32)
            for gen in self.gen_rows:
                for layer in range(self.n_layers):
                    for kind in (0, 1):
                        t = self._table_at(gen, layer, kind)
                        if t is not None:
                            r = self._row(gen, layer, kind)
                            vm[r], ol[r], cm[r] = t.as_arrays()
            self._table_stack = (vm, ol, cm)
        return self._table_stack

    # ------------------------------------------- table refresh / re-pack
    def drift_status(self, layer: int) -> dict | None:
        """Expected bits per value of the layer's drift sketch under its
        current tables against what they promised at calibration
        (``drift_status`` :1675); None until the layer is calibrated and
        ``refresh_min_pages`` pages of sketch exist."""
        if self.tables[layer][0] is None:
            return None
        pages = int(self.drift_pages[layer])
        if pages < self.refresh_min_pages:
            return None
        cur = [expected_bits_per_value(self.drift_hists[layer, k],
                                       self.tables[layer][k])
               for k in (0, 1)]
        regress = max(cur[k] / max(float(self.calib_bits[layer, k]), 1e-9)
                      for k in (0, 1))
        return {"pages": pages, "cur_bits": cur,
                "calib_bits": [float(b) for b in self.calib_bits[layer]],
                "regression": regress}

    def check_refresh(self) -> list[int]:
        """Layers whose refresh trigger fired, of those whose sketch moved
        since the last check (``check_refresh`` :1696)."""
        due = []
        for layer in sorted(self._drift_changed):
            st = self.drift_status(layer)
            if st is None:
                continue
            if (self.refresh_every_pages is not None
                    and st["pages"] >= self.refresh_every_pages):
                due.append(layer)
            elif st["regression"] > 1.0 + self.refresh_threshold:
                due.append(layer)
        self._drift_changed.clear()
        return due

    def maybe_refresh(self) -> list[int]:
        """Re-calibrate every due layer under one generation bump
        (``maybe_refresh`` :1717).  Returns the refreshed layers."""
        due = self.check_refresh()
        if due:
            self._refresh(due)
        return due

    def _refresh(self, layers: list[int]) -> None:
        """Snapshot the current tables as generation G (copy-forward), bump
        to G + 1, fit new tables to the due layers' drift sketches and
        queue their PACKED pages, newest first, for re-pack (``_refresh``
        :1725).  Old pages keep decoding through their generation's rows
        until the re-pack swaps them."""
        self._gen_snapshots.append([list(t) for t in self.tables])
        self.generation += 1
        self.gen_rows[self.generation] = max(self.gen_rows.values()) + 1
        for layer in layers:
            for kind in (0, 1):
                self.tables[layer][kind] = find_table(
                    self.drift_hists[layer, kind], bits=8,
                    is_activation=True)
                self.calib_bits[layer, kind] = expected_bits_per_value(
                    self.drift_hists[layer, kind], self.tables[layer][kind])
            self.table_gen[layer] = self.generation
            self.drift_hists[layer] = 0
            self.drift_pages[layer] = 0
            self.traffic["kv_table_bytes"] += 2 * TABLE_OVERHEAD_BITS // 8
            self.traffic["kv_refresh_count"] += 1
            for pid in sorted(self._packed[layer], reverse=True):
                self._repack_queue.append((layer, pid))
        self._table_stack = None
        self._tables_dirty = True
        self.compact_table_rows()

    def repack_pending(self, budget: int | None = None, *,
                       force: bool = False) -> int:
        """Re-code up to ``budget`` queued stale pages (all when None) under
        their layer's current tables (``repack_pending`` :1767), skipping
        pages freed or already current since they were queued.  Returns
        the pages processed (swapped + kept by the size gate).  Each batch
        is one launch of the decode kernel and one of the encode kernel
        (``launch_repack``) and one pull (``finish_repack``)."""
        done = 0
        while budget is None or done < budget:
            job = self.launch_repack(None if budget is None
                                     else budget - done, force=force)
            if job is None:
                break
            done += self.finish_repack(job, self._fetch(job["pull"]))
        return done

    def _verify_before_repack(self, items: list):
        """``verify_on_repack``: hold each page's planes against its
        checksum before the re-pack decodes them (``_repack`` :1804).
        Returns the items before the first failure, the failing item (or
        None) and the items after it."""
        crcs = self._plane_crc([pid for _, pid in items])
        for i, ((layer, pid), crc) in enumerate(zip(items, crcs)):
            if int(self.page_crc[pid]) != crc:
                return items[:i], items[i], items[i + 1:]
        return items, None, []

    def launch_repack(self, budget: int | None = None, *,
                      force: bool = False) -> dict | None:
        """Take the next batch of queued stale pages and queue its re-pack
        on the device: one decode launch with each page's own table rows
        (its generation's) and one encode launch with its layer's current
        tables, then the size gate (``_repack`` :1790) decided on the
        device: a page whose re-code is not smaller keeps its planes
        (unless ``force``).  Pages are independent, so the batch equals the
        reference's page-by-page sequence; the skips (freed, already
        current) are decided here on the host, and a page queued twice
        ends the batch, to be taken again by the next one.  Returns the job
        for ``finish_repack``, whose ``pull`` (device tensors) the caller
        brings back in one pull, or None when nothing is queued."""
        items, seen = [], set()
        while self._repack_queue and (budget is None or len(items) < budget):
            layer, pid = self._repack_queue[0]
            if pid in seen:
                break
            self._repack_queue.popleft()
            if pid not in self._packed[layer]:
                continue                      # freed/evicted since queued
            if int(self.page_gen[pid]) >= int(self.table_gen[layer]):
                continue                      # already current
            items.append((layer, pid))
            seen.add(pid)
        if not items:
            return None
        failed = None
        if self.verify_on_repack:
            # the reference re-packs page by page: the pages before a
            # corrupted one are re-packed, the ones after it stay queued
            items, failed, after = self._verify_before_repack(items)
            self._repack_queue.extendleft(reversed(after))
        job = self._launch_repack(items, force) if items else None
        if failed is not None:
            if job is not None:
                self.finish_repack(job, self._fetch(job["pull"]))
            self._corrupted(*failed)
        return job

    def _corrupted(self, layer: int, pid: int):
        """Raise for a PACKED page whose planes fail their checksum before
        a re-pack (``_repack`` :1804), counted and quarantined."""
        self.traffic["kv_integrity_failures"] += 1
        self.traffic["kv_quarantined_pages"] += 1
        raise m.PageIntegrityError(
            f"PACKED page {pid} (layer {layer}) failed checksum before "
            "re-pack — planes corrupted in place; owning request must "
            "be failed", rid=self._owner_of(pid), layer=layer, pid=pid)

    def _launch_repack(self, items: list, force: bool) -> dict:
        """Queue a re-pack batch on the device: under a mesh, each data
        shard re-packs its own pages on its lead device, one decode and one
        encode launch a shard (their planes read from the shard, the new
        ones written to every model shard of it), and the verdicts of all
        shards come back in page order in the one pull."""
        pool = self.pool
        pids = [pid for _, pid in items]
        n, e = len(pids), pool.elems_per_stream
        old = [int(self.page_gen[pid]) for pid in pids]
        new = [int(self.table_gen[layer]) for layer, _ in items]
        rows = np.array([[[self._row(g, layer, kind)
                           for g, (layer, _) in zip(gens, items)]
                          for kind in (0, 1)] for gens in (old, new)])
        tabs = self._table_rows(rows)                  # [2 old|new, 2, n]
        bits_at, swap_at, planes_at = [], [], []
        groups = pool.index(pids)
        for group in groups:
            shard, at, _ = group
            dev, ix = pool.lead(shard), [group]
            vm, ol, cm = ((t if at is None else t[:, :, pool._idx(at)])
                          .to(dev) for t in tabs)
            sym, ofs, st = (pool.read(f, ix, dev)
                            for f in ("sym", "ofs", "stored"))
            vals = apack_decode.decode(sym, ofs, st, vm[0], ol[0], cm[0],
                                       n_steps=e, bits=8)
            planes = apack_encode.encode(vals, vm[1], ol[1], cm[1],
                                         n_steps=e, bits=8)
            old_bits = (pool.read("sym_bits", ix, dev).sum(
                dim=(0, 2), dtype=torch.int64)
                + pool.read("ofs_bits", ix, dev).sum(dim=(0, 2),
                                                     dtype=torch.int64))
            new_bits = (planes[2].sum(dim=(0, 2), dtype=torch.int64)
                        + planes[3].sum(dim=(0, 2), dtype=torch.int64))
            swap = (torch.ones_like(new_bits, dtype=torch.bool) if force
                    else new_bits < old_bits)
            pool.repack(pids if at is None else [pids[i] for i in at],
                        planes, swap)
            bits_at.append((at, new_bits))
            swap_at.append((at, swap.long()))
            planes_at.append((at, planes))
        pull = {"repack": torch.stack([self._in_order(bits_at, n),
                                       self._in_order(swap_at, n)])}
        if self.verify_on_repack:
            pull.update(_plane_tree(self._planes_in_order(planes_at, n),
                                    pool.read("page_scale", groups)))
        return {"items": items, "gens": new, "pull": pull,
                "old_bytes": pool.page_bytes(np.asarray(pids, np.int64))}

    # apack: allow-transfer(budgeted re-pack event: host bookkeeping once the
    # step's pull is back; the job carries host arrays (items, generations, old
    # bytes) beside the device pull already fetched)
    def finish_repack(self, job: dict, pulled: dict) -> int:
        """Host half of a re-pack batch, once its pull is back: stamp the
        swapped pages' generation, bit count and (with
        ``verify_on_repack``) checksum, count the traffic, compact the
        table rows and upload them.  Returns the pages processed."""
        pool = self.pool
        new_bits, swap = pulled["repack"]
        for i, (layer, pid) in enumerate(job["items"]):
            # the decode read happened whatever the gate decided
            self.traffic["kv_repack_read_bytes"] += int(job["old_bytes"][i])
            if not swap[i]:
                self.traffic["kv_repack_kept"] += 1
                continue
            pool.packed_bits[pid] = int(new_bits[i])
            self.page_gen[pid] = job["gens"][i]
            if self.verify_on_repack:
                self.page_crc[pid] = _page_crc(pulled, i)
            self.traffic["kv_repack_write_bytes"] += int(
                pool.page_bytes(np.asarray([pid]))[0])
            self.traffic["kv_repack_pages"] += 1
        self.compact_table_rows()
        self._flush_tables()
        return len(job["items"])

    def refresh_step(self, budget: int | None = None) -> dict:
        """The decode loop's hook (``refresh_step`` :1852): check the
        triggers, refresh the due layers under one generation bump, and
        launch the re-pack of up to ``budget`` stale pages.  Returns
        ``{"refreshed_layers", "budget", "job"}``: the caller brings the
        job's ``pull`` back (the engine with the step's tokens, so a step
        that re-packs and seals nothing makes one device-to-host call) and
        hands it to ``finish_refresh``."""
        refreshed = self.maybe_refresh()
        if refreshed:
            self._flush_tables()
        return {"refreshed_layers": refreshed, "budget": budget,
                "job": self.launch_repack(budget)}

    def finish_refresh(self, rs: dict, pulled: dict | None) -> int:
        """Finish a ``refresh_step`` once its job's pull is back.
        Where the batch stopped at a page queued twice and budget is left,
        the rest is re-packed now, with its own pull.  Returns the pages
        processed."""
        job, budget = rs["job"], rs["budget"]
        if job is None:
            return 0
        done = self.finish_repack(job, pulled)
        if budget is None or done < budget:
            done += self.repack_pending(None if budget is None
                                        else budget - done)
        return done

    # ---------------------------------------------- device-resident mode
    def enable_device_pool(self, max_batch: int | None = None) -> None:
        """Expose the pool to the fused kernel (``enable_device_pool``
        :2079): kind-split plane views and the device table stack; with
        ``max_batch``, also the device state store of the recurrent layers
        (``init_state_store``), which the fused step carries.  Under a mesh
        the state store is split by batch over the data shards
        (``_state_specs`` :739), one store of ``max_batch / n_data`` slots
        on each data shard's lead device."""
        self.dev = DevicePoolPlanes(self.pool, max(2, self.n_table_rows))
        if max_batch is not None:
            if self.mesh is None:
                self.dev_states = init_state_store(self.cfg, max_batch,
                                                   self.device)
            else:
                self.slots_per_shard = max_batch // self.n_shards
                self.dev_states = [
                    init_state_store(self.cfg, self.slots_per_shard,
                                     self.pool.lead(sh))
                    for sh in range(self.n_shards)]
        self._tables_dirty = True
        self._flush_tables()

    def _flush_tables(self) -> None:
        """Upload the stacked tables to the kernel's table planes after a
        calibration, refresh or compaction, growing them first where a
        generation block no longer fits."""
        if self.dev is None or not self._tables_dirty:
            return
        vm, ol, cm = self._tables_stacked()
        n = vm.shape[0]
        self.dev.ensure_table_capacity(n)
        up = [self._put(vm), self._put(ol), self._put(cm)]
        for tabs in self.dev.tables.values():    # one copy a device
            for name, t in zip(("vm", "ol", "cum"), up):
                tabs[name][:n] = t
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

    def claim_append_targets_sharded(self, slot_rids: list) -> list[dict]:
        """``claim_append_targets`` under a mesh, one target dict a data
        shard on its lead device, in its own terms (``_localize_targets``
        :708): rows of its slots' new K/V, page ids within its range.  A
        shard appends only into its own pages; its idle slots claim
        nothing."""
        b = len(slot_rids)
        spb = b // self.n_shards
        pps = self.pool.pages_per_shard
        out = []
        for sh in range(self.n_shards):
            rows, pids, offs = [], [], []
            for ls in range(spb):
                rid = slot_rids[sh * spb + ls]
                if rid is None:
                    continue
                t = self.seq_len[rid]
                for i, layer in enumerate(self.attn_layers):
                    rows.append(i * spb + ls)
                    pids.append(self._claim_page(rid, layer, t) - sh * pps)
                    offs.append(t % self.page_size)
            arr = np.asarray([rows, pids, offs], np.int64).reshape(3, -1)
            if ((arr[1] < 0) | (arr[1] >= pps)).any():
                raise RuntimeError(f"data shard {sh} claimed a page outside "
                                   "its range")
            buf = self._put_to(arr, self.pool.lead(sh))
            out.append({"row": buf[0], "pid": buf[1], "off": buf[2]})
        return out

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
        tok_q, tok_s = pool.plane("tok_q"), pool.plane("tok_scale")
        planes = {"tok_k": tok_q[0], "tok_v": tok_q[1],
                  "tok_sk": tok_s[0], "tok_sv": tok_s[1]}
        device_append(planes, new_kv, self.claim_append_targets(slot_rids))
        for slot, rid in enumerate(slot_rids):
            if rid is None:
                continue
            for layer in self.state_layers:
                self.states[rid][layer] = {
                    f: x[slot].clone() for f, x in caches[layer].items()}
        self.note_appended(slot_rids)

    # ------------------------------------------- device-resident states
    def _state_row(self, slot: int):
        """The device state store that holds ``slot`` and its row there:
        under a mesh, its data shard's store."""
        if self.mesh is None:
            return self.dev_states, slot
        sh, row = divmod(slot, self.slots_per_shard)
        return self.dev_states[sh], row

    def read_state_slot(self, slot: int) -> dict:
        """One slot's recurrent states from the device store
        (``read_state_slot`` :2304), copied: a preemption boundary, never
        the steady-state step."""
        store, row = self._state_row(slot)
        return {layer: {f: x[row].clone() for f, x in store[layer].items()}
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
            store, row = self._state_row(slot)
            for f, v in st.items():
                store[layer][f][row] = v

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

    # --------------------------------------------------- host spill tier
    def _owner_of(self, pid: int) -> int | None:
        """Request owning a resident page (``_owner_of`` :1913)."""
        for rid, layers in self.page_tables.items():
            for pids in layers:
                if pid in pids:
                    return rid
        return None

    def spilled_pages(self, rid: int) -> int:
        """SPILLED page-table entries of a request (``spilled_pages``
        :1922)."""
        return sum(1 for pids in self.page_tables[rid] for pid in pids
                   if pid < 0)

    def request_last_read(self, rid: int) -> int:
        """Read clock of the request's most recently read page, the cold-
        first key of the pressure victim choice (``request_last_read``
        :1927)."""
        last = 0
        for layer in self.attn_layers:
            pids = [p for p in self.page_tables[rid][layer] if p >= 0]
            if pids:
                last = max(last, int(self.page_last_read[pids].max()))
        return last

    def spill_request(self, rid: int) -> int:
        """Park every resident page of a preempted request in the host spill
        tier (``spill_request`` :1937): PACKED pages as their APack planes,
        COLD as page-requantized int8, HOT as per-token int8, all of them
        in one pull.  Page-table entries become SPILLED (``-handle - 1``)
        and the slots return to the free list.  Returns the pages spilled.
        Never for an active slot: the fused step reads every page."""
        if self.faults is not None:
            d = self.faults.spill_delay()
            if d:
                time.sleep(d)
        where = [(layer, i, pid) for layer in self.attn_layers
                 for i, pid in enumerate(self.page_tables[rid][layer])
                 if pid >= 0]
        if not where:
            return 0
        recs = self.pool.spill([pid for _, _, pid in where], self._fetch)
        for (layer, i, pid), (st, fill, payload, comp) in zip(where, recs):
            raw = self.pool.dense_bytes(fill if st == m.PAGE_HOT
                                        else self.page_size)
            handle = self.spill_tier.put(m.SpillRecord(
                state=st, fill=fill, layer=layer,
                gen=int(self.page_gen[pid]), payload=payload,
                comp_bytes=comp, raw_bytes=raw,
                meta={"rid": rid, "pid": pid}))
            self._cold[layer].discard(pid)
            self._packed[layer].discard(pid)
            self.page_gen[pid] = 0
            self.page_crc[pid] = 0
            self.traffic["kv_spill_bytes"] += comp
            self.traffic["kv_spill_raw_bytes"] += raw
            self.traffic["kv_spill_pages"] += 1
            self.page_tables[rid][layer][i] = -handle - 1
        self.traffic["kv_spill_calls"] += 1
        return len(where)

    def unspill_request(self, rid: int) -> list[int]:
        """Readahead (``unspill_request`` :1984): restore every SPILLED page
        of ``rid`` into fresh slots, each record checksum-verified, in one
        upload from pinned memory; a COLD page whose layer calibrated while
        it was parked is packed (one batched ``_pack``), a PACKED one coded
        under a since-refreshed table is queued for re-pack.  A checksum
        mismatch quarantines the record and raises ``PageIntegrityError``
        for ``rid`` after the pages before it are restored, as the
        reference's page-by-page loop leaves them."""
        todo = [(layer, i, -e - 1) for layer in self.attn_layers
                for i, e in enumerate(self.page_tables[rid][layer]) if e < 0]
        recs, failed = [], None
        for layer, i, handle in todo:
            try:
                recs.append(self.spill_tier.get(handle))
            except m.PageIntegrityError as e:
                self.traffic["kv_integrity_failures"] += 1
                self.traffic["kv_quarantined_pages"] += 1
                failed = (layer, i, handle, e)
                break
        restored, to_pack = [], []
        if recs:
            pids = self.pool.adopt([(r.state, r.fill, r.payload)
                                    for r in recs], self._put,
                                   shard=self.request_shard.get(rid, 0))
            for (layer, i, handle), rec, pid in zip(todo, recs, pids):
                self.page_tables[rid][layer][i] = pid
                self.page_gen[pid] = rec.gen
                if rec.state == m.PAGE_PACKED:
                    self._packed[layer].add(pid)
                    self.page_crc[pid] = rec.crc
                    if rec.gen < int(self.table_gen[layer]):
                        self._repack_queue.append((layer, pid))
                elif rec.state == m.PAGE_COLD:
                    self._cold[layer].add(pid)
                    if self.tables[layer][0] is not None:
                        to_pack.append((layer, pid))
                self.spill_tier.drop(handle)
                restored.append(pid)
            self._pack(to_pack)
            self._flush_tables()
            self.traffic["kv_readahead_pages"] += len(restored)
            self.traffic["kv_readahead_bytes"] += int(
                self.pool.page_bytes(np.asarray(restored, np.int64)).sum())
        if failed is not None:
            layer, i, handle, e = failed
            raise m.PageIntegrityError(
                f"unspill of rid={rid} layer={layer} page {i}: {e}",
                rid=rid, layer=layer, handle=handle) from e
        if restored:
            self.traffic["kv_readahead_calls"] += 1
        return restored

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
        return self._meta_put(*self._meta_host(slot_rids, max_len), self._put)

    def step_meta_sharded(self, slot_rids: list, max_len: int) -> list[dict]:
        """``step_meta`` under a mesh: one meta dict a data shard, on its
        lead device, holding its slots' rows with their page ids in its
        own range (``_localize_meta`` :688: a masked entry's id, which may
        name any page, clipped into the range; its FREE state masks it).
        The page-slot count is the whole batch's bucket, as the
        reference's one sharded array has; one upload a shard."""
        arrays = self._meta_host(slot_rids, max_len)
        spb = len(slot_rids) // self.n_shards
        pps = self.pool.pages_per_shard
        out = []
        for sh in range(self.n_shards):
            pid, tid, kmeta, qw = (a[:, sh * spb:(sh + 1) * spb]
                                   for a in arrays)
            pid = np.clip(pid - sh * pps, 0, pps - 1).astype(np.int32)
            out.append(self._meta_put(
                pid, tid, kmeta, qw,
                lambda a, _sh=sh: self._put_to(a, self.pool.lead(_sh))))
        return out

    def _meta_put(self, pid, tid, kmeta, qw, put) -> dict:
        """Upload host meta arrays as one flat buffer (``put``) and view
        them as the kernel's fields."""
        na, b, pn = pid.shape
        flat = put(np.concatenate([pid.ravel(), tid.ravel(), kmeta.ravel(),
                                   qw.ravel()]))
        n1 = pid.size
        out = {"pid": flat[:n1].view(na, b, pn),
               "tid": flat[n1:2 * n1].view(na, b, pn),
               "kmeta": flat[2 * n1:4 * n1].view(na, b, pn, 2),
               "qw": flat[4 * n1:].view(na, b, 2)}
        out["state"] = out["kmeta"][..., 0]
        out["t0"] = out["kmeta"][..., 1]
        return out

    def _meta_host(self, slot_rids: list, max_len: int):
        """The host arrays of ``step_meta`` (pid, tid, kmeta, qw), with the
        step's read traffic accrued."""
        b = len(slot_rids)
        pn = self.meta_pages(max_len, slot_rids)
        na, ps = len(self.attn_layers), self.page_size
        ring = self._ring(max_len)
        pid = np.zeros((na, b, pn), np.int32)
        # unused slots keep generation 0's K row of their layer, masked
        tid = np.broadcast_to(
            np.asarray([self._row(0, layer, 0) for layer in self.attn_layers],
                       np.int32)[:, None, None], (na, b, pn)).copy()
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
                self._check_resident(rid, layer, pids)
                pid[i, slot, :k] = pids
                # each page's K row of the generation it was coded under
                # (V is the next row); generations coexist in a step
                tid[i, slot, :k] = self._k_rows(pids, rid, layer)
                kmeta[i, slot, :k, 0] = self.pool.state[pids]
                kmeta[i, slot, :k, 1] = (base + np.arange(k)) * ps
                if self.layer_kinds[layer] == "local":
                    qw[i, slot, 1] = ring
        self._accrue_read_traffic(slot_rids, max_len)
        return pid, tid, kmeta, qw

    def _check_resident(self, rid: int, layer: int, pids) -> None:
        """A SPILLED page on the read path fails its request: readahead
        must restore it first (``_accrue_read_traffic`` :2437)."""
        neg = np.asarray(pids, np.int64) < 0
        if neg.any():
            raise m.PageIntegrityError(
                f"active request {rid} layer {layer} page {int(neg.argmax())}"
                " is SPILLED at read time — readahead must restore before "
                "decode", rid=rid, layer=layer)

    def _accrue_read_traffic(self, slot_rids: list, max_len: int) -> None:
        """Charge the per-step KV read traffic (``_accrue_read_traffic``
        :2418): every page of every active slot, compressed as stored vs
        dense int8, per stream kind, and stamp each page's read clock.  A rolling layer's partly rolled-out
        page charges only its live token range, ``ceil(bytes * live /
        tokens)``."""
        pool, ps = self.pool, self.page_size
        ring = self._ring(max_len)
        raw = {"global": 0, "local": 0}
        read = {"global": 0, "local": 0}
        self._read_clock += 1
        for rid in slot_rids:
            if rid is None:
                continue
            qpos = self.seq_len[rid]
            for layer in self.attn_layers:
                pids = np.asarray(self.page_tables[rid][layer], np.int64)
                if not len(pids):
                    continue
                self._check_resident(rid, layer, pids)
                self._k_rows(pids, rid, layer)
                self.page_last_read[pids] = self._read_clock
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
        state (``init_state``'s fields) stacked over the slots (the init
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

    def _state_template(self, kind: str) -> dict:
        """The init state of a state layer of ``kind``, batch axis
        stripped (``_state_template`` :1323): what an idle slot holds."""
        one = init_state(self.cfg, kind, 1, self.device)
        return {f: x[0] for f, x in one.items()}

    def _state_leaves(self, layer: int, slot_rids: list) -> dict:
        """A state layer's states stacked over the slots, the init state
        where a slot is idle or has none."""
        init = self._state_template(self.layer_kinds[layer])
        rows = {f: [] for f in init}
        for rid in slot_rids:
            st = self.states[rid].get(layer) if rid is not None else None
            for f, z in init.items():
                rows[f].append(st[f] if st is not None else z)
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
                q = pool.plane("tok_q")[:, pid, o]
                sc = pool.plane("tok_scale")[:, pid, o]
            elif st == m.PAGE_COLD:
                q = pool.plane("cold_q")[:, pid, o]
                sc = pool.plane("page_scale")[:, pid]
            else:
                q, sc = dec[:, job, o], pool.plane("page_scale")[:, pid]
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
                       + [[self._row(int(self.page_gen[pid]), layer, kind)
                           for layer, pid in jobs] for kind in (0, 1)],
                       np.int32)
        ids = np.pad(ids, ((0, 0), pad), mode="edge")
        vm, ol, cm = self._device_tables()
        out = []
        for kind in (0, 1):
            self._count_put(ids[[0, 1 + kind]])     # the wrapper's upload
            out.append(decode(pool.plane("sym")[kind],
                              pool.plane("ofs")[kind],
                              pool.plane("stored")[kind], ids[0], vm, ol, cm,
                              n_steps=pool.elems_per_stream,
                              table_idx=ids[1 + kind])[:n])
        return quant.from_unsigned(torch.stack(out)).reshape(
            2, n, self.page_size, pool.kv_heads, pool.head_dim)
