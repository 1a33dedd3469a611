"""Batched serving engine over the paged APack KV cache or a dense cache.

Port of the single-device path of ``repro/serve/engine.py``, both
schedulers: ``prefill_bucket`` :52, ``Request`` :76, ``_InFlight`` :102,
``_PendingPrefill`` :113, ``AdmissionImpossible`` :132,
``ServeEngine.__init__`` :210 (with the packed weight store,
``weights="apack-int8"``), ``submit`` :398, ``_admission_order`` :418
(EDF over ``Request.slo_ms``),
``_try_reserve``/``_resume_request``/``_admit`` :468/:499/:514, the
pressure escalation ``_relieve_pressure``/``_spill_reserved`` :549/:605,
``_fail_request`` :614, ``_prefill_forward`` :646, ``_prefill_into_slot``
:680, ``_write_prefill_cache`` :710, ``preempt`` :730 (with the host
spill tier), ``_resume_into_slot`` :778, ``_retire`` :800,
``latency_stats`` :831, ``_check_deadlines``/``_on_hung``/
``_handle_integrity_failure`` :845-891, ``step`` :895 and
``_step_decode`` :928-1008 (fused, materialize and dense branches, the
fused one carrying the recurrent layers' device state store, and the
table refresh hook), the async event loop ``_step_async`` :1011,
``_overlap_host_work`` :1070, ``_pump_chunk``/``_stage_readahead``/
``_start_pump`` :1097-1147, ``_bind_prefilled``/``_admit_async``
:1158/:1173 and ``_dispatch``/``_collect``/``_drain`` :1230-1275,
``run_until_drained`` :1283, ``weight_stats`` :1308 and ``kv_stats``
:1333; and the checkpoint-style weight round trip, ``CompressedParams``
:146, ``compress_params`` :160 and ``decompress_params`` :196.  The stacks
are any mix of global and rolling attention layers and RG-LRU recurrent,
mLSTM and sLSTM layers, prefix or cycled, with dense or top-k MoE FFNs or
none, sequential or parallel blocks, tied or untied heads (every decoder
of the registry).  An encoder has no decode path and is refused.  Serving
on a mesh (``mesh=``, ``launch.mesh``; the validation :300-325, per-shard
reservations and admission :434-600, the sharded step in
``_step_decode`` :929-951 and the ``kv_shard_*`` stats :1352-1357) is
ported for the fused paged KV on the sync scheduler.

Continuous batching over ``max_batch`` decode slots: finished sequences
retire, waiting requests reserve their worst-case pages and are admitted
with a bucketed single-request prefill whose KV is chopped into pool pages
on the device.  Three decode modes:

- ``kv_cache_dtype="apack-int8"``, fused (the default): each step reads
  every page through the fused gather-decode attention kernel, appends the
  new token's K/V on the device, and seals (and APack-encodes) the pages
  that filled.  The step's only device-to-host reads are the greedy token
  ids and, at page seals, the calibration histograms or coded bit counts;
  a re-pack's verdicts ride the tokens' pull.
- ``kv_fused=False``, the materialize oracle: each step rebuilds a dense
  int8 cache from the pool (PACKED pages through the gather-decode kernel),
  runs the dense decode step over it and moves the new token back into
  pages.
- ``kv_cache_dtype="int8"`` or ``"bfloat16"``: no pool; the batch holds
  one dense cache of ``max_len`` positions per slot (a ring on a rolling
  layer), the raw-KV baseline.

Admission reserves pages per layer kind (``PagedKVCache.pages_needed``):
the full sequence on a global layer, ``window_pages`` on a rolling one,
none on a recurrent one, whose state lives in a per-slot state store.
``preempt`` parks an active request, its recurrent states APack-coded into
a snapshot, and resumes it at the same position without a new prefill;
with ``spill=True`` its pages go to the host spill tier (CRC-checked at
readahead) and its reservation is given up.  Under pool pressure the
engine spills parked requests, and with ``kv_pressure`` preempts active
ones; ``slot_deadline_steps`` and the watchdog preempt slow slots; a page
that fails an integrity check fails only its request.  ``kv_refresh``
re-fits a layer's activation tables to drifting traffic and re-packs its
pages under them, a budget a step.

With ``mesh=`` (a serving mesh, axes ``("data", "model")``) one controller
drives every shard: the slots split into contiguous blocks over the data
shards, each request binds to its slot's data shard, whose page range and
free list it allocates from, and admission reserves per shard; each step
runs ``model.build_sharded_step``: each data shard decodes its slots on
its lead device, kernel 3 runs once a model shard on its KV-head block and
kernel 5 once a model shard on its K range, and every shard's tokens come
back in the step's one pull.  Table refresh (the drift sketches and tables
global, each data shard re-packing its own pages), pressure preemption
(within the shard whose admission is short), ``kv_verify_on_repack``
(each page read from its owning shard) and fault injection (on the
owning shard's copies of a page) work on a mesh as on one device.

``scheduler="async"`` (fused paged KV only) runs each step as: the host
work of the sync step (refresh and re-pack launches, chunked prefill
ingest, spill readahead) while the previous decode step is still on the
card, then ``_collect`` (the step's one pull: its tokens, the re-pack
verdicts and the first tokens of prefills that finished ingesting; then
the seals those chunks queued, then the step's own), admission, and the
``_dispatch`` of the next step.  It all runs on one CUDA stream: kernel
launches are already asynchronous to the host, and stream order keeps the
pool's in-place writes behind the step that reads them.  The window,
``_dispatch`` and ``_start_pump`` only enqueue work: every upload in them
goes from pinned memory without a stream wait, and nothing in them reads
the device.  Tokens equal the sync engine's.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.tables import find_table
from repro_torch.device import resolve
from repro_torch.kernels import fastpath
from repro_torch.kernels.decompress_matmul import DEFAULT_WEIGHT_MIN_SIZE
from repro_torch.launch.mesh import device_grid
from repro_torch.models import model as M
from repro_torch.models import modules as m
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import PageIntegrityError
from repro_torch.runtime.supervisor import StragglerWatchdog, WatchdogEvent


def prefill_bucket(s: int, max_len: int) -> int:
    """Power-of-two prefill length for a prompt of ``s`` tokens, capped at
    the context window.  The JAX package buckets to bound its jit
    compiles; the port keeps the same padded shapes so both packages
    compute the same prefill."""
    b = 1
    while b < s:
        b *= 2
    return min(b, max_len)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # time.perf_counter() stamps (monotonic)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    # steps this request may hold a decode slot while others queue (None:
    # the engine's slot_deadline_steps, or no deadline)
    deadline_steps: int | None = None
    # end-to-end latency SLO: admission orders by earliest deadline
    # (t_submit + slo_ms); None sorts last, so traffic that sets no SLO
    # keeps FIFO admission
    slo_ms: float | None = None
    # a failure (integrity quarantine): done with the error set and the
    # tokens cut at the failure, never silently wrong
    error: str | None = None


@dataclasses.dataclass
class _InFlight:
    """A decode step dispatched and not yet collected (``_InFlight`` :102):
    the slot binding at dispatch, against which ``_collect`` applies the
    tokens, and the step's device results."""
    slot_reqs: list                     # slot -> Request at dispatch
    slot_rids: list                     # slot -> rid at dispatch
    logits: torch.Tensor                # [B, 1, V], on the device
    toks: torch.Tensor                  # [B] greedy ids, on the device


@dataclasses.dataclass
class _PendingPrefill:
    """A queued request whose prefill is pumped in the background
    (``_PendingPrefill`` :113): its forward was dispatched at pump start,
    and its pages ingest chunk by chunk in the overlap window, so one long
    prompt does not stall the batch."""
    req: Request
    s: int                              # prompt length
    logits: torch.Tensor                # [1, 1, V], on the device
    caches: list | None                 # the forward's caches until viewed
    view: dict | None = None            # ``prefill_host_view`` of them
    cursor: int = 0                     # tokens ingested so far
    tok_dev: torch.Tensor | None = None  # first token, pulled at collect
    tok: int | None = None              # first generated token when bound

    @property
    def ingested(self) -> bool:
        return self.cursor >= self.s

    @property
    def ready(self) -> bool:
        return self.tok is not None


SCHEDULERS = ("sync", "async")


KV_CACHE_DTYPES = ("apack-int8", "int8", "bfloat16")


# ------------------------------------------------- the weight round trip
@dataclasses.dataclass
class CompressedParams:
    """APack-compressed int8 view of a param tree (large matrices only), in
    the JAX package's layout: one entry per leaf of its stacked tree, keyed
    by the leaf's path (``blocks/0/ffn/w_up``, ``prefix/1/inner/w_x``), in
    its flatten order (``paths``).  A host object, like the JAX package's:
    containers are ``core.format.CompressedTensor``s with numpy scales,
    small leaves CPU tensors.  ``n_prefix``/``n_cycle``/``n_layers`` place
    the leaves back into the port's per-layer list."""
    containers: dict            # path -> (CompressedTensor, scale, dtype)
    passthrough: dict           # path -> stacked leaf (CPU tensor)
    paths: list[str]
    n_prefix: int
    n_cycle: int
    n_layers: int
    original_bytes: int
    compressed_bytes: int

    @property
    def ratio(self) -> float:
        return self.original_bytes / max(self.compressed_bytes, 1)


def _stacked_leaves(cfg: ModelConfig, params: dict):
    """``(path, thunk)`` of every leaf of the JAX package's tree for the
    port's ``params``, in ``jax.tree.flatten`` order (dict keys sorted):
    cycle position ``c``'s layers ``n_prefix + j * n_cycle + c`` become
    the one stack ``blocks/c`` along a leading axis, and each prefix layer
    ``i`` its own ``prefix/i``, the layout ``cfg`` gives the JAX tree
    (``init_params`` :77).  A thunk builds its leaf on demand, so that one
    stack at a time lives on the device."""
    def walk(node, path, get):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], f"{path}/{k}",
                                lambda b, k=k, get=get: get(b)[k])
        else:
            yield path, get
    n_prefix, n_cycle = len(cfg.prefix_pattern), len(cfg.cycle)
    layers = params["blocks"]
    keys = ["blocks", "embed", "final_norm"] + (["prefix"] if n_prefix
                                                 else []) \
        + (["unembed"] if "unembed" in params else [])
    for key in sorted(keys):
        if key == "blocks":
            for c in range(n_cycle):
                stack = layers[n_prefix + c::n_cycle]
                for path, get in walk(stack[0], f"blocks/{c}", lambda b: b):
                    yield path, (lambda get=get, stack=stack: torch.stack(
                        [get(b) for b in stack]))
        elif key == "prefix":
            for i in range(n_prefix):
                for path, get in walk(layers[i], f"prefix/{i}", lambda b: b):
                    yield path, (lambda get=get, i=i: get(layers[i]))
        else:
            yield key, (lambda key=key: params[key])


def compress_params(cfg: ModelConfig, params: dict,
                    min_size: int = DEFAULT_WEIGHT_MIN_SIZE, *,
                    timings: dict | None = None) -> CompressedParams:
    """int8-quantize and APack-compress every large matrix of a param tree.

    The leaves are the JAX package's stacked ones (``_stacked_leaves``,
    laid out by ``cfg``), and that sets the numbers:
    ``quantize_symmetric(axis=-1)`` gives one scale per last-axis channel
    shared by every layer of a stack, the table and the streams cover the
    whole stack, and a stack of norm scales [L, d] is a matrix past
    ``min_size`` where one layer's [d] would not be.  Each leaf is
    quantized on its device (a true division, as the eager JAX call makes
    it), its histogram taken there with ``torch.bincount`` and pulled, the
    weight-mode table searched on the host, and the streams coded by
    ``fastpath.compress_tensor``: the encode kernel on the card, the plain
    encoder on the CPU.  Byte counts are the JAX package's: ceil bytes of
    each container's ``total_bits`` plus its scale.  ``timings`` (a dict)
    gets the seconds of ``stack``, ``quantize_histogram``, ``find_table``
    and ``fastpath``'s parts."""
    containers: dict = {}
    passthrough: dict = {}
    paths = []
    orig = comp = 0
    dev = params["embed"].device
    for path, leaf_fn in _stacked_leaves(cfg, params):
        paths.append(path)
        with fastpath.timed(timings, "stack", dev):
            leaf = leaf_fn()
        nbytes = leaf.numel() * leaf.element_size()
        orig += nbytes
        if not (leaf.numel() >= min_size and leaf.is_floating_point()
                and leaf.dim() >= 2):
            passthrough[path] = leaf.cpu()
            comp += nbytes
            continue
        dtype = str(leaf.dtype).removeprefix("torch.")
        with fastpath.timed(timings, "quantize_histogram", dev):
            q, qp = quant.quantize_symmetric(leaf.to(torch.float32), axis=-1)
            del leaf
            u = quant.to_unsigned(q)
            del q
            hist = torch.bincount(u.reshape(-1), minlength=256)
        with fastpath.timed(timings, "find_table", dev):
            # weights are static: the weight-mode heuristic profiles the
            # whole tensor and steals no counts for empty ranges
            table = find_table(hist.cpu().numpy().astype(np.int64), 8,
                               is_activation=False)
        ct = fastpath.compress_tensor(u, table, timings=timings)
        del u
        scale = qp.scale.cpu().numpy()
        containers[path] = (ct, scale, dtype)
        # ceil bytes, and the per-channel dequant scale ships with the
        # payload
        comp += -(-ct.total_bits // 8) + scale.nbytes
    return CompressedParams(containers=containers, passthrough=passthrough,
                            paths=paths, n_prefix=len(cfg.prefix_pattern),
                            n_cycle=len(cfg.cycle),
                            n_layers=len(params["blocks"]),
                            original_bytes=orig,
                            compressed_bytes=comp)


def decompress_params(cp: CompressedParams, device=None, *,
                      timings: dict | None = None) -> dict:
    """The port's param tree (one dict per layer) from a
    ``CompressedParams``, on ``device.resolve(device)``: each container
    decoded by ``fastpath.decompress_tensor`` (the decode kernel on the
    card), then ``from_unsigned``, ``q.f32 * scale`` in f32 and the leaf's
    dtype, as the JAX package does; each stack split back into its layers
    (views of it).  ``timings`` gets ``upload``, ``decode`` and
    ``dequantize``."""
    dev = resolve(device)
    blocks: list = [{} for _ in range(cp.n_layers)]
    tree: dict = {"blocks": blocks}
    for path in cp.paths:
        if path in cp.passthrough:
            leaf = cp.passthrough[path].to(dev)
        else:
            ct, scale, dtype = cp.containers[path]
            u = fastpath.decompress_tensor(ct, dev, timings=timings)
            with fastpath.timed(timings, "dequantize", dev):
                q = quant.from_unsigned(u, bits=ct.bits)
                del u
                leaf = (q.to(torch.float32) * torch.from_numpy(scale).to(dev)
                        ).to(getattr(torch, dtype))
                del q
        keys = path.split("/")
        if keys[0] == "blocks":
            c = int(keys[1])
            placed = [(cp.n_prefix + j * cp.n_cycle + c, leaf[j])
                      for j in range(leaf.shape[0])]
        elif keys[0] == "prefix":
            placed = [(int(keys[1]), leaf)]
        else:
            tree[keys[0]] = leaf
            continue
        for layer, value in placed:
            node = blocks[layer]
            for k in keys[2:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = value
    return tree


class AdmissionImpossible(RuntimeError):
    """Admission can never succeed for the queue head
    (``AdmissionImpossible`` :132): ``run_until_drained`` raises it instead
    of spinning.  Names the request and its page reservation."""

    def __init__(self, req: Request, need: int, pool_pages: int, why: str):
        super().__init__(
            f"request {req.rid} can never be admitted: reserves {need} "
            f"pages worst-case against a pool of {pool_pages} ({why})")
        self.rid = req.rid
        self.pages_needed = need
        self.pool_pages = pool_pages


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *, max_batch: int = 8,
                 max_len: int = 256, eos_id: int | None = None,
                 kv_pages: int | None = None, kv_page_size: int = 16,
                 kv_calib_pages: int = 4, kv_fused: bool | None = None,
                 kv_refresh: bool = False,
                 kv_refresh_every_pages: int | None = None,
                 kv_refresh_threshold: float = 0.15,
                 kv_refresh_min_pages: int = 4,
                 kv_repack_budget: int = 4,
                 kv_pressure: bool = False,
                 slot_deadline_steps: int | None = None,
                 pressure_backoff_max: int = 64,
                 watchdog_ratio: float | None = None,
                 watchdog_patience: int = 3,
                 kv_verify_on_repack: bool = False,
                 scheduler: str = "sync",
                 prefill_chunk_tokens: int | None = None,
                 mesh=None, faults=None,
                 weights: str | None = None,
                 weight_min_size: int | None = None,
                 weight_tile_k: int | None = None, device=None):
        # mesh-sharded serving (``__init__`` :300-328): decode jobs
        # data-parallel over the mesh's "data" axis, KV heads
        # tensor-parallel over "model" in the fused kernel
        self.mesh = mesh
        self._n_data = self._n_model = 1
        self._step_mesh = None
        if mesh is not None:
            if not (cfg.kv_cache_dtype == "apack-int8"
                    and kv_fused is not False):
                raise ValueError(
                    "mesh= requires the fused paged apack-int8 KV (the "
                    "sharded step is the combined decode+append program)")
            if scheduler != "sync":
                raise ValueError(
                    "mesh= requires scheduler='sync' (the async overlap "
                    "window is not shard-aware yet)")
            if "data" not in dict(mesh.shape):
                raise ValueError("serving mesh must name a 'data' axis")
            self._n_data, self._n_model = M.mesh_axis_sizes(mesh)
            if max_batch % self._n_data:
                raise ValueError(
                    f"max_batch={max_batch} must divide over the "
                    f"{self._n_data}-way data axis (whole slots per shard)")
            if self._n_model > 1 and cfg.num_kv_heads % self._n_model:
                raise ValueError(
                    f"num_kv_heads={cfg.num_kv_heads} must divide over "
                    f"the {self._n_model}-way model axis")
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if scheduler == "async" and not (cfg.kv_cache_dtype == "apack-int8"
                                         and kv_fused is not False):
            raise ValueError(
                "scheduler='async' requires the fused paged apack-int8 KV "
                "(the overlap window is the in-flight fused device step)")
        if weights not in (None, "apack-int8"):
            raise ValueError(f"unknown weights mode {weights!r}; "
                             "expected 'apack-int8' or None")
        if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r};"
                             f" expected one of {KV_CACHE_DTYPES}")
        M.check_decoder(cfg)
        self.device = (resolve(device) if mesh is None
                       else device_grid(mesh)[0][0])
        self.cfg = cfg
        for t in (params["embed"], params["final_norm"]):
            if t.device != self.device:
                raise ValueError(f"params on {t.device}, engine on "
                                 f"{self.device}")
        # packed weight store: ``weights="apack-int8"`` turns every large
        # projection/FFN matrix into APack planes on the device
        # (``model.pack_weights``, from the original f32 values) and the
        # forward routes those sites through the decompress-matmul kernel
        self._weight_stats: dict | None = None
        self.weight_pack_s = 0.0
        if weights is not None:
            t0 = time.perf_counter()
            params, self._weight_stats = M.pack_weights(
                cfg, params, min_size=weight_min_size, tile_k=weight_tile_k)
            self.weight_pack_s = time.perf_counter() - t0
        self.params = M.serving_params(params)
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * max_batch
        self.positions = np.zeros(max_batch, np.int64)
        self.last_tokens = np.zeros((max_batch, 1), np.int64)
        self.last_logits = None
        self.stats = {"steps": 0, "generated": 0, "completed": 0,
                      "kv_admission_blocked": 0, "preempted": 0,
                      "resumed": 0, "kv_refreshes": 0,
                      "kv_pages_repacked": 0, "failed": 0,
                      "spilled_requests": 0, "admission_retries": 0,
                      "pressure_preempted": 0, "deadline_preempted": 0,
                      "watchdog_preempted": 0, "prefill_chunks": 0,
                      "staged_readahead": 0,
                      "queue_wait_p50_ms": 0.0, "queue_wait_p99_ms": 0.0,
                      "e2e_p50_ms": 0.0, "e2e_p99_ms": 0.0}
        # pressure policy (``__init__`` :265-283): level 1 (always on)
        # spills preempted requests' idle pages to the host tier when
        # admission blocks; level 2 (``kv_pressure``) also preempts active
        # slots with spill, under exponential backoff
        self.kv_pressure = kv_pressure
        self.slot_deadline_steps = slot_deadline_steps
        self.pressure_backoff_max = pressure_backoff_max
        self._pressure_backoff = 1
        self._next_pressure_admit = 0
        self._admit_clock = 0
        self._slot_steps = np.zeros(max_batch, np.int64)
        self._spilled: set[int] = set()
        # a hung step preempts the longest-running slot with spill
        self.watchdog = (StragglerWatchdog(ratio=watchdog_ratio,
                                           patience=watchdog_patience)
                         if watchdog_ratio is not None else None)
        self.faults = faults
        # table refresh: every decode step checks the drift triggers and
        # re-packs at most ``kv_repack_budget`` stale pages
        self.kv_refresh = kv_refresh
        self.kv_repack_budget = kv_repack_budget
        self.paged = cfg.kv_cache_dtype == "apack-int8"
        self.fused = self.paged and kv_fused is not False
        self.kv: M.PagedKVCache | None = None
        self.cache: list | None = None
        if self.paged:
            if kv_pages is None:
                # every slot at full context
                kv_pages = max_batch * M.PagedKVCache.pages_for_config(
                    cfg, max_len, kv_page_size)
            if kv_pages % self._n_data:
                # whole pages a shard: round the pool up so that every data
                # shard owns an equal contiguous range
                kv_pages += self._n_data - kv_pages % self._n_data
            self.kv = M.PagedKVCache(
                cfg, kv_pages, page_size=kv_page_size,
                calib_pages=kv_calib_pages,
                refresh_every_pages=kv_refresh_every_pages,
                refresh_threshold=kv_refresh_threshold,
                refresh_min_pages=kv_refresh_min_pages,
                verify_on_repack=kv_verify_on_repack,
                drift_sketch=kv_refresh, device=self.device, mesh=mesh)
            self.kv.faults = faults
            # both paged modes read the device pool (the oracle uses its
            # table stack for the gather decode); the fused step also
            # carries the recurrent layers' device state store
            self.kv.enable_device_pool(max_batch if self.fused else None)
            if mesh is not None:
                self._step_mesh = M.build_sharded_step(cfg, mesh,
                                                       params=self.params)
                # data shard 0's tree: the dense leaves are the same
                # tensors, the split sites K-split
                self.params = self._step_mesh.params[0]
        else:
            self.cache = M.init_cache(cfg, max_batch, max_len,
                                      device=self.device)
        # per-shard reservations (``_reserve`` :458): shard s owns pages
        # [s*pps, (s+1)*pps) and the slot block [s*spb, (s+1)*spb); each
        # shard's admission checks its own counter
        self._reserved: dict[int, int] = {}
        self._rshard: dict[int, int] = {}
        self._shard_reserved: list[int] = [0] * self._n_data
        # rid -> (state snapshot, position, last token) of a preempted
        # request, which resumes without a new prefill
        self._preempted: dict[int, tuple] = {}
        self._lat_wait: list[float] = []
        self._lat_e2e: list[float] = []
        # the async event loop (``__init__`` :379-393): the chunk budget of
        # one overlap window covers a few pages, so a short prompt binds
        # in one step and a long one spreads over many
        self.scheduler = scheduler
        self.prefill_chunk_tokens = (int(prefill_chunk_tokens)
                                     if prefill_chunk_tokens
                                     else kv_page_size * 4)
        self._inflight: _InFlight | None = None
        self._pump: dict[int, _PendingPrefill] = {}
        # launched in the window, landed by ``_collect``: the refresh
        # step's re-pack, the seals the chunks queued (in the reference's
        # order) and the prefills whose last chunk went in
        self._refresh_rs: dict | None = None
        self._chunk_seals: list = []
        self._finished: list[_PendingPrefill] = []

    # -------------------------------------------------------- scheduling
    def submit(self, req: Request) -> None:
        if self.paged:
            need = self._pages_for(req)
            if need > self._shard_pages():
                # a request lives within one data shard's page range
                raise ValueError(
                    f"request {req.rid} needs {need} pages worst-case but "
                    + (f"the pool only has {self.kv.pool.num_pages}"
                       if self._n_data == 1 else
                       f"each pool shard only has {self._shard_pages()}")
                    + "; shorten the request or grow kv_pages")
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _pages_for(self, req: Request) -> int:
        """Worst-case page reservation: prompt + generated tokens, capped
        at the context window."""
        toks = min(self.max_len, len(req.prompt) + req.max_new_tokens)
        return self.kv.pages_needed(toks)

    def _admission_order(self) -> list[Request]:
        """The queue in admission priority order (``_admission_order``
        :418): earliest SLO deadline first (EDF over ``t_submit +
        slo_ms``), submission order among requests without an SLO and as
        the tie-break; traffic that sets no SLO keeps FIFO admission."""
        if not any(r.slo_ms is not None for r in self.queue):
            return list(self.queue)

        def key(ir):
            i, r = ir
            ddl = (r.t_submit + r.slo_ms / 1e3
                   if r.slo_ms is not None else float("inf"))
            return (ddl, i)

        return [r for _, r in sorted(enumerate(self.queue), key=key)]

    @property
    def _reserved_total(self) -> int:
        return sum(self._shard_reserved)

    @_reserved_total.setter
    def _reserved_total(self, v: int) -> None:
        # the reference's hook (a check that fills the pool sets it): the
        # whole total on shard 0, exact on one shard
        self._shard_reserved = [int(v)] + [0] * (self._n_data - 1)

    def _slot_shard(self, slot: int) -> int:
        """The data shard of ``slot`` (``_slot_shard`` :451)."""
        return slot // (self.max_batch // self._n_data)

    def _shard_pages(self) -> int:
        """Pages of one data shard, the whole pool on one (``_shard_pages``
        :454)."""
        return self.kv.pool.num_pages // self._n_data

    def _reserve(self, rid: int, need: int, shard: int = 0) -> None:
        self._reserved[rid] = need
        self._rshard[rid] = shard
        self._shard_reserved[shard] += need

    def _unreserve(self, rid: int) -> int:
        need = self._reserved.pop(rid)
        self._shard_reserved[self._rshard.pop(rid, 0)] -= need
        return need

    def _try_reserve(self, req: Request, shard: int = 0, *,
                     allow_relief: bool) -> int | None:
        """Pages to reserve for an admission candidate against data shard
        ``shard``'s pages (0 while it still holds its reservation), or None
        while it stays blocked (``_try_reserve`` :468).  Only the head may
        trigger pressure relief (``allow_relief``); the need is taken again
        after relief, which can change the head's own standing."""
        need = 0 if req.rid in self._reserved else self._pages_for(req)
        if self._shard_reserved[shard] + need <= self._shard_pages():
            if allow_relief:
                self._pressure_backoff = 1    # clean head admission
            return need
        if not allow_relief:
            return None
        self.stats["kv_admission_blocked"] += 1
        if not self._relieve_pressure(req, need, shard):
            return None                       # the request waits
        need = 0 if req.rid in self._reserved else self._pages_for(req)
        if self._shard_reserved[shard] + need > self._shard_pages():
            return None                       # partial relief; retry later
        self.stats["admission_retries"] += 1
        return need

    def _resume_request(self, slot: int, req: Request, need: int,
                        shard: int = 0) -> None:
        """Resume a preempted request (``_resume_request`` :499): take its
        reservation again where it gave it up, and fail only it if its
        spilled pages come back corrupted.  It binds to ``shard``: a
        spilled request re-adopts its pages there, a resident one only
        reaches here with its own shard."""
        if need:
            self._reserve(req.rid, need, shard)
        self.kv.request_shard[req.rid] = shard
        try:
            self._resume_into_slot(slot, req)
        except PageIntegrityError as e:
            self._fail_request(req, e)

    def _admit(self) -> None:
        """Fill idle slots from the head of ``_admission_order`` (``_admit``
        :514); with the pool short, the head may trigger pressure relief
        and the rest wait behind it.  Each slot admits the first request
        eligible for its data shard: a preempted request whose pages are
        still in the pool resumes only into its own shard's slots (a
        spilled one re-adopts into any); on a mesh a blocked shard leaves
        the others admitting."""
        for slot in range(self.max_batch):
            if self.active[slot] is not None or not self.queue:
                continue
            if not self.paged:
                self._prefill_into_slot(slot, self.queue.popleft(), 0)
                continue
            self._admit_clock += 1
            shard = self._slot_shard(slot)
            head = next((r for r in self._admission_order()
                         if not (r.rid in self._preempted
                                 and r.rid not in self._spilled
                                 and self.kv.request_shard.get(r.rid, shard)
                                 != shard)), None)
            if head is None:
                continue                       # nothing for this shard
            need = self._try_reserve(head, shard, allow_relief=True)
            if need is None:
                if self._n_data > 1:
                    continue                   # shards admit on their own
                break                          # the head waits (FIFO)
            self.queue.remove(head)
            if head.rid in self._preempted:
                self._resume_request(slot, head, need, shard)
                continue
            self._prefill_into_slot(slot, head, need)

    def _relieve_pressure(self, head: Request, need: int,
                          shard: int = 0) -> bool:
        """Bounded spill -> retry -> preempt escalation under pool
        exhaustion (``_relieve_pressure`` :549).  Returns True when
        reservation headroom was freed.  Level 1: spill the coldest
        preempted request still holding a reservation (never the head).
        Level 2 (``kv_pressure``): preempt with spill the longest-running
        active slot, gated by exponential backoff; with no slot to preempt
        and nothing to spill, ``AdmissionImpossible``."""
        parked = [rid for rid in self._preempted
                  if rid in self._reserved and rid not in self._spilled
                  and rid != head.rid and self._rshard.get(rid, 0) == shard]
        if parked:
            self._spill_reserved(min(parked, key=self.kv.request_last_read))
            return True
        if not self.kv_pressure:
            return False
        if self._admit_clock < self._next_pressure_admit:
            return False                       # backing off
        victims = [s for s, r in enumerate(self.active)
                   if r is not None and self._slot_shard(s) == shard]
        if not victims:
            if self._pump:
                # pumped prefills hold reservations and will bind, serve
                # and retire: admission is delayed, not impossible
                return False
            if self._n_data > 1 and any(r is not None for r in self.active):
                return False          # other shards serve; this one waits
            raise AdmissionImpossible(
                head, need, self._shard_pages(),
                "no active slots to retire and no spillable reservations")
        slot = max(victims, key=lambda s: int(self._slot_steps[s]))
        self.preempt(slot, spill=True, requeue="tail")
        self.stats["pressure_preempted"] += 1
        self._next_pressure_admit = self._admit_clock + self._pressure_backoff
        self._pressure_backoff = min(2 * self._pressure_backoff,
                                     self.pressure_backoff_max)
        return True

    def _spill_reserved(self, rid: int) -> None:
        """Park a preempted request's pages in the host spill tier and give
        up its reservation (``_spill_reserved`` :605); resume reserves
        again and runs the checksum-verified readahead."""
        self.kv.spill_request(rid)
        self._unreserve(rid)
        self._spilled.add(rid)
        self.stats["spilled_requests"] += 1

    def _fail_request(self, req: Request, err: Exception) -> None:
        """Fail one request (``_fail_request`` :614): the error goes on the
        request, its pages, reservation and snapshot are released, and
        every other slot is left as it was."""
        req.done = True
        req.error = str(err)
        req.t_done = time.perf_counter()
        self.stats["failed"] += 1
        rid = req.rid
        self._pump.pop(rid, None)
        for s, r in enumerate(self.active):
            if r is req:
                # apack: allow-phase(overlap-reachable only via readahead
                # staging, which fails parked/spilled requests; a request bound
                # to an in-flight slot never takes this path)
                self.active[s] = None
        try:
            self.queue.remove(req)
        except ValueError:
            pass
        if self.paged:
            if rid in self.kv.page_tables:
                # apack: allow-phase(releases the pages of a parked request
                # that readahead failed; the in-flight step holds no slot of it
                # and reads none of them)
                self.kv.release(rid)
            if rid in self._reserved:
                self._unreserve(rid)
        self._preempted.pop(rid, None)
        self._spilled.discard(rid)

    def preempt(self, slot: int, *, spill: bool = False,
                requeue: str = "head") -> dict:
        """Kick the request in ``slot`` out of its decode slot and back to
        the queue, at its ``requeue`` end ("head" or "tail") (``preempt``
        :730).  Its recurrent states (from the device state store in fused
        mode) are APack-coded into a snapshot
        (``PagedKVCache.snapshot_state``) and the dense copy is dropped, so
        the snapshot is their only home until re-admission restores it and
        resumes at the same position, without a new prefill: the
        continuation is identical.  Its KV stays in the page pool,
        compressed as it is, with its reservation held; ``spill=True``
        parks the pages in the host spill tier instead and gives up the
        reservation (resume reserves again and restores them).  Returns
        the snapshot."""
        if not self.paged:
            raise RuntimeError("preempt requires the paged apack-int8 KV")
        if requeue not in ("head", "tail"):
            raise ValueError(f"requeue={requeue!r}: expected 'head' or "
                             "'tail'")
        self._drain()        # async: the in-flight step lands first
        req = self.active[slot]
        if req is None:
            raise ValueError(f"slot {slot} is idle, nothing to preempt")
        if self.fused and self.kv.state_layers:
            self.kv.states[req.rid] = self.kv.read_state_slot(slot)
        snap = self.kv.snapshot_state(req.rid)
        self.kv.states[req.rid] = {}
        self._preempted[req.rid] = (snap, int(self.positions[slot]),
                                    int(self.last_tokens[slot, 0]))
        self.active[slot] = None
        self._slot_steps[slot] = 0
        if requeue == "tail":
            self.queue.append(req)
        else:
            self.queue.appendleft(req)
        self.stats["preempted"] += 1
        if spill:
            self._spill_reserved(req.rid)
        return snap

    def _resume_into_slot(self, slot: int, req: Request) -> None:
        snap, pos, last = self._preempted[req.rid]
        if req.rid in self._spilled:
            # readahead: the spilled pages come back checksum-verified in
            # one upload before the next step reads them
            self.kv.unspill_request(req.rid)
            self._spilled.discard(req.rid)
        del self._preempted[req.rid]
        self.kv.restore_state(req.rid, snap)
        if self.fused and self.kv.state_layers:
            self.kv.write_state_slot(slot, req.rid)
        self.active[slot] = req
        self.positions[slot] = pos
        self.last_tokens[slot, 0] = last
        self._slot_steps[slot] = 0
        self.stats["resumed"] += 1

    def _prefill_forward(self, prompt, shard: int = 0):
        """Single-request prefill at the prompt's power-of-two bucket; a
        prompt shorter than its bucket is zero-padded and its logits are
        taken at the true last position.  On a mesh it runs on data shard
        ``shard``'s lead device with its params."""
        s = len(prompt)
        bucket = prefill_bucket(s, self.max_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :s] = np.asarray(prompt)
        params, dev = self.params, self.device
        if self._step_mesh is not None:
            params = self._step_mesh.params[shard]
            dev = self.kv.pool.lead(shard)
        tokens = m.to_device(toks, dev)
        return M.forward(self.cfg, params, tokens, last_only=True,
                         true_len=None if s == bucket else s)

    def _prefill_into_slot(self, slot: int, req: Request, need: int) -> None:
        s = len(req.prompt)
        req.t_admit = time.perf_counter()
        shard = self._slot_shard(slot)
        logits, caches = self._prefill_forward(req.prompt, shard)
        if self.paged:
            # the request binds to its slot's data shard: its pages come
            # from that shard's free list from here on
            self.kv.add_request(req.rid, shard)
            self._reserve(req.rid, need, shard)
            self.kv.ingest_prefill(req.rid, caches, s)
            if self.fused and self.kv.state_layers:
                self.kv.write_state_slot(slot, req.rid)
        else:
            self._write_prefill_cache(slot, caches)
        # apack: allow-transfer(admission event: the first token of a sync
        # prefill, one pull when the request is admitted; not in the steady
        # decode loop)
        next_tok = int(logits[0, -1].argmax())
        req.tokens.append(next_tok)
        self.active[slot] = req
        self.positions[slot] = s
        self.last_tokens[slot, 0] = next_tok
        self._slot_steps[slot] = 0

    def _write_prefill_cache(self, slot: int, caches: list) -> None:
        """Write one request's prefill cache, global layers padded to
        ``max_len``, into row ``slot`` of the batch cache (dense modes)."""
        for batch, one in zip(self.cache,
                              M.extend_caches(self.cfg, caches,
                                              self.max_len)):
            for f, x in one.items():
                batch[f][slot] = x[0].to(batch[f].dtype)

    def _retire(self) -> None:
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            eos = self.eos_id if req.eos_id is None else req.eos_id
            if (len(req.tokens) >= req.max_new_tokens
                    or (eos is not None and req.tokens
                        and req.tokens[-1] == eos)
                    or self.positions[slot] >= self.max_len - 1):
                req.done = True
                req.t_done = time.perf_counter()
                self._log_latency(req)
                self.stats["completed"] += 1
                self.active[slot] = None
                if self.paged:
                    self.kv.release(req.rid)
                    self._unreserve(req.rid)

    def _log_latency(self, req: Request) -> None:
        if req.t_submit <= 0.0:
            return
        t_admit = req.t_admit if req.t_admit > 0.0 else req.t_done
        self._lat_wait.append(max(t_admit - req.t_submit, 0.0))
        self._lat_e2e.append(max(req.t_done - req.t_submit, 0.0))
        for name, vals in (("queue_wait", self._lat_wait),
                           ("e2e", self._lat_e2e)):
            self.stats[f"{name}_p50_ms"] = float(
                np.percentile(vals, 50) * 1e3)
            self.stats[f"{name}_p99_ms"] = float(
                np.percentile(vals, 99) * 1e3)

    def latency_stats(self) -> dict:
        """Queue-wait and end-to-end latency percentiles (seconds) over
        every completed request."""
        out: dict = {"n": len(self._lat_e2e)}
        for name, vals in (("queue_wait", self._lat_wait),
                           ("e2e", self._lat_e2e)):
            if vals:
                out[f"{name}_p50"] = float(np.percentile(vals, 50))
                out[f"{name}_p99"] = float(np.percentile(vals, 99))
                out[f"{name}_mean"] = float(np.mean(vals))
        return out

    def _check_deadlines(self) -> None:
        """A slot that has decoded its ``deadline_steps`` (or the engine's
        ``slot_deadline_steps``) while others queue is preempted with spill
        to the queue's tail (``_check_deadlines`` :845)."""
        if not self.queue:
            return
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            ddl = (req.deadline_steps if req.deadline_steps is not None
                   else self.slot_deadline_steps)
            if ddl is not None and int(self._slot_steps[slot]) >= ddl:
                self.preempt(slot, spill=True, requeue="tail")
                self.stats["deadline_preempted"] += 1

    def _on_hung(self, ev: WatchdogEvent) -> None:
        """Watchdog escalation (``_on_hung`` :863): preempt with spill the
        longest-running slot and widen the pressure backoff."""
        victims = [s for s, r in enumerate(self.active) if r is not None]
        if not victims:
            return
        slot = max(victims, key=lambda s: int(self._slot_steps[s]))
        self.preempt(slot, spill=True, requeue="tail")
        self.stats["watchdog_preempted"] += 1
        self.watchdog.reset()
        self._next_pressure_admit = self._admit_clock + self._pressure_backoff
        self._pressure_backoff = min(2 * self._pressure_backoff,
                                     self.pressure_backoff_max)

    def _handle_integrity_failure(self, e: PageIntegrityError) -> None:
        """Fail the request that owns the corrupted page
        (``_handle_integrity_failure`` :879); corruption that names no
        request raises."""
        req = None
        if e.rid is not None:
            for r in list(self.active) + list(self.queue):
                if r is not None and r.rid == e.rid:
                    req = r
                    break
        if req is None:
            raise e
        self._fail_request(req, e)

    # ------------------------------------------------------------- step
    # apack: hot-path-root
    def step(self) -> int:
        """One engine iteration (``step`` :895): retire, deadlines, admit,
        decode (the async scheduler: ``_step_async``).  A page that fails
        an integrity check fails only its request; the watchdog observes
        the step's time.  Returns the number of active sequences."""
        if self.scheduler == "async":
            return self._step_async()
        t0 = time.perf_counter()
        if self.faults is not None:
            d = self.faults.step_delay()
            if d:
                time.sleep(d)
        self._retire()
        if self.paged:
            self._check_deadlines()
        self._admit()
        n_active = sum(r is not None for r in self.active)
        if n_active == 0:
            return 0
        slot_rids = [r.rid if r is not None else None for r in self.active]
        try:
            n_active = self._step_decode(slot_rids, n_active)
        except PageIntegrityError as e:
            # the guards fire before a page or a sequence changes
            # (step_meta and materialize's read guards, the re-pack's
            # check before its swap)
            self._handle_integrity_failure(e)
            n_active = sum(r is not None for r in self.active)
        if self.watchdog is not None:
            ev = self.watchdog.observe(time.perf_counter() - t0)
            if ev is not None and ev.kind == "hung":
                self._on_hung(ev)
        return n_active

    # apack: hot-path-root
    def _launch_fused(self, slot_rids: list) -> torch.Tensor:
        """Enqueue one fused decode step for ``slot_rids`` and its
        on-device append, without waiting for the card: the step meta,
        tokens and positions go up from pinned memory.  Returns the
        logits [B, 1, V] (on the device)."""
        kv = self.kv
        meta = kv.step_meta(slot_rids, self.max_len)
        logits, new_kv, kv.dev_states = M.decode_step_paged(
            self.cfg, self.params, kv.dev.planes, meta, kv.dev_states,
            m.to_device(self.last_tokens, self.device),
            m.to_device(self.positions, self.device))
        M.device_append(kv.dev.planes, new_kv,
                        kv.claim_append_targets(slot_rids))
        return logits

    def _launch_mesh(self, slot_rids: list):
        """Enqueue one sharded step (``_step_decode`` :929-951): each data
        shard's meta, then the append targets, then its tokens and
        positions up to its lead device and the sharded program.  The
        reference claims the targets first; the meta goes first here, as
        on one device, so that a poisoned generation (``step_meta``'s read
        guard) raises before any page is claimed, and the step can be taken
        again without its owner.  The tokens are the same either way (a
        claimed page holds no key yet).  Returns the gathered greedy tokens
        [B] and the logits [B, 1, V] on data shard 0's lead device."""
        kv, spb = self.kv, self.max_batch // self._n_data
        metas = kv.step_meta_sharded(slot_rids, self.max_len)
        targets = kv.claim_append_targets_sharded(slot_rids)
        leads = [kv.pool.lead(d) for d in range(self._n_data)]
        tokens = [m.to_device(self.last_tokens[d * spb:(d + 1) * spb], dev)
                  for d, dev in enumerate(leads)]
        pos = [m.to_device(self.positions[d * spb:(d + 1) * spb], dev)
               for d, dev in enumerate(leads)]
        toks, logits, _, kv.dev_states = self._step_mesh(
            kv.dev.shards, kv.dev_states, metas, tokens, pos, targets)
        return toks, torch.cat([lg.to(self.device) for lg in logits])

    def _step_decode(self, slot_rids: list, n_active: int) -> int:
        kv = self.kv
        toks_dev = None
        if self._step_mesh is not None:
            toks_dev, logits = self._launch_mesh(slot_rids)
            kv.note_appended(slot_rids)
        elif self.fused:
            logits = self._launch_fused(slot_rids)
            kv.note_appended(slot_rids)
        else:
            tokens = m.to_device(self.last_tokens, self.device)
            positions = m.to_device(self.positions, self.device)
            if self.paged:
                # the oracle: rebuild the dense int8 cache from the pool
                # (PACKED pages through the gather-decode kernel), decode
                # over it, move the new token back into pages, drop the
                # dense view
                cache = kv.materialize(slot_rids, self.max_len)
                logits, cache = M.decode_step(self.cfg, self.params, cache,
                                              tokens, positions)
                kv.append_step_tokens(cache, slot_rids, self.positions)
            else:
                logits, self.cache = M.decode_step(
                    self.cfg, self.params, self.cache, tokens, positions)
        if toks_dev is None:
            toks_dev = logits[:, 0].argmax(dim=-1)
        rs, failure = None, None
        if self.paged and self.kv_refresh:
            # drift check and budgeted re-pack after the step's seals
            # (``step`` :991-996); the re-pack's verdicts come back in the
            # tokens' pull
            try:
                rs = kv.refresh_step(self.kv_repack_budget)
                self.stats["kv_refreshes"] += len(rs["refreshed_layers"])
            except PageIntegrityError as e:
                failure = e
        if rs is not None and rs["job"] is not None:
            pulled = kv._fetch({"toks": toks_dev, **rs["job"]["pull"]})
            toks = pulled["toks"]
            try:
                self.stats["kv_pages_repacked"] += kv.finish_refresh(
                    rs, pulled)
            except PageIntegrityError as e:
                failure = e
        else:
            # apack: allow-transfer(the step's one sanctioned pull: the greedy
            # token ids for EOS/retire; a CUDA graph of the step leaves it
            # outside the graph)
            toks = toks_dev.cpu().numpy()
        self.last_logits = logits
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            req.tokens.append(int(toks[slot]))
            self.last_tokens[slot, 0] = toks[slot]
            self.positions[slot] += 1
            self._slot_steps[slot] += 1
            self.stats["generated"] += 1
        self.stats["steps"] += 1
        if failure is not None:
            # a page failed its checksum before its re-pack: the step's
            # K/V is appended already, so every slot takes its token
            # first, then the owner fails (``step``); the reference
            # raises before the tokens land and the others repeat the
            # step over K/V written twice (ROADMAP §3)
            raise failure
        return n_active

    # ------------------------------------------- async event-loop core
    def _step_async(self) -> int:
        """One iteration of the event loop (``_step_async`` :1011), in the
        reference's phase order:

        1. ``_overlap_host_work`` while the previous step is still on the
           card: host delays, the refresh and its re-pack launch, chunked
           prefill ingest, spill readahead;
        2. ``_collect``: the step's one pull, then the pages it and the
           chunks sealed, and its tokens against the dispatch-time slots;
        3. retire, deadlines and ``_admit_async``: every change of a slot
           binding happens here, after the collect;
        4. ``_dispatch`` of the next step, without waiting for it.

        The watchdog observes the step with the three phases' seconds."""
        t0 = time.perf_counter()
        if self.faults is not None:
            d = self.faults.step_delay()
            if d:
                time.sleep(d)
        self._overlap_host_work()
        t_host = time.perf_counter()
        self._collect()
        t_collect = time.perf_counter()
        self._retire()
        self._check_deadlines()
        self._admit_async()
        n_active = sum(r is not None for r in self.active)
        if n_active:
            try:
                self._dispatch()
            except PageIntegrityError as e:
                # step_meta's read guards fire before any page changes:
                # fail the owner and dispatch again for the rest
                self._handle_integrity_failure(e)
                n_active = sum(r is not None for r in self.active)
                if n_active:
                    self._dispatch()
        if self.watchdog is not None:
            ev = self.watchdog.observe(
                time.perf_counter() - t0,
                phases={"overlap_host": t_host - t0,
                        "collect": t_collect - t_host,
                        "schedule_dispatch":
                            time.perf_counter() - t_collect})
            if ev is not None and ev.kind == "hung":
                self._on_hung(ev)
        return n_active

    def _overlap_host_work(self) -> None:
        """The host work of the sync step, run while the dispatched step
        is on the card (``_overlap_host_work`` :1070).  With a step in
        flight it only enqueues: the re-pack's verdicts, the chunks' seals
        and the pumps' first tokens wait for ``_collect``'s pull.  With
        none in flight, a pump is drained at once, as a sync prefill."""
        if self.faults is not None:
            d = self.faults.host_delay()
            if d:
                time.sleep(d)
        if self.kv_refresh and self._inflight is not None:
            # drift check, refresh and the re-pack launch, once a step as
            # in the sync engine; ``_collect`` pulls the verdicts
            # apack: allow-phase(refresh swaps only sealed PACKED pages, whole
            # page and generation at once, and its re-pack launches on the
            # stream after the step in flight, so that step never reads a
            # half-swapped page)
            rs = self.kv.refresh_step(self.kv_repack_budget)
            self.stats["kv_refreshes"] += len(rs["refreshed_layers"])
            self._refresh_rs = rs
        for p in list(self._pump.values()):
            while not p.ingested:
                self._pump_chunk(p)
                if self._inflight is not None:
                    break          # paced: one chunk per overlapped step
        self._stage_readahead()

    def _pump_chunk(self, p: _PendingPrefill) -> None:
        """Ingest the pump's next ``prefill_chunk_tokens`` positions
        (``_pump_chunk`` :1097).  With a step in flight the chunk's seals,
        and a last chunk's ``finish_prefill`` and first-token pull, wait
        for ``_collect``; with none they run here."""
        kv = self.kv
        if p.view is None:
            p.view = kv.prefill_host_view(p.caches)
            p.caches = None
        t1 = min(p.cursor + self.prefill_chunk_tokens, p.s)
        flying = self._inflight is not None
        # apack: allow-phase(pending request's pages only: the rid has no slot
        # until admission completes post-collect, so the in-flight step cannot
        # reference these page tables)
        events = kv.ingest_prefill_chunk(p.req.rid, p.view, p.cursor, t1,
                                         p.s, seal=not flying)
        p.cursor = t1
        self.stats["prefill_chunks"] += 1
        if not p.ingested:
            if flying:
                self._chunk_seals += events
            return
        p.tok_dev = p.logits[0, -1].argmax()
        if flying:
            self._chunk_seals += events
            self._finished.append(p)
            return
        # apack: allow-phase(same pending-request argument as the chunk ingest
        # above: no slot binding exists yet for this rid)
        kv.finish_prefill(p.req.rid, p.view, p.s)
        p.view = None
        # apack: allow-transfer(prefill-completion event with no step in
        # flight, an idle engine's sync prefill: nothing to ride, one pull)
        p.tok = int(p.tok_dev)
        p.tok_dev = None

    def _stage_readahead(self) -> None:
        """Spill-tier readahead in the window (``_stage_readahead`` :1119):
        reserve and restore the highest-priority spilled request, so that
        its upload and checksum checks ride the step on the card instead
        of stalling the admission that resumes it.  One a step."""
        for req in self._admission_order():
            rid = req.rid
            if rid in self._preempted and rid in self._spilled:
                need = self._pages_for(req)
                if self._reserved_total + need > self.kv.pool.num_pages:
                    return                 # no headroom this step
                self._reserve(rid, need)
                try:
                    # apack: allow-phase(restores a parked spilled request into
                    # fresh pool slots; the in-flight step was dispatched
                    # without this rid and cannot read the new pages)
                    self.kv.unspill_request(rid)
                except PageIntegrityError as e:
                    self._fail_request(req, e)
                    return
                self._spilled.discard(rid)
                self.stats["staged_readahead"] += 1
                return
            if rid not in self._reserved and rid not in self._pump:
                return     # a higher-priority request claims the headroom

    def _start_pump(self, req: Request, need: int) -> None:
        """Reserve the request's pages and dispatch its bucketed prefill
        forward (``_start_pump`` :1147); it stays queued while the window
        ingests its pages chunk by chunk."""
        req.t_admit = time.perf_counter()
        logits, caches = self._prefill_forward(req.prompt)
        self.kv.add_request(req.rid)
        self._reserve(req.rid, need)
        self._pump[req.rid] = _PendingPrefill(
            req=req, s=len(req.prompt), logits=logits, caches=caches)

    def _bind_prefilled(self, slot: int, p: _PendingPrefill) -> None:
        """Bind a fully ingested pumped prefill to ``slot``
        (``_bind_prefilled`` :1158): its recurrent states into the device
        store, its first token as the slot's last."""
        req = p.req
        if self.kv.state_layers:
            self.kv.write_state_slot(slot, req.rid)
        req.tokens.append(p.tok)
        self.active[slot] = req
        self.positions[slot] = p.s
        self.last_tokens[slot, 0] = p.tok
        self._slot_steps[slot] = 0

    def _admit_async(self) -> None:
        """Continuous admission after the collect (``_admit_async`` :1173):
        bind ready pumped prefills and resume preempted requests into free
        slots; start pumps for queued requests that can reserve pages now.
        In ``_admission_order``; a blocked request stops the ones behind it
        from taking new reservations, but binds of work that already holds
        one still go ahead."""
        if not self.queue:
            return
        self._admit_clock += 1
        free = [s for s in range(self.max_batch) if self.active[s] is None]
        blocked = False
        for i, req in enumerate(self._admission_order()):
            rid = req.rid
            if rid in self._preempted:
                if not free:
                    # it still claims headroom while it waits for a slot
                    blocked = blocked or rid not in self._reserved
                    continue
                if blocked and rid not in self._reserved:
                    continue
                need = self._try_reserve(req, allow_relief=(i == 0))
                if need is None:
                    blocked = True
                    continue
                self.queue.remove(req)
                self._resume_request(free.pop(0), req, need)
                continue
            p = self._pump.get(rid)
            if p is None:
                if blocked or len(self._pump) >= self.max_batch:
                    blocked = True
                    continue
                need = self._try_reserve(req, allow_relief=(i == 0))
                if need is None:
                    blocked = True
                    continue
                self._start_pump(req, need)
                if free and not any(r is not None for r in self.active):
                    # idle engine: no step to overlap the ingest with, so
                    # admit as a sync prefill, in this very step
                    p = self._pump.pop(rid)
                    while not p.ingested:
                        self._pump_chunk(p)
                    self.queue.remove(req)
                    self._bind_prefilled(free.pop(0), p)
                continue
            if p.ready and free:
                self.queue.remove(req)
                del self._pump[rid]
                self._bind_prefilled(free.pop(0), p)
            # a pump still ingesting binds on a later step

    # apack: hot-path-root
    def _dispatch(self) -> None:
        """Enqueue the fused decode step for the current binding and
        return without waiting for it (``_dispatch`` :1230): the step, its
        on-device append and the greedy ids are launched
        (``_launch_fused``), and the binding is recorded for
        ``_collect``."""
        slot_rids = [r.rid if r is not None else None for r in self.active]
        logits = self._launch_fused(slot_rids)
        self._inflight = _InFlight(slot_reqs=list(self.active),
                                   slot_rids=slot_rids, logits=logits,
                                   toks=logits[:, 0].argmax(dim=-1))

    # apack: hot-path-root
    def _collect(self) -> None:
        """Land the step in flight (``_collect`` :1249): one pull brings
        its tokens, the re-pack verdicts of the window's refresh and the
        first tokens of the prefills that finished ingesting; then the
        re-pack is finished, the chunks' seals run, the finished prefills'
        ``finish_prefill`` (their evictions after those seals), and the
        step's own appends are noted and sealed, the order in which the
        reference's window and collect seal them; and the tokens go to the
        dispatch-time slots (every binding change runs after this)."""
        inf = self._inflight
        if inf is None:
            return
        self._inflight = None
        kv = self.kv
        rs, self._refresh_rs = self._refresh_rs, None
        tree = {"toks": inf.toks}
        if rs is not None and rs["job"] is not None:
            tree.update(rs["job"]["pull"])
        for p in self._finished:
            tree[f"tok/{p.req.rid}"] = p.tok_dev.reshape(1)
        pulled = kv._fetch(tree)
        toks = pulled["toks"]
        if rs is not None:
            self.stats["kv_pages_repacked"] += kv.finish_refresh(
                rs, pulled if rs["job"] is not None else None)
        seals, self._chunk_seals = self._chunk_seals, []
        kv._seal(seals)
        finished, self._finished = self._finished, []
        for p in finished:
            p.tok = int(pulled[f"tok/{p.req.rid}"][0])
            p.tok_dev = None
            kv.finish_prefill(p.req.rid, p.view, p.s)
            p.view = None
        kv.note_appended(inf.slot_rids)
        self.last_logits = inf.logits
        for slot, req in enumerate(inf.slot_reqs):
            if req is None:
                continue
            tok = int(toks[slot])
            req.tokens.append(tok)
            self.last_tokens[slot, 0] = tok
            self.positions[slot] += 1
            self._slot_steps[slot] += 1
            self.stats["generated"] += 1
        self.stats["steps"] += 1

    def _drain(self) -> None:
        """Land the step in flight, if any (``_drain`` :1275), so that a
        change from outside the loop (``preempt``) sees a consistent
        engine; nothing on the sync scheduler."""
        if self._inflight is not None:
            self._collect()

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        """Step until every request is done (``run_until_drained`` :1283);
        with work queued and nothing active for more than twice the
        pressure backoff's limit, ``AdmissionImpossible`` instead of
        spinning."""
        stalled = 0
        for _ in range(max_steps):
            # an idle step that advanced a pumped prefill is progress (the
            # async scheduler ingests chunks before the first slot binds)
            if self.step() > 0 or self._pump:
                stalled = 0
                continue
            if not self.queue:
                break
            stalled += 1
            if stalled > 2 * self.pressure_backoff_max:
                head = self.queue[0]
                need = self._pages_for(head) if self.paged else 0
                pool = self.kv.pool.num_pages if self.paged else 0
                raise AdmissionImpossible(
                    head, need, pool,
                    f"{stalled} consecutive no-progress steps with zero "
                    "active slots")

    def weight_stats(self) -> dict:
        """Weight-store accounting of the packed serving path
        (``weight_stats`` :1308).  Every decode step reads the compressed
        planes (APack payload + per-channel dequant scale) where the dense
        engine reads the full matrices: ``weight_ratio`` is that per-step
        read ratio against the int8 dense store, ``native_ratio`` against
        the original dtype.  Totals scale with ``stats["steps"]``."""
        if self._weight_stats is None:
            return {"weights": "dense"}
        s = dict(self._weight_stats)
        comp = s["payload_bytes"] + s["scale_bytes"]
        s["weights"] = "apack-int8"
        s["compressed_read_bytes_per_step"] = comp
        s["dense_read_bytes_per_step"] = s["int8_bytes"]
        s["weight_ratio"] = comp / max(s["int8_bytes"], 1)
        s["native_ratio"] = comp / max(s["native_bytes"], 1)
        steps = self.stats["steps"]
        s["compressed_read_bytes_total"] = comp * steps
        s["dense_read_bytes_total"] = s["int8_bytes"] * steps
        return s

    def kv_stats(self) -> dict:
        """Raw-vs-compressed KV traffic and pool occupancy (paged modes;
        empty for a dense cache)."""
        if not self.paged:
            return {}
        out = dict(self.kv.traffic)
        out["kv_ratio"] = self.kv.kv_ratio()
        out["kv_streams"] = self.kv.stream_stats()
        out["kv_pool_pages"] = self.kv.pool.num_pages
        out["kv_pages_allocated"] = self.kv.pool.alloc_count
        out["kv_pages_high_water"] = self.kv.pool.high_water
        out["kv_pages_evicted"] = self.kv.pool.evict_count
        out["kv_fused"] = self.fused
        out["transfers"] = dict(self.kv.transfers)
        if self._n_data > 1:
            # per data shard (``kv_stats`` :1352-1357): free-list depth and
            # live reservations
            out["kv_shard_free"] = [self.kv.pool.free_count_shard(s)
                                    for s in range(self._n_data)]
            out["kv_shard_reserved"] = list(self._shard_reserved)
        out["kv_repack"] = out["kv_streams"]["repack"]
        out["kv_spill"] = out["kv_streams"]["spill"]
        out["kv_pages_spilled"] = self.kv.pool.spill_count
        out["kv_pages_unspilled"] = self.kv.pool.unspill_count
        out["kv_spilled_requests"] = {
            rid: self.kv.spilled_pages(rid)
            for rid in sorted(self._spilled) if rid in self.kv.page_tables}
        return out
