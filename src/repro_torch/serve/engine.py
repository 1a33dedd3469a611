"""Batched serving engine over the paged APack KV cache or a dense cache.

Port of the single-device, ``scheduler="sync"`` path of
``repro/serve/engine.py``: ``prefill_bucket`` :52, ``Request`` :76,
``AdmissionImpossible`` :132, ``ServeEngine.__init__`` :210 (with the
packed weight store, ``weights="apack-int8"``), ``submit`` :398,
``_try_reserve``/``_resume_request``/``_admit`` :468/:499/:514, the
pressure escalation ``_relieve_pressure``/``_spill_reserved`` :549/:605,
``_fail_request`` :614, ``_prefill_forward`` :646, ``_prefill_into_slot``
:680, ``_write_prefill_cache`` :710, ``preempt`` :730 (with the host
spill tier), ``_resume_into_slot`` :778, ``_retire`` :800,
``latency_stats`` :831, ``_check_deadlines``/``_on_hung``/
``_handle_integrity_failure`` :845-891, ``step`` :895 and
``_step_decode`` :928-1008 (fused, materialize and dense branches, the
fused one carrying the recurrent layers' device state store, and the
table refresh hook), ``run_until_drained`` :1283, ``weight_stats`` :1308
and ``kv_stats`` :1333; and the checkpoint-style weight round trip,
``CompressedParams`` :146, ``compress_params`` :160 and
``decompress_params`` :196.  The stacks are any mix of global and rolling
attention layers and RG-LRU recurrent layers, prefix or cycled.  Not
ported: the async scheduler with chunked prefill, SLO admission and
meshes, each refused with its ROADMAP item.

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
from repro_torch.models import model as M
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
    # end-to-end latency SLO (admission by deadline is not ported: a
    # request that sets it is refused at submit)
    slo_ms: float | None = None
    # a failure (integrity quarantine): done with the error set and the
    # tokens cut at the failure, never silently wrong
    error: str | None = None


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


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
                                                 else [])
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
        if mesh is not None:
            _refuse("mesh= (multi-device serving)",
                    "open item 1.10, multi-device serving")
        if scheduler != "sync":
            _refuse(f"scheduler={scheduler!r}",
                    "open item 1.8, serving robustness (async scheduler)")
        if prefill_chunk_tokens is not None:
            _refuse("prefill_chunk_tokens (chunked prefill)",
                    "open item 1.8, serving robustness (async scheduler)")
        if weights not in (None, "apack-int8"):
            raise ValueError(f"unknown weights mode {weights!r}; "
                             "expected 'apack-int8' or None")
        if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r};"
                             f" expected one of {KV_CACHE_DTYPES}")
        M.check_supported(cfg)
        self.device = resolve(device)
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
                      "watchdog_preempted": 0,
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
            self.kv = M.PagedKVCache(
                cfg, kv_pages, page_size=kv_page_size,
                calib_pages=kv_calib_pages,
                refresh_every_pages=kv_refresh_every_pages,
                refresh_threshold=kv_refresh_threshold,
                refresh_min_pages=kv_refresh_min_pages,
                verify_on_repack=kv_verify_on_repack,
                drift_sketch=kv_refresh, device=self.device)
            self.kv.faults = faults
            # both paged modes read the device pool (the oracle uses its
            # table stack for the gather decode); the fused step also
            # carries the recurrent layers' device state store
            self.kv.enable_device_pool(max_batch if self.fused else None)
        else:
            self.cache = M.init_cache(cfg, max_batch, max_len,
                                      device=self.device)
        self._reserved: dict[int, int] = {}
        self._reserved_total = 0
        # rid -> (state snapshot, position, last token) of a preempted
        # request, which resumes without a new prefill
        self._preempted: dict[int, tuple] = {}
        self._lat_wait: list[float] = []
        self._lat_e2e: list[float] = []

    # -------------------------------------------------------- scheduling
    def submit(self, req: Request) -> None:
        if req.slo_ms is not None:
            _refuse("Request.slo_ms (SLO admission)",
                    "open item 1.8, serving robustness (SLO admission)")
        if self.paged:
            need = self._pages_for(req)
            if need > self.kv.pool.num_pages:
                raise ValueError(
                    f"request {req.rid} needs {need} pages worst-case but "
                    f"the pool only has {self.kv.pool.num_pages}; shorten "
                    "the request or grow kv_pages")
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _pages_for(self, req: Request) -> int:
        """Worst-case page reservation: prompt + generated tokens, capped
        at the context window."""
        toks = min(self.max_len, len(req.prompt) + req.max_new_tokens)
        return self.kv.pages_needed(toks)

    def _unreserve(self, rid: int) -> int:
        need = self._reserved.pop(rid)
        self._reserved_total -= need
        return need

    def _try_reserve(self, req: Request, *, allow_relief: bool) -> int | None:
        """Pages to reserve for an admission candidate (0 while it still
        holds its reservation), or None while it stays blocked
        (``_try_reserve`` :468).  Only the head may trigger pressure relief
        (``allow_relief``); the need is taken again after relief, which can
        change the head's own standing."""
        need = 0 if req.rid in self._reserved else self._pages_for(req)
        if self._reserved_total + need <= self.kv.pool.num_pages:
            if allow_relief:
                self._pressure_backoff = 1    # clean head admission
            return need
        if not allow_relief:
            return None
        self.stats["kv_admission_blocked"] += 1
        if not self._relieve_pressure(req, need):
            return None                       # the request waits
        need = 0 if req.rid in self._reserved else self._pages_for(req)
        if self._reserved_total + need > self.kv.pool.num_pages:
            return None                       # partial relief; retry later
        self.stats["admission_retries"] += 1
        return need

    def _resume_request(self, slot: int, req: Request, need: int) -> None:
        """Resume a preempted request (``_resume_request`` :499): take its
        reservation again where it gave it up, and fail only it if its
        spilled pages come back corrupted."""
        if need:
            self._reserved[req.rid] = need
            self._reserved_total += need
        try:
            self._resume_into_slot(slot, req)
        except PageIntegrityError as e:
            self._fail_request(req, e)

    def _admit(self) -> None:
        """Fill idle slots from the queue head (``_admit`` :514), FIFO;
        with the pool short, the head may trigger pressure relief."""
        for slot in range(self.max_batch):
            if self.active[slot] is not None or not self.queue:
                continue
            if not self.paged:
                self._prefill_into_slot(slot, self.queue.popleft(), 0)
                continue
            self._admit_clock += 1
            head = self.queue[0]
            need = self._try_reserve(head, allow_relief=True)
            if need is None:
                break                          # the head waits (FIFO)
            self.queue.remove(head)
            if head.rid in self._preempted:
                self._resume_request(slot, head, need)
                continue
            self._prefill_into_slot(slot, head, need)

    def _relieve_pressure(self, head: Request, need: int) -> bool:
        """Bounded spill -> retry -> preempt escalation under pool
        exhaustion (``_relieve_pressure`` :549).  Returns True when
        reservation headroom was freed.  Level 1: spill the coldest
        preempted request still holding a reservation (never the head).
        Level 2 (``kv_pressure``): preempt with spill the longest-running
        active slot, gated by exponential backoff; with no slot to preempt
        and nothing to spill, ``AdmissionImpossible``."""
        parked = [rid for rid in self._preempted
                  if rid in self._reserved and rid not in self._spilled
                  and rid != head.rid]
        if parked:
            self._spill_reserved(min(parked, key=self.kv.request_last_read))
            return True
        if not self.kv_pressure:
            return False
        if self._admit_clock < self._next_pressure_admit:
            return False                       # backing off
        victims = [s for s, r in enumerate(self.active) if r is not None]
        if not victims:
            raise AdmissionImpossible(
                head, need, self.kv.pool.num_pages,
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
        for s, r in enumerate(self.active):
            if r is req:
                self.active[s] = None
        try:
            self.queue.remove(req)
        except ValueError:
            pass
        if self.paged:
            if rid in self.kv.page_tables:
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

    def _prefill_forward(self, prompt):
        """Single-request prefill at the prompt's power-of-two bucket; a
        prompt shorter than its bucket is zero-padded and its logits are
        taken at the true last position."""
        s = len(prompt)
        bucket = prefill_bucket(s, self.max_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :s] = np.asarray(prompt)
        tokens = torch.as_tensor(toks, device=self.device)
        return M.forward(self.cfg, self.params, tokens, last_only=True,
                         true_len=None if s == bucket else s)

    def _prefill_into_slot(self, slot: int, req: Request, need: int) -> None:
        s = len(req.prompt)
        req.t_admit = time.perf_counter()
        logits, caches = self._prefill_forward(req.prompt)
        if self.paged:
            self.kv.add_request(req.rid)
            self._reserved[req.rid] = need
            self._reserved_total += need
            self.kv.ingest_prefill(req.rid, caches, s)
            if self.fused and self.kv.state_layers:
                self.kv.write_state_slot(slot, req.rid)
        else:
            self._write_prefill_cache(slot, caches)
        next_tok = int(logits[0, -1].argmax())   # admission event
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
    def step(self) -> int:
        """One engine iteration (``step`` :895): retire, deadlines, admit,
        decode.  A page that fails an integrity check fails only its
        request; the watchdog observes the step's time.  Returns the
        number of active sequences."""
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

    def _step_decode(self, slot_rids: list, n_active: int) -> int:
        kv = self.kv
        tokens = torch.as_tensor(self.last_tokens, device=self.device)
        positions = torch.as_tensor(self.positions, device=self.device)
        if self.fused:
            meta = kv.step_meta(slot_rids, self.max_len)
            logits, new_kv, kv.dev_states = M.decode_step_paged(
                self.cfg, self.params, kv.dev.planes, meta, kv.dev_states,
                tokens, positions)
            targets = kv.claim_append_targets(slot_rids)
            M.device_append(kv.dev.planes, new_kv, targets)
            kv.note_appended(slot_rids)
        elif self.paged:
            # the oracle: rebuild the dense int8 cache from the pool
            # (PACKED pages through the gather-decode kernel), decode over
            # it, move the new token back into pages, drop the dense view
            cache = kv.materialize(slot_rids, self.max_len)
            logits, cache = M.decode_step(self.cfg, self.params, cache,
                                          tokens, positions)
            kv.append_step_tokens(cache, slot_rids, self.positions)
        else:
            logits, self.cache = M.decode_step(self.cfg, self.params,
                                               self.cache, tokens, positions)
        toks_dev = logits[:, 0].argmax(dim=-1)
        rs = None
        if self.paged and self.kv_refresh:
            # drift check and budgeted re-pack after the step's seals
            # (``step`` :991-996); the re-pack's verdicts come back in the
            # tokens' pull
            rs = kv.refresh_step(self.kv_repack_budget)
            self.stats["kv_refreshes"] += len(rs["refreshed_layers"])
        if rs is not None and rs["job"] is not None:
            pulled = kv._fetch({"toks": toks_dev, **rs["job"]["pull"]})
            toks = pulled["toks"]
            self.stats["kv_pages_repacked"] += kv.finish_refresh(rs, pulled)
        else:
            # the step's one sanctioned pull: token ids for EOS/retire
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
        return n_active

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        """Step until every request is done (``run_until_drained`` :1283);
        with work queued and nothing active for more than twice the
        pressure backoff's limit, ``AdmissionImpossible`` instead of
        spinning."""
        stalled = 0
        for _ in range(max_steps):
            if self.step() > 0:
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
        out["kv_repack"] = out["kv_streams"]["repack"]
        out["kv_spill"] = out["kv_streams"]["spill"]
        out["kv_pages_spilled"] = self.kv.pool.spill_count
        out["kv_pages_unspilled"] = self.kv.pool.unspill_count
        out["kv_spilled_requests"] = {
            rid: self.kv.spilled_pages(rid)
            for rid in sorted(self._spilled) if rid in self.kv.page_tables}
        return out
