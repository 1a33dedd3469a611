"""The dry run's cost counter: FLOPs, bytes, collective bytes and memory of
one call of a cell, per device.

Counterpart of ``repro/launch/hlo_costs.py``.  The reference lowers each
cell and walks the compiled HLO (``walk`` :202-320), multiplying while-loop
bodies by their trips; the port runs eagerly, so it runs the cell itself,
once, and ``CostCounter`` (a ``TorchDispatchMode``) books each aten op as
it happens on the device of its output (a fake tensor on a fake device under
the dry run's ``FakeTensorMode``, or a tensor on the card).  Every loop
trip is an op sequence of its own, so nothing is multiplied.

- FLOPs as ``walk`` counts them: ``torch.utils.flop_counter``'s formulas
  for matmul, bmm and convolution (2 x numel(result) x the contracted
  size; an einsum reaches the counter as its bmm), numel(result) for
  every elementwise op and reduction, none for ops that only move or make
  data.
- Bytes: the operands plus the result of each op: an eager port writes
  every op's output, so this is its traffic, not a bound.  Views count 0;
  an op that writes in place counts the region it writes twice, and a
  scatter its indices and updates twice; a gather (index, embedding) twice
  its result (``walk``'s dynamic-update-slice, scatter and gather rules
  :266-301).
- Collective bytes: each copy between two devices, booked to the
  collective running (``sharding.collective_kind``; a copy outside one is
  a ``copy``), as operand bytes and as the wire bytes of
  ``_collective_bytes``' ring model (:184-199): an all-reduce moves twice
  its operands, the other kinds once.  The roofline reads each device's
  copies by the link they cross (``link``).
- Memory: each device's argument bytes (given) plus the bytes of the
  storages the call made and still holds, tracked with ``weakref.finalize``
  on each new storage; the peak over the call is the counterpart of
  ``memory_analysis()``'s argument + output + temp - alias.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.device import FAKE_DEVICE_TYPES, fake_index
from repro_torch.models.sharding import collective_kind

HOST = -1                      # ops on host tensors

# ``_collective_bytes`` :184-199, wire bytes a moved operand byte
RING = {"all-reduce": 2}

# ops that move or make data: bytes, no FLOPs
MOVE_OPS = frozenset({
    "_to_copy", "copy_", "clone", "cat", "stack", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like",
    "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like",
    "new_full", "fill_", "zero_", "arange", "scalar_tensor", "lift_fresh",
    "lift_fresh_copy", "index", "index_select", "gather", "embedding",
    "index_put_", "index_put", "_index_put_impl_", "scatter", "scatter_",
    "slice_scatter", "select_scatter", "roll", "constant_pad_nd", "repeat",
    "expand_copy", "_unsafe_view", "detach", "alias", "_local_scalar_dense",
    "flip", "tril", "triu", "one_hot", "masked_fill", "masked_fill_",
    "narrow_copy", "split_with_sizes_copy", "unbind_copy", "view_copy",
    "permute_copy", "t_copy", "transpose_copy", "_reshape_copy"})
# reads only what it gathers: twice its result
GATHER_OPS = frozenset({"index", "index_select", "gather", "embedding"})
# writes its updates in place: twice its indices and updates
SCATTER_OPS = frozenset({"index_put_", "_index_put_impl_", "scatter_",
                         "scatter_add_", "index_add_", "index_copy_"})
# views that no alias annotation marks
ZERO_OPS = frozenset({"_unsafe_view", "lift_fresh", "detach", "alias"})


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def dev_of(t: torch.Tensor) -> int:
    """The device index an op on ``t`` is booked to: a fake device's
    ``device.fake_index``, a card's index, ``HOST`` on the CPU."""
    dev = t.device
    if dev.type == "cpu":
        return HOST
    if dev.type in FAKE_DEVICE_TYPES:
        return fake_index(dev)
    return dev.index or 0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Books every aten op run under it (see the module docstring).

    ``arg_bytes``: ``{device index: bytes}`` the call's arguments hold
    (``sharding.device_bytes`` over the placed trees).  After the call:
    ``ops[(name, dev)] = [calls, flops, bytes]``, ``copies[(kind, src,
    dst)] = [calls, bytes]``, ``peak[dev]`` the most bytes the device held
    (arguments included) and ``record()`` all of it as plain JSON."""

    def __init__(self, arg_bytes: dict | None = None):
        super().__init__()
        self.arg = {int(k): int(v) for k, v in (arg_bytes or {}).items()}
        self.ops: dict = collections.defaultdict(lambda: [0, 0, 0])
        self.copies: dict = collections.defaultdict(lambda: [0, 0])
        self.live: dict = collections.defaultdict(int)
        self.peak: dict = dict(self.arg)
        self._seen: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._book(func, args, kwargs, out)
        return out

    def _book(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        mutates = func._schema.is_mutable
        if not outs and not mutates:       # a metadata query (``device``)
            return
        ins = _tensors(args) + _tensors(kwargs)
        dev = dev_of(outs[0] if outs else ins[0])
        if func.is_view or name in ZERO_OPS:
            flops = byts = 0
        elif name in ("_to_copy", "copy_") and len(ins) >= 1 and \
                self._cross(name, ins, outs):
            return
        else:
            packet = func.overloadpacket
            if packet in flop_registry:
                flops = int(flop_registry[packet](*args, **kwargs,
                                                  out_val=out))
            elif name in MOVE_OPS or not outs:
                flops = 0
            else:
                flops = outs[0].numel()
            if name in SCATTER_OPS:
                byts = 2 * sum(nbytes(t) for t in ins[1:])
            elif mutates and name.endswith("_"):
                byts = 2 * nbytes(ins[0])
            elif name in GATHER_OPS:
                byts = 2 * sum(nbytes(t) for t in outs)
            else:
                byts = sum(nbytes(t) for t in ins) + \
                    sum(nbytes(t) for t in outs)
        rec = self.ops[(name, dev)]
        rec[0] += 1
        rec[1] += flops
        rec[2] += byts
        if not mutates and not func.is_view and name not in ZERO_OPS:
            for t in outs:
                self._hold(t)

    def _cross(self, name: str, ins: list, outs: list) -> bool:
        """Book a copy between two devices (its read on the source, its
        write on the destination, its bytes to the collective running);
        False for a copy within one device."""
        src, dst = (ins[1], ins[0]) if name == "copy_" else (ins[0], outs[0])
        s, d = dev_of(src), dev_of(dst)
        if s == d:
            return False
        b = nbytes(src)
        for k in (s, d):
            rec = self.ops[(name, k)]
            rec[0] += 1
            rec[2] += b
        rec = self.copies[(collective_kind() or "copy", s, d)]
        rec[0] += 1
        rec[1] += b
        if name != "copy_":
            self._hold(outs[0])
        return True

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        dev, n = dev_of(t), st.nbytes()
        self._seen[key] = (dev, n)
        self.live[dev] += n
        now = self.arg.get(dev, 0) + self.live[dev]
        if now > self.peak.get(dev, 0):
            self.peak[dev] = now
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        dev, n = self._seen.pop(key)
        self.live[dev] -= n

    def record(self) -> dict:
        """The counts as plain JSON (``combine``, ``roofline`` and the dry
        run's saved per-op record read it)."""
        return {"ops": sorted([name, dev, *v]
                              for (name, dev), v in self.ops.items()),
                "copies": sorted([kind, s, d, *v]
                                 for (kind, s, d), v in self.copies.items()),
                "args": {str(k): v for k, v in sorted(self.arg.items())},
                "peak": {str(k): v for k, v in sorted(self.peak.items())}}


def combine(one: dict, two: dict, n: int) -> dict:
    """The record of ``n`` trips from records of one and of two (the same
    cell with one and two cycles of its layer pattern, or microbatches):
    ``one + (n - 1) (two - one)`` for every count, and for each device's
    argument bytes and peak; the counterpart of ``walk``'s ``trips``."""
    def lin(a, b):
        return a + (n - 1) * (b - a)

    def keyed(rows, width):
        out = {}
        for r in rows:
            out[tuple(r[:-width])] = r[-width:]
        return out

    out = {}
    for key, width in (("ops", 3), ("copies", 2)):
        a, b = keyed(one[key], width), keyed(two[key], width)
        rows = []
        for k in sorted(set(a) | set(b)):
            va, vb = a.get(k, [0] * width), b.get(k, [0] * width)
            rows.append([*k, *(lin(x, y) for x, y in zip(va, vb))])
        out[key] = rows
    for key in ("args", "peak"):
        devs = sorted(set(one[key]) | set(two[key]), key=int)
        out[key] = {d: lin(one[key].get(d, 0), two[key].get(d, 0))
                    for d in devs}
    return out


def by_op(record: dict) -> dict:
    """``{op name: [calls, flops, bytes]}`` summed over the devices."""
    out: dict = collections.defaultdict(lambda: [0, 0, 0])
    for name, _, calls, flops, byts in record["ops"]:
        o = out[name]
        o[0] += calls
        o[1] += flops
        o[2] += byts
    return dict(out)


def per_device(record: dict) -> dict:
    """``{dev: {"flops", "bytes"}}`` over the record's ops (the host's
    left out)."""
    out: dict = {}
    for _, dev, _, flops, byts in record["ops"]:
        if dev == HOST:
            continue
        d = out.setdefault(dev, {"flops": 0, "bytes": 0})
        d["flops"] += flops
        d["bytes"] += byts
    return out


def collectives(record: dict) -> dict:
    """By kind: ``{"calls", "operand_bytes", "wire_bytes"}`` (the ring
    model, ``RING``)."""
    out: dict = {}
    for kind, _, _, calls, byts in record["copies"]:
        k = out.setdefault(kind, {"calls": 0, "operand_bytes": 0,
                                  "wire_bytes": 0})
        k["calls"] += calls
        k["operand_bytes"] += byts
        k["wire_bytes"] += RING.get(kind, 1) * byts
    return out


def link_bytes(record: dict, cards_per_host: int) -> dict:
    """``{dev: {"in"|"out": {"nvlink"|"network": bytes}}}``: each copy by
    the link it crosses, NVLink between two cards of a host (device
    indices ``cards_per_host`` to a host, in mesh order), the network
    between hosts."""
    out: dict = {}
    for _, s, d, _, byts in record["copies"]:
        if HOST in (s, d):
            continue
        link = "nvlink" if s // cards_per_host == d // cards_per_host \
            else "network"
        for dev, way in ((s, "out"), (d, "in")):
            io = out.setdefault(dev, {"in": {}, "out": {}})[way]
            io[link] = io.get(link, 0) + byts
    return out


def roofline(record: dict, consts: dict) -> dict:
    """Each device's compute, memory and collective seconds (its FLOPs
    over the peak rate, its bytes over the memory rate, its copies over
    the link each crosses, the busier direction), and the cell's figure:
    the busiest device's terms (the largest of its three), with each
    term's spread over the devices.  ``consts``: ``peak_flops``,
    ``hbm_bw``, ``nvlink_bw``, ``network_bw``, ``cards_per_host``."""
    devs = per_device(record)
    links = link_bytes(record, consts["cards_per_host"])
    bw = {"nvlink": consts["nvlink_bw"], "network": consts["network_bw"]}
    terms = {}
    for dev in sorted(set(devs) | set(links)):
        d = devs.get(dev, {"flops": 0, "bytes": 0})
        io = links.get(dev, {"in": {}, "out": {}})
        coll = max(sum(b / bw[k] for k, b in io[w].items())
                   for w in ("in", "out"))
        terms[dev] = {"compute_s": d["flops"] / consts["peak_flops"],
                      "memory_s": d["bytes"] / consts["hbm_bw"],
                      "collective_s": coll, "flops": d["flops"],
                      "bytes": d["bytes"]}
    if not terms:
        return {}
    busiest = max(terms, key=lambda k: (max(
        terms[k][t] for t in ("compute_s", "memory_s", "collective_s")), -k))
    t = terms[busiest]
    dominant = max(("compute", t["compute_s"]), ("memory", t["memory_s"]),
                   ("collective", t["collective_s"]), key=lambda kv: kv[1])[0]

    def spread(key):
        v = sorted(x[key] for x in terms.values())
        return [v[0], v[len(v) // 2], v[-1]]

    return {"busiest_device": busiest, "compute_s": t["compute_s"],
            "memory_s": t["memory_s"], "collective_s": t["collective_s"],
            "dominant": dominant, "flops": t["flops"], "bytes": t["bytes"],
            "spread": {k: spread(k) for k in ("compute_s", "memory_s",
                                              "collective_s")},
            "n_devices": len(terms)}
