"""Fault injection for the port's serving loop.

Port of ``repro/serve/faults.py`` (``FaultInjector`` :26-132), acting on
the port's tensors.  The injector sits on seams the system already has:
the host<->device transfer boundary (``PagedKVCache._fetch``/``_put``),
the host spill tier's records (``modules.HostSpillTier``), the page
generation metadata and the engine's step timing.  Every injected fault
must be detected (checksum, generation guard) or absorbed (bounded
transfer retry, watchdog preemption); a token that silently changes is
the failure the tests look for.  Faults are deterministic and budgeted
(exactly ``n``), so runs reproduce.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.modules import (HostSpillTier, PageIntegrityError,
                                        TransferDropped)

__all__ = ["FaultInjector", "PageIntegrityError", "TransferDropped"]


class FaultInjector:
    """Deterministic, budgeted fault source for the KV and serving stack.

    Attach with ``ServeEngine(..., faults=inj)`` (or set
    ``PagedKVCache.faults``), then arm faults:

    * ``drop_transfers("h2d", n)``: the next ``n`` uploads raise
      ``TransferDropped`` (the cache retries up to ``transfer_retries``);
    * ``flip_bit(tier, handle)``: flip one bit of a spilled page's host
      payload (caught by its CRC at unspill, the record quarantined);
    * ``corrupt_packed_page(kv, pid)``: flip one bit of a resident PACKED
      page's K sym plane on its device (caught with ``verify_on_repack``);
      on a mesh, on every model shard's copy of the page in its data
      shard;
    * ``poison_generation(kv, pid)``: stamp a table generation outside the
      live pool (caught by the read guard of ``step_meta``);

    A page id is global: on a mesh a fault acts on the data shard that
    owns the page, at its index there.
    * ``delay_steps(seconds, n)`` / ``delay_spills(seconds, n)``: stall
      the engine's step or a spill (drives the watchdog);
    * ``delay_host_work(seconds, n)``: stalls the async scheduler's host
      phase; the sync engine has none and ignores it.
    """

    def __init__(self):
        self._drop_budget = {"h2d": 0, "d2h": 0}
        self._step_delays: list[float] = []
        self._spill_delays: list[float] = []
        self._host_delays: list[float] = []
        self.stats = {"h2d_dropped": 0, "d2h_dropped": 0,
                      "bits_flipped": 0, "generations_poisoned": 0,
                      "steps_delayed": 0, "spills_delayed": 0,
                      "host_work_delayed": 0}

    # ------------------------------------------------------- transfers
    def drop_transfers(self, direction: str, n: int = 1) -> None:
        if direction not in self._drop_budget:
            raise ValueError(f"unknown transfer direction {direction!r}")
        self._drop_budget[direction] += n

    def check_transfer(self, direction: str) -> None:
        """Called by ``PagedKVCache._fetch``/``_put`` before a transfer."""
        if self._drop_budget.get(direction, 0) > 0:
            self._drop_budget[direction] -= 1
            self.stats[f"{direction}_dropped"] += 1
            raise TransferDropped(
                f"injected {direction} transfer drop "
                f"({self._drop_budget[direction]} left in budget)",
                direction=direction)

    # ------------------------------------------------------- integrity
    def flip_bit(self, tier: HostSpillTier, handle: int, *,
                 array: str | None = None, bit: int = 0) -> None:
        """Flip one bit of a live spill record's payload in place: host
        memory corrupted while the page was parked."""
        rec = tier.get(handle, verify=False)
        name = array if array is not None else sorted(rec.payload)[0]
        flat = rec.payload[name].view(np.uint8).reshape(-1)
        flat[bit // 8] ^= np.uint8(1 << (bit % 8))
        self.stats["bits_flipped"] += 1

    def corrupt_packed_page(self, kv, pid: int, *, bit: int = 0) -> None:
        """Flip one bit of a resident PACKED page's K sym plane where it
        lies (on the card, or on the CPU).  On a mesh the page is one
        logical page whose PACKED planes every model shard of its data
        shard holds whole, so each copy takes the flip."""
        pool = kv.pool
        shard, loc = divmod(int(pid), pool.pages_per_shard)
        # the same bit as the JAX package's flip of byte bit // 8 of the
        # little-endian u32 words
        mask = int(np.uint32(1 << (bit % 32)).view(np.int32))
        for part in pool.parts[shard]:
            word = part["sym"][0, loc].reshape(-1)
            word[bit // 32] ^= mask
        self.stats["bits_flipped"] += 1

    def poison_generation(self, kv, pid: int, *, offset: int = 7) -> None:
        """Stamp a table generation past the live pool: a decode that
        trusted it would read rows that are not there."""
        kv.page_gen[pid] = kv.generation + offset
        self.stats["generations_poisoned"] += 1

    # ---------------------------------------------------------- delays
    def delay_steps(self, seconds: float, n: int = 1) -> None:
        self._step_delays.extend([seconds] * n)

    def step_delay(self) -> float:
        """Taken by the engine at the top of each step."""
        if self._step_delays:
            self.stats["steps_delayed"] += 1
            return self._step_delays.pop(0)
        return 0.0

    def delay_spills(self, seconds: float, n: int = 1) -> None:
        self._spill_delays.extend([seconds] * n)

    def delay_host_work(self, seconds: float, n: int = 1) -> None:
        self._host_delays.extend([seconds] * n)

    def host_delay(self) -> float:
        if self._host_delays:
            self.stats["host_work_delayed"] += 1
            return self._host_delays.pop(0)
        return 0.0

    def spill_delay(self) -> float:
        """Taken by ``PagedKVCache.spill_request``."""
        if self._spill_delays:
            self.stats["spills_delayed"] += 1
            return self._spill_delays.pop(0)
        return 0.0
