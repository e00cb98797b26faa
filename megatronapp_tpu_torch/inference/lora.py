"""Multi-tenant batched-LoRA serving: the adapter registry and the device
LRU cache (the port's copy of the JAX package's inference/lora.py).

One resident base model (bf16 or resident int8) serves many tenants'
low-rank adapters, batched into every decode step as ``base(x) + (x·A_i)
·B_i`` with a different adapter on each row:

- :class:`LoraAdapter`: one tenant's ``{A, B}`` pair per LORA_TARGETS
  kernel (q/kv/out/fc1/fc2), stacked over layers, as numpy fp32. Saved as
  ``<lora_dir>/<adapter_id>.npz`` (plain, or PTQ-int8 through the port's
  ``quantization.quantize_leaf``) in the JAX package's layout, so a file
  written by either package loads in the other bit for bit.
- :class:`AdapterRegistry`: where cache misses fetch from (in-memory
  adapters, then a ``lora_dir``).
- :class:`AdapterCache`: ``max_resident`` adapter slots per target held in
  fp32 banks ``A[L, slots, din, rank]`` / ``B[L, slots, rank, dout]`` on
  the engine's device. Slot 0 is the permanent all-zero NULL adapter
  (rows without an adapter index it and get an exactly-zero delta); slots
  1..R follow ``PagedKVCache``'s refcount / LRU-evict / ``audit()``
  discipline. A slot is written in place (``bank[:, slot].copy_``) at the
  commit point, as the JAX cache's ``.at[:, slot].set``.

The kernels that read the banks are in ops/lora.py (the segmented delta of
the unfused layers) and ops/cuda/fused_decode.py (the LoRA epilogues of
the fused kernels). The chaos site ``lora-load`` fires between the
registry fetch and the bank commit.

Per-tenant SLO classes and counters (the JAX module's ``TenantSLO``) are
not ported yet: ROADMAP Queue 1 item 1 ("per-tenant accounting").
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from megatronapp_tpu_torch.inference.quantization import (
    RESIDENT_KERNELS, quantize_leaf,
)
from megatronapp_tpu_torch.ops.activations import is_gated
from megatronapp_tpu_torch.utils import chaos
from megatronapp_tpu_torch.utils import metrics as telemetry
from megatronapp_tpu_torch.utils.device import resolve_device

# The serving-LoRA targets are the kernels that can stay int8-resident:
# the adapters ride on top of whatever form the base weights are in.
LORA_TARGETS = RESIDENT_KERNELS

TENANT_UNPORTED = ("tenant= (per-tenant SLO classes and counters) is not "
                   "ported yet: ROADMAP Queue 1 item 1, per-tenant "
                   "accounting")


def lora_target_dims(cfg) -> Dict[str, Tuple[int, int]]:
    """(din, dout) per LoRA target: A is [din, rank], B [rank, dout], the
    base kernels' [din, dout] (the delta adds into the same matmul
    output, before the bias)."""
    if getattr(cfg, "multi_latent_attention", False):
        raise ValueError(
            "LoRA serving targets the standard GQA projection kernels "
            "(q/kv/out); multi-latent attention factors attention "
            "through latent kernels with no q_kernel/kv_kernel leaves "
            "— serve MLA models without --lora-dir")
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_query_groups
    f = cfg.ffn_hidden_size
    fc1_out = 2 * f if is_gated(cfg.activation) else f
    return {"q_kernel": (h, nq * d), "kv_kernel": (h, 2 * nkv * d),
            "out_kernel": (nq * d, h), "fc1_kernel": (h, fc1_out),
            "fc2_kernel": (f, h)}


def adapter_nbytes(cfg, rank: int, num_layers: Optional[int] = None,
                   itemsize: int = 4) -> int:
    """Rank-exact bytes of ONE adapter: the sum over targets of
    L·(din + dout)·rank·itemsize."""
    layers = num_layers if num_layers is not None else cfg.num_layers
    return sum(layers * (din + dout) * rank * itemsize
               for din, dout in lora_target_dims(cfg).values())


@dataclasses.dataclass
class LoraAdapter:
    """One tenant's adapter: per-target A [L, din, rank] and B [L, rank,
    dout] fp32 numpy stacks."""
    adapter_id: str
    rank: int
    a: Dict[str, np.ndarray]
    b: Dict[str, np.ndarray]

    @property
    def nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.a.values())
                   + sum(v.nbytes for v in self.b.values()))

    @classmethod
    def random(cls, adapter_id: str, cfg, rank: int, *, seed: int = 0,
               num_layers: Optional[int] = None, scale: float = 0.05,
               zero_b: bool = False) -> "LoraAdapter":
        """A reproducible random adapter, the JAX draws from the same seed:
        A ~ N(0, 1) / sqrt(din), B ~ N(0, scale²), or B exactly zero with
        zero_b (the adapted stream is then the base model's)."""
        rng = np.random.default_rng(seed)
        layers = num_layers if num_layers is not None else cfg.num_layers
        a, b = {}, {}
        for t, (din, dout) in lora_target_dims(cfg).items():
            a[t] = (rng.standard_normal((layers, din, rank))
                    / np.sqrt(din)).astype(np.float32)
            if zero_b:
                b[t] = np.zeros((layers, rank, dout), np.float32)
            else:
                b[t] = (rng.standard_normal((layers, rank, dout))
                        * scale).astype(np.float32)
        return cls(adapter_id, rank, a, b)

    def save(self, lora_dir: str, *, quantize: bool = False) -> str:
        """Write ``<lora_dir>/<adapter_id>.npz``; quantize=True stores each
        stack PTQ-int8 (``q`` and ``scale`` per output column)."""
        os.makedirs(lora_dir, exist_ok=True)
        path = os.path.join(lora_dir, f"{self.adapter_id}.npz")
        payload = {"rank": np.int32(self.rank)}
        for t in LORA_TARGETS:
            for side, stack in (("a", self.a[t]), ("b", self.b[t])):
                key = f"{t}.{side}"
                if quantize:
                    q = quantize_leaf(torch.from_numpy(
                        np.ascontiguousarray(stack, np.float32)))
                    payload[key + ".q"] = q["q"].numpy()
                    payload[key + ".scale"] = q["scale"].numpy()
                else:
                    payload[key] = stack
        np.savez(path, **payload)
        return path

    @classmethod
    def load(cls, lora_dir: str, adapter_id: str) -> "LoraAdapter":
        """Read an adapter written by ``save`` (either package's)."""
        path = os.path.join(lora_dir, f"{adapter_id}.npz")
        with np.load(path) as z:
            rank = int(z["rank"])
            a, b = {}, {}
            for t in LORA_TARGETS:
                for side, dest in (("a", a), ("b", b)):
                    key = f"{t}.{side}"
                    if key in z:
                        dest[t] = np.asarray(z[key], np.float32)
                    else:   # dequantize_leaf: float32(q) * scale
                        dest[t] = (z[key + ".q"].astype(np.float32)
                                   * z[key + ".scale"]).astype(np.float32)
        return cls(adapter_id, rank, a, b)


class AdapterRegistry:
    """Where cache misses fetch from: in-memory adapters (tests, programs),
    then an optional ``lora_dir`` of .npz files (in-memory wins). Unknown
    ids raise KeyError naming the known ones: a permanent error the engine
    rejects at submit."""

    def __init__(self, lora_dir: Optional[str] = None):
        self.lora_dir = lora_dir
        self._mem: Dict[str, LoraAdapter] = {}

    def register(self, adapter: LoraAdapter) -> None:
        self._mem[adapter.adapter_id] = adapter

    def ids(self):
        known = set(self._mem)
        if self.lora_dir and os.path.isdir(self.lora_dir):
            known.update(fn[:-4] for fn in os.listdir(self.lora_dir)
                         if fn.endswith(".npz"))
        return sorted(known)

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._mem or bool(
            self.lora_dir and os.path.exists(
                os.path.join(self.lora_dir, f"{adapter_id}.npz")))

    def get(self, adapter_id: str) -> LoraAdapter:
        if adapter_id in self._mem:
            return self._mem[adapter_id]
        if self.lora_dir and os.path.exists(
                os.path.join(self.lora_dir, f"{adapter_id}.npz")):
            return LoraAdapter.load(self.lora_dir, adapter_id)
        raise KeyError(
            f"unknown adapter {adapter_id!r}; registry knows "
            f"{self.ids() or '[] (empty)'}")


class AdapterSlotsPinned(RuntimeError):
    """Every resident slot is pinned by in-flight requests: a transient
    condition (admission waits for a retirement), unlike KeyError."""


class AdapterCache:
    """Device-resident LoRA banks with PagedKVCache's pin/evict/audit
    discipline over ``max_resident`` adapter slots.

    banks[target] = (A [L, slots, din, rank], B [L, slots, rank, dout])
    fp32 on `device` (None: the card), slots = max_resident + 1 with slot
    0 the permanent NULL adapter. acquire() returns an adapter's slot,
    loading it on a miss (a free slot first, else the least recently used
    unpinned resident); release() unpins. audit() proves: slots 1..R are
    exactly free ∪ resident, every rc == 0 resident (and only those) is
    LRU-parked, slot 0 is never free, tabled or refcounted."""

    def __init__(self, cfg, registry: AdapterRegistry, *,
                 max_resident: int = 8, rank: int = 8,
                 num_layers: Optional[int] = None, dtype=torch.float32,
                 device=None):
        if max_resident < 1:
            raise ValueError(
                f"max_resident must be >= 1, got {max_resident}")
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.cfg = cfg
        self.registry = registry
        self.rank = int(rank)
        self.max_resident = int(max_resident)
        self.slots = self.max_resident + 1            # + NULL slot 0
        self.num_layers = (num_layers if num_layers is not None
                           else cfg.num_layers)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.dims = lora_target_dims(cfg)
        self.banks: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {
            t: (torch.zeros(self.num_layers, self.slots, din, self.rank,
                            dtype=dtype, device=self.device),
                torch.zeros(self.num_layers, self.slots, self.rank, dout,
                            dtype=dtype, device=self.device))
            for t, (din, dout) in self.dims.items()}
        self._free: deque = deque(range(1, self.slots))
        self._table: Dict[str, int] = {}              # adapter_id -> slot
        self._slot_id: Dict[int, str] = {}            # slot -> adapter_id
        self._refcount = np.zeros((self.slots,), np.int64)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "load_faults": 0}

    # ---- byte accounting --------------------------------------------------
    @property
    def adapter_nbytes(self) -> int:
        """Rank-exact bytes of ONE resident adapter."""
        return adapter_nbytes(self.cfg, self.rank, num_layers=self.num_layers,
                              itemsize=torch.finfo(self.dtype).bits // 8)

    def resident_bytes(self) -> int:
        return len(self._table) * self.adapter_nbytes

    def bank_bytes(self) -> int:
        """Device bytes of the banks (capacity, slot 0 included)."""
        return int(sum(a.numel() * a.element_size()
                       + b.numel() * b.element_size()
                       for a, b in self.banks.values()))

    # ---- lookup -----------------------------------------------------------
    def slot_of(self, adapter_id: str) -> Optional[int]:
        return self._table.get(adapter_id)

    def resident_ids(self):
        return sorted(self._table)

    # ---- acquire / release ------------------------------------------------
    def _validate(self, adapter: LoraAdapter) -> None:
        if adapter.rank != self.rank:
            raise ValueError(
                f"adapter {adapter.adapter_id!r} has rank "
                f"{adapter.rank} but the cache banks are sized for "
                f"rank {self.rank} (--lora-rank)")
        for t, (din, dout) in self.dims.items():
            want_a = (self.num_layers, din, self.rank)
            want_b = (self.num_layers, self.rank, dout)
            got_a = tuple(adapter.a[t].shape)
            got_b = tuple(adapter.b[t].shape)
            if got_a != want_a or got_b != want_b:
                raise ValueError(
                    f"adapter {adapter.adapter_id!r} target {t}: A/B "
                    f"shapes {got_a}/{got_b} do not match this model's "
                    f"{want_a}/{want_b}")

    def _take_free(self) -> int:
        if self._free:
            return self._free.popleft()
        if self._lru:
            slot, _ = self._lru.popitem(last=False)   # least recent
            evicted = self._slot_id.pop(slot)
            del self._table[evicted]
            self.stats["evictions"] += 1
            telemetry.inc("lora_cache_evictions")
            return slot
        raise AdapterSlotsPinned(
            f"all {self.max_resident} resident adapter slots are "
            f"pinned by in-flight requests — waiting for a retirement "
            f"(raise --max-resident-adapters to run more distinct "
            f"adapters concurrently)")

    def acquire(self, adapter_id: Optional[str]) -> int:
        """Pin an adapter resident and return its bank slot (0 for None).
        A miss fetches from the registry, takes a slot (free first, else
        LRU-evicts an unpinned resident), writes the banks in place and
        commits the books. A fault before the commit (the ``lora-load``
        site fires between fetch and commit) leaves every book as it was."""
        if adapter_id is None:
            return 0
        slot = self._table.get(adapter_id)
        if slot is not None:
            self.stats["hits"] += 1
            telemetry.inc("lora_cache_hits")
            self._refcount[slot] += 1
            self._lru.pop(slot, None)
            return slot
        self.stats["misses"] += 1
        telemetry.inc("lora_cache_misses")
        adapter = self.registry.get(adapter_id)       # may KeyError
        self._validate(adapter)
        try:
            chaos.fire("lora-load")
        except BaseException:
            self.stats["load_faults"] += 1
            raise
        slot = self._take_free()
        # Commit point: the slot's rows of every bank, then the books.
        with torch.no_grad():
            for t, (a_bank, b_bank) in self.banks.items():
                a_bank[:, slot].copy_(torch.from_numpy(adapter.a[t]))
                b_bank[:, slot].copy_(torch.from_numpy(adapter.b[t]))
        self._table[adapter_id] = slot
        self._slot_id[slot] = adapter_id
        self._refcount[slot] = 1
        return slot

    def release(self, slot: int) -> None:
        """Unpin one reference to a bank slot (0 is a no-op). rc == 0
        residents park in the LRU, still hittable."""
        slot = int(slot)
        if slot == 0:
            return
        assert slot in self._slot_id, f"release of untabled slot {slot}"
        self._refcount[slot] -= 1
        assert self._refcount[slot] >= 0, (
            f"negative refcount on adapter slot {slot}")
        if self._refcount[slot] == 0:
            self._lru[slot] = None

    # ---- invariants -------------------------------------------------------
    def audit(self) -> None:
        """Assert the exact-partition invariants (tests run it after every
        step)."""
        used = set(self._table.values())
        free = set(self._free)
        assert len(self._free) == len(free), "duplicate free slots"
        assert 0 not in used and 0 not in free, (
            "NULL slot 0 leaked into the managed books")
        assert not (used & free), f"slots both used and free: {used & free}"
        assert used | free == set(range(1, self.slots)), (
            f"slots 1..{self.slots - 1} are not an exact partition: "
            f"used={sorted(used)} free={sorted(free)}")
        assert used == set(self._slot_id), "table/slot_id out of sync"
        for aid, slot in self._table.items():
            assert self._slot_id[slot] == aid, (
                f"slot {slot} maps back to {self._slot_id[slot]!r}, "
                f"not {aid!r}")
        assert set(self._lru) <= used, "LRU entry for a non-resident slot"
        for slot in used:
            rc = int(self._refcount[slot])
            assert rc >= 0, f"negative refcount on slot {slot}"
            assert (slot in self._lru) == (rc == 0), (
                f"slot {slot} rc={rc} LRU-parked={slot in self._lru}")
        for slot in free:
            assert self._refcount[slot] == 0, (
                f"free slot {slot} still refcounted")
        assert self._refcount[0] == 0, "NULL slot 0 refcounted"

    def stats_snapshot(self) -> Dict:
        return {
            "rank": self.rank,
            "capacity": self.max_resident,
            "resident": len(self._table),
            "pinned": int(np.count_nonzero(self._refcount[1:])),
            "resident_ids": self.resident_ids(),
            "adapter_bytes": self.adapter_nbytes,
            "resident_bytes": self.resident_bytes(),
            "bank_bytes": self.bank_bytes(),
            **self.stats,
        }
