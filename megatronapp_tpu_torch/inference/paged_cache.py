"""Paged KV-cache block pool: allocator, prefix cache, preemption support
(the JAX package's inference/paged_cache.py).

KV storage is a shared pool [L, num_blocks, block_size, Hkv, D] on the
engine's device, in the compute dtype or quantized (``kv_cache_dtype``
int8 or fp8 e4m3) with per-(row, kv-head) fp32 scale pools [L, num_blocks,
block_size, Hkv] beside it (``scales``); each slot owns an ordered page
table row [max_blocks_per_seq] int32 kept on the host. Capacity is
admitted per block. An MLA config (``multi_latent_attention``) keeps its
compressed cache instead: a latent pool [L, NB, bs, kv_lora_rank] and a
roped-key pool [L, NB, bs, qk_pos_emb_head_dim], with no head axis, so a
quantized one carries one fp32 scale per row ([L, NB, bs] each; JAX
paged_cache.py:195-204).

Prefix caching: full blocks are keyed by a rolling hash of the token
prefix they complete, salted with the LoRA adapter the KV was computed
under (the NULL adapter's keys are unsalted), and refcounted. Blocks
whose refcount drops to zero stay resident on an LRU list, hittable
until the allocator evicts them.
A request whose prompt fully hits still needs the last position's
logits, so its final block is copy-on-write: the shared block's rows are
copied into a private block and only the diverging row is recomputed.

All bookkeeping is host-side (numpy/python); the page data is touched
only by the engine's in-place scatters and the CoW block copy here. A speculative
round grows a slot by several positions at once (``extend_capacity``,
never preempting) and gives back the blocks of rejected drafts
(``rewind``). Slot export/import, the host spill tier and the fleet
prefix store come with later slices.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.ops.cuda.paged_attention import (
    QUANT_DTYPES, storage_view,
)
from megatronapp_tpu_torch.utils import chaos
from megatronapp_tpu_torch.utils import metrics as telemetry


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def prefix_block_keys(tokens, block_size: int, limit: int,
                      salt: Optional[str] = None) -> List[bytes]:
    """Rolling hash per FULL block of tokens[:limit]: key i commits to
    the whole prefix through block i, so a table hit is an exact prefix
    match. salt: the LoRA adapter id the blocks' KV is computed under
    (its q/kv deltas shape every row), which starts the chain, so that
    requests on other adapters never share blocks; None (the NULL
    adapter, the base model) keeps the unsalted chain of the JAX
    package."""
    tokens = np.asarray(tokens, np.int32)
    keys: List[bytes] = []
    digest = (b"" if salt is None
              else hashlib.sha1(b"lora-adapter\0" + salt.encode()).digest())
    for i in range(limit // block_size):
        digest = hashlib.sha1(
            digest + np.ascontiguousarray(
                tokens[i * block_size:(i + 1) * block_size],
                dtype=np.int32).tobytes()
        ).digest()
        keys.append(digest)
    return keys


@dataclasses.dataclass(frozen=True)
class KvDtypeSpec:
    """One KV-cache storage dtype: the pool, the engine and the server's
    --kv-cache-dtype choices and help all derive from KV_CACHE_DTYPES.
    Quantized entries take their page dtype and range bound from the
    kernel's registry (ops/cuda/paged_attention.QUANT_DTYPES)."""
    name: str
    page_dtype: Optional[torch.dtype]   # None: the compute dtype
    quantized: bool                     # per-(row, kv-head) fp32 scale pools
    qmax: Optional[float]               # symmetric quantization range bound
    help: str                           # one-line CLI help fragment


def _quantized_spec(name: str, help_text: str) -> KvDtypeSpec:
    dtype, qmax = QUANT_DTYPES[name]
    return KvDtypeSpec(name, dtype, True, qmax, help_text)


KV_CACHE_DTYPES = {
    "bf16": KvDtypeSpec("bf16", None, False, None,
                        "compute-dtype pages (the baseline)"),
    "int8": _quantized_spec(
        "int8",
        "int8 pages + per-(row, kv-head) fp32 scales, rounded "
        "symmetric [-127, 127], dequantized in the kernel as each page "
        "is read"),
    "fp8": _quantized_spec(
        "fp8",
        "fp8 (e4m3) pages + per-(row, kv-head) fp32 scales — same "
        "bytes as int8 but saturating float rounding (no integer "
        "rounding step), dequantized in the kernel as each page is read"),
}


def kv_cache_dtype_help() -> str:
    """CLI help text for --kv-cache-dtype, derived from the registry."""
    return "; ".join(f"{n}: {s.help}" for n, s in KV_CACHE_DTYPES.items())


def validate_kv_cache_dtype(name: str, *, paged: bool = True,
                            mla: bool = False) -> KvDtypeSpec:
    """kv_cache_dtype validation shared by the pool, the engine and the
    server (the JAX package's messages; ValueError). mla is accepted, as
    JAX's is, so call sites say what they validate for: every storage
    dtype serves MLA latent pools too (one scale a row)."""
    del mla
    spec = KV_CACHE_DTYPES.get(name)
    if spec is None:
        raise ValueError(
            f"kv_cache_dtype must be one of "
            f"{sorted(KV_CACHE_DTYPES)}, got {name!r}")
    if spec.quantized and not paged:
        raise ValueError(
            f"kv_cache_dtype={spec.name} requires the paged backend "
            "(the per-block quantization scales live alongside the "
            "block pool; the dense slot cache has no block structure) "
            "— pass paged=True / --paged-kv-cache")
    return spec


@dataclasses.dataclass
class AdmitPlan:
    """Result of admitting a token sequence into a slot."""
    blocks: List[int]        # page-table row, sequence order
    cached_tokens: int       # leading tokens whose KV is already resident
    cow: bool                # last block was copy-on-write'd (full hit)


class PagedKVCache:
    """Block pool + page tables + refcounted prefix cache."""

    def __init__(self, cfg: TransformerConfig, max_batch: int,
                 max_seq_len: int, num_blocks: Optional[int] = None,
                 block_size: int = 16, enable_prefix_caching: bool = True,
                 kv_cache_dtype: str = "bf16", device="cpu", tp: int = 1):
        spec = validate_kv_cache_dtype(kv_cache_dtype,
                                       mla=cfg.multi_latent_attention)
        self.tp = tp
        self.kv_cache_dtype = kv_cache_dtype
        self.quantized = spec.quantized
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.max_blocks_per_seq = cdiv(max_seq_len, block_size)
        # Default pool = dense capacity (max_batch full sequences).
        self.num_blocks = (num_blocks if num_blocks is not None
                           else max_batch * self.max_blocks_per_seq)
        self.enable_prefix_caching = enable_prefix_caching
        self.num_slots = max_batch

        lead = (cfg.num_layers, self.num_blocks, block_size)
        # tp > 1: this rank's share of a tensor-parallel pool (JAX
        # dynamic_engine.py:489-517) — the GQA pools and their scale pools
        # hold Hkv/tp kv heads; an MLA latent pool holds kv_lora_rank/tp
        # columns while the roped-key pool and the per-row scale pools
        # (one scale for the WHOLE latent row) stay whole.
        if cfg.multi_latent_attention:
            # (latent, roped key) rows, no kv-head axis.
            shapes = [lead + (cfg.kv_lora_rank // tp,),
                      lead + (cfg.qk_pos_emb_head_dim,)]
        else:
            shapes = [lead + (cfg.num_query_groups // tp, cfg.head_dim)] * 2
        dt = spec.page_dtype if spec.quantized else cfg.compute_dtype
        self.pages: Tuple[torch.Tensor, ...] = tuple(
            torch.zeros(shape, dtype=dt, device=device) for shape in shapes)
        # scales: fp32 quantization scales of quantized pools, one per
        # (row, kv-head), or one per row of an MLA pool (None for
        # compute-dtype pools), written and copied with the rows they
        # scale (the same leading [L, NB, bs] dims).
        self.scales: Optional[Tuple[torch.Tensor, ...]] = None
        if spec.quantized:
            self.scales = tuple(torch.ones(shape[:-1], dtype=torch.float32,
                                           device=device)
                                for shape in shapes)

        self.page_table = np.zeros((self.num_slots, self.max_blocks_per_seq),
                                   np.int32)
        self._free: deque = deque(range(self.num_blocks))
        self._refcount = np.zeros((self.num_blocks,), np.int32)
        self._table: dict = {}            # prefix hash -> block id
        self._hash_of: dict = {}          # block id -> prefix hash
        self._lru: OrderedDict = OrderedDict()  # rc==0 hashed blocks
        self._slot_blocks: List[List[int]] = [
            [] for _ in range(self.num_slots)]
        # Each slot's prefix-key salt (its request's adapter id).
        self._slot_salt: List[Optional[str]] = [None] * self.num_slots
        self.stats = {"prefix_hit_tokens": 0, "prefill_tokens": 0,
                      "cow_copies": 0, "evictions": 0, "preemptions": 0,
                      "peak_blocks_in_use": 0}

    # ---- sizing ----------------------------------------------------------
    def _arrays(self) -> Tuple[torch.Tensor, ...]:
        return self.pages + (self.scales or ())

    @property
    def bytes_total(self) -> int:
        """Resident pool bytes, read off the pool tensors: the pages in
        their storage dtype plus the fp32 scale pools of quantized ones
        (this rank's own under tp)."""
        return sum(p.numel() * p.element_size() for p in self._arrays())

    @property
    def bytes_per_block(self) -> int:
        return self.bytes_total // self.num_blocks

    def blocks_in_use(self) -> int:
        """Blocks with live references (excludes free + evictable)."""
        return self.num_blocks - len(self._free) - len(self._lru)

    def available_blocks(self) -> int:
        return len(self._free) + len(self._lru)

    def free_blocks(self) -> int:
        return len(self._free)

    def evictable_blocks(self) -> int:
        return len(self._lru)

    def refcount(self, block: int) -> int:
        return int(self._refcount[block])

    def slot_blocks(self, slot: int) -> List[int]:
        return list(self._slot_blocks[slot])

    # ---- low-level block lifecycle --------------------------------------
    def _take_free(self) -> Optional[int]:
        if self._free:
            return self._free.popleft()
        if self._lru:
            # Chaos site fires BEFORE the eviction mutates anything.
            chaos.fire("paged-evict")
            blk, _ = self._lru.popitem(last=False)   # least recently used
            key = self._hash_of.pop(blk, None)
            if key is not None and self._table.get(key) == blk:
                del self._table[key]
            self.stats["evictions"] += 1
            telemetry.inc("paged_evictions")
            return blk
        return None

    def _acquire_cached(self, blk: int):
        self._refcount[blk] += 1
        self._lru.pop(blk, None)

    def _release_block(self, blk: int):
        self._refcount[blk] -= 1
        assert self._refcount[blk] >= 0, f"block {blk} over-released"
        if self._refcount[blk] == 0:
            if blk in self._hash_of:
                self._lru[blk] = None    # evictable, still hittable
            else:
                self._free.append(blk)

    def _copy_block(self, src: int, dst: int):
        # Chaos site fires before the copy: pages/stats untouched.
        chaos.fire("paged-cow")
        # In place, every layer at once; rows quantize on their own, so
        # scale rows are copied verbatim beside their pages. fp8 pages
        # copy as bytes.
        for p in self._arrays():
            p = storage_view(p)
            p[:, dst].copy_(p[:, src])
        self.stats["cow_copies"] += 1
        telemetry.inc("paged_cow_copies")

    def _note_usage(self):
        self.stats["peak_blocks_in_use"] = max(
            self.stats["peak_blocks_in_use"], self.blocks_in_use())

    def _block_keys(self, tokens: np.ndarray, limit: int,
                    salt: Optional[str]) -> List[bytes]:
        return prefix_block_keys(tokens, self.block_size, limit, salt)

    # ---- engine-facing API ----------------------------------------------
    def admit(self, slot: int, tokens: np.ndarray,
              salt: Optional[str] = None) -> Optional[AdmitPlan]:
        """Install blocks covering `tokens` into `slot`'s page table,
        reusing cached prefix blocks. Returns None (state rolled back)
        when the pool cannot supply the fresh blocks. salt: the adapter id
        the slot's KV is computed under (``prefix_block_keys``); the slot
        keeps it for its own registrations until it is released."""
        assert not self._slot_blocks[slot], f"slot {slot} still holds blocks"
        p_len = len(tokens)
        need_total = cdiv(p_len, self.block_size)

        hits: List[int] = []
        if self.enable_prefix_caching:
            for key in self._block_keys(tokens, p_len, salt):
                blk = self._table.get(key)
                if blk is None:
                    break
                hits.append(blk)
        cached = len(hits) * self.block_size
        cow = cached >= p_len        # full hit: recompute the last token
        if cow:
            cached = p_len - 1

        for blk in hits:
            self._acquire_cached(blk)
        fresh_needed = need_total - len(hits) + (1 if cow else 0)
        fresh: List[int] = []

        def _rollback():
            for b in fresh:
                self._refcount[b] = 0
                self._free.append(b)
            for b in hits:
                self._release_block(b)

        # Exception-safe allocation: eviction and CoW are fault sites.
        try:
            for _ in range(fresh_needed):
                blk = self._take_free()
                if blk is None:
                    _rollback()
                    return None
                self._refcount[blk] = 1
                fresh.append(blk)
            if cow:
                src = hits[-1]
                dst = fresh[0]
                self._copy_block(src, dst)
        except Exception:
            _rollback()
            raise

        if cow:
            self._release_block(src)
            blocks = hits[:-1] + [dst] + fresh[1:]
        else:
            blocks = hits + fresh

        self._slot_blocks[slot] = blocks
        self._slot_salt[slot] = salt
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(blocks)] = blocks
        self.stats["prefix_hit_tokens"] += cached
        self.stats["prefill_tokens"] += p_len - cached
        telemetry.inc("paged_prefix_hit_tokens", cached)
        telemetry.inc("paged_prefill_tokens", p_len - cached)
        self._note_usage()
        return AdmitPlan(blocks, cached, cow)

    def ensure_capacity(self, slot: int, position: int) -> bool:
        """Make sure `slot` owns the block covering `position` (decode
        appends grow one block at a time)."""
        idx = position // self.block_size
        owned = self._slot_blocks[slot]
        if idx < len(owned):
            return True
        assert idx == len(owned), (
            f"slot {slot} skipped a block: position {position} needs block "
            f"{idx}, owns {len(owned)}")
        blk = self._take_free()
        if blk is None:
            return False
        self._refcount[blk] = 1
        owned.append(blk)
        self.page_table[slot, idx] = blk
        self._note_usage()
        return True

    def extend_capacity(self, slot: int, position: int, span: int) -> int:
        """Best-effort growth for a multi-token (speculative) append:
        allocate blocks so `slot` covers positions [position, position +
        span), WITHOUT preempting anyone. Returns the span actually
        covered (>= 0); the caller shrinks its speculation to fit.
        Partially granted blocks stay owned: a later rewind() or release()
        returns them."""
        granted = 0
        for p in range(position, position + span):
            if p >= self.max_seq_len:
                break
            if not self.ensure_capacity(slot, p):
                break
            granted += 1
        return granted

    def rewind(self, slot: int, valid_len: int):
        """Roll a slot back to `valid_len` written positions: release the
        tail blocks past ceil(valid_len / block_size) (rejected
        speculation, and over-granted extend_capacity blocks). Only
        privately owned tail blocks may go; a refcounted or hashed block
        here would mean speculation wrote into a shared prefix block,
        which copy-on-write rules out, so that asserts rather than
        corrupting the prefix cache. A block is never split: rows past
        valid_len inside the kept tail block are overwritten by the next
        append."""
        keep = cdiv(max(valid_len, 1), self.block_size)
        owned = self._slot_blocks[slot]
        while len(owned) > keep:
            blk = owned.pop()
            assert self._refcount[blk] == 1 and blk not in self._hash_of, (
                f"rewind would drop shared/hashed block {blk} "
                f"(rc={int(self._refcount[blk])}) — speculative tail "
                "blocks must be private")
            self.page_table[slot, len(owned)] = 0
            self._release_block(blk)

    def flush_prefix_cache(self):
        """Invalidate every cached prefix (params reload: blocks hold KV
        computed with the OLD weights)."""
        self._table.clear()
        self._hash_of.clear()
        for blk in self._lru:
            self._free.append(blk)
        self._lru.clear()

    def audit(self):
        """Consistency check (tests): every block is exactly one of
        free / LRU-evictable / slot-referenced, and each block's
        refcount equals the number of slot page-table references to it."""
        nb = self.num_blocks
        refs = np.zeros((nb,), np.int64)
        for blocks in self._slot_blocks:
            for blk in blocks:
                refs[blk] += 1
        assert np.array_equal(refs, self._refcount), (
            f"refcount skew: table={self._refcount.tolist()} "
            f"actual={refs.tolist()}")
        free = set(self._free)
        assert len(free) == len(self._free), (
            "duplicate block on the free list (double-free)")
        lru = set(self._lru)
        held = {b for b in range(nb) if refs[b] > 0}
        assert not (free & lru) and not (free & held) and not (lru & held), (
            "block in two states: "
            f"free∩lru={free & lru} free∩held={free & held} "
            f"lru∩held={lru & held}")
        assert len(free) + len(lru) + len(held) == nb, (
            f"leaked blocks: free={len(free)} lru={len(lru)} "
            f"held={len(held)} != {nb}")
        for blk in lru:
            assert blk in self._hash_of, f"unhashed block {blk} on LRU"
        return True

    def register_prefix(self, slot: int, tokens: np.ndarray, valid_len: int):
        """Hash this slot's full blocks over tokens[:valid_len] so later
        same-prefix requests hit them (only rows actually written)."""
        if not self.enable_prefix_caching:
            return
        owned = self._slot_blocks[slot]
        for i, key in enumerate(self._block_keys(tokens, valid_len,
                                                 self._slot_salt[slot])):
            if i >= len(owned):
                break
            blk = owned[i]
            if blk not in self._hash_of and key not in self._table:
                self._table[key] = blk
                self._hash_of[blk] = key

    def release(self, slot: int, tokens: np.ndarray, valid_len: int,
                preempted: bool = False):
        """Return a slot's blocks to the pool. Full blocks get registered
        in the prefix cache first, then every block is de-referenced —
        rc==0 hashed blocks park on the LRU list, unhashed ones go
        straight to the free list."""
        self.register_prefix(slot, tokens, valid_len)
        for blk in self._slot_blocks[slot]:
            self._release_block(blk)
        self._slot_blocks[slot] = []
        self._slot_salt[slot] = None
        self.page_table[slot, :] = 0
        if preempted:
            self.stats["preemptions"] += 1
            telemetry.inc("paged_preemptions")
