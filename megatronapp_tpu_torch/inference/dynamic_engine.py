"""Dynamic inference engine: continuous batching over the paged KV pool.

The JAX package's inference/dynamic_engine.py with ``paged=True``:
requests of different lengths enter a waiting queue; the engine admits
them into free slots by block availability (inference/paged_cache.py),
prefills the uncached prompt tail in fixed-size chunks through the ragged
multi-query step, decodes ONE token per step for every active slot through
the one-token paged step, preempts the lowest-priority running request
when the pool runs dry, and retires finished requests — new requests join
mid-flight without draining the batch. Both steps attend through the
hand-written paged-attention kernel (ops/cuda/paged_attention.py).
``fused_decode=True`` (``--megakernel-decode``) runs both steps' layers as
the fused kernels instead (ops/fused_decode.py) when
``megakernel_ineligible_reason`` allows it, decided once at construction.
``kv_cache_dtype`` int8 or fp8 stores the pool quantized with per-(row,
kv-head) scale pools (the quantized paged kernel dequantizes as it reads);
params whose matmul kernels are resident int8 leaves
(inference/quantization.py) run as they are, both steps dequantizing at
matmul entry or inside the fused kernels. ``adapter_cache`` (an
inference/lora.py AdapterCache) serves batched multi-tenant LoRA: each
running slot pins its request's adapter in the cache's device banks
(``row_adapter``: the slot's bank slot, 0 = the NULL adapter), and every
step adds each row's low-rank delta to the five projections — the
segmented LoRA kernel in the unfused layers, the fused kernels' LoRA
epilogue in the fused step (ops/lora.py). An MLA config
(``multi_latent_attention``) serves from latent pools (one latent and one
roped-key row a token a layer, quantized per row for int8/fp8) through the
latent paged-attention kernel, unfused or with the fused MLA prologue; it
takes no adapter cache, as JAX's engine does not.

Where the JAX engine jits each step and donates the pools, this engine
runs eagerly on the card and writes the pools IN PLACE. All per-step
metadata (page tables, lengths, the rows each step writes) is built on the
host and copied to the card without waiting on it; the one host
synchronisation per step is reading the sampled tokens back, as
``jax.device_get`` is in the JAX engine.

Sampling: greedy rows take the argmax, exactly as the JAX engine does.
Sampled rows cannot reproduce JAX's ``fold_in`` key chains; each draws
Gumbel noise from a ``torch.Generator`` seeded from (seed, request id,
step), so a request's stream is reproducible and independent of what else
is in the batch.

``ctx`` (a parallel/mesh.py MeshContext) serves tensor-parallel, one
process a rank, as the JAX engine serves on a tp mesh: params whole on
every rank, the pools sharded (GQA on kv heads, MLA on latent columns),
the steps head-sharded or latent-column-sharded with their collectives
inside the layers, logits the same on every rank. Rank 0 alone makes the
host decisions of a step: before each step it broadcasts the step's
submissions, cancellations and deadline expirations, and every rank
applies them in the same order before stepping, so admission, prefix
hits, copy-on-write copies and preemption stay identical across ranks
and no clock is read off rank 0. Followers run ``follow()``; the lead
ends it with ``release_followers()``.

``spec_method`` ("ngram", "draft" or "mtp"; "mtp" on params without MTP
heads warns and decodes plainly, as JAX does) turns on speculative
decoding (inference/speculative.py): every round proposes up to
``spec_k`` drafts a slot, verifies them all in one ragged multi-query
step at [B, K+1] (the paged kernels, unfused or fused), accepts by exact
rejection sampling — greedy streams are the plain greedy streams — and
rewinds the rejected drafts' blocks. A round where nothing is proposed
takes the plain one-token step. For the MTP proposer the engine keeps
each slot's pre-head hidden at its last verified position (``_h_last``,
valid where ``_h_valid``; JAX dynamic_engine.py:598-601): set from the
prompt's last chunk and from each verify step's accepted row, cleared
with the slot.

Not ported yet (each raises at construction): the dense slot cache, the
host spill tier, and LoRA, speculation or a rolling reload under tp;
per-tenant accounting (``tenant=``) raises at submit.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from megatronapp_tpu_torch.config.parallel_config import moe_unported
from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.inference.engine import (
    SamplingParams, _warp_logits, mask_padded_vocab,
)
from megatronapp_tpu_torch.inference.lora import (
    TENANT_UNPORTED, AdapterSlotsPinned, lora_target_dims,
)
from megatronapp_tpu_torch.inference.paged_cache import (
    PagedKVCache, cdiv, validate_kv_cache_dtype,
)
from megatronapp_tpu_torch.inference.quantization import resident_nbytes
from megatronapp_tpu_torch.models.gpt import (
    gpt_embed, gpt_head, gpt_rope_tables,
)
from megatronapp_tpu_torch.ops.fused_decode import (
    megakernel_ineligible_reason,
)
from megatronapp_tpu_torch.ops.lora import (
    LoraRows, lora_kernel_ineligible_reason,
)
from megatronapp_tpu_torch.ops.paged_attention import (
    paged_write_index, tp_paged_ineligible_reason,
)
from megatronapp_tpu_torch.parallel import collectives
from megatronapp_tpu_torch.trace.request_trace import get_request_tracer
from megatronapp_tpu_torch.transformer.block import layer_forward
from megatronapp_tpu_torch.utils import chaos
from megatronapp_tpu_torch.utils import metrics as telemetry
from megatronapp_tpu_torch.utils.device import host_to, resolve_device

logger = logging.getLogger(__name__)


class DeadlineExceeded(RuntimeError):
    """A request's deadline passed: rejected at admission, or aborted
    mid-flight by the engine/stepper (its pool blocks are reclaimed on
    the retire path like any finished request)."""


def validate_admission(prompt_tokens, max_new_tokens: int,
                       max_seq_len: int, pool=None,
                       deadline_s=None) -> np.ndarray:
    """Admission validation: deadline, non-empty prompt, sequence bound
    and pool-capacity bound. Returns the normalized int32 prompt."""
    if deadline_s is not None and time.monotonic() >= deadline_s:
        raise DeadlineExceeded(
            "request deadline already expired at admission")
    prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
    if len(prompt) == 0:
        raise ValueError(
            "empty prompt: prefill samples the first token from the "
            "last PROMPT position, so at least one token (e.g. BOS/"
            "eod) is required")
    if len(prompt) + max_new_tokens > max_seq_len:
        raise ValueError(
            f"prompt({len(prompt)}) + max_new({max_new_tokens}) exceeds "
            f"max_seq_len({max_seq_len})")
    if pool is not None:
        need = cdiv(len(prompt) + max_new_tokens, pool.block_size)
        if need > pool.num_blocks:
            raise ValueError(
                f"request needs {need} blocks "
                f"(prompt {len(prompt)} + max_new {max_new_tokens} at "
                f"block_size {pool.block_size}) but the pool has "
                f"only {pool.num_blocks}")
    return prompt


@dataclasses.dataclass
class Request:
    """One generation request.

    priority: lower = more important; the engine preempts the highest
    (priority, request_id) running request when the block pool is
    exhausted. deadline_s: absolute time.monotonic() deadline; overdue
    requests are aborted by step()'s expiry sweep (event key
    "expired"). adapter_id: the LoRA adapter the request is served with
    (None: the base model)."""
    request_id: int
    prompt: np.ndarray                  # [P] int32
    max_new_tokens: int
    sampling: SamplingParams
    eod_id: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    adapter_id: Optional[str] = None
    # Filled by the engine:
    slot: int = -1
    generated: list = dataclasses.field(default_factory=list)
    finished: bool = False
    # First admission time (time-to-first-token measures from here) and
    # the time the request last entered the queue (queue-wait telemetry).
    admit_t: float = 0.0
    queued_t: float = 0.0
    # Speculative-decoding stats (spec_method engines):
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate([self.prompt,
                               np.asarray(self.generated, np.int32)])


TP_UNPORTED = ("LoRA serving under tensor parallelism is not ported yet "
               "(ROADMAP.md Queue 1): serve adapters on one card")
SPEC_TP_UNPORTED = ("speculative decoding under tensor parallelism is not "
                    "ported yet (ROADMAP.md Queue 1 item 1): speculate on "
                    "one card")


def _run_layers(params, h, cfg: TransformerConfig, cos, sin, pages,
                page_table, starts, chunk_counts, write_index,
                fused: bool = False, scales=None, lora=None, ctx=None):
    """Walk the per-layer modules (the JAX step's ``lax.scan`` over the
    stacked block) with layer l reading and writing pool slice l (and
    scale-pool slice l of a quantized pool, as the JAX scan carries them);
    `fused` runs each layer as the fused kernels. lora: {"row_adapter":
    LoraRows of the step's rows, "banks": {target: (A [L, slots, din,
    rank], B [L, slots, rank, dout])}}; layer l gets bank slices l, as the
    JAX scan carries the banks in its xs. ctx: the tp rank of a tp-paged
    engine (each layer's attention shards over it)."""
    pk, pv = pages
    for lid, layer_p in enumerate(params["layers"]):
        ll = None
        if lora is not None:
            ll = {"row_adapter": lora["row_adapter"],
                  "banks": {t: (a[lid], b[lid])
                            for t, (a, b) in lora["banks"].items()}}
        (h, _), _ = layer_forward(
            layer_p, h, cfg, cos, sin, kv_cache=(pk[lid], pv[lid]),
            cache_positions=starts, page_table=page_table,
            chunk_counts=chunk_counts, write_index=write_index,
            fused_decode=fused,
            kv_scales=None if scales is None else (scales[0][lid],
                                                   scales[1][lid]),
            lora=ll, ctx=ctx, layer_id=lid)
    return h


def _rope_rows(positions, rope_tables):
    cos_full, sin_full = rope_tables
    if cos_full is None:
        return None, None
    idx = positions.long()
    return cos_full[idx], sin_full[idx]


def _paged_decode_step(params, tokens, pages, page_table, lengths,
                       cfg: TransformerConfig, write_index, rope_tables,
                       fused: bool = False, scales=None, lora=None,
                       ctx=None):
    """One-token decode for every slot against the paged block pool.

    tokens [B, 1]; pages (k [L, NB, bs, Hkv, D], v like k), written in
    place; page_table [B, MB] int32; lengths [B] int32 append positions.
    write_index: the rows' ``paged_write_index`` (the JAX step's `active`
    mask: inactive rows are not in it, so their writes are dropped and
    their outputs are garbage). rope_tables: ``gpt_rope_tables`` over
    [0, max_seq_len). fused: the layers as the fused kernels
    (fused_layer_decode). scales: the (k, v) scale pools [L, NB, bs, Hkv]
    of an int8/fp8 pool, written in place with it. lora: the batched
    adapter deltas over the B rows (``_run_layers``). ctx: the tp rank of
    a tp-paged engine. Returns (last_logits [B, V] fp32, pages)."""
    h = gpt_embed(params, tokens, cfg, position_ids=lengths[:, None])
    cos, sin = _rope_rows(lengths, rope_tables)
    if cos is not None:
        cos, sin = cos[:, None], sin[:, None]            # [B, 1, half]
    h = _run_layers(params, h, cfg, cos, sin, pages, page_table, lengths,
                    None, write_index, fused, scales, lora, ctx)
    return gpt_head(params, h, cfg)[:, -1], pages


def _paged_multiquery_step(params, tokens, pages, page_table, starts,
                           q_lens, cfg: TransformerConfig, max_seq_len: int,
                           write_index, rope_tables, fused: bool = False,
                           scales=None, lora=None, ctx=None):
    """Ragged multi-token step against the paged pool (chunked prefill).

    tokens [B, S]; starts [B] per-row append positions; q_lens [B] valid
    token counts in [1, S] (rows past a row's count are padding whose
    outputs are garbage). Row b's token i lands at position starts[b] + i
    and attends the paged context plus the new tail causally. write_index
    rope_tables and scales as for ``_paged_decode_step``; fused: the layers
    as the fused kernels (fused_layer_multiquery); lora over the B·S
    flattened rows. Returns (logits [B, S, V], hidden [B, S, H] pre-head,
    pages)."""
    s = tokens.shape[1]
    positions = starts[:, None] + torch.arange(
        s, device=tokens.device, dtype=starts.dtype)[None, :]
    positions = positions.clamp(max=max_seq_len - 1)
    h = gpt_embed(params, tokens, cfg, position_ids=positions)
    cos, sin = _rope_rows(positions, rope_tables)
    h = _run_layers(params, h, cfg, cos, sin, pages, page_table, starts,
                    q_lens, write_index, fused, scales, lora, ctx)
    return gpt_head(params, h, cfg), h, pages


@torch.no_grad()
def _decode_step(params, tokens, cache, lengths, cfg: TransformerConfig,
                 rope_tables=None):
    """One-token decode for every slot against a dense per-slot cache
    (JAX dynamic_engine.py:162; the speculative draft model's step).

    tokens [B, 1]; cache (k, v) [L, B, S_max, Hkv, D], written IN PLACE;
    lengths [B] (tokens already in each row's cache: the row appends
    there). Row b attends cache positions <= lengths[b] through an
    explicit per-row mask; JAX's `active` is not an operand (JAX's step
    ignores it too: inactive rows write past their valid length, which
    the next append overwrites). rope_tables: ``gpt_rope_tables`` over
    [0, S_max) (built here when None). Returns (last_logits [B, V] fp32,
    cache)."""
    max_len = cache[0].shape[2]
    if rope_tables is None:
        rope_tables = gpt_rope_tables(cfg, max_len, device=tokens.device)
    h = gpt_embed(params, tokens, cfg, position_ids=lengths[:, None])
    cos, sin = _rope_rows(lengths.clamp(max=max_len - 1), rope_tables)
    if cos is not None:
        cos, sin = cos[:, None], sin[:, None]            # [B, 1, half]
    attend = (torch.arange(max_len, device=tokens.device)[None, :]
              <= lengths[:, None])
    mask = attend[:, None, None, :]                      # [B, 1, 1, S_max]
    ck, cv = cache
    for lid, layer_p in enumerate(params["layers"]):
        (h, _), _ = layer_forward(layer_p, h, cfg, cos, sin, mask,
                                  kv_cache=(ck[lid], cv[lid]),
                                  cache_positions=lengths, layer_id=lid)
    return gpt_head(params, h, cfg)[:, -1], cache


def _row_seed(seed: int, rid: int, step: int, *streams: int) -> int:
    """A 63-bit generator seed from (seed, request id, step): splitmix64
    over the triple, so neighbouring triples share no stream. `streams`
    extends the tuple with a stream tag (the speculative verifier's and
    the draft model's own draws, inference/speculative.py)."""
    z = 0
    for v in (seed, rid, step) + streams:
        z = (z ^ (v & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15
        z &= 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
    return z >> 1


def _sample_rows(logits, rows: Dict[str, np.ndarray]) -> torch.Tensor:
    """logits [B, V] fp32 → tokens [B] int64 on the logits' device.
    Greedy rows: argmax. Sampled rows: argmax of the warped logits plus
    Gumbel noise drawn from the row's own generator, seeded from (seed,
    request id, step) — independent of batch composition."""
    greedy = logits.argmax(dim=-1)
    sampled_rows = np.flatnonzero(rows["sampled"])
    if len(sampled_rows) == 0:
        return greedy
    dev = logits.device
    idx = host_to(sampled_rows, dev)
    x = _warp_logits(
        logits[idx],
        host_to(rows["temps"][sampled_rows], dev),
        host_to(rows["top_ks"][sampled_rows], dev),
        host_to(rows["top_ps"][sampled_rows], dev))
    out = greedy.clone()
    out[idx] = (x + _gumbel_rows(x.shape, [
        _row_seed(int(rows["seeds"][i]), int(rows["rids"][i]),
                  int(rows["steps"][i])) for i in sampled_rows],
        dev)).argmax(dim=-1)
    return out


def _gumbel_rows(shape, seeds, device) -> torch.Tensor:
    """Gumbel noise [N, ..., V] fp32 whose row j (all of shape[1:]) is
    drawn from its own generator seeded with seeds[j]: a row's noise is
    the same bits whatever else is drawn beside it."""
    noise = torch.empty(shape, dtype=torch.float32, device=device)
    for j, seed in enumerate(seeds):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        noise[j].uniform_(generator=g)
    return -torch.log(-torch.log(noise.clamp(min=1e-20)))


class DynamicInferenceEngine:
    """Continuous-batching engine over the paged KV pool.

    add_request() any time; step() decodes one token for every active
    request and admits waiting requests into free slots. block_size /
    num_blocks size the pool (num_blocks defaults to dense capacity —
    pass less to run oversubscribed with preemption) and
    enable_prefix_caching turns shared-prefix block reuse on or off.

    device: where params, the pool and every step live. None means the
    card; a host without one raises — pass device="cpu" to run the plain
    versions of the kernels on the CPU (the tests do).

    kv_cache_dtype: the pool's storage ("bf16": the compute dtype; "int8"
    or "fp8": quantized pages with fp32 scale pools).

    spec_method, spec_k, draft_params, draft_cfg: speculative decoding
    (module docstring); "draft" takes the draft model's params and config
    (its vocab must be the target's). ``spec_stats`` counts rounds,
    proposed and accepted drafts, emitted tokens and model steps.

    fused_decode: run the decode, chunked-prefill and verify steps' layers
    as the fused kernels. Eligibility is decided once here, as the JAX
    engine decides it (rows planned at ``mq_rows``: max(max_batch,
    prefill_chunk, max_batch·(spec_k+1) when speculating)): when
    ``megakernel_ineligible_reason`` names a failed predicate, a warning
    names it and the engine keeps the unfused step. ``megakernel`` says
    which step runs.

    adapter_cache: an inference/lora.py AdapterCache on the engine's
    device (batched multi-tenant LoRA). On the card the LoRA kernels'
    limits (``lora_kernel_ineligible_reason``) are checked here and raise:
    there is no other path for an adapter's delta there.

    ctx: a tensor-parallel MeshContext (parallel/mesh.py): this engine is
    one rank of a tp group. When ``tp_paged_ineligible_reason`` allows it
    (``tp_paged``), the pools hold the rank's shard and the steps run
    sharded; otherwise a warning names the failed predicate and every rank
    runs the whole step on whole pools. Either way rank 0 (the lead) takes
    the requests and the followers ``follow()`` it. The fused step is
    refused under tp_paged with JAX's predicate."""

    def __init__(self, params, cfg: TransformerConfig, tokenizer=None,
                 max_batch: int = 4, max_seq_len: Optional[int] = None,
                 paged: bool = True, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 enable_prefix_caching: bool = True,
                 prefill_chunk: int = 32, kv_cache_dtype: str = "bf16",
                 device=None, spec_method: Optional[str] = None,
                 spec_k: int = 4, draft_params=None, draft_cfg=None,
                 fused_decode: bool = False, adapter_cache=None,
                 spill_host_mb: float = 0.0, ctx=None):
        speculate = spec_method not in (None, "none")
        if speculate and not paged:
            raise ValueError(
                "speculative decoding runs over the paged-KV engine "
                "(multi-token append + rollback need the block pool) "
                "— pass paged=True")
        unported = {
            "paged=False (the dense slot cache)": not paged,
            "spill_host_mb (the host-RAM spill tier)": bool(spill_host_mb),
        }
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"not ported yet: {', '.join(asked)} — the port serves the "
                "paged engine only (see ROADMAP.md)")
        validate_kv_cache_dtype(kv_cache_dtype, paged=paged)
        if ctx is not None and cfg.is_moe:
            raise NotImplementedError(moe_unported(
                "MoE under tensor-parallel serving (--serve-tp)"))
        if ctx is not None and adapter_cache is not None:
            raise NotImplementedError(TP_UNPORTED)
        if ctx is not None and speculate:
            raise NotImplementedError(SPEC_TP_UNPORTED)
        self.device = resolve_device(
            ctx.device if device is None and ctx is not None else device)
        if ctx is not None and ctx.device != self.device:
            raise ValueError(f"engine on {self.device}, its tp rank on "
                             f"{ctx.device}")
        # Tensor-parallel serving (JAX dynamic_engine.py:461-517): params
        # whole on every rank; the pools and the steps shard when the
        # config is tp-eligible, and a warning names the failed predicate
        # when it is not.
        self.ctx = ctx
        self.tp_paged = False
        if ctx is not None:
            reason = tp_paged_ineligible_reason(cfg, ctx)
            self.tp_paged = reason is None
            if not self.tp_paged and ctx.tp > 1:
                logger.warning("paged kernels stay single-device on a tp=%d "
                               "mesh: %s", ctx.tp, reason)
        self._step_ctx = ctx if self.tp_paged else None
        # A server driving a tp lead steps it at least this often when
        # idle (DynamicBatchingDriver), well inside the group's timeout.
        self.keepalive_s = (ctx.timeout_s / 4 if ctx is not None
                            and ctx.tp > 1 and ctx.is_lead else None)
        # Rank 0 decides: requests, cancellations and expirations wait in
        # _pending until the next step broadcasts them (_sync_ranks).
        self._tp_sync = ctx is not None and ctx.tp > 1
        self._pending: List[tuple] = []
        self._pending_ids: set = set()
        self._cmd_lock = threading.Lock()
        self.params = params.to(self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len or cfg.max_position_embeddings
        self.prefill_chunk = min(prefill_chunk, self.max_seq_len)
        # Batched multi-tenant LoRA: row_adapter maps each slot to its
        # adapter's bank slot (0 = the NULL adapter); acquire at admission
        # and release with the slot keep an in-use adapter resident.
        self.adapters = adapter_cache
        self.row_adapter = np.zeros((max_batch,), np.int32)
        self.lora_pinned_waits = 0     # admissions that waited on pins
        self.lengths = np.zeros((max_batch,), np.int32)
        self.last_tokens = np.zeros((max_batch, 1), np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch
        # Speculative decoding (inference/speculative.py): the proposer,
        # or None — plain decode, also when the requested proposer is
        # unavailable (it warns).
        self.spec_method: Optional[str] = None
        self.spec_k = int(spec_k)
        self.proposer = None
        self.spec_stats = {"rounds": 0, "proposed": 0, "accepted": 0,
                           "emitted_tokens": 0, "model_steps": 0}
        self._h_last = torch.zeros((max_batch, cfg.hidden_size),
                                   dtype=torch.float32, device=self.device)
        self._h_valid = np.zeros((max_batch,), bool)
        if speculate:
            from megatronapp_tpu_torch.inference.speculative import (
                make_proposer,
            )
            self.proposer = make_proposer(spec_method, self,
                                          draft_params=draft_params,
                                          draft_cfg=draft_cfg)
            if self.proposer is not None:
                self.spec_method = spec_method
        # The widest flattened row count a multi-query step sees: decode
        # [B, 1], chunked prefill [1, prefill_chunk], speculative verify
        # [B, K+1] (JAX dynamic_engine.py:666-671).
        self.mq_rows = max(max_batch, self.prefill_chunk,
                           max_batch * (self.spec_k + 1)
                           if self.spec_method else 0)
        if adapter_cache is not None:
            self._check_adapter_cache(adapter_cache)
        self.megakernel = False
        if fused_decode:
            reason = megakernel_ineligible_reason(
                cfg, batch=max_batch, params=self.params,
                mq_rows=self.mq_rows, tp_paged=self.tp_paged,
                lora_rank=(adapter_cache.rank if adapter_cache is not None
                           else None))
            if reason is None:
                self.megakernel = True
            else:
                logger.warning("megakernel decode requested but ineligible "
                               "— keeping the unfused decode step: %s",
                               reason)
        # Rolling reload (DynamicBatchingDriver.request_reload): while
        # True, _admit leaves the waiting queue untouched.
        self.pause_admission = False
        self.pool = PagedKVCache(
            cfg, max_batch, self.max_seq_len, num_blocks=num_blocks,
            block_size=block_size,
            enable_prefix_caching=enable_prefix_caching,
            kv_cache_dtype=kv_cache_dtype, device=self.device,
            tp=ctx.tp if self.tp_paged else 1)
        self.rope_tables = gpt_rope_tables(cfg, self.max_seq_len,
                                           device=self.device)
        self._rt = get_request_tracer()
        self._last_round_t: Optional[float] = None
        self.waiting: deque = deque()
        self.requests: Dict[int, Request] = {}
        self._aborted: List[Request] = []   # aborted mid-admission
        self._ids = itertools.count()
        self.decode_steps = 0
        self.prefill_chunks = 0

    def _to_dev(self, arr, dtype=None) -> torch.Tensor:
        return host_to(arr, self.device, dtype)

    def _check_adapter_cache(self, cache):
        """The cache's banks live on the engine's device, and on the card
        the LoRA kernels take every target's shape, rank and bank dtype."""
        if cache.device != self.device:
            raise ValueError(f"adapter_cache banks on {cache.device}, the "
                             f"engine on {self.device}: build the cache "
                             "with the engine's device")
        if cache.num_layers != self.cfg.num_layers:
            raise ValueError(f"adapter_cache has {cache.num_layers} layers, "
                             f"the model {self.cfg.num_layers}")
        if self.device.type != "cuda":
            return
        rows = self.mq_rows
        for target, (din, dout) in lora_target_dims(self.cfg).items():
            reason = lora_kernel_ineligible_reason(
                din, dout, cache.rank, rows, cache.dtype,
                self.cfg.compute_dtype)
            if reason is not None:
                raise ValueError(f"batched LoRA on {self.device} ({target}):"
                                 f" {reason}")

    def _lora_args(self, rows: Optional[np.ndarray] = None,
                   repeat: int = 1):
        """The steps' `lora` operand: None without an adapter cache, else
        the rows' bank slots (every slot's by default; `rows` for a
        single-slot chunk, each id repeated over the chunk's `repeat`
        token rows) and the cache's banks."""
        if self.adapters is None:
            return None
        if rows is None:
            rows = self.row_adapter
        return {"row_adapter": LoraRows(rows, self.device, repeat),
                "banks": self.adapters.banks}

    # ---- request lifecycle ------------------------------------------------
    def add_request(self, prompt_tokens, max_new_tokens: int,
                    sampling: Optional[SamplingParams] = None,
                    eod_id: Optional[int] = None,
                    priority: int = 0,
                    deadline_s: Optional[float] = None,
                    request_id: Optional[int] = None,
                    adapter_id: Optional[str] = None,
                    tenant: Optional[str] = None) -> int:
        if tenant is not None:
            raise NotImplementedError(TENANT_UNPORTED)
        prompt = validate_admission(prompt_tokens, max_new_tokens,
                                    self.max_seq_len, pool=self.pool,
                                    deadline_s=deadline_s)
        # Unknown adapters are a permanent submit-time error (the registry
        # names what it knows); all-slots-pinned pressure waits at
        # admission instead.
        if adapter_id is not None:
            if self.adapters is None:
                raise ValueError(
                    "adapter_id requires an engine adapter cache — "
                    "construct with adapter_cache= / --lora-dir")
            if adapter_id not in self.adapters.registry:
                raise KeyError(
                    f"unknown adapter {adapter_id!r}; known: "
                    f"{sorted(self.adapters.registry.ids())}")
        if self._tp_sync:
            if not self.ctx.is_lead:
                raise RuntimeError("a tp follower takes its requests from "
                                   "rank 0's broadcast (follow())")
            with self._cmd_lock:
                if request_id is None:
                    request_id = next(self._ids)
                elif (request_id in self.requests
                      or request_id in self._pending_ids):
                    raise ValueError(f"request id {request_id} already "
                                     "admitted")
                self._pending_ids.add(request_id)
                self._pending.append(("add", dict(
                    request_id=request_id, prompt=prompt,
                    max_new_tokens=max_new_tokens,
                    sampling=sampling or SamplingParams(), eod_id=eod_id,
                    priority=priority, deadline_s=deadline_s,
                    adapter_id=adapter_id)))
            return request_id
        if request_id is None:
            request_id = next(self._ids)
        elif request_id in self.requests:
            raise ValueError(f"request id {request_id} already admitted")
        self._enqueue(Request(request_id, prompt, max_new_tokens,
                              sampling or SamplingParams(), eod_id=eod_id,
                              priority=priority, deadline_s=deadline_s,
                              adapter_id=adapter_id))
        return request_id

    def _enqueue(self, req: Request):
        """A validated request joins the waiting queue (at submit, or on
        every rank when a tp step applies it)."""
        now = time.monotonic()
        req.admit_t = req.queued_t = now
        self.waiting.append(req)
        self.requests[req.request_id] = req
        telemetry.inc("serving_requests_admitted")
        rt = self._rt
        if rt.enabled:
            rt.instant("admit", req.request_id,
                       prompt_tokens=len(req.prompt), priority=req.priority)
            rt.begin("request", req.request_id)
            rt.begin("queue-wait", req.request_id)

    def pop_request(self, request_id: int) -> Optional[Request]:
        """Remove and return a finished request (server-side consumers)."""
        return self.requests.pop(request_id, None)

    def abort_request(self, request_id: int) -> Optional[str]:
        """Cancel a request. Returns 'waiting' if it was dequeued before
        running (no finish event will fire), 'running' if it was marked
        to retire on the next step, or None if unknown/already done. Under
        tp the lead queues the cancellation for the next step's broadcast
        and answers 'running' (the step's finish event completes it)."""
        if self._tp_sync:
            with self._cmd_lock:
                known = (request_id in self._pending_ids
                         or request_id in self.requests)
                if known:
                    self._pending.append(("abort", request_id))
            return "running" if known else None
        return self._abort(request_id)

    def _abort(self, request_id: int) -> Optional[str]:
        req = self.requests.get(request_id)
        if req is None:
            return None
        if req in self.waiting:
            try:
                self.waiting.remove(req)
            except ValueError:
                pass    # raced with admission: treat as running below
            else:
                req.finished = True
                self._rt.finish(request_id, "abort")
                return "waiting"
        if not req.finished:
            req.finished = True
            self._rt.instant("abort", request_id)
            return "running"
        return None

    def expire_overdue(self, now: Optional[float] = None) -> List[int]:
        """Abort every request whose deadline passed: waiting ones leave
        the queue immediately; running ones are marked finished, so the
        same step's retire pass releases their slot and pool blocks.
        Returns the expired request ids."""
        return self._expire(self._overdue(now))

    def _overdue(self, now: Optional[float] = None) -> List[Request]:
        """The requests whose deadline passed, waiting ones first."""
        if now is None:
            now = time.monotonic()

        def overdue(r: Request) -> bool:
            return (r.deadline_s is not None and not r.finished
                    and now >= r.deadline_s)

        # Snapshot the waiting deque tolerantly: submit() may append
        # concurrently (deque iteration raises RuntimeError on mutation);
        # expiry is re-checked every step, so skipping one sweep is
        # harmless.
        for _ in range(4):
            try:
                overdue_waiting = [r for r in self.waiting if overdue(r)]
                break
            except RuntimeError:
                continue
        else:
            overdue_waiting = []
        return overdue_waiting + [r for r in self.slots
                                  if r is not None and overdue(r)]

    def _expire(self, reqs: List[Request]) -> List[int]:
        """Abort `reqs` as expired (waiting ones leave the queue, running
        ones retire this step); returns their ids."""
        expired: List[int] = []
        for req in reqs:
            if req.slot < 0:
                try:
                    self.waiting.remove(req)
                except ValueError:
                    continue    # cancelled concurrently: already retiring
                req.finished = True
                self._aborted.append(req)    # finish event fires this step
                expired.append(req.request_id)
                self._rt.finish(req.request_id, "expire")
            else:
                req.finished = True      # retired (blocks released) below
                expired.append(req.request_id)
                self._rt.instant("expire", req.request_id)
        if expired:
            telemetry.inc("serving_deadline_expired", len(expired))
        return expired

    def abort_all(self):
        """Drop ALL queued and running requests (server error recovery),
        releasing pool blocks so the bookkeeping stays consistent. Under
        tp the lead queues it for the next step's broadcast (every rank
        drops the same work), and its queued commands go with it."""
        if self._tp_sync and self.ctx.is_lead:
            with self._cmd_lock:
                self._pending = [("abort_all", None)]
                self._pending_ids.clear()
            return
        self._abort_all()

    def _abort_all(self):
        self._last_round_t = None
        for req in list(self.waiting):
            self.requests.pop(req.request_id, None)
            self._rt.finish(req.request_id, "abort")
        self.waiting.clear()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            try:
                self.pool.release(slot, np.asarray(req.tokens),
                                  int(self.lengths[slot]))
            except Exception:  # noqa: BLE001 — best-effort reclaim
                pass
            self._free_slot(slot)
            self.requests.pop(req.request_id, None)
            self._rt.finish(req.request_id, "abort")

    def _free_slot(self, slot: int):
        """Clear every per-slot engine resource (and unpin the slot's
        adapter: rc == 0 residents park in the cache's LRU, still
        hittable); pool blocks are released by the caller (release
        semantics differ per path)."""
        self.slots[slot] = None
        self.lengths[slot] = 0
        self._h_valid[slot] = False
        if self.adapters is not None:
            self.adapters.release(int(self.row_adapter[slot]))
            self.row_adapter[slot] = 0
        if self.proposer is not None:
            self.proposer.on_release(slot)

    @property
    def has_work(self) -> bool:
        return (bool(self.waiting) or bool(self._pending)
                or any(r is not None for r in self.slots))

    def set_params(self, params):
        """Install new model params (rolling reload) of the same
        structure; the prefix cache is flushed (its blocks hold KV from
        the old weights)."""
        if self._tp_sync:
            raise NotImplementedError(
                "a rolling reload under tensor parallelism is not ported "
                "yet (ROADMAP.md Queue 1): every rank would swap its params "
                "between the same two steps")
        self.params = params.to(self.device)
        self.pool.flush_prefix_cache()

    def drained_for_reload(self) -> bool:
        """True when a params swap is safe: no occupied slots."""
        return all(r is None for r in self.slots)

    # ---- admission and prefill -------------------------------------------
    def _admit(self) -> List[Request]:
        admitted = []
        if self.pause_admission:
            return admitted
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            # Pop FIRST (re-appended on failure): a peek-then-pop window
            # would race a concurrent abort_request removing the head.
            req = self.waiting.popleft()
            if req.finished:          # aborted while queued (racy path)
                self._aborted.append(req)
                continue
            # Admission by block availability: if the pool cannot host
            # this prompt now, keep FIFO order and wait for retirements
            # or preemptions to free blocks.
            # Prefix keys are salted with the adapter: another adapter's
            # blocks hold KV computed under its q/kv deltas.
            plan = self.pool.admit(slot, req.tokens, salt=req.adapter_id)
            if plan is None:
                self.waiting.appendleft(req)
                break
            if self.adapters is not None:
                try:
                    aslot = self.adapters.acquire(req.adapter_id)
                except AdapterSlotsPinned:
                    # Every bank slot is pinned by running requests: wait,
                    # in FIFO order, for a retirement to unpin one.
                    self.lora_pinned_waits += 1
                    self.pool.release(slot, np.asarray(req.tokens), 0)
                    self.waiting.appendleft(req)
                    break
                except Exception:
                    # A load fault (the "lora-load" drill): the cache
                    # changed nothing; release the admitted blocks, requeue
                    # at the head and re-raise for the stepper's watchdog.
                    self.pool.release(slot, np.asarray(req.tokens), 0)
                    req.queued_t = time.monotonic()
                    self.waiting.appendleft(req)
                    raise
                self.row_adapter[slot] = aslot
            req.slot = slot
            self.slots[slot] = req
            rid = req.request_id
            first_life = not req.generated   # vs resumed after preempt
            self._rt.end("queue-wait", rid)
            telemetry.observe("serving_queue_wait_ms",
                              (time.monotonic() - req.queued_t) * 1e3)
            self._rt.begin("prefill", rid, prompt_tokens=len(req.tokens))
            try:
                self._prefill_into_slot(req, plan)
            except Exception:
                # Return every admitted block (valid_len=0: partially
                # written rows are stale data the retry overwrites),
                # clear the slot and requeue at the head.
                self.pool.release(slot, np.asarray(req.tokens), 0)
                self._free_slot(slot)
                req.slot = -1
                req.queued_t = time.monotonic()
                self.waiting.appendleft(req)
                self._rt.end("prefill", rid, error=True)
                self._rt.begin("queue-wait", rid)
                raise
            self._rt.end("prefill", rid)
            if first_life:
                telemetry.observe("serving_ttft_ms",
                                  (time.monotonic() - req.admit_t) * 1e3)
            self._rt.begin("decode", rid)
            admitted.append(req)
        return admitted

    def _prefill_into_slot(self, req: Request, plan):
        # req.tokens (prompt + any pre-preemption generated tokens): a
        # resumed request re-prefills its full history and samples the
        # NEXT token, exactly like a fresh admission.
        tokens = req.tokens
        p_len = len(tokens)
        logits_last = self._paged_prefill_chunked(req, tokens, p_len, plan)
        self.lengths[req.slot] = p_len
        # First generated token comes from the last PROMPT position.
        logits_last = mask_padded_vocab(logits_last, self.cfg)
        tok = self._sample(logits_last[None], req)
        self._record_token(req, int(tok[0]))
        if self.proposer is not None:
            self.proposer.on_admit(req.slot, req)

    @torch.no_grad()
    def _paged_prefill_chunked(self, req: Request, tokens, p_len: int,
                               plan) -> torch.Tensor:
        """Prefill the uncached prompt tail in fixed-size chunks against
        the page table: each chunk is one multi-query step at shape
        [1, prefill_chunk]. Returns the last prompt position's logits
        [V] and records its pre-head hidden for the MTP proposer."""
        slot = req.slot
        pool = self.pool
        c = self.prefill_chunk
        table_np = pool.page_table[slot][None]                  # [1, MB]
        table = self._to_dev(table_np)
        lora = self._lora_args(self.row_adapter[slot:slot + 1], repeat=c)
        pos, count = plan.cached_tokens, 0
        logits = hid = None
        while pos < p_len:
            count = min(c, p_len - pos)
            chunk = np.zeros((1, c), np.int32)
            chunk[0, :count] = tokens[pos:pos + count]
            starts = np.asarray([pos], np.int32)
            counts = np.asarray([count], np.int32)
            index = paged_write_index(
                torch.from_numpy(table_np), torch.from_numpy(starts),
                torch.from_numpy(counts), torch.ones(1, dtype=torch.bool),
                pool.block_size, c)
            logits, hid, _ = _paged_multiquery_step(
                self.params, self._to_dev(chunk), pool.pages, table,
                self._to_dev(starts), self._to_dev(counts), self.cfg,
                self.max_seq_len, tuple(self._to_dev(t) for t in index),
                self.rope_tables, fused=self.megakernel,
                scales=pool.scales, lora=lora, ctx=self._step_ctx)
            self.prefill_chunks += 1
            pos += count
        # Register the prompt's full blocks so concurrent same-prefix
        # requests hit them immediately.
        pool.register_prefix(slot, np.asarray(tokens), p_len)
        if self.proposer is not None and self.proposer.needs_hidden:
            self._h_last[slot] = hid[0, count - 1].float()
            self._h_valid[slot] = True
        return logits[0, count - 1]

    # ---- sampling ---------------------------------------------------------
    @staticmethod
    def _rows_for(reqs: Dict[int, Request], b: int
                  ) -> Dict[str, np.ndarray]:
        """Per-row sampling parameters + generator-seed inputs for `b`
        rows; rows not in `reqs` keep neutral greedy defaults (their
        outputs are ignored)."""
        rows = {"seeds": np.zeros(b, np.int64),
                "rids": np.zeros(b, np.int64),
                "steps": np.zeros(b, np.int64),
                "temps": np.ones(b, np.float32),
                "top_ks": np.zeros(b, np.int32),
                "top_ps": np.zeros(b, np.float32),
                "sampled": np.zeros(b, bool)}
        for i, r in reqs.items():
            s = r.sampling
            rows["seeds"][i], rows["rids"][i] = s.seed, r.request_id
            rows["steps"][i] = len(r.generated)
            rows["temps"][i], rows["top_ks"][i] = s.temperature, s.top_k
            rows["top_ps"][i], rows["sampled"][i] = s.top_p, not s.greedy
        return rows

    def _sample(self, logits, req: Request) -> np.ndarray:
        """Single-row sampling (prefill) with the same per-row generator
        seeding as the batched decode sampler."""
        return _sample_rows(logits, self._rows_for({0: req}, 1)).cpu().numpy()

    def _sampling_rows(self) -> Dict[str, np.ndarray]:
        """Every slot's sampling row (unfinished requests; the others keep
        neutral greedy defaults): the one source for the plain sampler,
        the speculative verifier and the draft proposer."""
        reqs = {i: r for i, r in enumerate(self.slots)
                if r is not None and not r.finished}
        return self._rows_for(reqs, self.max_batch)

    def _sample_all(self, logits) -> np.ndarray:
        """Batched sampling for every slot: the step's one host
        synchronisation is reading these tokens back."""
        return _sample_rows(logits, self._sampling_rows()).cpu().numpy()

    def _record_token(self, req: Request, tok: int):
        req.generated.append(tok)
        self.last_tokens[req.slot, 0] = tok
        if (tok == req.eod_id or
                len(req.generated) >= req.max_new_tokens):
            req.finished = True

    # ---- pool pressure ----------------------------------------------------
    def _preempt(self, req: Request, out: List[Request]):
        """Push a running request back to the waiting queue, releasing
        its blocks (full blocks stay prefix-cached while evictable, so
        the resume prefill usually re-hits its own KV)."""
        slot = req.slot
        self.pool.release(slot, np.asarray(req.tokens),
                          int(self.lengths[slot]), preempted=True)
        self._free_slot(slot)
        req.slot = -1
        req.queued_t = time.monotonic()
        self.waiting.appendleft(req)
        out.append(req)
        rt = self._rt
        if rt.enabled:
            rt.end("decode", req.request_id)
            rt.instant("preempt", req.request_id)
            rt.begin("queue-wait", req.request_id)

    def _ensure_decode_capacity(self) -> List[Request]:
        """Before a decode step, every active slot needs the block that
        covers its append position. Exhaustion preempts the
        lowest-priority running request (highest (priority,
        request_id)); the needy request preempts ITSELF when it is the
        lowest."""
        preempted: List[Request] = []
        runners = sorted(
            (r for r in self.slots if r is not None and not r.finished),
            key=lambda r: (r.priority, r.request_id))
        for req in runners:
            if req.slot < 0:
                continue                 # preempted earlier this step
            while not self.pool.ensure_capacity(
                    req.slot, int(self.lengths[req.slot])):
                victim = next(r for r in reversed(runners)
                              if r.slot >= 0)
                self._preempt(victim, preempted)
                if victim is req:
                    break
        return preempted

    def _retire(self) -> List[Request]:
        done = []
        for slot, req in enumerate(self.slots):
            if req is not None and req.finished:
                done.append(req)
                # The cache holds tokens[:-1] (the final sampled token's
                # KV was never written): register/release only those.
                self.pool.release(slot, np.asarray(req.tokens),
                                  int(self.lengths[slot]))
                self._free_slot(slot)
                telemetry.inc("serving_requests_retired")
                self._rt.finish(req.request_id, "retire",
                                generated=len(req.generated))
        return done

    # ---- tensor-parallel lockstep -----------------------------------------
    def _apply(self, cmds):
        """Apply the lead's queued commands, in order (every rank)."""
        for op, arg in cmds:
            if op == "add":
                self._enqueue(Request(**arg))
            elif op == "abort":
                req = self.requests.get(arg)
                if self._abort(arg) == "waiting":
                    self._aborted.append(req)    # its finish event fires
            else:
                self._abort_all()

    def _sync_ranks(self) -> Optional[List[int]]:
        """The step's host decisions, made on the lead and broadcast: its
        queued submissions, cancellations and aborts, the deadline
        expirations of its clock and its admission pause. Every rank
        applies them in the same order. Returns the expired ids, or None
        on a follower told to stop."""
        ctx = self.ctx
        if ctx.is_lead:
            with self._cmd_lock:
                cmds, self._pending = self._pending, []
                self._pending_ids.clear()
            self._apply(cmds)
            msg = {"cmds": cmds, "pause": self.pause_admission,
                   "expired": [r.request_id for r in self._overdue()]}
            collectives.broadcast_object(msg, ctx)
        else:
            msg = collectives.broadcast_object(None, ctx)
            if msg is None:
                return None
            self._apply(msg["cmds"])
            self.pause_admission = msg["pause"]
        return self._expire([self.requests[rid] for rid in msg["expired"]])

    def release_followers(self):
        """Lead: end the followers' ``follow()`` loops (after the last
        step)."""
        if self._tp_sync and self.ctx.is_lead:
            collectives.broadcast_object(None, self.ctx)

    def follow(self) -> Dict[int, np.ndarray]:
        """Follower rank: step in lockstep with the lead until it releases
        the followers. Returns {request_id: full token array} of every
        request finished meanwhile (the lead's streams, on this rank)."""
        if not self._tp_sync or self.ctx.is_lead:
            raise RuntimeError("follow() runs on a tp follower rank")
        results: Dict[int, np.ndarray] = {}
        while True:
            ev = self.step()
            if ev is None:
                return results
            for rid in ev["finished"]:
                req = self.requests.pop(rid, None)
                if req is not None:
                    results[rid] = req.tokens

    # ---- main loop --------------------------------------------------------
    def step(self) -> Optional[Dict[str, List]]:
        """Admit → decode one token for all active slots → retire.

        Returns {"admitted": [ids], "tokens": [(id, tok)], "finished":
        [ids], "preempted": [ids], "expired": [ids]} for this step
        (expired ⊆ finished); a tp follower returns None when the lead
        released it."""
        if self._tp_sync:
            expired = self._sync_ranks()
            if expired is None:
                return None
        else:
            expired = self.expire_overdue()
        admitted = self._admit()
        events = {"admitted": [r.request_id for r in admitted],
                  "tokens": [(r.request_id, r.generated[-1])
                             for r in admitted],
                  "finished": [], "preempted": [], "expired": expired}
        events["preempted"] = [
            r.request_id for r in self._ensure_decode_capacity()]

        active = [r for r in self.slots
                  if r is not None and not r.finished]
        if active:
            # Token-interval telemetry: back-to-back decode rounds only.
            t_round = time.monotonic()
            if self._last_round_t is not None:
                iv_ms = (t_round - self._last_round_t) * 1e3
                telemetry.observe("decode_interval_ms", iv_ms)
            if self.spec_method:
                self._spec_round(active, events)
            else:
                self._plain_round(active, events)
            self._last_round_t = time.monotonic()
        else:
            self._last_round_t = None

        events["finished"] = [r.request_id for r in self._retire()]
        events["finished"] += [r.request_id for r in self._aborted]
        self._aborted = []
        return events

    @torch.no_grad()
    def _plain_round(self, active: List[Request], events: Dict):
        """One-token decode for every active slot."""
        self._rt.begin("decode-step", None, batch=len(active))
        try:
            active_np = np.array(
                [self.slots[i] is not None and not self.slots[i].finished
                 for i in range(self.max_batch)])
            table_np = self.pool.page_table[:self.max_batch]
            index = paged_write_index(
                torch.from_numpy(table_np), torch.from_numpy(self.lengths),
                torch.ones(self.max_batch, dtype=torch.int32),
                torch.from_numpy(active_np), self.pool.block_size, 1)
            logits, _ = _paged_decode_step(
                self.params, self._to_dev(self.last_tokens),
                self.pool.pages, self._to_dev(table_np),
                self._to_dev(self.lengths), self.cfg,
                tuple(self._to_dev(t) for t in index), self.rope_tables,
                fused=self.megakernel, scales=self.pool.scales,
                lora=self._lora_args(), ctx=self._step_ctx)
            # The decode wrote each active row's kv at lengths[slot].
            self.lengths += active_np.astype(np.int32)
            logits = mask_padded_vocab(logits, self.cfg)
            toks = self._sample_all(logits)
            self.decode_steps += 1
            self.spec_stats["model_steps"] += 1
            self.spec_stats["emitted_tokens"] += len(active)
            telemetry.inc("serving_tokens_emitted", len(active))
            for req in active:
                tok = int(toks[req.slot])
                self._record_token(req, tok)
                events["tokens"].append((req.request_id, tok))
        finally:
            self._rt.end("decode-step", None)

    def _spec_round(self, active: List[Request], events: Dict):
        """One speculate-and-verify round (JAX dynamic_engine.py:1712):
        propose up to spec_k drafts a slot, verify them all in ONE ragged
        multi-query step, accept by exact rejection sampling, and rewind
        the rejected drafts' KV (PagedKVCache.rewind)."""
        # Opportunistic capacity for the speculative tail: the append
        # position's block is already guaranteed by
        # _ensure_decode_capacity; under pressure speculation SHRINKS
        # instead of preempting.
        k_caps = np.zeros((self.max_batch,), np.int32)
        for req in active:
            slot = req.slot
            length = int(self.lengths[slot])
            want = min(self.spec_k,
                       req.max_new_tokens - len(req.generated) - 1,
                       self.max_seq_len - 1 - length)
            if want > 0:
                k_caps[slot] = self.pool.extend_capacity(slot, length + 1,
                                                         want)
        self._rt.begin("spec-round", None, batch=len(active))
        try:
            self._spec_round_inner(active, events, k_caps)
        except Exception:
            # Leave the pool consistent on any mid-round failure (the
            # "spec-verify" drill): every surviving slot rewinds to its
            # last verified length (+1: this step's guaranteed append
            # block); written-but-unaccepted draft KV is stale rows that
            # the retried round overwrites, and the over-granted tail
            # blocks go back to the pool. The proposer forgets the round's
            # drafts (a draft model's cache length too).
            for req in active:
                if req.slot >= 0:
                    self.pool.rewind(req.slot,
                                     int(self.lengths[req.slot]) + 1)
                    self.proposer.on_abort(req.slot)
            raise
        finally:
            self._rt.end("spec-round", None)

    @torch.no_grad()
    def _spec_round_inner(self, active: List[Request], events: Dict,
                          k_caps: np.ndarray):
        from megatronapp_tpu_torch.inference.speculative import (
            _verify_and_sample,
        )
        b, k = self.max_batch, self.spec_k
        drafts, counts, q_probs = self.proposer.propose(k_caps)
        if not counts.any():
            # Nothing proposed anywhere: the (K+1)-wide verify would cost
            # more than the one-token step and emit the same one token a
            # row, so take the plain step (the same streams). Drop the
            # over-granted blocks first, keeping this step's append block.
            for req in active:
                self.pool.rewind(req.slot, int(self.lengths[req.slot]) + 1)
            self._plain_round(active, events)
            return
        q_lens = np.ones((b,), np.int32)
        tokens = np.zeros((b, k + 1), np.int32)
        active_np = np.zeros((b,), bool)
        for req in active:
            slot = req.slot
            active_np[slot] = True
            tokens[slot, 0] = self.last_tokens[slot, 0]
            n = int(counts[slot])
            tokens[slot, 1:1 + n] = drafts[slot, :n]
            q_lens[slot] = 1 + n
        rows = self._sampling_rows()
        logits, hidden = self._verify_step(tokens, q_lens, active_np)
        # Chaos site "spec-verify": the worst point — the step wrote every
        # draft's KV and nothing is accepted yet — so the drill proves
        # _spec_round's rollback keeps the pool auditable and the stream
        # exact.
        chaos.fire("spec-verify")
        accepts, out_toks = _verify_and_sample(
            logits, drafts, q_lens, q_probs, rows,
            point_mass=self.proposer.point_mass)
        if self.proposer.needs_hidden:
            # Each active slot's hidden at its accepted row: the position
            # whose next token this round emitted last.
            idx = self._to_dev(np.flatnonzero(active_np))
            acc = self._to_dev(accepts.astype(np.int64))
            self._h_last[idx] = hidden[idx, acc[idx]].float()
            self._h_valid[active_np] = True
        self.spec_stats["rounds"] += 1
        self.spec_stats["model_steps"] += 1
        for req in active:
            slot = req.slot
            n = int(counts[slot])
            a = min(int(accepts[slot]), n)
            emitted = [int(t) for t in drafts[slot, :a]]
            emitted.append(int(out_toks[slot]))
            len_before = int(self.lengths[slot])
            m = 0
            for tok in emitted:
                self._record_token(req, tok)
                events["tokens"].append((req.request_id, tok))
                m += 1
                if req.finished:
                    break   # eod or budget: drop the rest of the window
            # Valid KV = [last token, accepted drafts]: rewind the
            # written-but-rejected tail (and over-granted blocks).
            self.lengths[slot] = len_before + m
            self.pool.rewind(slot, len_before + m)
            req.spec_proposed += n
            req.spec_accepted += a
            self.spec_stats["proposed"] += n
            self.spec_stats["accepted"] += a
            self.spec_stats["emitted_tokens"] += m
            # Accepted drafts a verify round a request row: /metrics
            # percentiles show the acceptance distribution.
            telemetry.observe("spec_accepted_per_round", a,
                              lo=0.5, hi=64, growth=1.5)
            telemetry.inc("spec_proposed_tokens", n)
            telemetry.inc("spec_accepted_tokens", a)
            telemetry.inc("serving_tokens_emitted", m)
            self.proposer.on_verified(slot, a)

    @torch.no_grad()
    def _verify_step(self, tokens: np.ndarray, q_lens: np.ndarray,
                     active: np.ndarray):
        """The verify step: one ragged multi-query step at [B, K+1] over
        every slot (row b's q_lens[b] tokens append at lengths[b]; the
        pool must already cover them), in place. Returns the logits [B,
        K+1, V] fp32, padded vocab masked, and the pre-head hidden [B,
        K+1, H] (unfused or fused), on the engine's device."""
        s = tokens.shape[1]
        table_np = self.pool.page_table[:self.max_batch]
        index = paged_write_index(
            torch.from_numpy(table_np), torch.from_numpy(self.lengths),
            torch.from_numpy(q_lens), torch.from_numpy(active),
            self.pool.block_size, s)
        logits, hidden, _ = _paged_multiquery_step(
            self.params, self._to_dev(tokens), self.pool.pages,
            self._to_dev(table_np), self._to_dev(self.lengths),
            self._to_dev(q_lens), self.cfg, self.max_seq_len,
            tuple(self._to_dev(t) for t in index), self.rope_tables,
            fused=self.megakernel, scales=self.pool.scales,
            lora=self._lora_args(repeat=s), ctx=self._step_ctx)
        return mask_padded_vocab(logits, self.cfg), hidden

    def run_to_completion(self,
                          token_callback: Optional[Callable] = None
                          ) -> Dict[int, np.ndarray]:
        """Drive step() until every request finishes; returns
        {request_id: full token array}."""
        results: Dict[int, np.ndarray] = {}
        finished_reqs: Dict[int, Request] = {}
        while self.has_work:
            ev = self.step()
            if token_callback is not None:
                for rid, tok in ev["tokens"]:
                    token_callback(rid, tok)
            for rid in ev["finished"]:
                finished_reqs[rid] = self.requests[rid]
        for rid, req in finished_reqs.items():
            results[rid] = req.tokens
            self.requests.pop(rid, None)
        return results

    # ---- observability ----------------------------------------------------
    def stats_snapshot(self) -> Dict:
        """JSON-ready serving stats (GET /stats): batch occupancy, pool
        occupancy and storage dtype, prefix-cache hit rate, the params'
        device bytes, whether the fused step runs, the kernels' launch
        counts and, with an adapter cache, its books ("lora"); under tp
        the rank, the group and the collectives' counts ("tp"), and the
        rank's own pool bytes."""
        from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
        from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
        from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
        from megatronapp_tpu_torch.ops.cuda import lora as cl
        from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
        from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
        pool = self.pool
        st = dict(pool.stats)
        seen = st["prefix_hit_tokens"] + st["prefill_tokens"]
        bpb = pool.bytes_per_block
        resident_blocks = pool.num_blocks - pool.free_blocks()
        return {
            "engine": "dynamic",
            "paged": True,
            "device": str(self.device),
            "max_batch": self.max_batch,
            "active": sum(1 for r in self.slots if r is not None),
            "waiting": len(self.waiting),
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "megakernel": self.megakernel,
            "param_bytes": resident_nbytes(self.params),
            "kernel_launches": {"paged_attention": dict(pa.launches),
                                "paged_latent": dict(pl.launches),
                                "fused_decode": dict(fd.launches),
                                "fused_mla": dict(fm.launches),
                                "fused_decode_lora": dict(fd.lora_launches),
                                "lora": dict(cl.launches),
                                "latent_tp": dict(lt.launches)},
            "tp": None if self.ctx is None else {
                "tp": self.ctx.tp, "rank": self.ctx.rank,
                "backend": self.ctx.backend,
                "device": str(self.ctx.device), "tp_paged": self.tp_paged,
                "collectives": dict(collectives.calls)},
            "pool": {
                "num_blocks": pool.num_blocks,
                "block_size": pool.block_size,
                "kv_cache_dtype": pool.kv_cache_dtype,
                "bytes_per_block": bpb,
                "pool_bytes_total": pool.bytes_total,
                "resident_bytes": resident_blocks * bpb,
                "blocks_in_use": pool.blocks_in_use(),
                "blocks_free": pool.free_blocks(),
                "blocks_evictable": pool.evictable_blocks(),
                "prefix_hit_rate": (
                    round(st["prefix_hit_tokens"] / seen, 4) if seen
                    else 0.0),
                **st,
            },
            **({"lora": {**self.adapters.stats_snapshot(),
                         "pinned_waits": self.lora_pinned_waits}}
               if self.adapters is not None else {}),
            **({"speculative": self._spec_snapshot()}
               if self.spec_method else {}),
        }

    def _spec_snapshot(self) -> Dict:
        """The speculative section of /stats (JAX's keys): method, k,
        acceptance rate, tokens per model step and the raw counts."""
        ss = dict(self.spec_stats)
        return {"method": self.spec_method, "k": self.spec_k,
                "acceptance_rate": (round(ss["accepted"] / ss["proposed"], 4)
                                    if ss["proposed"] else 0.0),
                "tokens_per_step": (
                    round(ss["emitted_tokens"] / ss["model_steps"], 4)
                    if ss["model_steps"] else 0.0),
                **ss}
