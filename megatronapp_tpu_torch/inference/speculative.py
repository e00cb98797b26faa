"""Speculative decoding over the paged engine (the JAX package's
inference/speculative.py): proposers and the exact rejection-sampling
verifier for ``DynamicInferenceEngine(spec_method=...)``.

- ``NGramProposer`` ("ngram"): model-free prompt lookup — the longest
  suffix n-gram of the request's tokens is matched against its earlier
  occurrences and the continuation is proposed.
- ``DraftModelProposer`` ("draft"): a small draft model sharing the
  target's vocab, with its own dense per-slot KV cache
  (inference/engine.py:init_kv_cache). Each round it catches up on the
  tokens the target accepted since its last run, then drafts K tokens;
  sampled requests draft from the draft's warped distribution and hand
  the verifier the proposal probabilities q.
- "mtp" (self-drafting through the model's MTP heads) needs the heads,
  which the port does not load yet: ``make_proposer`` warns, counts
  ``spec_proposer_fallbacks`` and the engine decodes plainly, as JAX does
  for a model without heads.

Verification: every draft (plus the mandatory next token) runs through
the engine's one ragged multi-query step (the paged kernel at [B, K+1]),
and ``_verify_and_sample`` accepts on the logits' device:

- greedy rows accept draft i while it equals the argmax of the target
  logits at its position, so the stream is the plain greedy stream;
- sampled rows accept draft d with probability min(1, p(d)/q(d)) and on
  rejection sample the residual norm(max(p - q, 0)); deterministic
  proposers (n-gram) are a point mass q: accept with p(d), residual = p
  with d zeroed. p is warped through the engine's ``_warp_logits``.

Randomness: JAX folds (request id, step) into its PRNG key; the port seeds
a ``torch.Generator`` from ``_row_seed(seed, request id, step)``, as its
plain sampler does. The acceptance uniform, the residual draw and the
draft's own draw each come from a stream of their own (a stream tag
appended to the triple), and a round whose drafts are all accepted draws
its bonus token from the plain sampler's own stream at that step, so the
streams stay reproducible and independent of batch composition.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from megatronapp_tpu_torch.inference.dynamic_engine import (
    _decode_step, _gumbel_rows, _row_seed, _warp_logits,
)
from megatronapp_tpu_torch.inference.engine import (
    _forward_with_cache, init_kv_cache, mask_padded_vocab,
)
from megatronapp_tpu_torch.models.gpt import gpt_rope_tables
from megatronapp_tpu_torch.utils.device import host_to

# Stream tags appended to (seed, request id, step): the acceptance
# uniform, the residual draw and the draft model's own sampling draw; the
# bare triple is the plain sampler's (and the bonus token's) stream.
_ACCEPT_FOLD = 1
_RESIDUAL_FOLD = 2
_DRAFT_FOLD = 3


def _sampled_params(rows: Dict[str, np.ndarray], idx: np.ndarray, device,
                    repeat: int = 1):
    """(temps, top_ks, top_ps) of rows `idx` on `device`, each row repeated
    `repeat` times."""
    return tuple(host_to(np.repeat(rows[k][idx], repeat), device)
                 for k in ("temps", "top_ks", "top_ps"))


def _stream_seeds(rows, idx, steps, fold: Optional[int] = None):
    """Generator seeds of rows `idx` at per-row steps (the plain sampler's
    stream, or stream `fold`)."""
    extra = () if fold is None else (fold,)
    return [_row_seed(int(rows["seeds"][i]), int(rows["rids"][i]),
                      int(st), *extra) for i, st in zip(idx, steps)]


@torch.no_grad()
def _verify_and_sample(logits: torch.Tensor, drafts: np.ndarray,
                       q_lens: np.ndarray, q_probs: Optional[torch.Tensor],
                       rows: Dict[str, np.ndarray], *, point_mass: bool
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """One round's verification (JAX speculative.py:75).

    logits [B, K+1, V] fp32 target logits (padded vocab masked; row i sits
    at the position whose NEXT token is decided: generated index
    rows["steps"] + i); drafts [B, K] host ints; q_lens [B] = 1 + the
    row's draft count; q_probs [B, K, V] proposal probabilities (None for
    a point-mass proposer, or when no row samples); rows: the engine's
    per-slot sampling rows (``_rows_for``). Everything runs on the logits'
    device; the result comes back to the host in one copy. Returns
    (accepted [B] in [0, K], out_token [B]): the emitted window is
    drafts[:accepted] + [out]."""
    b, s, v = logits.shape
    k = s - 1
    dev = logits.device
    d = host_to(drafts.astype(np.int64), dev)
    limit = host_to(q_lens.astype(np.int64) - 1, dev)
    pos = torch.arange(k, device=dev)
    # Greedy acceptance: draft i == the argmax plain decode would take.
    acc = d == logits[:, :k].argmax(dim=-1)
    sampled = np.flatnonzero(rows["sampled"])
    if len(sampled):
        idx = host_to(sampled, dev)
        n = len(sampled)
        warped = _warp_logits(
            logits[idx].reshape(n * s, v),
            *_sampled_params(rows, sampled, dev, repeat=s)).reshape(n, s, v)
        probs = torch.softmax(warped, dim=-1)
        base = rows["steps"][sampled]
        # Sampled acceptance: u * q(d) <= p(d), u from the row's accept
        # stream at each position's step.
        u = torch.stack([torch.rand(
            (), generator=torch.Generator(device=dev).manual_seed(sd),
            device=dev) for j in range(k)
            for sd in _stream_seeds(rows, sampled, base + j, _ACCEPT_FOLD)])
        u = u.reshape(k, n).T
        ds = d[idx]
        pd = probs[:, :k].gather(-1, ds[..., None])[..., 0]
        qd = (torch.ones_like(pd) if point_mass else
              q_probs[idx].gather(-1, ds[..., None])[..., 0])
        acc[idx] = u * qd <= pd
    acc = acc & (pos[None, :] < limit[:, None])
    a = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)        # [B]
    out = logits.gather(1, a[:, None, None].expand(b, 1, v))[:, 0].argmax(-1)
    if len(sampled):
        a_s = a[idx]
        rows_i = torch.arange(n, device=dev)
        row_warped = warped[rows_i, a_s]
        row_probs = probs[rows_i, a_s]
        # Fully accepted bonus: the plain sampler's stream at step
        # base + a, drawn for every a the row could reach and picked on
        # the device (no host round trip for a).
        bonus_noise = torch.stack([_gumbel_rows(
            (n, v), _stream_seeds(rows, sampled, base + c), dev)
            for c in range(k + 1)], dim=1)
        bonus = (row_warped + bonus_noise[rows_i, a_s]).argmax(-1)
        # Rejection: the residual norm(max(p - q, 0)); p ≈ q underflow
        # falls back to p (the acceptance was ~1 there anyway).
        a_c = a_s.clamp(max=k - 1)
        d_a = ds[rows_i, a_c]
        if point_mass:
            q_row = torch.nn.functional.one_hot(d_a, v).to(row_probs.dtype)
        else:
            q_row = q_probs[idx][rows_i, a_c]
        resid = (row_probs - q_row).clamp(min=0.0)
        total = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(total > 1e-9, resid / total.clamp(min=1e-30),
                            row_probs)
        resid_noise = torch.stack([_gumbel_rows(
            (n, v), _stream_seeds(rows, sampled, base + c, _RESIDUAL_FOLD),
            dev) for c in range(k)], dim=1)
        correction = (torch.log(resid.clamp(min=1e-30))
                      + resid_noise[rows_i, a_c]).argmax(-1)
        rejected = a_s < limit[idx]
        out[idx] = torch.where(rejected, correction, bonus)
    both = torch.stack([a, out]).cpu().numpy()
    return both[0].astype(np.int32), both[1].astype(np.int32)


# ---------------------------------------------------------------------------
# Proposers
# ---------------------------------------------------------------------------


class Proposer:
    """Engine-side proposer interface (one instance per engine).

    point_mass: the proposal is deterministic given the context (n-gram
    lookup); the verifier then treats q as a point mass, which keeps
    rejection sampling exact without materialising q."""

    name = "base"
    point_mass = True

    def __init__(self, engine):
        self.engine = engine

    # Lifecycle hooks (the engine calls these).
    def on_admit(self, slot: int, req):
        pass

    def on_release(self, slot: int):
        pass

    def on_verified(self, slot: int, accepted: int):
        pass

    def on_abort(self, slot: int):
        """The round failed before verification: forget its drafts."""
        pass

    def propose(self, k_caps: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, Optional[torch.Tensor]]:
        """k_caps [max_batch]: each slot's draft budget this round. Returns
        (drafts [B, spec_k] int32, counts [B] int32 with counts <= k_caps,
        q_probs [B, spec_k, V] on the engine's device, or None for a point
        mass or when no row samples)."""
        raise NotImplementedError


# The suffix n-gram lengths the n-gram proposer tries, longest first
# (JAX speculative.py:229).
NGRAM_MAX_N = 3
NGRAM_MIN_N = 1


def _ngram_lookup(tokens: np.ndarray, k: int, max_n: int,
                  min_n: int) -> np.ndarray:
    """Prompt lookup: the most recent earlier occurrence of the longest
    suffix n-gram; returns up to k continuation tokens (possibly 0)."""
    t = np.asarray(tokens)
    length = len(t)
    for n in range(min(max_n, length - 1), min_n - 1, -1):
        pat = t[length - n:]
        hay = t[:length - 1]            # the continuation must exist
        if len(hay) < n:
            continue
        win = np.lib.stride_tricks.sliding_window_view(hay, n)
        hits = np.flatnonzero(np.all(win == pat[None], axis=1))
        # Exclude the suffix matching itself (start == length - n).
        hits = hits[hits < length - n]
        if len(hits):
            start = int(hits[-1]) + n   # the most recent occurrence
            cont = t[start:start + k]
            if len(cont):
                return cont.astype(np.int32)
    return np.zeros((0,), np.int32)


class NGramProposer(Proposer):
    """Model-free prompt-lookup proposer (n-gram continuation)."""

    name = "ngram"
    point_mass = True

    def propose(self, k_caps):
        eng = self.engine
        drafts = np.zeros((eng.max_batch, eng.spec_k), np.int32)
        counts = np.zeros((eng.max_batch,), np.int32)
        for req in eng.slots:
            if req is None or req.finished:
                continue
            cap = int(k_caps[req.slot])
            if cap <= 0:
                continue
            cont = _ngram_lookup(req.tokens, cap, NGRAM_MAX_N, NGRAM_MIN_N)
            drafts[req.slot, :len(cont)] = cont
            counts[req.slot] = len(cont)
        return drafts, counts, None


@torch.no_grad()
def _draft_sample(logits: torch.Tensor, rows: Dict[str, np.ndarray],
                  steps: np.ndarray) -> Tuple[torch.Tensor,
                                              Optional[torch.Tensor]]:
    """One draft-chain step's tokens (JAX speculative.py:336): greedy rows
    take the argmax; sampled rows draw from the draft's warped
    distribution on their own draft stream (independent of the verifier's
    uniforms: a proposal that saw the acceptance randomness would bias
    the test). Returns (tokens [B] on the device, q [B, V] warped proposal
    probabilities of the sampled rows, zero elsewhere; None when no row
    samples)."""
    toks = logits.argmax(dim=-1)
    sampled = np.flatnonzero(rows["sampled"])
    if not len(sampled):
        return toks, None
    dev = logits.device
    idx = host_to(sampled, dev)
    warped = _warp_logits(logits[idx], *_sampled_params(rows, sampled, dev))
    q = torch.zeros_like(logits)
    q[idx] = torch.softmax(warped, dim=-1)
    toks[idx] = (warped + _gumbel_rows(
        warped.shape, _stream_seeds(rows, sampled, steps[sampled],
                                    _DRAFT_FOLD), dev)).argmax(-1)
    return toks, q


class DraftModelProposer(Proposer):
    """A small draft model with its own DENSE per-slot KV cache.

    The draft shares the target's (padded) vocab, so its proposal q lives
    in the same space as the target's p. Each round it (1) catches up on
    the tokens the target accepted since its last run, at most K+1
    batched one-token steps, then (2) drafts K tokens autoregressively,
    keeping q for the verifier. Rejected drafts' KV needs no rollback: the
    dense cache masks by each row's length, and the next catch-up
    overwrites stale rows. The whole chain stays on the device: its
    tokens come back to the host once, at the end of the round's
    drafting."""

    name = "draft"
    point_mass = False

    def __init__(self, engine, draft_params, draft_cfg):
        super().__init__(engine)
        if draft_cfg.vocab_size != engine.cfg.vocab_size:
            raise ValueError(
                f"draft vocab ({draft_cfg.vocab_size}) must match the "
                f"target vocab ({engine.cfg.vocab_size}) — the rejection "
                "sampler compares p and q over one distribution")
        dev = engine.device
        self.params = draft_params.to(dev)
        self.cfg = draft_cfg
        b = engine.max_batch
        self.cache = init_kv_cache(draft_cfg, b, engine.max_seq_len, dev)
        self.rope_tables = gpt_rope_tables(draft_cfg, engine.max_seq_len,
                                           device=dev)
        self.lens = np.zeros((b,), np.int32)
        self._round_base = np.zeros((b,), np.int32)
        self._round_fed = np.zeros((b,), np.int32)
        self.steps = 0      # draft-model forwards (prefills not counted)

    def on_admit(self, slot, req):
        """Prefill the slot's dense cache with the tokens the target has
        in its pool (the prompt's valid length: all but the pending
        token)."""
        eng = self.engine
        valid = int(eng.lengths[slot])
        tokens = host_to(req.tokens[None, :valid].astype(np.int64),
                         eng.device)
        view = tuple(c[:, slot:slot + 1] for c in self.cache)
        _forward_with_cache(self.params, tokens, view, 0, self.cfg)
        self.lens[slot] = valid

    def on_release(self, slot):
        self.lens[slot] = 0
        self._round_fed[slot] = 0

    def on_verified(self, slot, accepted):
        # The draft KV of the accepted prefix [pending, d1..da] is valid
        # (computed from accepted context); rewind past it — the first
        # rejected draft's row is overwritten by the next catch-up.
        fed = int(self._round_fed[slot])
        if fed:
            self.lens[slot] = int(self._round_base[slot]) + min(
                accepted + 1, fed)
            self._round_fed[slot] = 0

    def on_abort(self, slot):
        # Back to the round's base: the draft rows written past it are
        # masked by the length and overwritten by the retried chain.
        if self._round_fed[slot]:
            self.lens[slot] = self._round_base[slot]
            self._round_fed[slot] = 0

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        eng = self.engine
        self.steps += 1
        logits, _ = _decode_step(
            self.params, tokens, self.cache,
            host_to(self.lens.astype(np.int64), eng.device), self.cfg,
            self.rope_tables)
        return mask_padded_vocab(logits, eng.cfg)

    def propose(self, k_caps):
        eng = self.engine
        b, k, dev = eng.max_batch, eng.spec_k, eng.device
        drafts = np.zeros((b, k), np.int32)
        counts = np.zeros((b,), np.int32)
        self._round_fed[:] = 0
        reqs = [r for r in eng.slots if r is not None and not r.finished
                and int(k_caps[r.slot]) > 0]
        if not reqs:
            return drafts, counts, None
        # 1) Catch-up: feed the accepted tokens the draft has not seen.
        toks = {r.slot: r.tokens for r in reqs}
        while True:
            behind = [s for s, t in toks.items()
                      if self.lens[s] < len(t) - 1]
            if not behind:
                break
            feed = np.zeros((b, 1), np.int64)
            for s in behind:
                feed[s, 0] = toks[s][self.lens[s]]
            self._step(host_to(feed, dev))
            for s in behind:
                self.lens[s] += 1
        # 2) The draft chain: K batched steps on the engine's per-slot
        # sampling rows (greedy rows draft greedily, sampled rows from q
        # on their own streams), fed on the device.
        rows = eng._sampling_rows()
        cur = np.zeros((b,), np.int64)
        for r in reqs:
            cur[r.slot] = toks[r.slot][-1]
            self._round_base[r.slot] = self.lens[r.slot]
        cur = host_to(cur, dev)
        caps = np.asarray(k_caps)
        k_max = int(max(caps[r.slot] for r in reqs))
        cols, q_cols = [], []
        for j in range(k_max):
            act = np.zeros((b,), bool)
            for r in reqs:
                act[r.slot] = caps[r.slot] > j
            logits = self._step(cur[:, None])
            tok, q = _draft_sample(logits, rows, rows["steps"] + j)
            cur = torch.where(host_to(act, dev), tok, cur)
            cols.append(tok)
            q_cols.append(q)
            for r in reqs:
                if act[r.slot]:
                    self.lens[r.slot] += 1
                    self._round_fed[r.slot] += 1
                    counts[r.slot] = j + 1
        out = torch.stack(cols, dim=1).cpu().numpy()
        for r in reqs:
            n = int(counts[r.slot])
            drafts[r.slot, :n] = out[r.slot, :n]
        if q_cols[0] is None:
            return drafts, counts, None
        q_probs = torch.zeros((b, k, q_cols[0].shape[-1]),
                              dtype=q_cols[0].dtype, device=dev)
        q_probs[:, :k_max] = torch.stack(q_cols, dim=1)
        return drafts, counts, q_probs


MTP_UNPORTED = ("spec_method='mtp' requested but the model has no MTP "
                "depth modules (cfg.mtp_num_layers == 0 or params lack "
                "'mtp') — falling back to plain decode")


def make_proposer(method: str, engine, draft_params=None,
                  draft_cfg=None) -> Optional[Proposer]:
    """Build the requested proposer, or None (with a warning) when it is
    unavailable — the engine then decodes plainly (JAX
    speculative.py:509). The port loads no MTP heads (ROADMAP.md Queue 1
    item 3), so "mtp" always falls back."""
    from megatronapp_tpu_torch.utils import metrics as telemetry
    if method == "ngram":
        return NGramProposer(engine)
    if method == "mtp":
        warnings.warn(MTP_UNPORTED, stacklevel=2)
        telemetry.inc("spec_proposer_fallbacks")
        return None
    if method == "draft":
        if draft_params is None or draft_cfg is None:
            warnings.warn(
                "spec_method='draft' requested without draft_params/"
                "draft_cfg — falling back to plain decode", stacklevel=2)
            telemetry.inc("spec_proposer_fallbacks")
            return None
        return DraftModelProposer(engine, draft_params, draft_cfg)
    raise ValueError(f"unknown spec_method {method!r} "
                     "(expected 'draft', 'mtp', or 'ngram')")
