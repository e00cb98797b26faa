"""Static inference engine: KV-cached autoregressive generation over a
dense preallocated cache (the JAX package's inference/engine.py).

Besides the engine this module holds the pieces the dynamic engine and
the speculative draft model share with it: sampling parameters,
padded-vocab masking and the dense per-slot cache with its forward.

The static engine prefills the prompt batch in one forward and decodes
one token a step through ``_forward_with_cache``, streaming each token
(and its masked logits) to a callback: the MegaScope per-token contract
the server's visualization path rides on. Its attention is dense plain
PyTorch over the cache, as the JAX engine leaves it to XLA (no kernel).
Sampling draws its Gumbel noise from a ``torch.Generator`` seeded with
SamplingParams.seed: greedy streams are the JAX engine's, sampled ones
follow the same law with other draws. MLA's compressed dense cache is not
ported (``DENSE_MLA_UNPORTED``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.utils.device import host_to, resolve_device

# MLA's compressed dense cache and the dense-slot target engine.
DENSE_MLA_UNPORTED = (
    "MLA's dense slot cache is not ported yet (ROADMAP.md Queue 1 item "
    "6): an MLA model serves through the paged pools and cannot be a "
    "draft model")


@dataclasses.dataclass
class SamplingParams:
    """Reference common_inference_params/SamplingParams."""
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 0.0      # 0 = disabled
    greedy: bool = False
    seed: int = 0


def mask_padded_vocab(logits: torch.Tensor, cfg: TransformerConfig
                      ) -> torch.Tensor:
    """Mask logits for vocab rows beyond the tokenizer's true vocab to
    -1e30, so padded ids can never be sampled."""
    true_v = cfg.true_vocab_size
    if true_v is None or true_v >= logits.shape[-1]:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < true_v, logits, torch.full_like(logits, -1e30))


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device=None):
    """Dense per-slot decode cache (JAX engine.py:129): K and V [L, B,
    S_max, Hkv, D] in the compute dtype, zeros."""
    if cfg.multi_latent_attention:
        raise NotImplementedError(DENSE_MLA_UNPORTED)
    shape = (cfg.num_layers, batch, max_len, cfg.num_query_groups,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


@torch.no_grad()
def _forward_with_cache(p, tokens: torch.Tensor, cache, cache_index: int,
                        cfg: TransformerConfig):
    """tokens [B, S] starting at position cache_index → (logits [B, S, V]
    fp32, cache) (JAX engine.py:147): every layer appends its K/V at
    [cache_index, cache_index + S) of its cache slice IN PLACE and
    attends causally over the cache."""
    from megatronapp_tpu_torch.models.gpt import (
        gpt_embed, gpt_head, gpt_rope_tables,
    )
    from megatronapp_tpu_torch.transformer.block import layer_forward
    s = tokens.shape[1]
    h = gpt_embed(p, tokens, cfg, position_offset=cache_index)
    cos, sin = gpt_rope_tables(cfg, s, device=tokens.device,
                               positions=cache_index + torch.arange(
                                   s, device=tokens.device))
    ck, cv = cache
    for lid, layer_p in enumerate(p["layers"]):
        (h, _), _ = layer_forward(layer_p, h, cfg, cos, sin,
                                  kv_cache=(ck[lid], cv[lid]),
                                  cache_index=cache_index, layer_id=lid)
    return gpt_head(p, h, cfg), cache


def _warp_logits(logits, temps, top_ks, top_ps):
    """Per-row temperature → top-k → top-p filtering ([N, V] → [N, V],
    filtered entries at -1e30), the JAX engine's _warp_logits."""
    v = logits.shape[-1]
    x = logits / temps[:, None].clamp(min=1e-6)
    sorted_desc = x.sort(dim=-1, descending=True).values
    k_idx = (top_ks - 1).clamp(0, v - 1).long()
    kth = sorted_desc.gather(-1, k_idx[:, None])
    x = torch.where((top_ks[:, None] > 0) & (x < kth),
                    torch.full_like(x, -1e30), x)
    sorted2 = x.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted2, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_ps[:, None]).sum(dim=-1).clamp(max=v - 1)
    cutoff = sorted2.gather(-1, cutoff_idx[:, None])
    return torch.where((top_ps[:, None] > 0.0) & (x < cutoff),
                       torch.full_like(x, -1e30), x)


def sample_logits(logits: torch.Tensor, gen: torch.Generator,
                  params: SamplingParams) -> torch.Tensor:
    """logits [B, V] → token ids [B] (JAX engine.py:103): argmax when
    greedy, else ``_warp_logits`` with the parameters on every row and a
    categorical draw as the argmax of the filtered logits plus Gumbel
    noise from the one generator `gen`."""
    if params.greedy:
        return logits.argmax(dim=-1)
    b, dev = logits.shape[0], logits.device
    x = _warp_logits(
        logits.float(),
        torch.full((b,), params.temperature, dtype=torch.float32,
                   device=dev),
        torch.full((b,), params.top_k, dtype=torch.int64, device=dev),
        torch.full((b,), params.top_p, dtype=torch.float32, device=dev))
    u = torch.rand(x.shape, generator=gen, device=dev, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return (x + gumbel).argmax(dim=-1)


def _decode_loop(cfg, prompt_tokens, raw_logits_last, step_fn,
                 max_new_tokens, sampling, eod_id, token_callback):
    """The autoregressive sampling loop (JAX engine.py:43): sampling,
    padded-vocab masking, eod early stop, the per-token callback
    ``token_callback(step, tokens [B] int32, logits [B, V] fp32)`` (host
    arrays). step_fn(next_tok [B]) → raw logits [B, V] of the next
    position. Returns [B, S_prompt + new] int32 on the host."""
    sampling = sampling or SamplingParams()
    b = prompt_tokens.shape[0]
    gen = torch.Generator(device=raw_logits_last.device)
    gen.manual_seed(sampling.seed)
    logits_last = mask_padded_vocab(raw_logits_last, cfg)
    out = [prompt_tokens.cpu().numpy().astype(np.int32)]
    finished = np.zeros((b,), bool)
    for step in range(max_new_tokens):
        next_tok = sample_logits(logits_last, gen, sampling)
        tok_host = next_tok.cpu().numpy().astype(np.int32)
        if token_callback is not None:
            token_callback(step, tok_host, logits_last.cpu().numpy())
        if eod_id is not None:
            finished |= tok_host == eod_id
        out.append(tok_host[:, None])
        if eod_id is not None and finished.all():
            break
        if step == max_new_tokens - 1:
            break
        logits_last = mask_padded_vocab(step_fn(next_tok), cfg)
    return np.concatenate(out, axis=1)


def _generate_text(engine, prompts, max_new_tokens, sampling,
                   token_callback):
    """The string-level API (JAX engine.py:73): each prompt runs as its
    own batch (no padding leaks into causal attention)."""
    if engine.tokenizer is None:
        raise ValueError("generate_text needs an engine tokenizer")
    eod = getattr(engine.tokenizer, "eod", None)
    texts = []
    for prompt in prompts:
        ids = np.asarray([engine.tokenizer.tokenize(prompt)], np.int32)
        out = engine.generate(ids, max_new_tokens, sampling, eod_id=eod,
                              token_callback=token_callback)
        new_ids = out[0, ids.shape[1]:].tolist()
        if eod is not None and eod in new_ids:
            new_ids = new_ids[: new_ids.index(eod)]
        texts.append(engine.tokenizer.detokenize(new_ids))
    return texts


class StaticInferenceEngine:
    """generate() over a fixed-shape batch with a preallocated dense
    cache (JAX engine.py:180).

    params: the model's params, moved to `device` (None: the card; a host
    without one raises — pass device="cpu" for the plain CPU run).
    max_seq_len: the cache length of every generate() call (default
    cfg.max_position_embeddings; a cache row holds 2·L·S·Hkv·D values in
    the compute dtype, so size it to prompt plus new tokens)."""

    def __init__(self, params, cfg: TransformerConfig, tokenizer=None,
                 max_seq_len: Optional[int] = None, device=None):
        if cfg.multi_latent_attention:
            raise NotImplementedError(DENSE_MLA_UNPORTED)
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len or cfg.max_position_embeddings

    def _forward(self, tokens, cache, cache_index: int):
        return _forward_with_cache(self.params, tokens, cache, cache_index,
                                   self.cfg)

    def generate(self, prompt_tokens: np.ndarray, max_new_tokens: int,
                 sampling: Optional[SamplingParams] = None,
                 eod_id: Optional[int] = None,
                 token_callback: Optional[Callable] = None) -> np.ndarray:
        """prompt_tokens [B, S_prompt] int32 → [B, S_prompt + max_new]
        (shorter when every row hit eod_id)."""
        prompt = host_to(np.asarray(prompt_tokens, np.int32), self.device,
                         torch.long)
        b, s_prompt = prompt.shape
        total = s_prompt + max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(f"prompt+new ({total}) exceeds max_seq_len "
                             f"({self.max_seq_len})")
        cache = init_kv_cache(self.cfg, b, self.max_seq_len, self.device)
        logits, cache = self._forward(prompt, cache, 0)
        state = {"cache": cache, "pos": s_prompt}

        def step_fn(next_tok):
            logits, state["cache"] = self._forward(
                next_tok[:, None], state["cache"], state["pos"])
            state["pos"] += 1
            return logits[:, -1]

        return _decode_loop(self.cfg, prompt, logits[:, -1], step_fn,
                            max_new_tokens, sampling, eod_id,
                            token_callback)

    def generate_text(self, prompts, max_new_tokens: int,
                      sampling: Optional[SamplingParams] = None,
                      token_callback: Optional[Callable] = None):
        return _generate_text(self, prompts, max_new_tokens, sampling,
                              token_callback)


def beam_search(engine: StaticInferenceEngine, prompt_tokens: np.ndarray,
                max_new_tokens: int, beam_width: int = 4,
                length_penalty: float = 1.0,
                eod_id: Optional[int] = None) -> np.ndarray:
    """Beam search decode of a single prompt [1, S] (JAX engine.py:325):
    the beams' scores are float64 sums of fp32 log-probabilities, ranked
    on the host as the JAX function ranks them. Returns [1, S + new]."""
    cfg, dev = engine.cfg, engine.device
    prompt = np.asarray(prompt_tokens, np.int32)
    if prompt.shape[0] != 1:
        raise ValueError("beam search takes a single prompt")
    s_prompt = prompt.shape[1]
    beams = np.tile(prompt, (beam_width, 1))
    cache = init_kv_cache(cfg, beam_width, engine.max_seq_len, dev)
    logits, cache = engine._forward(host_to(beams, dev, torch.long), cache,
                                    0)
    logp = torch.log_softmax(mask_padded_vocab(logits[:, -1], cfg).float(),
                             dim=-1)
    # First step: the top beam_width continuations of the single prompt.
    top_logp, top_idx = torch.topk(logp[0], beam_width)
    scores = top_logp.cpu().numpy().astype(np.float64)
    beams = np.concatenate([beams, top_idx.cpu().numpy().astype(
        np.int32)[:, None]], axis=1)
    finished = np.zeros((beam_width,), bool)
    pos = s_prompt
    for _ in range(max_new_tokens - 1):
        if eod_id is not None and finished.all():
            break
        tok = host_to(beams[:, -1:], dev, torch.long)
        logits, cache = engine._forward(tok, cache, pos)
        pos += 1
        logp = torch.log_softmax(
            mask_padded_vocab(logits[:, -1], cfg).float(),
            dim=-1).cpu().numpy()
        vocab = logp.shape[-1]
        cand = scores[:, None] + np.where(finished[:, None], -1e9, logp)
        if eod_id is not None:
            # Finished beams keep their score on a dummy continuation.
            cand[finished, 0] = scores[finished]
        flat = cand.ravel()
        best = np.argsort(flat)[::-1][:beam_width]
        parents, toks = best // vocab, best % vocab
        scores = flat[best]
        beams = np.concatenate([beams[parents], toks[:, None]], axis=1)
        finished = finished[parents] | (
            (toks == eod_id) if eod_id is not None else False)
        # Reorder the cache rows to follow the surviving beams.
        idx = host_to(parents, dev, torch.long)
        cache = tuple(c[:, idx] for c in cache)
    lengths = (beams.shape[1] - s_prompt) * np.ones(beam_width)
    final = scores / (lengths ** length_penalty)
    return beams[int(np.argmax(final))][None]
