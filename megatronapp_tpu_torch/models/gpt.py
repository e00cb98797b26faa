"""GPT model (the JAX package's models/gpt.py): init, the embedding, the
rope tables, the head, the training forward and loss (with the MTP
heads' auxiliary loss, transformer/mtp.py), and the pipelined loss of a
pp grid's stage (``gpt_pipeline_loss``).

Under a rank grid (``ctx``, training) the params are this tp rank's
shards (parallel/sharding.py): the word embedding is vocab-parallel (a
masked local lookup, then a sum over tp), the output layer is
column-parallel over the vocabulary, tied or untied, and the logits stay
vocab-parallel into the cross entropy (ops/cross_entropy.py); the learned
position embedding and the norms are replicated.

Under context parallelism (ctx.cp > 1) the callers pass whole sequences
and each rank takes its share (parallel/sharding.py ``cp_share``), in
zigzag order when ``zigzag_active`` allows it (JAX gpt.py:181-280,
:318-360): tokens, targets, loss mask and segment ids alike, with the
rope tables and learned positions at the share's global positions; the
logits are the share's, and the cross entropy's token mean runs over
dp × cp. MLA and MTP under cp raise.

A MoE config's layers hold ``moe`` leaves (transformer/moe.py); the aux
loss the layers return joins the loss, and under a grid it is each
rank's share, as the cross entropy's token mean is. MoE with MTP depths,
and MoE under pp or cp, raise (config/parallel_config.py
``moe_unported``)."""

from __future__ import annotations

import torch

from megatronapp_tpu_torch.config.transformer_config import (
    NormKind, PositionEmbeddingKind, TransformerConfig,
)
from typing import Optional

from megatronapp_tpu_torch.config.parallel_config import moe_unported
from megatronapp_tpu_torch.ops import rotary
from megatronapp_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatronapp_tpu_torch.ops.normalization import apply_norm
from megatronapp_tpu_torch.parallel.collectives import (
    copy_to_tp, reduce_from_tp,
)
from megatronapp_tpu_torch.parallel.sharding import (
    MTP_MLA_UNDER_CP, MTP_UNDER_PP, cp_share, fsdp_gather_named, fsdp_view,
    shard_tree, stage_layer_ids,
)
from megatronapp_tpu_torch.scope.hooks import scope_capture
from megatronapp_tpu_torch.transformer.block import (
    block_forward, init_layer_params,
)
from megatronapp_tpu_torch.transformer.moe import check_expert_parallel
from megatronapp_tpu_torch.utils.params import ParamTree, normal


def init_gpt_params(cfg: TransformerConfig, generator: torch.Generator,
                    device, ctx=None) -> ParamTree:
    """Random weights made directly on `device` from `generator` (the
    generator must live on the same device). Leaves as in the JAX
    package: embedding.word [V, H] (+ embedding.pos), layers.i.*,
    final_ln_scale (+ final_ln_bias), output [H, V] when untied, and
    mtp.d.* (the MTP depth modules) when cfg.mtp_num_layers.

    ctx: a training grid; each piece (the embedding, the output layer,
    each layer) is drawn whole, in the one-device order, kept only when
    this rank's pipeline stage holds it (parallel/sharding.py: the
    embedding on stage 0 and, tied, a copy of the word embedding on the
    last stage; the final norm and output layer on the last stage;
    layers.<global id> by the interleaved placement), cut to this tp
    rank's shards and dropped before the next piece is drawn. So any
    pp × dp × tp starts from the weights of one device, and the peak is
    one piece."""
    std, dt = cfg.init_method_std, cfg.params_dtype
    h, v = cfg.hidden_size, cfg.vocab_size
    pp = 1 if ctx is None else ctx.pp
    tied = not cfg.untie_embeddings_and_output_weights
    if pp > 1 and cfg.mtp_num_layers:
        raise NotImplementedError(MTP_UNDER_PP)
    check_moe(cfg, ctx)
    emb = {"word": normal((v, h), std, dt, generator, device)}
    if cfg.position_embedding == PositionEmbeddingKind.learned_absolute:
        emb["pos"] = normal((cfg.max_position_embeddings, h), std, dt,
                            generator, device)
    if pp > 1 and not ctx.is_first_stage:
        emb = {"word": emb["word"]} if tied and ctx.is_last_stage else {}
    emb = shard_tree(ParamTree(emb), ctx) if emb else None
    top = {"final_ln_scale": torch.ones(h, dtype=dt, device=device)}
    if cfg.normalization == NormKind.layernorm:
        top["final_ln_bias"] = torch.zeros(h, dtype=dt, device=device)
    if cfg.untie_embeddings_and_output_weights:
        top["output"] = normal((h, v), std, dt, generator, device)
    if pp > 1 and not ctx.is_last_stage:
        top = {}
    top = dict(shard_tree(ParamTree(top), ctx).named_parameters())
    if pp > 1:
        mine = set(stage_layer_ids(cfg.num_layers, pp, ctx.vpp,
                                   ctx.pp_rank))
        kept = {}
        for i in range(cfg.num_layers):
            layer = init_layer_params(cfg, generator, device, i)
            if i in mine:
                kept[str(i)] = shard_tree(layer, ctx)
            del layer
        layers = ParamTree(**kept)
    else:
        layers = torch.nn.ModuleList(
            shard_tree(init_layer_params(cfg, generator, device, i), ctx)
            for i in range(cfg.num_layers))
    children = ({"layers": layers} if emb is None
                else {"embedding": emb, "layers": layers})
    if cfg.mtp_num_layers:
        from megatronapp_tpu_torch.transformer.mtp import init_mtp_params
        children["mtp"] = shard_tree(
            init_mtp_params(cfg, generator, device), ctx)
    return ParamTree({k: t.detach() for k, t in top.items()}, **children)


def check_moe(cfg: TransformerConfig, ctx=None) -> None:
    """Raise where a MoE config does not run yet: with MTP depths, and on
    a grid the MoE layer does not take (transformer/moe.py
    ``check_expert_parallel``)."""
    if not cfg.is_moe:
        return
    if cfg.mtp_num_layers:
        raise NotImplementedError(moe_unported("MoE with MTP depths"))
    check_expert_parallel(cfg, ctx)


def gpt_embed(p, tokens: torch.Tensor, cfg: TransformerConfig,
              position_ids: Optional[torch.Tensor] = None,
              position_offset: int = 0, ctx=None) -> torch.Tensor:
    """tokens [B, S] at position_ids [B, S] (or [B, 1]; default 0..S-1),
    shifted by position_offset (a dense cache's append position) →
    embeddings [B, S, H] in the compute dtype. ctx (training under tp):
    the vocab-parallel lookup (module docstring); under FSDP the
    embedding's leaves are gathered whole for the lookup."""
    emb = fsdp_view(p["embedding"], ctx)
    if ctx is not None and ctx.tp > 1:
        word = emb["word"]
        local = tokens.long() - ctx.tp_rank * word.shape[0]
        mine = (local >= 0) & (local < word.shape[0])
        h = word[torch.where(mine, local, 0)] * mine[..., None]
        h = reduce_from_tp(h, ctx)
    else:
        h = emb["word"][tokens.long()]
    if "pos" in emb:
        if position_ids is None:
            position_ids = torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :]
        h = h + emb["pos"][position_ids.long() + position_offset]
    return h.to(cfg.compute_dtype)


def rope_params(cfg: TransformerConfig, device=None):
    """(inv_freq, mscale) for the configured rope variant, or (None,
    1.0). MLA ropes only its decoupled qk_pos_emb_head_dim heads (JAX
    models/gpt.py:116)."""
    rope_dim = (cfg.qk_pos_emb_head_dim if cfg.multi_latent_attention
                else cfg.head_dim)
    if cfg.position_embedding == PositionEmbeddingKind.rope:
        return rotary.rope_frequencies(rope_dim, cfg.rotary_base,
                                       cfg.rotary_percent, device), 1.0
    if cfg.position_embedding == PositionEmbeddingKind.yarn:
        inv_freq = rotary.yarn_frequencies(
            rope_dim, cfg.rotary_base,
            scaling_factor=cfg.rope_scaling_factor,
            original_max_position=cfg.yarn_original_max_position,
            beta_fast=cfg.yarn_beta_fast, beta_slow=cfg.yarn_beta_slow,
            rotary_percent=cfg.rotary_percent, device=device)
        return inv_freq, rotary.yarn_mscale(cfg.rope_scaling_factor,
                                            cfg.yarn_mscale_coeff)
    return None, 1.0


def gpt_rope_tables(cfg: TransformerConfig, seq_len: int, device=None,
                    positions: Optional[torch.Tensor] = None):
    """Rope cos/sin tables over positions [0, seq_len), or over explicit
    per-token `positions` ([B, S] for packed sequences → [B, S, half]);
    (None, None) without rope."""
    inv_freq, m = rope_params(cfg, device)
    if inv_freq is None:
        return None, None
    if positions is None:
        positions = torch.arange(seq_len, device=device)
    cos, sin = rotary.rope_cos_sin(positions, inv_freq)
    if m != 1.0:
        cos, sin = cos * m, sin * m
    return cos, sin


def gpt_head(p, h: torch.Tensor, cfg: TransformerConfig,
             ctx=None) -> torch.Tensor:
    """Final norm + vocab projection. h [..., S, H] → logits fp32 (ctx
    under tp: this rank's vocabulary columns; under FSDP the norm and the
    output layer gathered whole)."""
    leaves = {"final_ln_scale": p["final_ln_scale"]}
    if "final_ln_bias" in p:
        leaves["final_ln_bias"] = p["final_ln_bias"]
    if "output" in p:
        leaves["output"] = p["output"]
    else:
        leaves["word"] = p["embedding"]["word"]
    leaves = fsdp_gather_named(leaves, ctx)
    h = apply_norm(cfg.normalization, h, leaves["final_ln_scale"],
                   leaves.get("final_ln_bias"), cfg.layernorm_epsilon)
    h = copy_to_tp(h, ctx)
    out_kernel = leaves["output"] if "output" in leaves \
        else leaves["word"].T
    dt = cfg.compute_dtype
    logits = scope_capture("result", h.to(dt) @ out_kernel.to(dt))
    return logits.float()


def packed_position_ids(segment_ids: torch.Tensor) -> torch.Tensor:
    """Positions restart at 0 at each segment boundary (--reset-position-
    ids). [B, S] → [B, S] int32."""
    b, s = segment_ids.shape
    idx = torch.arange(s, device=segment_ids.device)[None, :].expand(b, s)
    is_start = torch.ones_like(segment_ids, dtype=torch.bool)
    is_start[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return (idx - seg_start).to(torch.int32)


def _cp_index(cfg: TransformerConfig, ctx, seq_len: int, segment_ids,
              attention_mask, device):
    """(this cp rank's share of the sequence, zigzag) under cp > 1, else
    (None, False): the zigzag layout when zigzag_active and no packed
    segments or explicit mask (JAX gpt.py:206-209)."""
    if ctx is None or ctx.cp == 1:
        return None, False
    from megatronapp_tpu_torch.ops.context_parallel import zigzag_active
    if cfg.multi_latent_attention or cfg.mtp_num_layers:
        raise NotImplementedError(MTP_MLA_UNDER_CP)
    zz = (zigzag_active(cfg, ctx) and segment_ids is None
          and attention_mask is None)
    return cp_share(seq_len, ctx, zz, device), zz


def gpt_forward(p, tokens: torch.Tensor, cfg: TransformerConfig,
                attention_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None, ctx=None,
                return_hidden: bool = False, fp8=None):
    """tokens [B, S] → (logits [B, S, V] fp32, moe_aux_loss). segment_ids
    [B, S]: packed sequences — positions restart per segment (for the
    learned embedding and the rope tables) and attention stays within a
    segment. return_hidden: also the main stack's output [B, S, H] (before
    the final norm) and the rope tables (cos, sin), for the MTP heads.
    ctx: the training grid (dp × tp; a serving ctx rides the engine's
    paged steps, inference/dynamic_engine.py): the logits are then this
    tp rank's vocabulary columns. Under cp > 1 tokens (and segment_ids)
    are whole sequences and the logits, hidden states and tables are this
    cp rank's share (module docstring). fp8: the step's fp8 state
    (training/fp8.py Fp8Step) for the layers' rings."""
    positions = None
    if segment_ids is not None:
        positions = packed_position_ids(segment_ids)
    idx, zz = _cp_index(cfg, ctx, tokens.shape[1], segment_ids,
                        attention_mask, tokens.device)
    rope_pos = positions
    if idx is not None:
        tokens = tokens[:, idx]
        if segment_ids is not None:
            segment_ids = segment_ids[:, idx]
            positions = rope_pos = positions[:, idx]
        else:
            positions, rope_pos = idx[None, :], idx
    h = gpt_embed(p, tokens, cfg, position_ids=positions, ctx=ctx)
    cos, sin = gpt_rope_tables(cfg, tokens.shape[1], tokens.device,
                               positions=rope_pos)
    h, aux = block_forward(p["layers"], h, cfg, cos, sin, attention_mask,
                           segment_ids=segment_ids, ctx=ctx, zigzag=zz,
                           fp8=fp8)
    logits = gpt_head(p, h, cfg, ctx)
    if return_hidden:
        return logits, aux, h, (cos, sin)
    return logits, aux


def gpt_loss(p, tokens: torch.Tensor, targets: torch.Tensor,
             loss_mask: Optional[torch.Tensor], cfg: TransformerConfig,
             segment_ids: Optional[torch.Tensor] = None, ctx=None,
             fp8=None):
    """Training loss (CE + MoE aux, + the scaled MTP loss when
    cfg.mtp_num_layers) → (loss, {"lm_loss", "moe_aux_loss"[,
    "mtp_loss"]}); mtp_loss is the unscaled mean over depths (JAX
    gpt.py:239-275). ctx: the training grid; the loss is then this dp (×
    cp) rank's share of the microbatch's token mean (ops/cross_entropy.py),
    from vocab-parallel logits under tp; under cp the targets and mask
    take the share the logits hold. fp8: the step's fp8 state
    (training/fp8.py Fp8Step; MTP depths refuse fp8)."""
    if not cfg.mtp_num_layers:
        logits, aux = gpt_forward(p, tokens, cfg, segment_ids=segment_ids,
                                  ctx=ctx, fp8=fp8)
        idx, _ = _cp_index(cfg, ctx, tokens.shape[1], segment_ids, None,
                           tokens.device)
        if idx is not None:
            targets = targets[:, idx]
            loss_mask = None if loss_mask is None else loss_mask[:, idx]
        loss, _ = cross_entropy_loss(logits, targets, loss_mask, ctx=ctx)
        return loss + aux, {"lm_loss": loss, "moe_aux_loss": aux}
    if segment_ids is not None:
        raise NotImplementedError(
            "multi token prediction + sequence packing is not "
            "supported (reference multi_token_prediction.py assert)")
    check_moe(cfg, ctx)
    if ctx is not None and ctx.cp > 1:
        raise NotImplementedError(MTP_MLA_UNDER_CP)
    if ctx is not None and ctx.tp > 1:
        raise NotImplementedError(
            "MTP depths under tensor parallelism are not ported yet "
            "(ROADMAP.md Queue 1 item 4, MTP under tp); under dp alone they "
            "run")
    from megatronapp_tpu_torch.transformer.mtp import mtp_loss
    logits, aux, hid, (cos, sin) = gpt_forward(p, tokens, cfg, ctx=ctx,
                                               return_hidden=True)
    # ctx here is a dp-only grid (or None): the embedding and the head
    # take it for FSDP's gathers alone.
    scaled, mean, layer_aux = mtp_loss(
        fsdp_view(p["mtp"], ctx), hid,
        lambda t: gpt_embed(p, t, cfg, ctx=ctx),
        lambda hh: gpt_head(p, hh, cfg, ctx), tokens, targets, loss_mask,
        cfg, cos, sin, ctx=ctx)
    aux = aux + layer_aux
    loss, _ = cross_entropy_loss(logits, targets, loss_mask, ctx=ctx)
    return loss + aux + scaled, {"lm_loss": loss, "moe_aux_loss": aux,
                                 "mtp_loss": mean}


def gpt_pipeline_loss(p, batch, cfg: TransformerConfig, ctx, *,
                      schedule: str = "1f1b", order_policy: str = "dfc",
                      grad: bool = True, fbd=None):
    """The pipelined training loss (JAX models/gpt.py gpt_pipeline_loss)
    of this rank's stage over microbatched inputs batch[k] [M, mb, S]
    (tokens, labels, optional loss_mask and segment_ids), run by
    parallel/pipeline.py ``run_pipeline``; grad: the backward too (the
    params' .grad accumulate). Returns (loss, metrics) on every rank:
    the loss on the last stage's ranks, zeros elsewhere.

    Stage 0 embeds all M microbatches (vocab-parallel under tp) and
    injects microbatch m at its chunk 0; every stage runs its chunks'
    layers under their global ids (transformer/block.py layer_ids); the
    last stage applies the final norm, the head and the cross entropy.
    The loss is JAX's token mean over all M microbatches and every dp
    rank's rows (each dp rank its share): the last stage divides each
    microbatch's masked sum by the mask count of the whole step, so
    uneven masks weigh tokens, not microbatches. Packed sequences
    (segment_ids) ride as JAX's aux inputs: every stage computes its own
    microbatch's positions, rope tables and segment masks. fbd: a MegaFBD
    rank's parallel/pipeline.py ``TwinLink`` (its forward ranks pass
    grad=False); a backward rank's head runs a microbatch at a time inside
    the backward program, against the same whole-step mask count. Under
    cp > 1 every stage takes its cp share of each microbatch (JAX
    gpt.py:318-360, :402-416): stage hops carry [mb, S/cp, H], the rope
    tables are the share's, and the mask count runs over dp × cp."""
    from megatronapp_tpu_torch.parallel.pipeline import (
        StageProgram, run_pipeline,
    )
    tokens = batch["tokens"]
    segs = batch.get("segment_ids")
    m_count, mb, s = tokens.shape
    if segs is not None and schedule == "zero-bubble":
        raise NotImplementedError(
            "--pp-schedule zero-bubble does not compose with packed "
            "sequences (per-microbatch aux inputs) yet — run the "
            "1f1b schedule there")
    if cfg.mtp_num_layers:
        raise NotImplementedError(MTP_UNDER_PP)
    if cfg.is_moe:
        raise NotImplementedError(moe_unported(
            "MoE under pipeline parallelism"))
    dev, dt = tokens.device, cfg.compute_dtype
    positions = None if segs is None else packed_position_ids(
        segs.reshape(m_count * mb, s)).reshape(m_count, mb, s)
    idx, zz = _cp_index(cfg, ctx, s, segs, None, dev)
    if idx is not None:
        batch = {k: v[:, :, idx] for k, v in batch.items()}
        tokens, segs = batch["tokens"], batch.get("segment_ids")
        positions = None if positions is None else positions[:, :, idx]
        s = idx.numel()
    if positions is None:
        tables = [gpt_rope_tables(cfg, s, dev, positions=idx)] * m_count
    else:
        tables = [gpt_rope_tables(cfg, s, dev, positions=positions[m])
                  for m in range(m_count)]
    ids = stage_layer_ids(cfg.num_layers, ctx.pp, ctx.vpp, ctx.pp_rank)
    lc = len(ids) // ctx.vpp
    layers = [p["layers"][str(i)] for i in ids]

    def chunk_fn(c, m, x):
        cut = slice(c * lc, (c + 1) * lc)
        cos, sin = tables[m]
        y, _ = block_forward(layers[cut], x, cfg, cos, sin,
                             segment_ids=None if segs is None else segs[m],
                             ctx=ctx, layer_ids=ids[cut], zigzag=zz)
        return y

    h = None
    if ctx.is_first_stage:
        with torch.set_grad_enabled(grad):
            pos_ids = (None if positions is None
                       else positions.reshape(m_count * mb, s))
            if pos_ids is None and idx is not None:
                pos_ids = idx[None, :]
            h = gpt_embed(p, tokens.reshape(m_count * mb, s), cfg,
                          position_ids=pos_ids,
                          ctx=ctx).reshape(m_count, mb, s, -1)

    def embed_backward(d_inputs):
        h.backward(torch.stack([d_inputs[m] for m in range(m_count)]))

    counts = []

    def step_count():
        """The mask count of the whole step, over every dp and cp rank
        (an all-reduce an axis, at the head's first microbatch)."""
        if not counts:
            mask = batch.get("loss_mask")
            count = (torch.tensor(float(tokens.numel()), device=dev)
                     if mask is None else mask.float().sum())
            from megatronapp_tpu_torch.parallel.collectives import (
                all_reduce,
            )
            count = count.clone()
            for axis in ("dp", "cp"):
                count = all_reduce(count, ctx, axis)
            counts.append(count.clamp(min=1.0))
        return counts[0]

    def head_one(m, o):
        mask = batch.get("loss_mask")
        logits = gpt_head(p, o, cfg, ctx)
        loss_m, _ = cross_entropy_loss(
            logits, batch["labels"][m], None if mask is None else mask[m],
            ctx=ctx, count=step_count())
        return loss_m

    def head(outs, want_grad):
        total = torch.zeros((), dtype=torch.float32, device=dev)
        d_outs = {}
        for m in range(m_count):
            o = outs[m].detach().requires_grad_(want_grad)
            with torch.set_grad_enabled(want_grad):
                loss_m = head_one(m, o)
            if want_grad:
                loss_m.backward()
                d_outs[m] = o.grad
            total = total + loss_m.detach()
            del loss_m
        return total, d_outs

    prog = StageProgram(
        chunk_fn=chunk_fn,
        inject=None if h is None else (lambda m: h[m].detach()),
        inject_backward=None if h is None else embed_backward,
        like=torch.empty((mb, s, cfg.hidden_size), dtype=dt, device=dev),
        head=head, head_one=head_one)
    loss = run_pipeline(ctx, prog, m_count, schedule=schedule,
                        order_policy=order_policy, grad=grad,
                        packed=segs is not None, fbd=fbd)
    if loss is None:
        loss = torch.zeros((), dtype=torch.float32, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return loss + aux, {"lm_loss": loss, "moe_aux_loss": aux}
