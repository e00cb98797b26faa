"""Mixture-of-Experts layer (the JAX package's transformer/moe.py): the
top-k router with its load-balancing and z losses, the dropless and the
capacity dispatch, the shared expert, and the expert-parallel all-to-all
dispatch of a dp × ep × tp training grid.

The JAX package runs no Pallas kernel here: its grouped GEMM is XLA's
``lax.ragged_dot`` and its dispatch and combine are einsums and
collectives. So this module is plain PyTorch, function for function:

- ``_router``: an fp32 softmax over the experts, top-k, the k
  probabilities renormalised; the Switch load-balancing loss coeff · e ·
  Σ frac · mean_prob (frac divided by k) and the z-loss on
  logsumexp(logits)², each from statistics that ``stats_mean`` may
  average over the ranks that split the tokens before they combine.
  ``torch.topk`` does not promise JAX's lower-index-first order on exact
  ties of two probabilities; the tests' inputs have none.
- ``_dropless_experts`` (``moe_capacity_factor`` None, the default): the
  T·k copies sorted by expert with a stable sort (as ``jnp.argsort``),
  one matmul pair per expert on its contiguous rows (the group sizes read
  to the host once a layer; an expert without rows runs none), and the
  combine as the inverse permutation, ``y[inv].view(t, k, h)`` summed
  over k in fp32 with the probabilities as weights: JAX's scatter-add
  without atomics, so reruns on the card repeat bit for bit.
- ``_capacity_experts``: GShard's capacity F·T·k/e; a copy whose arrival
  position (``_position_in_expert``) reaches it is dropped, the kept ones
  fill an [e, C, h] buffer that ``_expert_ffn`` runs as one batched
  product, and the combine sums each token's kept copies.
- ``_with_shared``: the always-on shared expert.

Expert stacks (``fc1_kernel`` [e, h, fc1_out], ``fc2_kernel`` [e, f, h])
go through ``resolve_param`` at matmul entry, so resident int8 stacks
(inference/quantization.py, per channel on the last axis) dequantize
there: an expert at a time on the dropless path.

Training grids (``ctx``, parallel/mesh.py; one process a rank). JAX's
GSPMD router sees the whole batch; here each rank routes its own rows,
and three things keep JAX's numbers:

- the router statistics (frac, mean_prob, the z² mean) are all-reduced
  (mean) over the ranks that split the tokens — the "batch" group of dp ×
  ep; tp ranks hold the same tokens and are not a token axis — before
  they combine (JAX's ``stats_mean``). Each rank's loss carries aux / n
  of the n token shares, as its cross entropy carries its share of the
  token mean (ops/cross_entropy.py), so the ranks' losses and their
  summed grads are JAX's; the mean's backward is the identity, the
  transpose of a mean whose cotangents are the same on every rank;
- at dp > 1 without ep, the capacity is computed from the global T, and
  each copy's arrival position is global: offset by the exclusive prefix,
  over lower dp ranks, of the per-expert counts (one all-gather of an [e]
  count vector). dp ranks hold contiguous blocks of the batch
  (training/train.py ``dp_rows``), so this is JAX's order;
- at ep > 1, ``_a2a_expert_forward``: JAX's full-manual region, each
  rank routing its t_loc tokens and packing static [ep, e_loc, cap, h]
  send buffers (cap = t_loc when dropless, which provably drops nothing,
  else JAX's per-shard F·t_loc·k/e, positions per shard), exchanged with
  the experts' home ranks either by one all-to-all each way
  (``moe_comm_overlap`` False) or by ``_chunked_a2a_ffn``: ep − 1 ring
  hops out and ep − 1 back, each issued before the FFN on the chunk that
  came before (hop s delivers from rank me − s; the return hop goes to me
  − s), under MegaScan's 'moe-a2a-permute' / 'moe-a2a-compute' spans.
  Every rank issues the same hops in the same order, and its backward
  graph is the same (parallel/collectives.py's hops and all-to-all are
  autograd Functions with JAX's transposes). The router statistics mean
  runs over dp × ep.

Tensor parallelism: the MoE leaves take JAX's layout (the 'mlp'
dimension over tp: each expert's fc1 column-parallel, its gate and value
halves split separately, and fc2 row-parallel; the shared expert's
likewise; the router replicated), and the experts run as Megatron's
expert tensor parallelism: every tp rank routes the same tokens the same
way (the router is replicated and its input is the same on every tp
rank), runs its columns of every expert on the dispatched rows, and the
per-copy outputs are summed over tp (``reduce_from_tp``) before the
combine, so the router's weights see whole outputs and their gradients
stay whole; the dispatched rows enter through ``copy_to_tp`` (their
grads summed over tp). JAX's region computes the experts replicated over
tp instead: the same function, the fp32 order of the tp sum aside. At ep
× tp, rank (x, t) exchanges with the ep ranks of its own tp index.
The stacks split over ep by the 'experts' rule (parallel/sharding.py):
rank x of ep holds experts [x·e/ep, (x+1)·e/ep).

MoE under pp > 1, cp > 1, MegaFBD, MegaDPP, MTP depths and tensor-
parallel serving raise (config/parallel_config.py ``moe_unported``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from megatronapp_tpu_torch.config.parallel_config import moe_unported
from megatronapp_tpu_torch.config.transformer_config import TransformerConfig
from megatronapp_tpu_torch.inference.quantization import (
    is_resident_leaf, resolve_param,
)
from megatronapp_tpu_torch.ops.activations import apply_activation, is_gated
from megatronapp_tpu_torch.parallel.collectives import (
    EpHop, all_gather_cat, all_reduce, copy_to_tp, ep_all_to_all,
    reduce_from_tp,
)
from megatronapp_tpu_torch.trace.tracer import get_tracer
from megatronapp_tpu_torch.utils.params import ParamTree, normal

MOE_PERMUTE_EVENT = "moe-a2a-permute"
MOE_COMPUTE_EVENT = "moe-a2a-compute"


def init_moe_params(cfg: TransformerConfig, generator: torch.Generator,
                    device, out_std: float) -> ParamTree:
    """The router (fp32 [h, e], as JAX keeps it), the expert stacks
    fc1_kernel [e, h, fc1_out] (fc1_out = 2f when gated) and fc2_kernel
    [e, f, h], and with moe_shared_expert_intermediate_size the shared
    expert's shared_fc1 / shared_fc2."""
    h, f = cfg.hidden_size, cfg.moe_ffn_hidden_size
    e = cfg.num_moe_experts
    std, dt = cfg.init_method_std, cfg.params_dtype
    fc1_out = 2 * f if is_gated(cfg.activation) else f
    p = {"router_kernel": normal((h, e), std, torch.float32, generator,
                                 device),
         "fc1_kernel": normal((e, h, fc1_out), std, dt, generator, device),
         "fc2_kernel": normal((e, f, h), out_std, dt, generator, device)}
    if cfg.moe_shared_expert_intermediate_size:
        fs = cfg.moe_shared_expert_intermediate_size
        shared_out = 2 * fs if is_gated(cfg.activation) else fs
        p["shared_fc1"] = normal((h, shared_out), std, dt, generator,
                                 device)
        p["shared_fc2"] = normal((fs, h), out_std, dt, generator, device)
    return ParamTree(p)


def _router(p, x_flat: torch.Tensor, cfg: TransformerConfig,
            stats_mean=None) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """x_flat [T, H] → (topk_idx [T, k] int64, topk_probs [T, k] fp32,
    aux scalar). stats_mean: a reducer of the per-expert statistics (one
    1-D tensor: frac, mean_prob and the z² mean, as the losses need them)
    applied before they combine."""
    e, k = cfg.num_moe_experts, cfg.moe_router_topk
    logits = x_flat.float() @ p["router_kernel"].float()
    probs = torch.softmax(logits, dim=-1)
    topk_probs, topk_idx = torch.topk(probs, k, dim=-1)
    topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True).clamp_min(
        1e-9)
    stats = []
    if cfg.moe_aux_loss_coeff:
        counts = torch.bincount(topk_idx.reshape(-1), minlength=e)
        stats += [counts.float() / x_flat.shape[0] / k, probs.mean(0)]
    z = None
    if cfg.moe_z_loss_coeff:
        z = torch.logsumexp(logits, dim=-1).square().mean()
        stats.append(z[None])
    aux = torch.zeros((), dtype=torch.float32, device=x_flat.device)
    if not stats:
        return topk_idx, topk_probs, aux
    flat = torch.cat(stats)
    if stats_mean is not None:
        flat = stats_mean(flat)
    if cfg.moe_aux_loss_coeff:
        frac, mean_prob = flat[:e], flat[e:2 * e]
        aux = aux + cfg.moe_aux_loss_coeff * e * torch.sum(frac * mean_prob)
    if cfg.moe_z_loss_coeff:
        aux = aux + cfg.moe_z_loss_coeff * flat[-1]
    return topk_idx, topk_probs, aux


def _apply_act(cfg: TransformerConfig, y: torch.Tensor) -> torch.Tensor:
    """The configured activation; gated kinds split fc1's 2F columns into
    [gate | value]."""
    if is_gated(cfg.activation):
        gate, val = y.chunk(2, dim=-1)
        return apply_activation(cfg.activation, val, gate)
    return apply_activation(cfg.activation, y)


def _expert_weight(stack, i: int, dt: torch.dtype) -> torch.Tensor:
    """Expert i's kernel of a stack at matmul entry (a resident int8
    stack's slice dequantized, as resolve_param does the whole stack)."""
    if is_resident_leaf(stack):
        stack = {"qint8": stack["qint8"][i], "qscale": stack["qscale"][i]}
        return resolve_param(stack, dt)
    return stack[i].to(dt)


def _expert_ffn(p, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Batched expert MLP: x [E, C, H] → [E, C, H] (JAX's two einsums)."""
    dt = cfg.compute_dtype
    y = torch.matmul(x.to(dt), resolve_param(p["fc1_kernel"], dt))
    return torch.matmul(_apply_act(cfg, y), resolve_param(p["fc2_kernel"],
                                                          dt))


def _dropless_experts(p, x_flat: torch.Tensor, topk_idx: torch.Tensor,
                      topk_probs: torch.Tensor, cfg: TransformerConfig,
                      ctx=None) -> torch.Tensor:
    """Every copy through its expert (module docstring) → [T, H] fp32.
    ctx: a training grid, whose tp rank holds its columns of the experts
    (the copies' outputs summed over tp)."""
    t, h = x_flat.shape
    k, e, dt = cfg.moe_router_topk, cfg.num_moe_experts, cfg.compute_dtype
    flat = topk_idx.reshape(t * k)
    order = torch.argsort(flat, stable=True)
    # The layer's one host read: each expert's contiguous group of rows.
    sizes = torch.bincount(flat, minlength=e).tolist()
    x_sorted = x_flat.to(dt)[order // k]
    outs, a = [], 0
    for i, n in enumerate(sizes):
        if n:
            y = x_sorted[a:a + n] @ _expert_weight(p["fc1_kernel"], i, dt)
            outs.append(_apply_act(cfg, y)
                        @ _expert_weight(p["fc2_kernel"], i, dt))
        a += n
    y_sorted = reduce_from_tp(torch.cat(outs), ctx)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    y = y_sorted[inv].float().view(t, k, h)
    return (y * topk_probs.float()[..., None]).sum(dim=1)


def _position_in_expert(flat_expert: torch.Tensor, e: int) -> torch.Tensor:
    """Arrival-order slot of each (token, choice) copy within its
    expert's buffer (GShard position accounting). [T·k] → [T·k] int64."""
    onehot = torch.nn.functional.one_hot(flat_expert, e)
    before = torch.cumsum(onehot, dim=0) - onehot
    return (before * onehot).sum(dim=1)


def _capacity_experts(p, x_flat: torch.Tensor, topk_idx: torch.Tensor,
                      topk_probs: torch.Tensor, cfg: TransformerConfig,
                      offsets: Optional[torch.Tensor] = None,
                      global_tokens: Optional[int] = None,
                      ctx=None) -> torch.Tensor:
    """GShard capacity dispatch → [T, H] fp32: copies at or beyond
    max(int(F·T·k/e), 1) of their expert are dropped. offsets [e] and
    global_tokens: under dp, the copies' position offsets (the lower dp
    ranks' counts) and the global T (module docstring); a kept copy takes
    its local arrival slot, which its global position bounds. ctx: as
    ``_dropless_experts``'."""
    t, h = x_flat.shape
    e, k, dt = cfg.num_moe_experts, cfg.moe_router_topk, cfg.compute_dtype
    tokens = t if global_tokens is None else global_tokens
    capacity = max(int(cfg.moe_capacity_factor * tokens * k / e), 1)
    flat = topk_idx.reshape(t * k)
    local = _position_in_expert(flat, e)
    pos = local if offsets is None else local + offsets[flat]
    keep = pos < capacity
    kept = keep.nonzero().squeeze(1)
    buf = torch.zeros((e, capacity, h), dtype=dt, device=x_flat.device)
    buf = buf.index_put((flat[kept], local[kept]),
                        x_flat.to(dt)[kept // k])
    y = _expert_ffn(p, buf, cfg)
    w = topk_probs.reshape(t * k).float() * keep
    rows = reduce_from_tp(y[flat, local.clamp(max=capacity - 1)], ctx)
    contrib = rows.float() * w[:, None]
    return contrib.view(t, k, h).sum(dim=1)


def _with_shared(p, x_flat: torch.Tensor, out: torch.Tensor,
                 cfg: TransformerConfig, ctx=None) -> torch.Tensor:
    """Add the always-on shared expert (reference shared_experts.py);
    ctx: a training grid, whose tp rank holds its columns (x_flat entered
    through copy_to_tp)."""
    if "shared_fc1" not in p:
        return out
    dt = cfg.compute_dtype
    y = _apply_act(cfg, x_flat.to(dt) @ p["shared_fc1"].to(dt))
    return out + reduce_from_tp(y @ p["shared_fc2"].to(dt), ctx).float()


class _StatsMean(torch.autograd.Function):
    """The router statistics' mean over the "batch" group (dp × ep); its
    backward is the identity (module docstring)."""

    @staticmethod
    def forward(fctx, stats, ctx):
        total = all_reduce(stats.detach().clone(), ctx, "batch")
        return total / ctx.batch

    @staticmethod
    def backward(fctx, g):
        return g, None


def _stats_mean(ctx):
    """The router's stats_mean on a training grid (None without token
    shares to average)."""
    if ctx is None or ctx.batch == 1:
        return None
    return lambda s: _StatsMean.apply(s, ctx)


def check_expert_parallel(cfg: TransformerConfig, ctx) -> None:
    """Raise where the port's MoE layer does not run on the grid `ctx`:
    the layouts JAX sends to its GSPMD fallback (experts that do not split
    over ep) and the compositions not ported yet."""
    if ctx is None:
        return
    if ctx.pp > 1:
        raise NotImplementedError(moe_unported(
            "MoE under pipeline parallelism"))
    if ctx.cp > 1:
        raise NotImplementedError(moe_unported(
            "MoE under context parallelism"))
    if ctx.ep > 1 and cfg.num_moe_experts % ctx.ep:
        raise ValueError(
            f"expert parallelism needs num_moe_experts % ep == 0 (got "
            f"num_moe_experts={cfg.num_moe_experts}, ep={ctx.ep}); JAX runs "
            "such a layout on its GSPMD fallback, which the port does not "
            "have")


def moe_forward(p, x: torch.Tensor, cfg: TransformerConfig, layer_id=None,
                ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, H] → ([B, S, H] in x's dtype, aux scalar fp32). ctx: a
    training grid (module docstring); the aux is then this rank's share,
    aux / (dp · ep). At ep > 1 the all-to-all dispatch runs. layer_id:
    accepted for the layer's signature; the MoE layer has no MegaScope
    site (JAX's mlp1 / mlp2 captures live in the dense MLP only)."""
    b, s, h = x.shape
    check_expert_parallel(cfg, ctx)
    x_flat = x.reshape(b * s, h)
    # The experts' input: its grads from each tp rank's columns summed
    # over tp (the router's are whole on every rank).
    x_e = copy_to_tp(x_flat, ctx)
    if ctx is not None and ctx.ep > 1:
        out, aux = _a2a_expert_forward(p, x_flat, x_e, cfg, ctx)
    else:
        topk_idx, topk_probs, aux = _router(p, x_flat, cfg,
                                            stats_mean=_stats_mean(ctx))
        if cfg.moe_capacity_factor is None:
            out = _dropless_experts(p, x_e, topk_idx, topk_probs, cfg, ctx)
        else:
            offsets = tokens = None
            if ctx is not None and ctx.batch > 1:
                offsets, tokens = _global_positions(topk_idx, cfg, ctx)
            out = _capacity_experts(p, x_e, topk_idx, topk_probs, cfg,
                                    offsets, tokens, ctx)
    if ctx is not None and ctx.batch > 1:
        aux = aux / ctx.batch
    return _with_shared(p, x_e, out, cfg, ctx).reshape(b, s, h).to(
        x.dtype), aux


def _global_positions(topk_idx: torch.Tensor, cfg: TransformerConfig, ctx):
    """(offsets [e], global T) of this rank's copies at dp > 1: the
    per-expert counts of the lower batch ranks, summed (one all-gather of
    every rank's [e] counts), and T times the token shares."""
    counts = torch.bincount(topk_idx.reshape(-1),
                            minlength=cfg.num_moe_experts)
    every = all_gather_cat(counts[None], ctx, "batch", 0)
    offsets = every[:ctx.batch_rank].sum(dim=0)
    return offsets, topk_idx.shape[0] * ctx.batch


def _chunked_a2a_ffn(send: torch.Tensor, fc1, fc2, cfg: TransformerConfig,
                     ctx) -> torch.Tensor:
    """The decomposed all-to-all → expert FFN → all-to-all (JAX's
    ``_chunked_a2a_ffn``). send [ep, e_loc, cap, h]: send[j] = this
    rank's buffer bound for the experts of ep rank j. Hop s delivers the
    chunk from rank me − s (what rank i sends is send[(i + s) % ep]); it
    is issued before the FFN on the chunk that came before and waited
    after it; the FFN's result goes back to rank me − s by a return hop,
    and what arrives is this rank's chunk's result from rank me + s.
    Returns y [ep, e_loc, cap, h], y[j] = the outputs of this rank's
    copies dispatched to rank j."""
    ep, me = ctx.ep, ctx.ep_rank
    params = {"fc1_kernel": fc1, "fc2_kernel": fc2}
    tracer = get_tracer()

    def chunk_for_shift(s):
        return send[(me + s) % ep]

    def span(name, ph, step, op="fwd"):
        tracer.phase_event(name, ph, op=op, rank=me, step=int(step))

    ys = [None] * ep
    nxt = None
    if ep > 1:
        span(MOE_PERMUTE_EVENT, "B", 0)
        nxt = EpHop(ctx, chunk_for_shift(1), 1, "out",
                    on_wait=lambda: span(MOE_PERMUTE_EVENT, "E", 0))
    span(MOE_COMPUTE_EVENT, "B", 0)
    ys[me] = _expert_ffn(params, chunk_for_shift(0), cfg)
    span(MOE_COMPUTE_EVENT, "E", 0)
    returns = []
    for s in range(1, ep):
        arrived = nxt.result()
        nxt = None
        if s + 1 < ep:
            span(MOE_PERMUTE_EVENT, "B", s)
            nxt = EpHop(ctx, chunk_for_shift(s + 1), s + 1, "out",
                        on_wait=lambda s=s: span(MOE_PERMUTE_EVENT, "E", s))
        span(MOE_COMPUTE_EVENT, "B", s)
        out_s = _expert_ffn(params, arrived, cfg)
        span(MOE_COMPUTE_EVENT, "E", s)
        span(MOE_PERMUTE_EVENT, "B", s, op="ret")
        returns.append(((me + s) % ep, EpHop(
            ctx, out_s, -s, "ret",
            on_wait=lambda s=s: span(MOE_PERMUTE_EVENT, "E", s, op="ret"))))
    for j, hop in returns:
        ys[j] = hop.result()
    return torch.stack(ys)


def _a2a_expert_forward(p, x_flat: torch.Tensor, x_e: torch.Tensor,
                        cfg: TransformerConfig, ctx
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch (JAX's ``_a2a_expert_forward``, one
    rank's share of its region): x_flat [t_loc, H] (the router's input;
    x_e the experts', through copy_to_tp) → ([t_loc, H] fp32 before the
    shared expert, aux)."""
    e, k, ep = cfg.num_moe_experts, cfg.moe_router_topk, ctx.ep
    e_loc, dt = e // ep, cfg.compute_dtype
    t_loc, h = x_flat.shape
    topk_idx, topk_probs, aux = _router(p, x_flat, cfg,
                                        stats_mean=_stats_mean(ctx))
    if cfg.moe_capacity_factor is not None:
        cap = max(int(cfg.moe_capacity_factor * t_loc * k / e), 1)
    else:
        # An expert receives at most one copy a token: t_loc drops none.
        cap = t_loc
    flat = topk_idx.reshape(t_loc * k)
    pos = _position_in_expert(flat, e)
    valid = pos < cap
    kept = valid.nonzero().squeeze(1)
    send = torch.zeros((e, cap, h), dtype=dt, device=x_flat.device)
    send = send.index_put((flat[kept], pos[kept]), x_e.to(dt)[kept // k])
    # Rank x of ep holds experts [x·e_loc, (x+1)·e_loc): send[j] goes there.
    send = send.view(ep, e_loc, cap, h)
    fc1, fc2 = p["fc1_kernel"], p["fc2_kernel"]
    if cfg.moe_comm_overlap:
        y = _chunked_a2a_ffn(send, fc1, fc2, cfg, ctx)
    else:
        recv = ep_all_to_all(send, ctx)                  # [ep_src, ...]
        xin = recv.transpose(0, 1).reshape(e_loc, ep * cap, h)
        y = _expert_ffn({"fc1_kernel": fc1, "fc2_kernel": fc2}, xin, cfg)
        y = y.view(e_loc, ep, cap, h).transpose(0, 1).contiguous()
        y = ep_all_to_all(y, ctx)                        # back home
    y = y.reshape(e, cap, h)
    w = topk_probs.reshape(t_loc * k).float() * valid
    rows = reduce_from_tp(y[flat, pos.clamp(max=cap - 1)], ctx)
    contrib = rows.float() * w[:, None]
    return contrib.view(t_loc, k, h).sum(dim=1), aux
