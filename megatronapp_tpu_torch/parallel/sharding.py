"""Logical-axis sharding rules and the tensor-parallel shards of the
params.

The port's own copy of the JAX package's rule table
(megatronapp_tpu/parallel/sharding.py ``DEFAULT_RULES``,
``logical_to_spec``) and of the logical axes its init functions give each
leaf. A leaf's tp-split dimension is the one whose logical axis maps to
"tp": vocab (the vocab-parallel embedding and output layer), qkv (the
column-parallel q and kv projections, row-parallel out-projection) and
mlp (column-parallel fc1, row-parallel fc2). Every other leaf is
replicated over tp.

JAX's GSPMD splits a leaf contiguously along that dimension and moves
data as the computation needs; the port's explicit tensor parallelism
runs each rank's projections on its own heads and columns, so a fused
leaf is split segment by segment: ``kv_kernel`` / ``kv_bias`` are [K | V]
(two segments, each split by kv heads) and a gated ``fc1_kernel`` /
``fc1_bias`` is [gate | value]. Rank r's shard of a leaf of s segments is
the concatenation of its share of each segment; ``gather_tree`` puts the
segments back in JAX's order bit for bit. q heads split contiguously, so
rank r's q heads keep their kv group (q head i → kv head i·nkv/nq).

Pipeline placement (JAX parallel/pipeline.py
``reshape_params_for_pipeline``): chunk c of stage s holds the global
layers [(c·pp + s)·Lc, (c·pp + s + 1)·Lc), Lc = L / (pp·vpp)
(``stage_layer_ids``). Stage 0 holds the embedding, the last stage the
final norm and the output layer; with tied embeddings the last stage
also holds a copy of the word embedding (JAX keeps the embedding
replicated over pp; training/distributed_optimizer.py sums the two
copies' grads). A stage's layers sit under ``layers.<global id>`` (a
ParamTree keyed by the ids), so every leaf keeps its one-device path.

Mixture of Experts (transformer/moe.py): the MoE leaves' logical axes
are JAX's (``MOE_LOGICAL_AXES``: the router ("embed", None), the expert
stacks ("experts", "embed", "mlp") / ("experts", "mlp", "embed"), the
shared expert's ("embed", "mlp") / ("mlp", "embed")). The expert stacks
split over ep along the experts dimension by the rule ("experts", "ep")
(``ep_dim``): ep rank x holds experts [x·e/ep, (x+1)·e/ep). Their mlp
dimension splits over tp as the dense MLP's does (fc1's [gate | value]
segment by segment; transformer/moe.py runs them as expert tensor
parallelism), the router stays replicated; the batch splits over dp × ep
(the rule ("batch", ("dp", "ep"))).

Context parallelism (the rule ("seq", "cp")): the params are replicated
over cp, and each cp rank takes its share of every sequence
(``cp_share``): its contiguous S/cp block, of the zigzag-permuted
sequence when the zigzag ring runs (ops/context_parallel.py
``seq_indices``); the positions of its tokens are those indices.

FSDP (``ctx.parallel.fsdp``, JAX's ``FSDP_RULES``: the rule ("embed",
("dp",)), a second use of dp within one leaf replicated): on top of its
tp shard, each leaf with an 'embed' axis keeps its 1/dp slice along that
axis (``fsdp_dim``; dp rank d holds the d-th contiguous slice), and the
leaves without one stay whole. The layers gather what they use
(``fsdp_view``, one all-gather over the stage's dp group a subtree:
parallel/collectives.py ``fsdp_gather``) and their grads return to the
shards by a reduce-scatter.

``shard_tree(full, ctx)`` returns this rank's shards of a param tree
(its stage's pieces, then their tp shards); ``gather_tree(local, ctx)``
is its exact inverse (an all-gather over tp, then every stage's leaves
broadcast over the world). Convert (models/convert.py), init
(models/gpt.py) and the checkpoints (training/distributed_optimizer.py)
use them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from megatronapp_tpu_torch.utils.params import ParamTree

# The JAX rule table: logical axis → mesh axis (or a tuple of them).
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("vocab", "tp"),
    ("embed", None),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("qkv", "tp"),
    ("experts", "ep"),
    ("layers", None),
    ("pp_stage", "pp"),
    ("vpp_chunk", None),
    ("stage_layers", None),
    ("batch", ("dp", "ep")),
    ("seq", "cp"),
    ("pos", None),
)

# FSDP's table (JAX FSDP_RULES): the residual 'embed' axis over dp too.
FSDP_RULES: Tuple[Tuple[str, Any], ...] = tuple(
    (name, ("dp",) if name == "embed" else axis)
    for name, axis in DEFAULT_RULES)

# Each leaf's logical axes, as the JAX init functions give them (without
# the stacked layer axis): models/gpt.py, transformer/attention.py,
# transformer/mlp.py, transformer/block.py, transformer/mtp.py.
LOGICAL_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "word": ("vocab", "embed"),
    "pos": ("pos", "embed"),
    "output": ("embed", "vocab"),
    "final_ln_scale": ("embed",),
    "final_ln_bias": ("embed",),
    "ln1_scale": ("embed",),
    "ln1_bias": ("embed",),
    "ln2_scale": ("embed",),
    "ln2_bias": ("embed",),
    "q_kernel": ("embed", "qkv"),
    "kv_kernel": ("embed", "qkv"),
    "out_kernel": ("qkv", "embed"),
    "q_bias": ("qkv",),
    "kv_bias": ("qkv",),
    "out_bias": ("embed",),
    "q_ln_scale": ("head_dim",),
    "k_ln_scale": ("head_dim",),
    "fc1_kernel": ("embed", "mlp"),
    "fc1_bias": ("mlp",),
    "fc2_kernel": ("mlp", "embed"),
    "fc2_bias": ("embed",),
    "hnorm_scale": ("embed",),
    "enorm_scale": ("embed",),
    "proj": (None, "embed"),
}

# The MoE layer's leaves (JAX transformer/moe.py:46-58), under "moe".
MOE_LOGICAL_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "router_kernel": ("embed", None),
    "fc1_kernel": ("experts", "embed", "mlp"),
    "fc2_kernel": ("experts", "mlp", "embed"),
    "shared_fc1": ("embed", "mlp"),
    "shared_fc2": ("mlp", "embed"),
}

# Replicated leaves applied inside the tp-sharded region (to each rank's
# own heads): each tp rank holds only its heads' share of their gradient,
# so their grads are summed over tp before the norm and the update.
TP_PARTIAL_GRAD_LEAVES = frozenset({"q_ln_scale", "k_ln_scale"})


def logical_to_spec(logical_axes, rules=DEFAULT_RULES) -> tuple:
    """A tuple of logical axis names → the mesh axis of each dimension
    (None: replicated); a mesh axis is used once, later uses replicate
    (JAX's logical_to_spec)."""
    table = dict(rules)
    spec, used = [], set()
    for name in logical_axes:
        axis = None if name is None else table.get(name)
        key = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
        if axis is None or any(k in used for k in key):
            spec.append(None)
        else:
            used.update(key)
            spec.append(axis)
    return tuple(spec)


def leaf_name(path: str) -> str:
    return path.rsplit(".", 1)[-1]


def is_moe_leaf(path: str) -> bool:
    """A leaf of a MoE layer (its parent module is "moe")."""
    parts = path.rsplit(".", 2)
    return len(parts) > 1 and parts[-2] == "moe"


def logical_axes(path: str) -> Tuple[Optional[str], ...]:
    """Leaf `path`'s logical axes (JAX's); a leaf the tables do not know
    raises."""
    name = leaf_name(path)
    table = MOE_LOGICAL_AXES if is_moe_leaf(path) else LOGICAL_AXES
    if name not in table:
        raise KeyError(f"sharding: no logical axes for leaf {path!r} (MLA "
                       "and quantized leaves train on one rank only)")
    return table[name]


def tp_dim(path: str) -> Optional[int]:
    """The dimension of leaf `path` split over tp, None when replicated;
    a leaf the tables do not know raises."""
    spec = logical_to_spec(logical_axes(path))
    return spec.index("tp") if "tp" in spec else None


def ep_dim(path: str) -> Optional[int]:
    """The dimension of leaf `path` split over ep (the experts axis of an
    expert stack), None for every other leaf."""
    spec = logical_to_spec(logical_axes(path))
    return spec.index("ep") if "ep" in spec else None


def fsdp_on(ctx) -> bool:
    """Whether ctx's grid shards the params' 'embed' axes over dp (FSDP
    at dp > 1)."""
    return ctx is not None and ctx.parallel.fsdp and ctx.dp > 1


def fsdp_dim(path: str) -> Optional[int]:
    """The dimension of leaf `path` split over dp under FSDP (its first
    'embed' axis, JAX's FSDP_RULES), None for a leaf without one."""
    spec = logical_to_spec(logical_axes(path), FSDP_RULES)
    return spec.index(("dp",)) if ("dp",) in spec else None


def fsdp_shard(t: torch.Tensor, path: str, ctx) -> torch.Tensor:
    """This dp rank's FSDP slice of (the tp shard) t; t itself when FSDP
    is off or the leaf has no 'embed' axis."""
    dim = fsdp_dim(path) if fsdp_on(ctx) else None
    if dim is None:
        return t
    n = t.shape[dim]
    if n % ctx.dp:
        raise ValueError(f"{path}: its 'embed' dimension ({n}) does not "
                         f"split over dp {ctx.dp} (FSDP)")
    k = n // ctx.dp
    return t.narrow(dim, ctx.dp_rank * k, k).contiguous()


def fsdp_gather_named(named: Dict[str, torch.Tensor], ctx
                      ) -> Dict[str, torch.Tensor]:
    """{leaf path: tensor} with every FSDP-sharded leaf gathered whole
    (one all-gather for them all, differentiable); `named` itself when
    FSDP is off."""
    if not fsdp_on(ctx):
        return named
    from megatronapp_tpu_torch.parallel.collectives import fsdp_gather
    keys = [n for n in named if fsdp_dim(n) is not None]
    whole = fsdp_gather([named[n] for n in keys],
                        [fsdp_dim(n) for n in keys], ctx)
    return {**named, **dict(zip(keys, whole))}


def fsdp_view(tree, ctx):
    """A read-only view of a param subtree (a ParamTree or a ModuleList)
    for the layer functions: nested dicts and lists with every
    FSDP-sharded leaf gathered whole (``fsdp_gather_named``); the tree
    itself when FSDP is off."""
    if not fsdp_on(ctx):
        return tree
    named = dict(tree.named_parameters())
    whole = fsdp_gather_named(named, ctx)
    out: Dict[str, Any] = {}
    for n, t in whole.items():
        node, parts = out, n.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        kids = {k: listify(v) for k, v in node.items()}
        if kids and all(k.isdigit() for k in kids):
            return [kids[k] for k in sorted(kids, key=int)]
        return kids

    return listify(out)


def segment_counts(named: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Each leaf's fused segments, by its path in `named`: 2 for kv (K |
    V), 2 for a gated fc1 (its width twice its fc2's rows), else 1."""
    out = {}
    for n, t in named.items():
        leaf, base = leaf_name(n), n[:-len(leaf_name(n))]
        if leaf in ("kv_kernel", "kv_bias"):
            out[n] = 2
        elif leaf in ("fc1_kernel", "fc1_bias"):
            out[n] = t.shape[-1] // named[base + "fc2_kernel"].shape[-2]
        elif leaf == "shared_fc1":
            out[n] = t.shape[-1] // named[base + "shared_fc2"].shape[-2]
        else:
            out[n] = 1
    return out


def shard_leaf(t: torch.Tensor, dim: Optional[int], segments: int, tp: int,
               rank: int) -> torch.Tensor:
    """Rank `rank`'s tp shard of the full leaf t (a new tensor)."""
    if dim is None or tp == 1:
        return t.clone()
    n = t.shape[dim]
    if n % (segments * tp):
        raise ValueError(f"a dimension of {n} ({segments} segment(s)) does "
                         f"not split over tp {tp}")
    k = n // (segments * tp)
    parts = [t.narrow(dim, s * (n // segments) + rank * k, k)
             for s in range(segments)]
    return torch.cat(parts, dim=dim).contiguous()


def unshard_leaf(shards, dim: Optional[int], segments: int) -> torch.Tensor:
    """The full leaf from every rank's shard (rank order): the inverse of
    shard_leaf."""
    if dim is None or len(shards) == 1:
        return shards[0]
    per_seg = [s.chunk(segments, dim=dim) for s in shards]
    return torch.cat([p[s] for s in range(segments) for p in per_seg],
                     dim=dim)


def ep_shard(t: torch.Tensor, path: str, ctx) -> torch.Tensor:
    """This ep rank's experts of the whole leaf t (t itself when the leaf
    does not split over ep)."""
    dim = ep_dim(path) if ctx is not None and ctx.ep > 1 else None
    if dim is None:
        return t
    n = t.shape[dim]
    if n % ctx.ep:
        raise ValueError(f"{path}: {n} experts do not split over ep "
                         f"{ctx.ep}")
    k = n // ctx.ep
    return t.narrow(dim, ctx.ep_rank * k, k).contiguous()


def gather_leaf(t: torch.Tensor, path: str, segments: int, ctx
                ) -> torch.Tensor:
    """The full leaf from every tp rank's shard t (an all-gather when the
    leaf is split over tp), and every ep rank's experts (an all-gather
    over ep for an expert stack); collective: every rank of those groups
    calls it."""
    from megatronapp_tpu_torch.parallel.collectives import all_gather_cat
    dim = fsdp_dim(path) if fsdp_on(ctx) else None
    if dim is not None:
        t = all_gather_cat(t, ctx, "dp", dim)
    dim = ep_dim(path) if ctx.ep > 1 else None
    if dim is not None:
        t = all_gather_cat(t, ctx, "ep", dim)
    dim = tp_dim(path) if ctx.tp > 1 else None
    if dim is None:
        return t
    full = all_gather_cat(t, ctx, "tp", dim)
    return unshard_leaf(list(full.chunk(ctx.tp, dim=dim)), dim, segments)


def _map_tree(tree: nn.Module, fn) -> nn.Module:
    """A new tree of the same structure whose leaves are fn(path,
    tensor, its segment count)."""
    segs = segment_counts(dict(tree.named_parameters()))

    def walk(m, prefix):
        if isinstance(m, nn.ModuleList):
            return nn.ModuleList(walk(c, f"{prefix}{i}.")
                                 for i, c in enumerate(m))
        leaves = {n: fn(prefix + n, p.detach(), segs[prefix + n])
                  for n, p in m._parameters.items()}
        return ParamTree(leaves, **{n: walk(c, f"{prefix}{n}.")
                                    for n, c in m._modules.items()})

    return walk(tree, "")


def cp_share(seq_len: int, ctx, zigzag: bool, device) -> torch.Tensor:
    """The global positions of this cp rank's share of a sequence of
    seq_len, in its local order (a long tensor on `device`): what it
    takes of tokens, targets, masks and segment ids along the sequence,
    and its tokens' positions (rope, the learned embedding)."""
    from megatronapp_tpu_torch.ops.context_parallel import seq_indices
    return torch.from_numpy(seq_indices(seq_len, ctx.cp, ctx.cp_rank,
                                        zigzag)).to(device)


MTP_MLA_UNDER_CP = ("MTP depths and MLA under context parallelism are not "
                    "ported yet (ROADMAP.md Queue 1 item 4 (MTP and MLA "
                    "under grids))")

MTP_UNDER_PP = ("MTP depths under pipeline parallelism are not ported yet "
                "(ROADMAP.md Queue 1 item 4, MTP under grids): the MTP "
                "head needs stage 0's embedding on the last stage")


def stage_layer_ids(num_layers: int, pp: int, vpp: int, stage: int
                    ) -> List[int]:
    """The global layer ids stage `stage` holds, chunk by chunk (chunk c:
    [(c·pp + stage)·Lc, ...), Lc = num_layers / (pp·vpp))."""
    if num_layers % (pp * vpp):
        raise ValueError(f"num_layers={num_layers} does not split into "
                         f"pp*vpp={pp * vpp} equal chunks")
    lc = num_layers // (pp * vpp)
    return [(c * pp + stage) * lc + i for c in range(vpp) for i in range(lc)]


def stage_tree(full: nn.Module, ctx) -> nn.Module:
    """This rank's stage's pieces of a whole param tree (the leaves stay
    the same tensors); the tree itself at pp 1."""
    if ctx is None or ctx.pp == 1:
        return full
    if "mtp" in full:
        raise NotImplementedError(MTP_UNDER_PP)
    leaves = dict(full._parameters)
    tied = "output" not in leaves
    top = {k: v.detach() for k, v in leaves.items()} \
        if ctx.is_last_stage else {}
    children = {}
    if ctx.is_first_stage:
        children["embedding"] = full["embedding"]
    elif tied and ctx.is_last_stage:
        children["embedding"] = ParamTree(
            {"word": full["embedding"]["word"].detach()})
    layers = full["layers"]
    ids = stage_layer_ids(len(layers), ctx.pp, ctx.vpp, ctx.pp_rank)
    children["layers"] = ParamTree(**{str(i): layers[i] for i in ids})
    return ParamTree(top, **children)


def shard_tree(full: nn.Module, ctx) -> nn.Module:
    """This rank's shards of a full param tree, or of a piece of one (new
    frozen leaves; the full tree is not touched): its stage's pieces of a
    whole tree (``stage_tree``), then their tp shards and the ep rank's
    experts."""
    if ctx is None:
        return full
    if "layers" in full and "embedding" in full:
        full = stage_tree(full, ctx)
    if ctx.tp == 1 and ctx.ep == 1 and not fsdp_on(ctx):
        return full
    return _map_tree(full, lambda path, t, segs: fsdp_shard(ep_shard(
        shard_leaf(t, tp_dim(path), segs, ctx.tp, ctx.tp_rank), path, ctx),
        path, ctx))


def gather_stages(named: Dict[str, torch.Tensor], ctx
                  ) -> Dict[str, torch.Tensor]:
    """Every stage's whole leaves on every rank (host tensors): each leaf
    is broadcast over the world from the lowest rank that offers it.
    `named`: this rank's whole leaves (gathered over tp and dp; a rank
    of dp, cp or tp index > 0 offers none). Collective over the world."""
    import torch.distributed as dist
    mine = [(n, tuple(t.shape), str(t.dtype)) for n, t in named.items()]
    every: List[Any] = [None] * ctx.world
    dist.all_gather_object(every, mine, group=ctx.world_group)
    owner: Dict[str, Tuple[int, tuple, str]] = {}
    for r, leaves in enumerate(every):
        for n, shape, dt in leaves:
            owner.setdefault(n, (r, shape, dt))
    out = {}
    for n, (r, shape, dt) in owner.items():
        dtype = getattr(torch, dt.split(".")[-1])
        t = (named[n].detach().to("cpu", copy=True)
             if r == ctx.grid_rank else torch.empty(shape, dtype=dtype))
        raw = t.view(torch.uint8) if dtype == torch.bfloat16 else t
        dist.broadcast(raw, src=ctx.rank_base + r, group=ctx.world_group)
        out[n] = t
    return out


def tree_from_named(named: Dict[str, torch.Tensor]) -> nn.Module:
    """A ParamTree from {leaf path: tensor} (``layers.<i>`` and
    ``mtp.<d>`` become ModuleLists in index order)."""
    leaves, kids = {}, {}
    for n, t in named.items():
        head, dot, rest = n.partition(".")
        if dot:
            kids.setdefault(head, {})[rest] = t
        else:
            leaves[head] = t
    children = {}
    for k, sub in kids.items():
        tree = tree_from_named(sub)
        if all(c.isdigit() for c in tree._modules) and not \
                tree._parameters:
            tree = nn.ModuleList(tree._modules[c] for c in sorted(
                tree._modules, key=int))
        children[k] = tree
    return ParamTree(leaves, **children)


def gather_tree(local: nn.Module, ctx) -> nn.Module:
    """The full param tree from every rank's shards (an all-gather over
    tp a sharded leaf and over ep an expert stack, then at pp > 1 every
    stage's leaves over the world): the exact inverse of shard_tree."""
    if ctx is None or (ctx.tp == 1 and ctx.pp == 1 and ctx.ep == 1
                       and not fsdp_on(ctx)):
        return local
    if ctx.tp > 1 or ctx.ep > 1 or fsdp_on(ctx):
        local = _map_tree(local, lambda path, t, segs: gather_leaf(
            t, path, segs, ctx).clone())
    if ctx.pp == 1:
        return local
    named = dict(local.named_parameters())
    if ctx.dp_rank or ctx.cp_rank or ctx.tp_rank or ctx.ep_rank:
        named = {}
    device = next(local.parameters()).device
    return tree_from_named({n: t.to(device) for n, t in
                            gather_stages(named, ctx).items()})
