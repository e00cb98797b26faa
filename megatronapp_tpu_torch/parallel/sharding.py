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

``shard_tree(full, ctx)`` returns this rank's shards of a param tree;
``gather_tree(local, ctx)`` is its exact inverse (an all-gather over tp).
Convert (models/convert.py), init (models/gpt.py) and the checkpoints
(training/distributed_optimizer.py) use them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


def tp_dim(path: str) -> Optional[int]:
    """The dimension of leaf `path` split over tp, None when replicated;
    a leaf the table does not know raises."""
    name = leaf_name(path)
    if name not in LOGICAL_AXES:
        raise KeyError(f"sharding: no logical axes for leaf {path!r} (MLA, "
                       "MoE and quantized leaves train on one rank only)")
    spec = logical_to_spec(LOGICAL_AXES[name])
    return spec.index("tp") if "tp" in spec else None


def segment_counts(named: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Each leaf's fused segments, by its path in `named`: 2 for kv (K |
    V), 2 for a gated fc1 (its width twice its fc2's rows), else 1."""
    out = {}
    for n, t in named.items():
        leaf, base = leaf_name(n), n[:-len(leaf_name(n))]
        if leaf in ("kv_kernel", "kv_bias"):
            out[n] = 2
        elif leaf in ("fc1_kernel", "fc1_bias"):
            out[n] = t.shape[-1] // named[base + "fc2_kernel"].shape[0]
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


def gather_leaf(t: torch.Tensor, path: str, segments: int, ctx
                ) -> torch.Tensor:
    """The full leaf from every tp rank's shard t (an all-gather when the
    leaf is split over tp; collective: every tp rank calls it)."""
    dim = tp_dim(path) if ctx.tp > 1 else None
    if dim is None:
        return t
    from megatronapp_tpu_torch.parallel.collectives import all_gather_cat
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


def shard_tree(full: nn.Module, ctx) -> nn.Module:
    """This rank's tp shards of a full param tree, or of a piece of one
    (new frozen leaves; the full tree is not touched)."""
    if ctx is None or ctx.tp == 1:
        return full
    return _map_tree(full, lambda path, t, segs: shard_leaf(
        t, tp_dim(path), segs, ctx.tp, ctx.tp_rank))


def gather_tree(local: nn.Module, ctx) -> nn.Module:
    """The full param tree from every tp rank's shards (an all-gather a
    sharded leaf): the exact inverse of shard_tree."""
    if ctx is None or ctx.tp == 1:
        return local
    return _map_tree(local, lambda path, t, segs: gather_leaf(
        t, path, segs, ctx).clone())
