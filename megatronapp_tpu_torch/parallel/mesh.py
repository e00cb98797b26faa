"""The rank grid: the port's counterpart of the JAX package's
``MeshContext`` / ``build_mesh`` (parallel/mesh.py).

JAX runs one controller over a device mesh with the axes pp, dp, ep, cp,
tp (tp innermost); the port runs one process a rank, joined by
``torch.distributed`` process groups, in the same order: rank =
(((pp_index · dp + dp_index) · ep + ep_index) · cp + cp_index) · tp +
tp_index (JAX parallel/mesh.py:153-158). ``build_mesh`` joins the world
group and builds one tp group per (pp, dp, ep, cp) index, one dp group
per (pp, ep, cp, tp), one cp group per (pp, dp, ep, tp), one pp group
(the stage ring) per (dp, ep, cp, tp) and, at pp > 1, one embedding
group of the first and last stages per (dp, ep, cp, tp): a tied
embedding's two copies sum their grads there (JAX keeps the embedding
replicated over pp). At ep > 1 it also builds one ep group per (pp, dp,
cp, tp) (the experts' all-to-all dispatch, transformer/moe.py) and one
"batch" group per (pp, cp, tp): the dp × ep ranks that split the batch
(JAX's ("batch", (dp, ep)) rule), over which the leaves that are not
experts reduce their grads; at ep 1 the batch group is the dp group. At
cp > 1 with ``cp_a2a_size`` (the inner all-to-all size of cp_comm_type
'a2a+p2p', 1 < a2a < cp) it also builds the inner all-to-all groups,
a2a consecutive cp ranks each; the ring across them (the ranks of one
inner index, ``cp_outer_ranks``) and the cp ring itself
(``cp_next_rank``, ``cp_prev_rank``) move blocks point to point over the
world group, so they need no group of their own. The tp-only grid of
tensor-parallel serving (``--serve-tp``) is the case pp = dp = ep = cp =
1, whose tp group is the world; at ep 1 and cp 1 every grid keeps the
rank numbering and the groups it had before those axes.

The backend is gloo: it carries CUDA tensors (staged through host memory
by gloo itself) and CPU tensors alike, and unlike NCCL it takes several
ranks on one card. So a grid on one card checks kernels, shards
and collectives, never parallel speed. Each rank names its own device;
``device=None`` means the card, and a host without one raises before a
group is joined.

A grid may be one of two halves of a larger world (MegaFBD,
parallel/fbd.py ``split_fbd_meshes``): its ranks are then the global
ranks [rank_base, rank_base + world), ``grid_rank`` is a rank's index
among them, every rank list and the "world" group are the half's, and
``fbd_role`` ("forward" or "backward") and ``twin_rank`` (the rank of
the same (pp, dp, tp) index in the other half) are set.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional

import torch
import torch.distributed as dist

from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.utils.device import resolve_device

# Every collective of the groups fails after this long instead of hanging
# (a rank that diverged from the others, or died).
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class MeshContext:
    """One rank's view of the grid: its tp group (``group``), the degrees,
    its global rank, the device it computes on, and for training its dp,
    pp and embedding groups and the world group (None where the axis has
    one rank)."""

    group: dist.ProcessGroup
    parallel: ParallelConfig
    rank: int
    device: torch.device
    backend: str
    timeout_s: float = DEFAULT_TIMEOUT_S
    dp_group: Optional[dist.ProcessGroup] = None
    world_group: Optional[dist.ProcessGroup] = None
    pp_group: Optional[dist.ProcessGroup] = None
    embed_group: Optional[dist.ProcessGroup] = None
    cp_group: Optional[dist.ProcessGroup] = None
    # 'a2a+p2p': this rank's inner all-to-all group and its size (None /
    # 1 without one).
    cp_a2a_group: Optional[dist.ProcessGroup] = None
    cp_a2a_size: int = 1
    # ep > 1: this rank's ep group and its dp × ep batch group.
    ep_group: Optional[dist.ProcessGroup] = None
    ep_batch_group: Optional[dist.ProcessGroup] = None
    # A half of a MegaFBD world (module docstring); 0 / None otherwise.
    rank_base: int = 0
    fbd_role: Optional[str] = None
    twin_rank: Optional[int] = None

    @property
    def tp(self) -> int:
        return self.parallel.tensor_parallel

    @property
    def dp(self) -> int:
        return self.parallel.data_parallel or 1

    @property
    def pp(self) -> int:
        return self.parallel.pipeline_parallel

    @property
    def vpp(self) -> int:
        return self.parallel.virtual_pipeline_parallel

    @property
    def cp(self) -> int:
        return self.parallel.context_parallel

    @property
    def ep(self) -> int:
        return self.parallel.expert_parallel

    @property
    def batch(self) -> int:
        """The ranks that split the batch (dp × ep)."""
        return self.dp * self.ep

    @property
    def world(self) -> int:
        return self.tp * self.cp * self.ep * self.dp * self.pp

    @property
    def num_devices(self) -> int:
        return self.world

    @property
    def grid_rank(self) -> int:
        """This rank's index in its grid (its global rank but in a
        MegaFBD half)."""
        return self.rank - self.rank_base

    @property
    def world_ranks(self) -> List[int]:
        """The global ranks of this rank's grid, in grid order."""
        return list(range(self.rank_base, self.rank_base + self.world))

    @property
    def tp_rank(self) -> int:
        return self.grid_rank % self.tp

    @property
    def cp_rank(self) -> int:
        return self.grid_rank // self.tp % self.cp

    @property
    def ep_rank(self) -> int:
        return self.grid_rank // (self.tp * self.cp) % self.ep

    @property
    def dp_rank(self) -> int:
        return self.grid_rank // (self.tp * self.cp * self.ep) % self.dp

    @property
    def batch_rank(self) -> int:
        """This rank's block of the batch: dp_rank · ep + ep_rank (JAX's
        P((dp, ep)))."""
        return self.dp_rank * self.ep + self.ep_rank

    @property
    def pp_rank(self) -> int:
        """This rank's pipeline stage."""
        return self.grid_rank // (self.tp * self.cp * self.ep * self.dp)

    def _at(self, p: int, d: int, c: int, t: int, x: Optional[int] = None
            ) -> int:
        """The global rank of grid index (pp, dp, ep, cp, tp); ep index x
        defaults to this rank's."""
        x = self.ep_rank if x is None else x
        return self.rank_base + (((p * self.dp + d) * self.ep + x)
                                 * self.cp + c) * self.tp + t

    @property
    def is_first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def is_last_stage(self) -> bool:
        return self.pp_rank == self.pp - 1

    @property
    def tp_group(self):
        return self.group

    @property
    def tp_ranks(self) -> List[int]:
        """The global ranks of this rank's tp group, in tp order."""
        return [self._at(self.pp_rank, self.dp_rank, self.cp_rank, t)
                for t in range(self.tp)]

    @property
    def dp_ranks(self) -> List[int]:
        """The global ranks of this rank's dp group, in dp order."""
        return [self._at(self.pp_rank, d, self.cp_rank, self.tp_rank)
                for d in range(self.dp)]

    @property
    def ep_ranks(self) -> List[int]:
        """The global ranks of this rank's ep group, in ep order (rank x
        holds experts [x·e/ep, (x+1)·e/ep))."""
        return [self._at(self.pp_rank, self.dp_rank, self.cp_rank,
                         self.tp_rank, x) for x in range(self.ep)]

    @property
    def batch_ranks(self) -> List[int]:
        """The global ranks of this rank's dp × ep batch group, in batch
        order (dp major)."""
        return [self._at(self.pp_rank, d, self.cp_rank, self.tp_rank, x)
                for d in range(self.dp) for x in range(self.ep)]

    @property
    def batch_group(self):
        return self.ep_batch_group if self.ep > 1 else self.dp_group

    @property
    def cp_ranks(self) -> List[int]:
        """The global ranks of this rank's cp group, in cp order (rank c
        holds the sequence's c-th share)."""
        return [self._at(self.pp_rank, self.dp_rank, c, self.tp_rank)
                for c in range(self.cp)]

    @property
    def cp_a2a_ranks(self) -> List[int]:
        """The global ranks of this rank's inner all-to-all group
        ('a2a+p2p'): the cp_a2a_size consecutive cp ranks holding it."""
        a = self.cp_a2a_size
        g = self.cp_rank // a
        return self.cp_ranks[g * a:(g + 1) * a]

    @property
    def cp_outer_ranks(self) -> List[int]:
        """'a2a+p2p''s ring across the inner groups, in ring order: the
        rank of this rank's inner index in each inner group."""
        a = self.cp_a2a_size
        return self.cp_ranks[self.cp_rank % a::a]

    @property
    def cp_next_rank(self) -> int:
        """The next rank on the cp ring (a ring hop's destination)."""
        return self.cp_ranks[(self.cp_rank + 1) % self.cp]

    @property
    def cp_prev_rank(self) -> int:
        """The previous rank on the cp ring (a ring hop's source)."""
        return self.cp_ranks[(self.cp_rank - 1) % self.cp]

    @property
    def pp_ranks(self) -> List[int]:
        """The global ranks of this rank's stage ring, in stage order."""
        return [self._at(p, self.dp_rank, self.cp_rank, self.tp_rank)
                for p in range(self.pp)]

    @property
    def embed_ranks(self) -> List[int]:
        """The first and the last stage's ranks of this (dp, cp, tp)
        index."""
        ring = self.pp_ranks
        return [ring[0], ring[-1]]

    @property
    def next_rank(self) -> int:
        """The global rank of the next stage (the last stage's is stage
        0: the chunk hand-off of the interleaved schedule)."""
        return self.pp_ranks[(self.pp_rank + 1) % self.pp]

    @property
    def prev_rank(self) -> int:
        return self.pp_ranks[(self.pp_rank - 1) % self.pp]

    @property
    def is_lead(self) -> bool:
        """Rank 0 (of its grid) decides every host-side choice of a
        serving step and broadcasts it (inference/dynamic_engine.py), and
        alone logs, writes metrics and checkpoints in training (under
        MegaFBD, the backward half's lead: training/train.py)."""
        return self.grid_rank == 0

    def shard(self, n: int) -> slice:
        """This rank's contiguous tp share of n (heads, columns, rows)."""
        if n % self.tp:
            raise ValueError(f"{n} does not split over tp {self.tp}")
        k = n // self.tp
        return slice(self.tp_rank * k, (self.tp_rank + 1) * k)

    def close(self):
        """Leave the groups (the process can then exit cleanly)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def _join(world: int, rank: int, init_method: str, device, backend: str,
          timeout_s: float):
    """Check the backend, set this rank's card and join the world group
    (the resolved device)."""
    dev = resolve_device(device)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if backend != "gloo":
        raise NotImplementedError(
            f"backend {backend!r}: the port's groups run over gloo (NCCL "
            "with one rank per card waits for a multi-card machine, "
            "ROADMAP.md Queue 1 item 4)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _grid_groups(rank: int, base: int, pp: int, dp: int, tp: int,
                 timeout_s: float, cp: int = 1, cp_a2a: int = 1,
                 ep: int = 1) -> dict:
    """The process groups of the pp × dp × ep × cp × tp grid of global
    ranks [base, base + pp·dp·ep·cp·tp): {axis: group} of this rank's
    groups ({} when the rank is not in the grid); cp_a2a > 1 adds the
    inner all-to-all groups ("cp_a2a") of 'a2a+p2p', ep > 1 the ep and
    the dp × ep "batch" groups. Every rank of the world must call it for
    every grid, in one order (new_group is collective over the world). A
    group of one rank is None; a group of the whole world is WORLD."""
    timeout = datetime.timedelta(seconds=timeout_s)
    total = dist.get_world_size()
    mine = {}

    def groups(axis, all_ranks):
        for ranks in all_ranks:
            g = dist.group.WORLD if len(ranks) == total else (
                dist.new_group(ranks, timeout=timeout) if len(ranks) > 1
                else None)
            if rank in ranks:
                mine[axis] = g

    def at(p, d, c, t, x=0):
        return base + (((p * dp + d) * ep + x) * cp + c) * tp + t

    xs = range(ep)
    groups("tp", [[at(p, d, c, t, x) for t in range(tp)]
                  for p in range(pp) for d in range(dp) for x in xs
                  for c in range(cp)])
    groups("dp", [[at(p, d, c, t, x) for d in range(dp)]
                  for p in range(pp) for x in xs for c in range(cp)
                  for t in range(tp)])
    if cp > 1:
        cps = [[at(p, d, c, t, x) for c in range(cp)]
               for p in range(pp) for d in range(dp) for x in xs
               for t in range(tp)]
        groups("cp", cps)
        if 1 < cp_a2a < cp:
            groups("cp_a2a", [ranks[g:g + cp_a2a] for ranks in cps
                              for g in range(0, cp, cp_a2a)])
    if ep > 1:
        groups("ep", [[at(p, d, c, t, x) for x in xs]
                      for p in range(pp) for d in range(dp)
                      for c in range(cp) for t in range(tp)])
        groups("batch", [[at(p, d, c, t, x) for d in range(dp) for x in xs]
                         for p in range(pp) for c in range(cp)
                         for t in range(tp)])
    if pp > 1:
        rings = [[at(p, d, c, t, x) for p in range(pp)]
                 for d in range(dp) for x in xs for c in range(cp)
                 for t in range(tp)]
        groups("pp", rings)
        groups("embed", [[r[0], r[-1]] for r in rings])
    groups("world", [list(range(base, base + pp * dp * ep * cp * tp))])
    return mine


def cp_a2a_of(parallel: ParallelConfig, cp_a2a_size: Optional[int]
              ) -> int:
    """The inner all-to-all size a grid builds groups for: cp_a2a_size
    (the 'a2a+p2p' runs' hierarchical_cp_a2a_size) when it splits cp, else
    1."""
    cp = parallel.context_parallel
    if not cp_a2a_size or cp_a2a_size <= 1 or cp_a2a_size >= cp:
        return 1
    if cp % cp_a2a_size:
        raise ValueError(f"hierarchical cp: a2a size {cp_a2a_size} does "
                         f"not divide context_parallel={cp}")
    return cp_a2a_size


def build_mesh(parallel: ParallelConfig, *, rank: int, init_method: str,
               device=None, backend: str = "gloo",
               timeout_s: float = DEFAULT_TIMEOUT_S,
               world_size: Optional[int] = None,
               cp_a2a_size: Optional[int] = None) -> MeshContext:
    """Join the grid as `rank` of `world_size` ranks (default: tp · pp ·
    ep · cp, the serving grid at pp = ep = cp = 1); dp = world_size / (tp
    · pp · ep · cp) (``infer_data_parallel``). init_method: where the ranks meet,
    ``tcp://localhost:<port>``, ``env://`` (the launcher's MASTER_ADDR
    and MASTER_PORT) or ``file://<path>`` (the tests use a FileStore
    path). device: this rank's device (None: the card; raises without
    one). cp_a2a_size: the inner all-to-all size of cp_comm_type
    'a2a+p2p' (``cp_a2a_of``)."""
    tp, pp = parallel.tensor_parallel, parallel.pipeline_parallel
    cp, ep = parallel.context_parallel, parallel.expert_parallel
    world = tp * pp * ep * cp if world_size is None else world_size
    dp = parallel.infer_data_parallel(world)
    a2a = cp_a2a_of(parallel, cp_a2a_size)
    dev = _join(world, rank, init_method, device, backend, timeout_s)
    mine = _grid_groups(rank, 0, pp, dp, tp, timeout_s, cp, a2a, ep)
    par = dataclasses.replace(parallel, data_parallel=dp)
    return MeshContext(group=mine["tp"] if tp > 1 else mine["world"],
                       parallel=par, rank=rank, device=dev, backend=backend,
                       timeout_s=timeout_s, dp_group=mine["dp"],
                       world_group=mine["world"], pp_group=mine.get("pp"),
                       embed_group=mine.get("embed"),
                       cp_group=mine.get("cp"),
                       cp_a2a_group=mine.get("cp_a2a"), cp_a2a_size=a2a,
                       ep_group=mine.get("ep"),
                       ep_batch_group=mine.get("batch"))
