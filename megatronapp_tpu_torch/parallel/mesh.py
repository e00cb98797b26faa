"""The tensor-parallel group: the port's counterpart of the JAX package's
``MeshContext`` / ``build_mesh`` (parallel/mesh.py).

JAX runs one controller over a device mesh; the port runs one process per
tp rank, joined by a ``torch.distributed`` process group. The group's
backend is gloo: it carries CUDA tensors (staged through host memory by
gloo itself) and CPU tensors alike, and unlike NCCL it takes several ranks
on one card. Each rank names its own device; ``device=None`` means the
card, and a host without one raises before the group is joined.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.utils.device import resolve_device

# Every collective of the group fails after this long instead of hanging
# (a rank that diverged from the others, or died).
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class MeshContext:
    """One rank's view of the tp group: the process group, the tp degree,
    this rank, and the device this rank computes on."""

    group: dist.ProcessGroup
    parallel: ParallelConfig
    rank: int
    device: torch.device
    backend: str
    timeout_s: float = DEFAULT_TIMEOUT_S

    @property
    def tp(self) -> int:
        return self.parallel.tensor_parallel

    @property
    def num_devices(self) -> int:
        return self.tp

    @property
    def is_lead(self) -> bool:
        """Rank 0 decides every host-side choice of a serving step and
        broadcasts it (inference/dynamic_engine.py)."""
        return self.rank == 0

    def shard(self, n: int) -> slice:
        """This rank's contiguous share of n (heads or latent columns)."""
        if n % self.tp:
            raise ValueError(f"{n} does not split over tp {self.tp}")
        k = n // self.tp
        return slice(self.rank * k, (self.rank + 1) * k)

    def close(self):
        """Leave the group (the process can then exit cleanly)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def build_mesh(parallel: ParallelConfig, *, rank: int, init_method: str,
               device=None, backend: str = "gloo",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> MeshContext:
    """Join the tp group of `parallel.tensor_parallel` ranks as `rank`.
    init_method: where the ranks meet, ``tcp://localhost:<port>`` or
    ``file://<path>`` (the tests use a FileStore path). device: this
    rank's device (None: the card; raises without one)."""
    dev = resolve_device(device)
    tp = parallel.tensor_parallel
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp {tp}")
    if backend != "gloo":
        raise NotImplementedError(
            f"backend {backend!r}: the port's tp group runs over gloo (NCCL "
            "with one rank per card waits for a multi-card machine, "
            "ROADMAP.md)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=tp,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return MeshContext(group=dist.group.WORLD, parallel=parallel, rank=rank,
                       device=dev, backend=backend, timeout_s=timeout_s)
