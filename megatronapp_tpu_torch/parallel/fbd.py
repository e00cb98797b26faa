"""MegaFBD: forward/backward disaggregation on two halves of a gloo world
(the JAX package's parallel/fbd.py: ``split_fbd_meshes``,
``FBDExecutor``).

The world of 2 · pp · (dp/2) · cp · tp ranks splits as JAX splits its
devices (the reference's rank accounting, parallel_state.py:444-453):
ranks [0, W/2) form the forward half and [W/2, W) the backward half, each
its own pp × (dp/2) × cp × tp grid (parallel/mesh.py, with its own tp,
dp, cp, pp, embedding and world groups), and a rank's twin holds the same
(pp, dp, cp, tp) index in the other half: both hold the same share of
the sequence, so a shipped stage input is [mb, S/cp, H]. An odd dp
raises JAX's message.

Each step, one role a rank:

- a **forward rank** runs the step's forward without grad over its dp
  rows: each microbatch's loss at pp 1, or the forward programs of the
  1F1B table through its own half's stage hops at pp > 1, shipping every
  stage input it consumes to its twin (parallel/pipeline.py
  ``TwinLink``; stage 0's chunk-0 inputs are not shipped: the twin
  embeds the same rows itself). Its last stage keeps the step's loss,
  ``fwd_loss``;
- a **backward rank** runs the train step of its half's grid
  (training/train_step.py: fp32 grads accumulated, the tp and dp
  reductions, ZeRO-1 over the halved dp, the model-wide norm, the NaN
  gate and the optax chain's update). At pp 1 it runs each microbatch's
  forward and backward itself. At pp > 1 it takes each stage input from
  its twin, recomputes the stage forward with grad just before its
  backward (the last stage with the head and loss, over the step's whole
  mask count as ``gpt_pipeline_loss`` does), receives dY from the next
  backward stage and sends dX to the previous one: one F's graph at a
  time. After the update it streams its updated flat params (its stage's
  tp shards, fp32) to its twin.

**Departure from JAX.** JAX ships each microbatch's vjp residuals, so its
backward mesh never recomputes (tests/test_fbd_dpp.py counts the flops).
Torch cannot send an autograd graph between processes, so the backward
rank recomputes its stage's forward from the shipped input: the
reference's own MegaFBD schedule (forward_step_no_grad, then
send_corresponding_forward → recv_corresponding_forward, recompute and
backward_step; schedules.py:1837-1866, :2208). Losses and grads are
unchanged; only the flop split differs, and the flop test has no
counterpart here. At pp 1 nothing is shipped at all.

``step`` returns JAX's metrics on every rank of the world (one all-gather
over the whole world): ``loss`` and ``grad_norm`` (the backward half's),
``fwd_loss`` (the forward half's) and ``shipped_bytes`` (the stage-input
bytes the forward half shipped this step), with the grid step's ``lr``,
``skipped``, ``lm_loss`` and ``moe_aux_loss``. Twin hops count as
"send/fbd" / "recv/fbd" and the param stream as "send/fbd-params" /
"recv/fbd-params" (parallel/collectives.py ``traffic``);
``stream_s`` keeps each param stream's host seconds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
from megatronapp_tpu_torch.parallel import collectives
from megatronapp_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S, MeshContext, _grid_groups, _join, cp_a2a_of,
)
from megatronapp_tpu_torch.parallel.pipeline import TwinLink

# The metrics the backward half's lead hands every rank.
_BWD_KEYS = ("loss", "grad_norm", "lr", "skipped", "lm_loss",
             "moe_aux_loss")


def split_fbd_meshes(parallel: ParallelConfig, *, rank: int,
                     world_size: int, init_method: str, device=None,
                     backend: str = "gloo",
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     cp_a2a_size=None) -> MeshContext:
    """Join the world as `rank` of `world_size` and return this rank's
    half (module docstring): its MeshContext of a pp × (dp/2) × cp × tp
    grid with ``fbd_role`` and ``twin_rank`` set. Every rank makes every
    group of both halves. Raises before joining when dp is odd.
    cp_a2a_size: as parallel/mesh.py build_mesh's."""
    dp = parallel.infer_data_parallel(world_size)
    if dp % 2 != 0:
        raise ValueError(
            f"forward/backward disaggregation requires even data-parallel "
            f"degree (got dp={dp}) — reference parallel_state.py:453")
    half = dataclasses.replace(parallel, data_parallel=dp // 2,
                               forward_backward_disaggregating=False)
    n = world_size // 2
    tp, pp = half.tensor_parallel, half.pipeline_parallel
    cp, a2a = half.context_parallel, cp_a2a_of(half, cp_a2a_size)
    dev = _join(world_size, rank, init_method, device, backend, timeout_s)
    mine = {}
    for base in (0, n):
        got = _grid_groups(rank, base, pp, dp // 2, tp, timeout_s, cp, a2a)
        if got:
            mine = got
    base = 0 if rank < n else n
    return MeshContext(
        group=mine["tp"] if tp > 1 else mine["world"], parallel=half,
        rank=rank, device=dev, backend=backend, timeout_s=timeout_s,
        dp_group=mine["dp"], world_group=mine["world"],
        pp_group=mine.get("pp"), embed_group=mine.get("embed"),
        cp_group=mine.get("cp"), cp_a2a_group=mine.get("cp_a2a"),
        cp_a2a_size=a2a, rank_base=base, fbd_role="forward" if rank < n else "backward",
        twin_rank=rank + n if rank < n else rank - n)


class FBDExecutor:
    """One rank's part of MegaFBD training (module docstring).

    cfg: the model; ctx: this rank's half (``split_fbd_meshes``); state:
    its TrainState (a backward rank's with the optimizer's state; a
    forward rank's params alone); optimizer: the backward rank's
    training/distributed_optimizer.py ``DistributedOptimizer`` (None on a
    forward rank)."""

    def __init__(self, cfg, ctx: MeshContext, state, optimizer=None, *,
                 check_nan: bool = True):
        from megatronapp_tpu_torch.training.distributed_optimizer import (
            FlatLayout, layout_copies,
        )
        from megatronapp_tpu_torch.training.train_step import (
            make_train_step, named_trainable,
        )
        self.cfg, self.ctx, self.state = cfg, ctx, state
        self.backward = ctx.fbd_role == "backward"
        self.shipped_bytes = 0
        self.stream_s: List[float] = []
        if self.backward:
            self.optimizer = optimizer
            self.layout = optimizer.layout
            self._train_step = make_train_step(
                self._loss_fn, optimizer, check_nan=check_nan, ctx=ctx,
                pipeline=ctx.pp > 1)
        else:
            tied = not cfg.untie_embeddings_and_output_weights
            self.layout = FlatLayout(named_trainable(state.params), ctx,
                                     layout_copies(ctx, tied), grads=False)

    # -- the two roles' passes ---------------------------------------------
    def _pipeline(self, params, batch, grad: bool):
        from megatronapp_tpu_torch.models.gpt import gpt_pipeline_loss
        return gpt_pipeline_loss(
            params, batch, self.cfg, self.ctx, schedule="1f1b",
            order_policy=self.ctx.parallel.pipeline_order_policy,
            grad=grad, fbd=TwinLink(self.ctx, self.ctx.fbd_role))

    def _loss_fn(self, params, batch):
        """The backward rank's loss function of the grid step: a
        microbatch's (pp 1) or the pipeline's over the whole batch."""
        if self.ctx.pp > 1:
            return self._pipeline(params, batch, grad=True)
        from megatronapp_tpu_torch.models.gpt import gpt_loss
        return gpt_loss(params, batch["tokens"], batch["labels"],
                        batch["loss_mask"], self.cfg,
                        segment_ids=batch.get("segment_ids"), ctx=self.ctx)

    @torch.no_grad()
    def _forward(self, batch: Dict[str, torch.Tensor]) -> float:
        """The forward rank's pass: its share of the step's loss."""
        params = self.state.params
        if self.ctx.pp > 1:
            loss, _ = self._pipeline(params, batch, grad=False)
            return float(loss)
        from megatronapp_tpu_torch.models.gpt import gpt_loss
        num_micro = batch["tokens"].shape[0]
        total = None
        for i in range(num_micro):
            loss, _ = gpt_loss(params, batch["tokens"][i],
                               batch["labels"][i], batch["loss_mask"][i],
                               self.cfg, segment_ids=None
                               if "segment_ids" not in batch
                               else batch["segment_ids"][i], ctx=self.ctx)
            total = loss if total is None else total + loss
        return float(total * (1.0 / num_micro))

    # -- the param stream ----------------------------------------------------
    def stream_params(self) -> None:
        """The backward rank's flat params to its twin (the forward rank
        receives them into its own flat buffer, in place)."""
        t0 = time.perf_counter()
        if self.backward:
            collectives.twin_hop(self.ctx, send=self.layout.params,
                                 kind="fbd-params")
        else:
            collectives.twin_hop(self.ctx, recv_into=self.layout.params,
                                 kind="fbd-params")
        self.stream_s.append(time.perf_counter() - t0)

    def agree(self, values: List[float]) -> List[float]:
        """The backward lead's `values` on every rank of the world (one
        all-gather; the other ranks pass theirs, which are ignored)."""
        mine = torch.tensor(values, dtype=torch.float64)
        if not (self.backward and self.ctx.is_lead):
            mine.zero_()
        every = collectives.all_gather_cat(mine[None], self.ctx, "fbd", 0)
        return every.sum(dim=0).tolist()

    # -- one step ------------------------------------------------------------
    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One disaggregated step over this rank's dp rows of the
        [num_micro, mb, S] batch; the metrics (module docstring), the same
        on every rank."""
        sent0 = collectives.traffic.get("send/fbd", {}).get("bytes", 0)
        if self.backward:
            got = self._train_step(self.state, batch)
            fwd_share = 0.0
        else:
            got = dict.fromkeys(_BWD_KEYS, 0.0)
            fwd_share = self._forward(batch)
            self.state.step += 1
        self.stream_params()
        shipped = collectives.traffic.get("send/fbd", {}).get(
            "bytes", 0) - sent0
        mine = torch.tensor(
            [float(got[k]) if self.backward and self.ctx.is_lead else 0.0
             for k in _BWD_KEYS]
            + [fwd_share if not self.backward and self.ctx.tp_rank == 0
               else 0.0, float(shipped)], dtype=torch.float64)
        every = collectives.all_gather_cat(mine[None], self.ctx, "fbd", 0)
        total = every.sum(dim=0).tolist()
        out = dict(zip(_BWD_KEYS, total))
        out["skipped"] = int(out["skipped"])
        out["fwd_loss"] = total[len(_BWD_KEYS)]
        self.shipped_bytes = int(total[-1])
        out["shipped_bytes"] = self.shipped_bytes
        return out
