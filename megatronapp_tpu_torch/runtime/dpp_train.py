"""MegaDPP in the training path: a host-driven forward + backward GPT step
through ``DppPipelineRunner.run_train`` (the JAX package's
runtime/dpp_train.py).

The reference starts its dynamic transport inside ``pretrain_body``
(training.py:746-783): MegaDPP is a property of training runs.
``make_dpp_train_step`` is the trainer's step under ``--use-dpp`` at pp >
1 and tp 1 (training/train.py): per-stage devices and streams,
readiness-ordered transfers, and a backward sweep through the same
scheduler in reverse topology.

Layout: a [pp][dp] grid of stage devices, one process (JAX's single
controller). Each dp replica runs its own pipeline over its column, on
its shard of every microbatch, in a thread of its own; replica r's stage
s is its own (device, stream) pair. ``stage_devices`` places stage (s,
r) on the visible cards round-robin (index s · dp + r), so on a
one-card machine every stage shares ``cuda:0`` on streams of their own,
and in the tests every stage is the CPU. **Departure from JAX:** JAX
infers dp from the devices of its mesh; here dp is ParallelConfig's
``data_parallel`` (default 1), since one card would otherwise give dp 1.

Params are the one-device model's (training/train.py's state, so
checkpoints and resumes are the one-device trainer's): chunk (s, c) is
the layers of global ids (c · pp + s) · Lc .. + Lc (spmd_pipeline's
layer offset). A chunk's "vjp" is its (detached input, output) pair;
the backward calls ``torch.autograd.grad(y, (h_in, *chunk_params), g)``
and per-(stage, chunk) grads sum over microbatches. The embedding runs
on the first stage and the head on the last, a microbatch at a time
against the replica's mask count. Combine weights ride the cotangent
seeds (``ce_seed = w_r / W``, w_r the replica's mask-token count;
``aux_seed = 1 / dp``), so replica grads plain-sum and a fully masked
shard contributes nothing but its aux term. MoE layers under the DPP
runtime are not ported yet (ROADMAP.md Queue 1 item 4, MoE under pp, cp,
FBD, DPP, MTP and serve-tp) and raise, so the aux term is 0 here; its
seed is kept. MTP and packed segments raise JAX's messages.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from megatronapp_tpu_torch.config.parallel_config import moe_unported

from megatronapp_tpu_torch.runtime.dpp import DppPipelineRunner

_MTP = ("the DPP runtime step does not support multi-token prediction "
        "yet; drop --mtp-num-layers or --use-dpp")
_PACKED = ("the DPP runtime step does not support packed segments "
           "yet; unpack the batch or drop --use-dpp")


def _device_grid(devices) -> List[List[torch.device]]:
    """Normalize to [pp][dp]: a flat sequence means dp=1."""
    arr = np.asarray(devices, dtype=object)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2:
        raise ValueError(f"devices must be [pp] or [pp][dp], got shape "
                         f"{arr.shape}")
    return [[torch.device(d) for d in row] for row in arr]


def stage_devices(pp: int, dp: int = 1, device=None
                  ) -> List[List[torch.device]]:
    """The [pp][dp] stage grid: stage (s, r) on cuda:((s · dp + r) % the
    visible cards), or every stage on the CPU when device is "cpu"
    (device None means the card; raises without one)."""
    from megatronapp_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [[dev] * dp for _ in range(pp)]
    n = torch.cuda.device_count()
    return [[torch.device("cuda", (s * dp + r) % n) for r in range(dp)]
            for s in range(pp)]


def _place(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A param as an autograd leaf on `dev`: itself when it lives there,
    else a copy."""
    if t.device == dev:
        return t
    return t.detach().to(dev).requires_grad_()


class _Model:
    """The one-device params seen as DPP stages (module docstring):
    per-(stage, chunk) layer lists on a replica's devices, and the
    embedding's and the head's leaves on its first and last stage."""

    def __init__(self, params, pp: int, vpp: int, rdevs):
        from megatronapp_tpu_torch.parallel.sharding import stage_layer_ids
        layers = params["layers"]
        lc = len(layers) // (pp * vpp)
        self.chunks = []          # [stage][chunk] -> (ids, modules)
        for st in range(pp):
            stage_ids = stage_layer_ids(len(layers), pp, vpp, st)
            row = []
            for c in range(vpp):
                ids = stage_ids[c * lc:(c + 1) * lc]
                mods = [layers[i] if next(layers[i].parameters()).device
                        == rdevs[st] else
                        copy.deepcopy(layers[i]).to(rdevs[st])
                        .requires_grad_() for i in ids]
                row.append((ids, mods))
            self.chunks.append(row)
        emb = params["embedding"]
        self.embed = {n: _place(t, rdevs[0]) for n, t in
                      emb.named_parameters()}
        self.head: Dict[str, torch.Tensor] = {}
        for n in ("final_ln_scale", "final_ln_bias", "output"):
            if n in params:
                self.head[n] = _place(params[n], rdevs[-1])
        if "output" not in params:
            self.head["embedding.word"] = _place(emb["word"], rdevs[-1])

    def chunk_leaves(self, st: int, c: int) -> List[Tuple[str, Any]]:
        ids, mods = self.chunks[st][c]
        return [(f"layers.{i}.{n}", t) for i, m in zip(ids, mods)
                for n, t in m.named_parameters()]

    def head_tree(self) -> dict:
        tree = {k: v for k, v in self.head.items() if "." not in k}
        if "embedding.word" in self.head:
            tree["embedding"] = {"word": self.head["embedding.word"]}
        return tree

    def embed_tree(self) -> dict:
        return {"embedding": self.embed}


def _split(batch_mb, dp: int):
    """(tokens, labels, mask or None, the replicas' row slices)."""
    if batch_mb.get("segment_ids") is not None:
        raise NotImplementedError(_PACKED)
    tokens = batch_mb["tokens"]
    m, mb, s = tokens.shape
    if mb % dp:
        raise ValueError(
            f"per-microbatch batch {mb} not divisible by dp={dp} "
            "under the DPP runtime")
    shard = mb // dp
    return (tokens, batch_mb["labels"], batch_mb.get("loss_mask"),
            [slice(r * shard, (r + 1) * shard) for r in range(dp)])


def _run_replicas(dp: int, fn: Callable[[int], Any]) -> List[Any]:
    """fn(r) for every replica, each in a thread of its own (dp > 1)."""
    results: List[Any] = [None] * dp
    errors: List[BaseException] = []

    def run_replica(r):
        try:
            results[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(RuntimeError(f"DPP replica {r} failed: {e!r}"))
            errors[-1].__cause__ = e

    if dp == 1:
        run_replica(0)
    else:
        ts = [threading.Thread(target=run_replica, args=(r,), daemon=True)
              for r in range(dp)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    if errors:
        raise errors[0]
    return results


class _Streams:
    """One stream a (stage, replica) on a card, kept across steps."""

    def __init__(self, grid):
        self.grid = grid
        self._streams: Dict[Tuple[int, int], Any] = {}

    def column(self, r: int) -> list:
        out = []
        for st, row in enumerate(self.grid):
            dev = row[r]
            if dev.type != "cuda":
                out.append(None)
                continue
            if (st, r) not in self._streams:
                self._streams[(st, r)] = torch.cuda.Stream(device=dev)
            out.append(self._streams[(st, r)])
        return out


def _ctx(stream):
    from megatronapp_tpu_torch.runtime.dpp import _stream_ctx
    return _stream_ctx(stream)


def _drain(devices, streams=()) -> None:
    """The calling thread's stream on each card of `devices`, and
    `streams`, drained on the host: work one stream issued is complete
    before another stream (or the caller) reuses its tensors or their
    memory (runtime/dpp.py's phase boundary, at a step's edges)."""
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
    for st in streams:
        if st is not None:
            st.synchronize()


def make_dpp_gpt_value_and_grad(cfg, devices, vpp: int = 1,
                                policy: str = "dfc", dynamic: bool = True,
                                n_buffers: int = 4, jitter=None):
    """Build vg(params, batch_mb) -> (loss, grads, metrics, runners).

    batch_mb: {'tokens','labels','loss_mask': [M, mb, S]} tensors. params
    is the one-device GPT ParamTree (trainable). devices: [pp] stage
    devices, or [pp][dp] for data-parallel replicas (each column runs one
    pipeline on its batch shard). grads: {param name: tensor} on the
    params' device; loss and metrics 0-d tensors there. jitter: {(stage,
    chunk): seconds} slept before each of that chunk's forwards (a
    straggling stage, for the A/B of dynamic against static order)."""
    from megatronapp_tpu_torch.models.gpt import (
        gpt_embed, gpt_head, gpt_rope_tables,
    )
    from megatronapp_tpu_torch.ops.cross_entropy import cross_entropy_loss
    from megatronapp_tpu_torch.transformer.block import block_forward

    if getattr(cfg, "mtp_num_layers", 0):
        raise NotImplementedError(_MTP)
    if cfg.is_moe:
        raise NotImplementedError(moe_unported("MoE under MegaDPP (--use-dpp)"))
    grid = _device_grid(devices)
    pp, dp = len(grid), len(grid[0])
    streams = _Streams(grid)
    rope_cache: Dict[Tuple[int, torch.device], Tuple[Any, Any]] = {}
    rope_lock = threading.Lock()

    def rope(s: int, dev: torch.device):
        with rope_lock:
            if (s, dev) not in rope_cache:
                rope_cache[(s, dev)] = gpt_rope_tables(cfg, s, dev)
            return rope_cache[(s, dev)]

    def _replica_vg(params, tokens_mb, targets_mb, loss_mask_mb,
                    rdevs, rstreams, count: float, ce_seed: float,
                    aux_seed: float):
        """One data-parallel replica's full fwd+bwd on its pp devices.

        Returns (ce, aux, {name: grad} on the params' device, runner).
        The combine weights ride the cotangent SEEDS — ce_seed = w_r/W
        (this replica's mask-token share) on the head loss, aux_seed =
        1/dp on every chunk's aux output — so the caller combines
        gradient trees by PLAIN SUM (module docstring)."""
        m, mb, s = tokens_mb.shape
        pdev = next(params.parameters()).device
        if rdevs[0].type == "cuda":
            torch.cuda.set_device(rdevs[0])
        model = _Model(params, pp, vpp, rdevs)
        embed_leaves = list(model.embed.items())
        head_leaves = list(model.head.items())

        # Embedding on the first stage device.
        with _ctx(rstreams[0]), torch.enable_grad():
            h_flat = gpt_embed(model.embed_tree(),
                               tokens_mb.to(rdevs[0]).reshape(m * mb, s),
                               cfg)
        h_mb = h_flat.reshape(m, mb, s, -1)
        aux_parts: List[torch.Tensor] = []

        def chunk_vjp_fn(stage, c, h, m_idx):
            if jitter and (stage, c) in jitter:
                # A straggling stage (the dynamic-vs-static A/B).
                time.sleep(jitter[(stage, c)])
            ids, mods = model.chunks[stage][c]
            leaves = [t for _, t in model.chunk_leaves(stage, c)]
            cos, sin = rope(s, rdevs[stage])
            x = h.detach().requires_grad_()
            with torch.enable_grad():
                y, a = block_forward(mods, x, cfg, cos, sin,
                                     layer_ids=ids)
            aux_parts.append(a.detach())

            def vjp(g_y):
                outs, seeds = [y], [g_y]
                if a.requires_grad:
                    # Each chunk's aux loss enters the total as
                    # aux_sum / (M · dp).
                    outs.append(a)
                    seeds.append(torch.tensor(aux_seed / m,
                                              dtype=a.dtype,
                                              device=a.device))
                got = torch.autograd.grad(outs, [x] + leaves, seeds,
                                          allow_unused=True)
                dparams = [torch.zeros_like(t) if g is None else g
                           for t, g in zip(leaves, got[1:])]
                return dparams, got[0]

            return y, vjp

        loss_box: Dict[str, Any] = {}

        def seed_grads_fn(outputs):
            # The head on the last stage device, a microbatch at a time
            # against this replica's mask count.
            dev = rdevs[-1]
            targets = targets_mb.to(dev)
            mask = None if loss_mask_mb is None else loss_mask_mb.to(dev)
            denom = torch.tensor(max(count, 1.0), dtype=torch.float32,
                                 device=dev)
            tree = model.head_tree()
            head_ts = [t for _, t in head_leaves]
            g_head = None
            ce = torch.zeros((), dtype=torch.float32, device=dev)
            g_outs = []
            with _ctx(rstreams[-1]), torch.enable_grad():
                for i in range(m):
                    o = outputs[i].detach().requires_grad_()
                    logits = gpt_head(tree, o, cfg)
                    ce_i, _ = cross_entropy_loss(
                        logits, targets[i], None if mask is None
                        else mask[i], count=denom)
                    got = torch.autograd.grad(
                        ce_i, [o] + head_ts,
                        torch.tensor(ce_seed, dtype=ce_i.dtype,
                                     device=dev), allow_unused=True)
                    g_outs.append(got[0])
                    gh = [torch.zeros_like(t) if g is None else g
                          for t, g in zip(head_ts, got[1:])]
                    g_head = gh if g_head is None else [
                        a + b for a, b in zip(g_head, gh)]
                    ce = ce + ce_i.detach()
                    del logits, ce_i
            loss_box["ce"] = ce
            loss_box["g_head"] = g_head
            return g_outs, None

        runner = DppPipelineRunner(
            None, rdevs, pp, vpp, m, policy=policy, dynamic=dynamic,
            n_buffers=n_buffers, streams=rstreams)
        _, block_grads, input_grads, _ = runner.run_train(
            [h_mb[i].detach() for i in range(m)], chunk_vjp_fn,
            seed_grads_fn)

        # Embedding grad: chain the input cotangents into the lookup.
        with _ctx(rstreams[0]):
            dh = torch.stack([g.to(rdevs[0]) for g in input_grads])
            g_embed = torch.autograd.grad(
                h_flat, [t for _, t in embed_leaves],
                dh.reshape(h_flat.shape), allow_unused=True)
        # Every stage stream's work done before the caller's stream reads.
        _drain(rdevs + [pdev], rstreams)
        grads: Dict[str, torch.Tensor] = {}

        def add(name, g):
            g = g.to(pdev)
            grads[name] = g if name not in grads else grads[name] + g

        for st in range(pp):
            for c in range(vpp):
                for (name, _), g in zip(model.chunk_leaves(st, c),
                                        block_grads[(st, c)]):
                    add(name, g)
        for (name, t), g in zip(embed_leaves, g_embed):
            add(f"embedding.{name}", torch.zeros_like(t) if g is None
                else g)
        for (name, _), g in zip(head_leaves, loss_box["g_head"]):
            add(name, g)
        aux = (sum(a.to(pdev) for a in aux_parts) / m if aux_parts
               else torch.zeros((), device=pdev))
        return loss_box["ce"].to(pdev), aux, grads, runner

    def vg(params, batch_mb):
        tokens_mb, targets_mb, loss_mask_mb, sls = _split(batch_mb, dp)
        m, mb, s = tokens_mb.shape
        shard = mb // dp
        _drain([d for row in grid for d in row])
        # Mask-token weights: the pipelined CE is a masked mean over the
        # GLOBAL batch, which decomposes exactly as sum_r w_r*ce_r /
        # sum_r w_r with w_r the replica's mask sum.
        if loss_mask_mb is not None:
            w = [float(loss_mask_mb[:, sl].float().sum()) for sl in sls]
        else:
            w = [float(m * shard * s)] * dp
        W = sum(w) or 1.0

        def replica(r):
            return _replica_vg(
                params, tokens_mb[:, sls[r]], targets_mb[:, sls[r]],
                None if loss_mask_mb is None else loss_mask_mb[:, sls[r]],
                [grid[st][r] for st in range(pp)], streams.column(r),
                count=w[r], ce_seed=w[r] / W, aux_seed=1.0 / dp)

        results = _run_replicas(dp, replica)
        ce = sum((w[r] / W) * results[r][0] for r in range(dp))
        aux = sum(results[r][1] for r in range(dp)) / dp
        # Plain sum: the combine weights already rode the cotangent
        # seeds (ce_seed/aux_seed), so loss and gradients stay
        # consistent even for a fully masked shard.
        grads = {}
        for n, _ in params.named_parameters():
            parts = [res[2][n] for res in results if n in res[2]]
            grads[n] = (parts[0] if len(parts) == 1 else sum(parts)) \
                if parts else torch.zeros_like(dict(
                    params.named_parameters())[n])
        runners = [res[3] for res in results]
        loss = ce + aux
        metrics = {"lm_loss": ce, "moe_aux_loss": aux}
        return loss, grads, metrics, runners

    return vg


def make_dpp_eval_step(cfg, devices, vpp: int = 1, policy: str = "dfc",
                       dynamic: bool = True, n_buffers: int = 4):
    """The forward-only loss through ``DppPipelineRunner.run`` (the
    trainer's evaluation under --use-dpp): the token mean over every
    microbatch and replica, as the pipelined eval step's, as a 0-d fp32
    tensor on the params' device. eval_step(state, batch)."""
    from megatronapp_tpu_torch.models.gpt import (
        gpt_embed, gpt_head, gpt_rope_tables,
    )
    from megatronapp_tpu_torch.ops.cross_entropy import cross_entropy_loss
    from megatronapp_tpu_torch.transformer.block import block_forward

    if getattr(cfg, "mtp_num_layers", 0):
        raise NotImplementedError(_MTP)
    if cfg.is_moe:
        raise NotImplementedError(moe_unported("MoE under MegaDPP (--use-dpp)"))
    grid = _device_grid(devices)
    pp, dp = len(grid), len(grid[0])
    streams = _Streams(grid)

    @torch.no_grad()
    def eval_step(state, batch):
        params = state.params
        tokens_mb, targets_mb, mask_mb, sls = _split(batch, dp)
        m, mb, s = tokens_mb.shape
        pdev = next(params.parameters()).device
        _drain([d for row in grid for d in row])
        count = torch.tensor(float(tokens_mb.numel()) if mask_mb is None
                             else float(mask_mb.float().sum()),
                             dtype=torch.float32).clamp(min=1.0)

        def replica(r):
            rdevs = [grid[st][r] for st in range(pp)]
            rstreams = streams.column(r)
            model = _Model(params, pp, vpp, rdevs)

            def chunk_fn(stage, c, h, _m):
                ids, mods = model.chunks[stage][c]
                cos, sin = gpt_rope_tables(cfg, s, rdevs[stage])
                with torch.no_grad():
                    return block_forward(mods, h, cfg, cos, sin,
                                         layer_ids=ids)[0]

            with _ctx(rstreams[0]):
                h = gpt_embed(model.embed_tree(), tokens_mb[:, sls[r]].to(
                    rdevs[0]).reshape(-1, s), cfg).reshape(
                        m, -1, s, cfg.hidden_size)
            runner = DppPipelineRunner(
                chunk_fn, rdevs, pp, vpp, m, policy=policy,
                dynamic=dynamic, n_buffers=n_buffers, streams=rstreams)
            outs = runner.run([h[i] for i in range(m)])
            dev = rdevs[-1]
            total = torch.zeros((), dtype=torch.float32, device=dev)
            with _ctx(rstreams[-1]):
                for i in range(m):
                    logits = gpt_head(model.head_tree(), outs[i], cfg)
                    loss_i, _ = cross_entropy_loss(
                        logits, targets_mb[i, sls[r]].to(dev),
                        None if mask_mb is None
                        else mask_mb[i, sls[r]].to(dev),
                        count=count.to(dev))
                    total = total + loss_i
            out = total.to(pdev)
            _drain(rdevs + [pdev], rstreams)
            return out

        return sum(_run_replicas(dp, replica))

    return eval_step


def make_dpp_train_step(optimizer, opt_cfg, cfg, devices, train_iters: int,
                        vpp: int = 1, policy: str = "dfc",
                        dynamic: bool = True, check_nan: bool = True,
                        jitter=None):
    """The trainer's step when the DPP runtime drives pp (× dp): the
    value-and-grad half runs host-driven through the dynamic scheduler;
    the update is training/train_step.py's (the same NaN gate, global
    grad norm, lr schedule and metrics contract). optimizer: the
    one-device training/optimizer.py ``Optimizer``. Returns step(state,
    batch) -> metrics (host floats); the state is updated in place, as
    the port's make_train_step does."""
    from megatronapp_tpu_torch.training.optimizer import (
        global_norm, lr_schedule,
    )
    from megatronapp_tpu_torch.training.train_step import named_trainable

    sched = lr_schedule(opt_cfg, train_iters)
    vg = make_dpp_gpt_value_and_grad(cfg, devices, vpp=vpp, policy=policy,
                                     dynamic=dynamic, jitter=jitter)

    def step(state, batch) -> Dict[str, float]:
        import math

        from megatronapp_tpu_torch.trace.tracer import get_tracer
        tracer = get_tracer()
        tracing = tracer.enabled and tracer.active
        t0 = time.perf_counter()
        anchor = tracer.now_in_iteration_us() if tracing else None
        loss, grads, aux, runners = vg(state.params, batch)
        if tracing:
            # Per-(chunk, mb) compute/transfer spans on per-stage
            # timelines — MegaScan sees the DPP transport like the
            # reference's tracer sees its shm/RDMA sends. Replica r's
            # stage rows land on pids 5000+100r+stage.
            for r, runner in enumerate(runners):
                tracer.add_collective_records(
                    runner.trace_events(t0, pid_base=5000 + 100 * r),
                    offset_us=anchor)
        params = named_trainable(state.params)
        norm = global_norm(grads.values())
        names = list(aux)
        host = torch.stack([loss.float(), norm] + [
            aux[k].float() for k in names]).tolist()
        loss_h, norm_h = host[0], host[1]
        finite = math.isfinite(loss_h) and math.isfinite(norm_h)
        skipped = check_nan and not finite
        if not skipped:
            optimizer.update(params, grads, state.opt_state,
                             (norm_h, norm))
        del grads
        metrics = {
            "loss": loss_h, "grad_norm": norm_h,
            "lr": float(sched(state.step)), "skipped": int(skipped),
            **dict(zip(names, host[2:])),
            # Scheduler observables, per phase, summed over replicas:
            # downstream input wait is the stall DPP ordering removes.
            "dpp_fwd_compute_wait_s": sum(
                sum(ru.fwd_metrics["compute_wait_s"][1:])
                for ru in runners),
            "dpp_bwd_compute_wait_s": sum(
                sum(ru.bwd_metrics["compute_wait_s"][:-1])
                for ru in runners),
        }
        state.step += 1
        return metrics

    return step
