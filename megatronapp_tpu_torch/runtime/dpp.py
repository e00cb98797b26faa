"""MegaDPP's dynamic runtime: readiness-ordered transfers between
pipeline stages (the JAX package's runtime/dpp.py).

The static schedules of parallel/pipeline.py commit to one send order
('dfc' / 'bfc'); the reference also runs background sender threads that
ship whichever finished (chunk, microbatch) ranks highest in DFC / BFC
priority (shm_tensor_new_rdma.cpp:1478-1646, forward_send /
backward_send), through a bounded pool of pre-allocated buffers
(shm_tensor_new_rdma_pre_alloc.cpp:126-205). This module keeps JAX's
names, metrics and messages: ``send_priority``, ``static_order``,
``TransferPool``, ``_Mailbox`` and ``DppPipelineRunner`` (``run``,
``run_train``, ``_phase_metrics``, ``trace_events``).

One process drives every stage, as JAX's single controller does: per
stage a compute thread and a sender thread. On a card:

- each stage's compute thread issues its work under its own
  ``torch.cuda.Stream`` (the runner's ``streams``), so two stages can
  overlap on one card; an item is ready when an event recorded on that
  stream after its work has completed (the compute thread waits on it,
  where JAX calls ``jax.block_until_ready``), so readiness means
  finished on the device, not merely issued, and the sender's stall and
  ship times are taken after it;
- a hop makes the receiving stage's stream wait on that event, then
  copies the tensor into a fresh buffer on the receiving stage's device
  on that stream (``record_stream`` keeps the source alive for the
  copy), and waits for the copy's own event before the receiver sees it
  (JAX's ``device_put`` + ``block_until_ready``). A slot of the sending
  stage's ``TransferPool`` is held for the whole hop, as in JAX: the
  pool bounds the transfers in flight, and the caching allocator
  recycles the buffers' memory;
- each phase starts and ends by synchronizing the calling thread's
  stream and every stage stream, so tensors handed between the caller
  and the stage threads (seeds, outputs, grads) are complete, and no
  block freed by one stream's work is reused under work still pending
  on another.

On the CPU the streams and events are absent and the hop is a copy.
Python threads suit the runtime: kernel launches, event waits and
copies release the GIL.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "send_priority", "static_order", "TransferPool", "DppPipelineRunner",
]


def send_priority(chunk: int, mb: int, pp: int, vpp: int,
                  policy: str = "dfc") -> Tuple[int, ...]:
    """Priority key for a finished (chunk, microbatch) activation — lower
    ships first. Mirrors the reference forward_send traversal of the
    (chunk, microbatch) matrix (shm_tensor_new_rdma.cpp:1487-1510):

    - 'dfc' (depth-first-chunk): rounds of pp microbatches; within a
      round, all chunks before the next round — the interleaved-schedule
      order (round, chunk, position).
    - 'bfc' (breadth-first-chunk): all microbatches of chunk c before
      chunk c+1 (chunk, mb).
    """
    if policy == "dfc":
        return (mb // pp, chunk, mb % pp)
    if policy == "bfc":
        return (chunk, mb)
    raise ValueError(f"unknown DPP order policy {policy!r}")


def static_order(pp: int, vpp: int, num_microbatches: int,
                 policy: str = "dfc") -> List[Tuple[int, int]]:
    """The full (chunk, mb) send order a static scheduler commits to."""
    items = [(c, m) for c in range(vpp) for m in range(num_microbatches)]
    items.sort(key=lambda cm: send_priority(cm[0], cm[1], pp, vpp, policy))
    return items


class TransferPool:
    """Bounded pool of transfer slots (the reference's NUM_GPU_BUFFERS
    pre-allocated staging buffers with ready/expired queues,
    shm_tensor_new_rdma_pre_alloc.cpp:126-205). A sender must hold a slot
    for the duration of a transfer; acquisition stall time is recorded —
    it is the backpressure signal the dynamic scheduler reacts to."""

    def __init__(self, n_buffers: int = 4):
        self._sem = threading.Semaphore(n_buffers)
        self._lock = threading.Lock()
        self.stall_s = 0.0
        self.acquisitions = 0

    def acquire(self) -> None:
        t0 = time.perf_counter()
        self._sem.acquire()
        dt = time.perf_counter() - t0
        with self._lock:
            self.stall_s += dt
            self.acquisitions += 1

    def release(self) -> None:
        self._sem.release()


class _Mailbox:
    """Arrival table keyed by (chunk, mb) with blocking pop."""

    def __init__(self):
        self._cv = threading.Condition()
        self._items: Dict[Tuple[int, int], Any] = {}

    def put(self, key: Tuple[int, int], value: Any) -> None:
        with self._cv:
            self._items[key] = value
            self._cv.notify_all()

    def pop(self, key: Tuple[int, int], timeout: float = 120.0) -> Any:
        with self._cv:
            ok = self._cv.wait_for(lambda: key in self._items, timeout)
            if not ok:
                raise TimeoutError(f"activation {key} never arrived")
            return self._items.pop(key)

    def pop_best(self, keyfn, timeout: float = 120.0
                 ) -> Tuple[Tuple[int, int], Any]:
        """Pop the minimum-priority available item (dynamic readiness
        scan, reference forward_send:1487-1520)."""
        with self._cv:
            ok = self._cv.wait_for(lambda: bool(self._items), timeout)
            if not ok:
                raise TimeoutError("no activation became ready")
            key = min(self._items, key=keyfn)
            return key, self._items.pop(key)


def _stream_ctx(stream):
    """The stream's context on a card; a no-op on the CPU."""
    import contextlib
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _ready(stream) -> Optional["torch.cuda.Event"]:
    """An event after the work issued so far on `stream`, waited for on
    the host (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    ev.synchronize()
    return ev


class DppPipelineRunner:
    """Host-driven interleaved pipeline with dynamic send ordering.

    chunk_fn(stage, chunk, h, mb) -> h' runs one model chunk of one
    microbatch on ``devices[stage]``. The runner executes the full
    vpp-interleaved forward: (stage s, chunk c) feeds (s+1, c) or wraps
    (pp-1, c) → (0, c+1); chunk vpp-1 leaving stage pp-1 is an output.

    Per stage, a compute thread consumes arrivals and a sender thread
    ships finished activations — in readiness-first priority order
    (``dynamic=True``) or strict static order — through a bounded
    TransferPool per link. streams: one ``torch.cuda.Stream`` a stage
    (made on its device when None and the device is a card; module
    docstring). Metrics collected per run:
      transfer_order[stage]  — (chunk, mb) in actual ship order
      sender_stall_s[stage]  — time the sender spent waiting for work
      pool_stall_s[stage]    — time blocked on the bounded buffer pool
      compute_wait_s[stage]  — time the compute loop starved for inputs
                               (the downstream stall DPP reordering cuts)
    """

    def __init__(self, chunk_fn: Callable[[int, int, Any, int], Any],
                 devices: Sequence[Any], pp: int, vpp: int,
                 num_microbatches: int, policy: str = "dfc",
                 dynamic: bool = True, n_buffers: int = 4,
                 join_timeout_s: Optional[float] = None,
                 streams: Optional[Sequence[Any]] = None):
        if len(devices) < pp:
            raise ValueError(f"need {pp} devices, got {len(devices)}")
        self.chunk_fn = chunk_fn
        self.devices = [torch.device(d) for d in devices[:pp]]
        self.pp, self.vpp, self.M = pp, vpp, num_microbatches
        self.policy, self.dynamic = policy, dynamic
        self.n_buffers = n_buffers
        if streams is None:
            streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                       else None for d in self.devices]
        self.streams = list(streams[:pp])
        # Per-phase thread-join budget: constructor arg, else the
        # MEGATRON_DPP_JOIN_TIMEOUT_S env (big models on slow hosts
        # legitimately exceed the default), else 300 s.
        if join_timeout_s is None:
            join_timeout_s = float(os.environ.get(
                "MEGATRON_DPP_JOIN_TIMEOUT_S", "300"))
        self.join_timeout_s = join_timeout_s
        # Per-run state (populated by run()).
        self.transfer_order: List[List[Tuple[int, int]]] = []
        self.sender_stall_s: List[float] = []
        self.pool_stall_s: List[float] = []

    # -- topology -----------------------------------------------------

    def _next_hop(self, stage: int, chunk: int
                  ) -> Optional[Tuple[int, int]]:
        """(stage, chunk) an activation flows to next, or None if it is a
        pipeline output."""
        if stage < self.pp - 1:
            return stage + 1, chunk
        if chunk < self.vpp - 1:
            return 0, chunk + 1
        return None

    def _prev_hop(self, stage: int, chunk: int
                  ) -> Optional[Tuple[int, int]]:
        """Reverse topology for the backward pass: where the gradient of
        (stage, chunk)'s INPUT flows — the producer of that input — or
        None for (0, 0), whose dh is a grad w.r.t. the pipeline seed
        (reference backward_send direction,
        shm_tensor_new_rdma.cpp:1550-1646)."""
        if stage > 0:
            return stage - 1, chunk
        if chunk > 0:
            return self.pp - 1, chunk - 1
        return None

    # -- execution ----------------------------------------------------

    def _sync(self) -> None:
        """The calling thread's stream and every stage stream drained
        (the phase boundary of the module docstring)."""
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.current_stream(dev).synchronize()
        for st in self.streams:
            if st is not None:
                st.synchronize()

    def _hop(self, h: torch.Tensor, ev, stage: int) -> torch.Tensor:
        """h (ready at event ev) copied into a buffer on `stage`'s
        device, on its stream (module docstring)."""
        st = self.streams[stage]
        with _stream_ctx(st):
            if st is not None:
                st.wait_event(ev)
                if h.device.type == "cuda":
                    h.record_stream(st)
            buf = torch.empty(h.shape, dtype=h.dtype,
                              device=self.devices[stage])
            buf.copy_(h, non_blocking=st is not None)
        _ready(st)
        return buf

    def _pipeline_phase(self, seeds: Dict[Tuple[int, int], Any],
                        seed_stage: int,
                        exec_fn: Callable[[int, int, Any, int], Any],
                        next_hop: Callable[[int, int],
                                           Optional[Tuple[int, int]]],
                        keyfn: Callable[[Tuple[int, int]], Tuple],
                        plan: List[Tuple[int, int]]) -> Dict[int, Any]:
        """One scheduled pipeline sweep (forward OR backward — the
        reference runs the same sender machinery in both directions).

        seeds {(chunk, mb): value} enter ``seed_stage``'s inbox;
        ``exec_fn(stage, chunk, value, mb)`` computes; finished values
        ship along ``next_hop`` — readiness-first under ``keyfn`` when
        dynamic, strict ``plan`` order otherwise — through a bounded
        TransferPool per link. Items whose hop is None are collected
        into the returned {mb: value}. Per-phase metrics land on
        ``self`` (transfer_order, ship_time_s, sender_stall_s,
        compute_wait_s, pool_stall_s, wall_s)."""
        pp, vpp, M = self.pp, self.vpp, self.M
        inboxes = [_Mailbox() for _ in range(pp)]       # compute inputs
        finished = [_Mailbox() for _ in range(pp)]      # awaiting send
        pools = [TransferPool(self.n_buffers) for _ in range(pp)]
        outputs: Dict[int, Any] = {}
        out_lock = threading.Lock()
        errors: List[BaseException] = []
        sender_stall = [0.0] * pp
        compute_wait = [0.0] * pp
        order_log: List[List[Tuple[int, int]]] = [[] for _ in range(pp)]
        # Per-(chunk, mb) ship timestamps relative to run start: the
        # direct observable for head-of-line blocking (a static sender
        # ships ready work late; see tests/test_torch_dpp.py).
        ship_log: List[Dict[Tuple[int, int], float]] = [
            {} for _ in range(pp)]
        # Absolute (perf_counter) compute/transfer windows per
        # (chunk, mb) — the raw material for MegaScan trace events
        # (trace_events(); the reference's tracer sees its shm/RDMA
        # sends the same way).
        compute_spans: List[Dict[Tuple[int, int], Tuple[float, float]]] = [
            {} for _ in range(pp)]
        send_spans: List[Dict[Tuple[int, int], Tuple[float, float]]] = [
            {} for _ in range(pp)]
        for (c, m), h in seeds.items():
            if h.device != self.devices[seed_stage]:
                h = h.to(self.devices[seed_stage])
            inboxes[seed_stage].put((c, m), h)
        self._sync()
        t_run0 = time.perf_counter()

        def on_device(stage: int):
            # A new thread has no current CUDA context of its own.
            if self.devices[stage].type == "cuda":
                torch.cuda.set_device(self.devices[stage])

        def compute_loop(stage: int):
            try:
                on_device(stage)
                n_items = vpp * M
                for _ in range(n_items):
                    # Compute follows readiness in priority order too (the
                    # schedule order when nothing is late).
                    t0 = time.perf_counter()
                    (c, m), h = inboxes[stage].pop_best(keyfn)
                    t1 = time.perf_counter()
                    compute_wait[stage] += t1 - t0
                    with _stream_ctx(self.streams[stage]):
                        h = exec_fn(stage, c, h, m)
                    ev = _ready(self.streams[stage])
                    compute_spans[stage][(c, m)] = (
                        t1, time.perf_counter() - t1)
                    finished[stage].put((c, m), (h, ev))
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        def sender_loop(stage: int):
            try:
                on_device(stage)
                for i in range(len(plan)):
                    t0 = time.perf_counter()
                    if self.dynamic:
                        (c, m), (h, ev) = finished[stage].pop_best(keyfn)
                    else:
                        c, m = plan[i]           # strict static order:
                        h, ev = finished[stage].pop((c, m))  # block on it
                    sender_stall[stage] += time.perf_counter() - t0
                    order_log[stage].append((c, m))
                    ship_log[stage][(c, m)] = time.perf_counter() - t_run0
                    hop = next_hop(stage, c)
                    if hop is None:
                        with out_lock:
                            outputs[m] = h
                        continue
                    nxt_stage, nxt_chunk = hop
                    pools[stage].acquire()
                    t_send = time.perf_counter()
                    try:
                        h = self._hop(h, ev, nxt_stage)
                    finally:
                        send_spans[stage][(c, m)] = (
                            t_send, time.perf_counter() - t_send)
                        pools[stage].release()
                    inboxes[nxt_stage].put((nxt_chunk, m), h)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = []
        for s in range(pp):
            threads.append(threading.Thread(target=compute_loop, args=(s,),
                                            daemon=True,
                                            name=f"dpp-compute-{s}"))
            threads.append(threading.Thread(target=sender_loop, args=(s,),
                                            daemon=True,
                                            name=f"dpp-sender-{s}"))
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        deadline = time.perf_counter() + self.join_timeout_s
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        timed_out = [t.name for t in threads if t.is_alive()]
        self.wall_s = time.perf_counter() - t_start
        if errors:
            raise errors[0]
        if timed_out:
            # Distinct from "output genuinely missing" below: the phase is
            # still RUNNING (deadlock or slow host), not silently done-
            # but-short. Raise with the knob that widens the budget.
            raise RuntimeError(
                f"dpp pipeline phase exceeded join_timeout_s="
                f"{self.join_timeout_s:.0f}s with {len(timed_out)} "
                f"thread(s) still running ({', '.join(timed_out)}); "
                f"produced {len(outputs)}/{M} outputs so far — raise "
                "join_timeout_s (or MEGATRON_DPP_JOIN_TIMEOUT_S) if the "
                "host is just slow")
        if len(outputs) != M:
            raise RuntimeError(
                f"pipeline produced {len(outputs)}/{M} outputs although "
                "every phase thread exited cleanly — a schedule/topology "
                "bug dropped microbatches (NOT a timeout)")
        self._sync()
        self.transfer_order = order_log
        self.ship_time_s = ship_log
        self.sender_stall_s = sender_stall
        self.compute_wait_s = compute_wait
        self.pool_stall_s = [p.stall_s for p in pools]
        self.compute_spans = compute_spans
        self.send_spans = send_spans
        return outputs

    def run(self, microbatch_inputs: Sequence[Any]) -> List[Any]:
        """Execute the forward pipeline over all microbatches. Returns
        outputs indexed by microbatch."""
        if len(microbatch_inputs) != self.M:
            raise ValueError("need one input per microbatch")
        pp, vpp, M = self.pp, self.vpp, self.M

        def keyfn(cm):
            return send_priority(cm[0], cm[1], pp, vpp, self.policy)

        seeds = {(0, m): h for m, h in enumerate(microbatch_inputs)}
        outputs = self._pipeline_phase(
            seeds, 0,
            lambda s, c, h, m: self.chunk_fn(s, c, h, m),
            self._next_hop, keyfn, static_order(pp, vpp, M, self.policy))
        return [outputs[m] for m in range(M)]

    def run_train(self, microbatch_inputs: Sequence[Any],
                  chunk_vjp_fn: Callable[[int, int, Any, int],
                                         Tuple[Any, Callable]],
                  seed_grads_fn: Callable[[List[Any]],
                                          Tuple[Sequence[Any], Any]],
                  ) -> Tuple[List[Any], Dict[Tuple[int, int], Any],
                             List[Any], Any]:
        """Full fwd+bwd through the dynamic scheduler (the reference's
        forward_send AND backward_send loops,
        shm_tensor_new_rdma.cpp:1478-1646 — not argued by symmetry: the
        backward pass executes through the same `_pipeline_phase`
        machinery in reverse topology with mirrored priority).

        chunk_vjp_fn(stage, chunk, h, mb) -> (h_out, vjp) where
        vjp(g_out) -> (dparams, dh). seed_grads_fn(outputs) ->
        (per-mb output grads, aux) runs the loss head after the forward
        sweep. Returns (outputs, param_grads {(stage, chunk): list of
        tensors summed over mbs}, input_grads per mb, aux).

        Metrics: after return, fwd_metrics/bwd_metrics hold each phase's
        (transfer_order, ship_time_s, sender_stall_s, compute_wait_s,
        pool_stall_s, wall_s).
        """
        if len(microbatch_inputs) != self.M:
            raise ValueError("need one input per microbatch")
        pp, vpp, M = self.pp, self.vpp, self.M
        residuals: Dict[Tuple[int, int, int], Callable] = {}

        def fwd_key(cm):
            return send_priority(cm[0], cm[1], pp, vpp, self.policy)

        def fwd_exec(stage, c, h, m):
            out, vjp = chunk_vjp_fn(stage, c, h, m)
            residuals[(stage, c, m)] = vjp
            return out

        seeds = {(0, m): h for m, h in enumerate(microbatch_inputs)}
        fwd_out = self._pipeline_phase(
            seeds, 0, fwd_exec, self._next_hop, fwd_key,
            static_order(pp, vpp, M, self.policy))
        self.fwd_metrics = self._phase_metrics()
        outputs = [fwd_out[m] for m in range(M)]

        out_grads, aux = seed_grads_fn(outputs)
        if len(out_grads) != M:
            raise ValueError("seed_grads_fn must return one grad per "
                             "microbatch")

        # Mirrored priority: the latest-forward item goes backward first
        # (the reference's backward traversal mirrors forward_send).
        def bwd_key(cm):
            return tuple(-x for x in fwd_key(cm))

        param_grads: Dict[Tuple[int, int], Any] = {}

        def bwd_exec(stage, c, g, m):
            dparams, dh = residuals.pop((stage, c, m))(g)
            acc = param_grads.get((stage, c))
            param_grads[(stage, c)] = (
                list(dparams) if acc is None
                else [a + b for a, b in zip(acc, dparams)])
            return dh

        bwd_seeds = {(vpp - 1, m): g for m, g in enumerate(out_grads)}
        bwd_out = self._pipeline_phase(
            bwd_seeds, pp - 1, bwd_exec, self._prev_hop, bwd_key,
            sorted([(c, m) for c in range(vpp) for m in range(M)],
                   key=bwd_key))
        self.bwd_metrics = self._phase_metrics()
        input_grads = [bwd_out[m] for m in range(M)]
        return outputs, param_grads, input_grads, aux

    def _phase_metrics(self) -> Dict[str, Any]:
        return {
            "transfer_order": self.transfer_order,
            "ship_time_s": self.ship_time_s,
            "sender_stall_s": self.sender_stall_s,
            "compute_wait_s": self.compute_wait_s,
            "pool_stall_s": self.pool_stall_s,
            "wall_s": self.wall_s,
            "compute_spans": self.compute_spans,
            "send_spans": self.send_spans,
        }

    def trace_events(self, t0: float,
                     pid_base: int = 5000) -> List[Dict[str, Any]]:
        """MegaScan records for the last run_train: per-(chunk, mb)
        compute and transfer spans on per-stage timelines (pid
        pid_base+stage — default 5000, disjoint from process pids and
        the device 1000-range; dp replicas pass distinct bases), ts/dur
        in microseconds relative to ``t0`` (a perf_counter taken at step
        entry). The reference's tracer shows its shm/RDMA transport
        activity the same way (its SendOp/RecvOp rows); feed through
        Tracer.add_collective_records."""
        events: List[Dict[str, Any]] = []
        for phase, metrics in (
                ("forward", getattr(self, "fwd_metrics", None)),
                ("backward", getattr(self, "bwd_metrics", None))):
            if not metrics:
                continue
            for kind, tid, per_stage in (
                    ("dpp-compute", 0, metrics["compute_spans"]),
                    ("dpp-send", 1, metrics["send_spans"])):
                for stage, spans in enumerate(per_stage):
                    for (c, m), (t_abs, dur) in spans.items():
                        events.append({
                            "name": kind, "ph": "X",
                            "pid": pid_base + stage, "tid": tid,
                            "ts": (t_abs - t0) * 1e6,
                            "dur": dur * 1e6,
                            "args": {"stage": stage, "chunk": c,
                                     "mb": m, "dir": phase},
                        })
        return events
