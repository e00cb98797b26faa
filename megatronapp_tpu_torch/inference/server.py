"""Text-generation server: REST /api + WebSocket per-token streaming
(the JAX package's inference/server.py), over the continuous-batching
engine (``--engine dynamic``) or the static engine (``--engine static``).

Dynamic: every connection submits into one shared DynamicInferenceEngine
and a single stepper thread (DynamicBatchingDriver) drives engine.step(),
so concurrent requests decode in the same batch. Static: one generation
at a time under a lock, and the WebSocket path serves MegaScope
visualization requests (``generate_streaming``: capture frames,
top-20 candidates per token, disturbances); the dynamic engine answers
those with JAX's error message. aiohttp is imported inside the handlers:
the engines, DynamicBatchingDriver and ``generate_streaming`` run without
it.

REST:  PUT /api  {"prompts": [...], "tokens_to_generate": N,
                  "temperature": f, "top_k": i, "top_p": f, "greedy": b,
                  "random_seed": i, "timeout_s": f}
       → {"text": [...], "segments": [...]}
       GET /stats, /healthz, /metrics, /trace
       (/stats has a "speculative" section on a speculative engine —
       acceptance rate, tokens per model step and the raw counts — and
       /metrics its counters: spec_proposed_tokens, spec_accepted_tokens,
       serving_tokens_emitted and the spec_accepted_per_round histogram)
WS:    /ws — client sends the same JSON; server streams
       {"type": "token", "step": i, "token": id, "text": str} per token
       then {"type": "done", "text": full}. On the static engine a
       request may add "visualization" ({FlagType name: [layer ids]}),
       "compressor" ({"pixels", "method"}) and "disturbance" ({site:
       {"kind", "scale", "layers"}}, seeded by "random_seed"): capture
       frames {"update_type", "site", "layer_id", "result"} stream as the
       forward runs and each token frame carries "candidates".

The mamba engine, fleets and per-tenant accounting are later slices.
"""

from __future__ import annotations

import asyncio
import collections
import json
import threading
import time
from typing import Optional

from megatronapp_tpu_torch.inference.dynamic_engine import (
    DeadlineExceeded, DynamicInferenceEngine,
)
from megatronapp_tpu_torch.inference.engine import (
    SamplingParams, StaticInferenceEngine,
)
from megatronapp_tpu_torch.trace.request_trace import get_request_tracer
from megatronapp_tpu_torch.utils import chaos
from megatronapp_tpu_torch.utils import metrics as telemetry


class _ClientGone(Exception):
    """Raised inside the generation worker when the WS client vanished
    mid-stream."""


class DynamicBatchingDriver:
    """One stepper thread drives a shared DynamicInferenceEngine for ALL
    server connections (continuous batching across clients).

    submit() is thread-safe and returns (request_id, done_event); the
    optional token_cb(rid, token) fires from the stepper thread for every
    generated token. cancel() aborts a request (waiting requests complete
    immediately; running ones retire on the next step, releasing their
    blocks). The stepper is a daemon thread started on first submit and
    parks on a condition variable whenever the engine has no work.

    Self-healing: per-request deadlines (submit timeout_s); a stepper
    watchdog (a failing engine.step broadcasts the error to every waiter,
    reclaims the pool via abort_all, counts a restart and backs off
    exponentially on consecutive failures). Rolling reload:
    `request_reload(params)` pauses admission, drains running requests,
    swaps the weights on the empty batch and resumes admission."""

    def __init__(self, engine, crash_backoff_base: float = 0.25,
                 crash_backoff_cap: float = 5.0):
        self.engine = engine
        self._cv = threading.Condition()
        self._subs = {}     # rid -> {"cb": fn|None, "done": Event}
        self._errors = {}   # rid -> Exception from a failed step
        self._thread = None
        self.max_active = 0   # high-water concurrently-active slots
        self.restarts = 0             # step failures survived
        self.thread_restarts = 0      # stepper threads found dead
        self.consecutive_failures = 0
        self.deadline_expired = 0     # requests aborted past deadline
        self.crash_backoff_base = crash_backoff_base
        self.crash_backoff_cap = crash_backoff_cap
        self._reload = None   # (params, [done events]) or None
        self.reloads = 0
        self._closed = False

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            if self._thread is not None:
                self.thread_restarts += 1
            self._thread = threading.Thread(
                target=self._loop, name="dynamic-engine-stepper",
                daemon=True)
            self._thread.start()

    def submit(self, prompt_ids, max_new_tokens, sampling, eod_id=None,
               token_cb=None, priority: int = 0,
               timeout_s: Optional[float] = None,
               adapter_id: Optional[str] = None,
               tenant: Optional[str] = None):
        """timeout_s: per-request deadline in seconds from now; already
        expired work (timeout_s <= 0) is rejected with DeadlineExceeded.
        adapter_id: the request's LoRA adapter in the engine's cache
        (unknown ids are rejected at submit). tenant: per-tenant accounting,
        not ported yet (the engine raises naming it). Both are forwarded
        only when set."""
        deadline = None
        if timeout_s is not None:
            if timeout_s <= 0:
                self.deadline_expired += 1
                telemetry.inc("serving_deadline_expired")
                raise DeadlineExceeded(
                    "request deadline expired at admission "
                    f"(timeout_s={timeout_s})")
            deadline = time.monotonic() + timeout_s
        extra = {}
        if adapter_id is not None:
            extra["adapter_id"] = adapter_id
        if tenant is not None:
            extra["tenant"] = tenant
        with self._cv:
            rid = self.engine.add_request(prompt_ids, max_new_tokens,
                                          sampling, eod_id=eod_id,
                                          priority=priority,
                                          deadline_s=deadline, **extra)
            done = threading.Event()
            self._subs[rid] = {"cb": token_cb, "done": done}
            self._ensure_thread()
            self._cv.notify_all()
        return rid, done

    def close(self):
        """Stop the stepper thread once its current step is done (the
        engine is then the caller's again: a tp lead releases its
        followers after this)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=600)

    def request_reload(self, params) -> threading.Event:
        """Schedule a rolling params swap; the returned event fires once
        the new weights are live. A second request before the first lands
        supersedes its params, and both events fire on the swap."""
        done = threading.Event()
        with self._cv:
            waiters = ([done] if self._reload is None
                       else self._reload[1] + [done])
            self._reload = (params, waiters)
            self._ensure_thread()
            self._cv.notify_all()
        return done

    def _maybe_reload_locked(self):
        """Advance the reload state machine (caller holds _cv)."""
        if self._reload is None:
            return
        self.engine.pause_admission = True
        if not self.engine.drained_for_reload():
            return
        params, waiters = self._reload
        try:
            self.engine.set_params(params)
        finally:
            self.engine.pause_admission = False
            self._reload = None
        self.reloads += 1
        for done in waiters:
            done.set()

    def cancel(self, rid):
        with self._cv:
            state = self.engine.abort_request(rid)
            if state == "waiting":
                # Never ran: no finish event will fire — complete here.
                self.engine.pop_request(rid)
                sub = self._subs.pop(rid, None)
                if sub:
                    sub["done"].set()

    def result_tokens(self, rid):
        """Full token array of a finished request (pops it). Raises the
        stepper-side error if the request's step failed."""
        err = self._errors.pop(rid, None)
        if err is not None:
            self.engine.pop_request(rid)
            raise err
        req = self.engine.pop_request(rid)
        return None if req is None else req.tokens

    def _loop(self):
        # A tp lead steps an idle engine every keepalive_s, so that its
        # followers' wait for the next step never outlasts the group's
        # collective timeout.
        keepalive = getattr(self.engine, "keepalive_s", None)
        while True:
            with self._cv:
                idle = False
                while not (self.engine.has_work or self._closed or
                           self._reload is not None):
                    if not self._cv.wait(timeout=keepalive):
                        idle = True
                        break
                if self._closed:
                    return
                if not idle:
                    self._maybe_reload_locked()
                    if not self.engine.has_work:
                        continue
            try:
                chaos.fire("stepper-step")
                ev = self.engine.step()
                self.consecutive_failures = 0
            except Exception as e:  # noqa: BLE001 — broadcast & reset
                self.restarts += 1
                self.consecutive_failures += 1
                telemetry.inc("serving_step_failures")
                with self._cv:
                    for rid, sub in self._subs.items():
                        self._errors[rid] = e
                        sub["done"].set()
                    self._subs.clear()
                    # The engine state is suspect: drop all work and
                    # reclaim the pool through abort_all.
                    self.engine.abort_all()
                time.sleep(min(self.crash_backoff_cap,
                               self.crash_backoff_base *
                               2 ** (self.consecutive_failures - 1)))
                continue
            self.max_active = max(self.max_active, sum(
                1 for r in self.engine.slots if r is not None))
            with self._cv:
                for rid in ev.get("expired", ()):
                    if rid in self._subs:
                        self.deadline_expired += 1
                        self._errors[rid] = DeadlineExceeded(
                            f"request {rid} aborted: deadline exceeded")
                for rid, tok in ev["tokens"]:
                    sub = self._subs.get(rid)
                    if sub and sub["cb"] is not None:
                        try:
                            sub["cb"](rid, int(tok))
                        except Exception:  # noqa: BLE001 — dead sink
                            sub["cb"] = None
                for rid in ev["finished"]:
                    sub = self._subs.pop(rid, None)
                    if sub:
                        sub["done"].set()

    def stats(self) -> dict:
        """Stepper health for GET /healthz."""
        return {
            "started": self._thread is not None,
            "alive": self._thread is not None and self._thread.is_alive(),
            "restarts": self.restarts,
            "thread_restarts": self.thread_restarts,
            "consecutive_failures": self.consecutive_failures,
            "deadline_expired": self.deadline_expired,
            "subscribers": len(self._subs),
            "max_active": self.max_active,
            "reloads": self.reloads,
            "reload_pending": self._reload is not None,
        }


def _sampling_from_request(req: dict) -> SamplingParams:
    return SamplingParams(
        temperature=float(req.get("temperature", 1.0)),
        top_k=int(req.get("top_k", 0)),
        top_p=float(req.get("top_p", 0.0)),
        greedy=bool(req.get("greedy", False)),
        seed=int(req.get("random_seed", 0)),
    )


def _timeout_of(req: dict) -> Optional[float]:
    t = req.get("timeout_s")
    return None if t is None else float(t)


class TextGenerationServer:
    """REST + WebSocket front end over one DynamicInferenceEngine or one
    StaticInferenceEngine."""

    def __init__(self, engine, host="0.0.0.0", port=5000):
        if not isinstance(engine, (DynamicInferenceEngine,
                                   StaticInferenceEngine)):
            raise NotImplementedError(
                f"{type(engine).__name__}: the port serves the dynamic and "
                "static engines; the mamba engine is a later slice")
        self.engine = engine
        self.host = host
        self.port = port
        # One generation at a time on the static engine: the engine, the
        # capture hooks and the disturbance state are shared.
        self._gen_lock = threading.Lock()
        self._driver = (DynamicBatchingDriver(engine)
                        if isinstance(engine, DynamicInferenceEngine)
                        else None)

    def generate_streaming(self, req: dict, emit,
                           cancel: Optional[threading.Event] = None):
        """One WebSocket request's generation on the static engine, in
        process (JAX server.py:500-600): the first prompt, its token
        frames {"type": "token", "step", "token", "text"} passed to
        emit(payload) as they are sampled, and, when req has
        "visualization", the capture frames of every forward and each
        token's top-20 "candidates" (TensorTracer.report_result). A
        "disturbance" config (seeded by "random_seed") applies for this
        generation only. Hooks and disturbances are set in this thread and
        cleared after, whatever happens. cancel: set → _ClientGone at the
        next token. Returns the generated texts."""
        from megatronapp_tpu_torch.scope.disturbance import get_disturbance
        from megatronapp_tpu_torch.scope.hooks import capture_payload
        from megatronapp_tpu_torch.scope.tensor_tracer import (
            get_tensor_tracer,
        )
        prompts = req.get("prompts") or [req.get("prompt", "")]
        n = int(req.get("tokens_to_generate", 64))
        sampling = _sampling_from_request(req)
        viz = req.get("visualization")
        tok = self.engine.tokenizer
        tt = get_tensor_tracer()

        def cb(step, tokens, logits):
            if cancel is not None and cancel.is_set():
                raise _ClientGone()
            payload = {"type": "token", "step": int(step),
                       "token": int(tokens[0]),
                       "text": (tok.detokenize([int(tokens[0])]) if tok
                                else "")}
            if viz and logits is not None:
                payload["candidates"] = tt.report_result(
                    logits[0], int(tokens[0]), tok)["candidates"]
            emit(payload)

        with self._gen_lock:
            if not viz:
                return self.engine.generate_text(
                    prompts[:1], n, sampling, token_callback=cb)
            comp = req.get("compressor") or {}

            def report(site, layer_id, arr):
                emit(capture_payload(site, layer_id, arr))

            # Config application sits inside the try: a malformed client
            # config must not leave hooks or noise active.
            try:
                tt.set_flags_from_config(viz)
                tt.activate(report, pixels=int(comp.get("pixels", 16)),
                            method=comp.get("method", "mean"))
                if req.get("disturbance") is not None:
                    get_disturbance().configure(
                        req["disturbance"],
                        seed=int(req.get("random_seed", 0)))
                return self.engine.generate_text(
                    prompts[:1], n, sampling, token_callback=cb)
            finally:
                tt.deactivate()
                tt.clear_records()
                get_disturbance().clear()

    # ------------------------------------------------------------------
    def _submit_and_wait(self, prompts, n, sampling,
                         cancel: Optional[threading.Event] = None,
                         token_cb=None, timeout_s: Optional[float] = None,
                         adapter_id: Optional[str] = None,
                         tenant: Optional[str] = None):
        """Submit every prompt into the shared batch, wait for
        completion, detokenize. token_cb(rid, tok) streams tokens of the
        FIRST prompt (WS contract); adapter_id / tenant as for
        DynamicBatchingDriver.submit."""
        import numpy as np
        tok = self.engine.tokenizer
        if tok is None:
            raise ValueError("the server needs an engine tokenizer")
        eod = getattr(tok, "eod", None)
        subs = []
        for i, prompt in enumerate(prompts):
            ids = np.asarray(tok.tokenize(prompt), np.int32)
            rid, done = self._driver.submit(
                ids, n, sampling, eod_id=eod,
                token_cb=token_cb if i == 0 else None,
                timeout_s=timeout_s, adapter_id=adapter_id, tenant=tenant)
            subs.append((ids, rid, done))
        texts = []
        first_err = None
        for ids, rid, done in subs:
            while not done.wait(timeout=0.1):
                if cancel is not None and cancel.is_set():
                    self._driver.cancel(rid)
                    done.wait(timeout=60)   # retires on the next step
                    break
            try:
                toks = self._driver.result_tokens(rid)
            except Exception as e:  # noqa: BLE001 — re-raised after drain
                # Drain EVERY rid before surfacing the error, or the later
                # prompts' results would stay in DynamicBatchingDriver.
                if first_err is None:
                    first_err = e
                continue
            if cancel is not None and cancel.is_set():
                raise _ClientGone()
            new_ids = [] if toks is None else toks[len(ids):].tolist()
            if eod is not None and eod in new_ids:
                new_ids = new_ids[: new_ids.index(eod)]
            texts.append(tok.detokenize(new_ids))
        if first_err is not None:
            raise first_err
        return texts

    # ------------------------------------------------------------------
    async def handle_api(self, request):
        from aiohttp import web
        try:
            req = await request.json()
            prompts = req["prompts"]
            n = int(req.get("tokens_to_generate", 64))
            sampling = _sampling_from_request(req)
            timeout_s = _timeout_of(req)
            adapter_id, tenant = req.get("adapter_id"), req.get("tenant")
            loop = asyncio.get_running_loop()

            def run_api():
                if self._driver is None:
                    with self._gen_lock:
                        return self.engine.generate_text(prompts, n,
                                                         sampling)
                return self._submit_and_wait(prompts, n, sampling,
                                             timeout_s=timeout_s,
                                             adapter_id=adapter_id,
                                             tenant=tenant)

            texts = await loop.run_in_executor(None, run_api)
            return web.json_response({
                "text": [p + t for p, t in zip(prompts, texts)],
                "segments": texts,
            })
        except Exception as e:  # parity: 400 with the message
            return web.json_response({"message": str(e)}, status=400)

    async def handle_ws(self, request):
        from aiohttp import web
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        loop = asyncio.get_running_loop()
        # One persistent receive task doubles as the mid-generation
        # disconnect watcher; TEXT frames that arrive mid-generation are
        # buffered in `pending` (bounded) and served in order.
        max_pending = 32
        pending: collections.deque = collections.deque()
        recv_task = asyncio.ensure_future(ws.receive())
        while True:
            if len(pending) > max_pending:
                await ws.close(
                    code=1008,
                    message=b"too many pipelined requests; await replies")
                break
            if pending:
                msg = pending.popleft()
            else:
                msg = await recv_task
                if msg.type == 1:
                    recv_task = asyncio.ensure_future(ws.receive())
            if msg.type != 1:  # not TEXT → close/closing/error: done
                break
            req = json.loads(msg.data)
            prompts = req.get("prompts") or [req.get("prompt", "")]
            n = int(req.get("tokens_to_generate", 64))
            sampling = _sampling_from_request(req)
            if req.get("visualization") and self._driver is not None:
                await ws.send_json({
                    "type": "error",
                    "message": "visualization requires --engine static "
                               "(the continuous-batching backend shares "
                               "one step loop across connections)"})
                continue
            queue: asyncio.Queue = asyncio.Queue()
            cancel = threading.Event()
            state = {"step": 0}

            def driver_cb(rid, token):
                if cancel.is_set():
                    return
                tok = self.engine.tokenizer
                payload = {"type": "token", "step": state["step"],
                           "token": int(token),
                           "text": tok.detokenize([int(token)])}
                state["step"] += 1
                loop.call_soon_threadsafe(queue.put_nowait, payload)

            def run_generation():
                if self._driver is None:
                    return self.generate_streaming(
                        req, lambda p: loop.call_soon_threadsafe(
                            queue.put_nowait, p), cancel)
                return self._submit_and_wait(
                    prompts[:1], n, sampling, cancel=cancel,
                    token_cb=driver_cb, timeout_s=_timeout_of(req),
                    adapter_id=req.get("adapter_id"),
                    tenant=req.get("tenant"))

            fut = loop.run_in_executor(None, run_generation)
            # Sentinel-terminated drain: every per-token payload is
            # queued before the done-callback's sentinel.
            done_marker = object()
            fut.add_done_callback(lambda _: queue.put_nowait(done_marker))
            completed = False
            get_task = asyncio.ensure_future(queue.get())
            try:
                while True:
                    done, _ = await asyncio.wait(
                        {get_task, recv_task},
                        return_when=asyncio.FIRST_COMPLETED)
                    if recv_task in done:
                        m = recv_task.result()
                        if m.type == 1 and len(pending) < max_pending:
                            pending.append(m)
                            recv_task = asyncio.ensure_future(
                                ws.receive())
                            continue
                        if m.type == 1:
                            pending.append(m)  # outer loop closes 1008
                        break           # disconnect/flood → abort
                    payload = get_task.result()
                    if payload is done_marker:
                        completed = True
                        break
                    await ws.send_json(payload)
                    get_task = asyncio.ensure_future(queue.get())
            except (ConnectionResetError, RuntimeError):
                pass                    # TCP reset mid-send → abort
            finally:
                if not completed:
                    cancel.set()
                if not get_task.done():
                    get_task.cancel()
            if not completed:
                try:
                    await fut      # the worker cancels its request
                except Exception:  # noqa: BLE001 — client already gone
                    pass
                continue
            try:
                texts = fut.result()
            except _ClientGone:
                continue
            except Exception as e:  # noqa: BLE001 — error frame
                await ws.send_json({"type": "error", "message": str(e)})
                continue
            await ws.send_json({"type": "done", "text": texts[0]})
        if not recv_task.done():
            recv_task.cancel()
        return ws

    # ------------------------------------------------------------------
    def close(self):
        """Stop the driver's stepper thread (at shutdown)."""
        if self._driver is not None:
            self._driver.close()

    def stats_snapshot(self) -> dict:
        """Serving stats for GET /stats (the static engine has only its
        name to report)."""
        if self._driver is None:
            return {"engine": "static"}
        out = self.engine.stats_snapshot()
        out["driver_max_active"] = self._driver.max_active
        return out

    async def handle_stats(self, request):
        from aiohttp import web
        return web.json_response(self.stats_snapshot())

    def health_snapshot(self) -> dict:
        """GET /healthz payload: stepper liveness, restart accounting and
        pool pressure. status: 'ok', 'degraded' (stepper failing steps
        but self-healing) or 'unhealthy' (stepper thread dead)."""
        if self._driver is None:
            return {"status": "ok", "engine": "static"}
        eng = self.engine
        st = self._driver.stats()
        out = {"status": "ok", "engine": "dynamic", "stepper": st,
               "restarts": st["restarts"] + st["thread_restarts"],
               "active": sum(1 for r in eng.slots if r is not None),
               "waiting": len(eng.waiting)}
        pool_stats = eng.stats_snapshot()["pool"]
        pool_stats["pressure"] = round(
            pool_stats["blocks_in_use"] / pool_stats["num_blocks"], 4)
        out["pool"] = pool_stats
        if st["started"] and not st["alive"]:
            out["status"] = "unhealthy"
        elif st["consecutive_failures"] > 0 and eng.has_work:
            out["status"] = "degraded"
        return out

    async def handle_healthz(self, request):
        from aiohttp import web
        payload = self.health_snapshot()
        return web.json_response(
            payload, status=503 if payload["status"] == "unhealthy"
            else 200)

    def _export_live_gauges(self):
        """Point-in-time gauges refreshed at scrape time (the dynamic
        engine's; the static engine has none)."""
        if self._driver is None:
            return
        eng = self.engine
        telemetry.set_gauge("serving_active_slots", sum(
            1 for r in eng.slots if r is not None))
        telemetry.set_gauge("serving_waiting", len(eng.waiting))
        telemetry.set_gauge("paged_blocks_in_use", eng.pool.blocks_in_use())
        telemetry.set_gauge("paged_blocks_free", eng.pool.free_blocks())
        telemetry.set_gauge("paged_blocks_evictable",
                            eng.pool.evictable_blocks())
        if eng.adapters is not None:
            # LoRA adapter cache occupancy (its hit/miss/eviction counters
            # accumulate where the cache counts them).
            lstats = eng.adapters.stats_snapshot()
            telemetry.set_gauge("lora_adapters_resident", lstats["resident"])
            telemetry.set_gauge("lora_adapters_pinned", lstats["pinned"])
            telemetry.set_gauge("lora_resident_bytes",
                                lstats["resident_bytes"])
        st = self._driver.stats()
        telemetry.set_gauge("serving_stepper_alive", int(st["alive"]))
        telemetry.set_gauge("serving_stepper_restarts",
                            st["restarts"] + st["thread_restarts"])

    def metrics_text(self) -> str:
        """Prometheus text for GET /metrics."""
        if telemetry.enabled():
            self._export_live_gauges()
        return telemetry.render_prometheus()

    async def handle_metrics(self, request):
        from aiohttp import web
        return web.Response(text=self.metrics_text(),
                            content_type="text/plain")

    def dump_request_trace(self, path: Optional[str] = None) -> dict:
        """Render the request-trace ring as one Chrome trace; optionally
        write it to `path`."""
        trace = get_request_tracer().chrome_trace()
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    async def handle_trace(self, request):
        from aiohttp import web
        if not get_request_tracer().enabled:
            return web.json_response(
                {"message": "request tracing disabled — enable with "
                            "--request-trace"},
                status=404)
        return web.json_response(self.dump_request_trace())

    # ------------------------------------------------------------------
    def build_app(self):
        from aiohttp import web
        app = web.Application()
        app.router.add_put("/api", self.handle_api)
        app.router.add_post("/api", self.handle_api)
        app.router.add_get("/stats", self.handle_stats)
        app.router.add_get("/healthz", self.handle_healthz)
        app.router.add_get("/metrics", self.handle_metrics)
        app.router.add_get("/trace", self.handle_trace)
        app.router.add_get("/ws", self.handle_ws)
        return app

    def run(self):
        from aiohttp import web
        web.run_app(self.build_app(), host=self.host, port=self.port)
