"""MegaScope training-mode WebSocket server (the JAX package's
scope/ws_server.py).

The reference's training_wsserver.py:39-146 with its training-loop
integration: the frontend sends ``run_training_step`` with visualization
/ disturbance / compressor configs; training runs one step with those
configs applied and streams the captured tensor payloads back, then a
step summary.

Wire contract: per capture the server sends
  {"update_type": <FlagType value>, "layer_id": int, "site": str,
   "result": [[...]]}
then {"type": "pca", "points": ...} when MLP2 records accumulated, and
{"type": "step_done", "iteration": i, "loss": f, "grad_norm": f}.

``TrainingScopeSession.run_step`` is the whole step in process (no
aiohttp); ``TrainingScopeServer`` serves it over /ws with the frontend
at / and /frontend. The port's step is eager, so a config change needs
no rebuild: the capture sites and disturbances read their state as they
run.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
from typing import Dict, List, Optional

import torch

from megatronapp_tpu_torch.scope.disturbance import get_disturbance
from megatronapp_tpu_torch.scope.hooks import capture_payload
from megatronapp_tpu_torch.scope.tensor_tracer import get_tensor_tracer

FRONTEND_DIR = os.path.join(os.path.dirname(__file__), "frontend")


class TrainingScopeSession:
    """Owns a GPT model's train state and step on one device; one
    training step per run_step() call with the requested scope configs
    applied.

    device: None means the card (a host without one raises); pass
    device="cpu" to run the plain versions on the CPU. The weights are
    made on the device from train_cfg.seed."""

    def __init__(self, model_cfg, train_cfg, opt_cfg, batch_iter=None,
                 device=None):
        from megatronapp_tpu_torch.data.mock import mock_batches
        from megatronapp_tpu_torch.models.gpt import init_gpt_params
        from megatronapp_tpu_torch.training.optimizer import Optimizer
        from megatronapp_tpu_torch.training.train import gpt_microbatch_loss
        from megatronapp_tpu_torch.training.train_step import (
            TrainState, make_train_step, named_trainable,
        )
        from megatronapp_tpu_torch.utils.device import resolve_device

        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        optimizer = Optimizer(opt_cfg, train_cfg.train_iters)
        gen = torch.Generator(self.device).manual_seed(train_cfg.seed)
        params = init_gpt_params(model_cfg, gen, self.device)
        params.requires_grad_(True)
        self.state = TrainState(params,
                                optimizer.init(named_trainable(params)))
        self.step_fn = make_train_step(
            gpt_microbatch_loss(model_cfg), optimizer,
            check_nan=train_cfg.check_for_nan_in_loss)
        self.batch_iter = batch_iter or mock_batches(
            train_cfg.seq_length, model_cfg.vocab_size,
            train_cfg.global_batch_size, seed=train_cfg.seed)
        self.iteration = 0
        self._lock = threading.Lock()

    def run_step(self, visualization: Optional[Dict] = None,
                 disturbance: Optional[Dict] = None,
                 compressor: Optional[Dict] = None) -> List[dict]:
        """Apply the configs, run one training step, return the payloads
        (captures, the step's MLP2 PCA when there is one, the step
        summary). The disturbance is seeded by the iteration."""
        from megatronapp_tpu_torch.training.train import (
            _FIELDS, reshape_global_batch,
        )
        from megatronapp_tpu_torch.training.train_step import (
            to_device_batch,
        )
        with self._lock:
            payloads: List[dict] = []
            tt = get_tensor_tracer()

            def report(site, layer_id, arr):
                payloads.append(capture_payload(site, layer_id, arr))

            comp = compressor or {}
            try:
                if visualization:
                    tt.set_flags_from_config(visualization)
                    tt.activate(report, pixels=int(comp.get("pixels", 16)),
                                method=comp.get("method", "mean"))
                else:
                    tt.deactivate()
                if disturbance is not None:
                    get_disturbance().configure(disturbance,
                                                seed=self.iteration)
                else:
                    get_disturbance().clear()
                num_micro = self.train_cfg.num_microbatches(1)
                batch = reshape_global_batch(next(self.batch_iter),
                                             num_micro)
                batch = to_device_batch({k: v for k, v in batch.items()
                                         if k in _FIELDS}, self.device)
                metrics = self.step_fn(self.state, batch)
            finally:
                tt.deactivate()
                get_disturbance().clear()
            # PCA of this step's MLP2 records (the reference's tik_end →
            # the frontend's PCAPlot). A PCA failure never turns a
            # completed step into an error: the optimizer has moved on.
            try:
                pca = tt.pca_mlp2()
            except Exception:  # noqa: BLE001
                pca = None
            if pca is not None:
                payloads.append({"type": "pca", "points": pca.tolist()})
            tt.clear_records()
            self.iteration += 1
            payloads.append({
                "type": "step_done",
                "iteration": self.iteration,
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
            })
            return payloads


class TrainingScopeServer:
    """WS endpoint /ws driving a TrainingScopeSession, the frontend at /
    and its component modules under /frontend (aiohttp, imported here
    only)."""

    def __init__(self, session: TrainingScopeSession, host="0.0.0.0",
                 port=5656):
        self.session = session
        self.host = host
        self.port = port

    async def handle_ws(self, request):
        from aiohttp import web
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        loop = asyncio.get_running_loop()
        async for msg in ws:
            if msg.type != 1:
                continue
            req = json.loads(msg.data)
            if req.get("type") != "run_training_step":
                await ws.send_json({"type": "error",
                                    "message": "unknown message type"})
                continue
            try:
                payloads = await loop.run_in_executor(
                    None, lambda: self.session.run_step(
                        req.get("visualization"),
                        req.get("disturbance"),
                        req.get("compressor")))
                for p in payloads:
                    await ws.send_json(p)
            except Exception as e:  # noqa: BLE001 — error frame
                await ws.send_json({"type": "error", "message": str(e)})
        return ws

    async def handle_index(self, request):
        from aiohttp import web
        return web.FileResponse(os.path.join(FRONTEND_DIR, "index.html"))

    def build_app(self):
        from aiohttp import web
        app = web.Application()
        app.router.add_get("/", self.handle_index)
        app.router.add_get("/ws", self.handle_ws)
        app.router.add_static("/frontend", FRONTEND_DIR)
        return app

    def run(self):
        from aiohttp import web
        web.run_app(self.build_app(), host=self.host, port=self.port)
