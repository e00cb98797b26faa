"""MegaScope Python client: drives the training WS server programmatically
(the JAX package's scope/client.py).

Pins the wire contract from the CLIENT side (the other side of
scope/ws_server.py): a headless counterpart of the web UI
(scope/frontend/index.html), usable for scripted probing, contract tests,
and notebook analysis.

  client = ScopeClient("ws://localhost:5656/ws")
  payloads = client.run_step(
      visualization={"QKV_mat_mul": [0, 1]},
      compressor={"pixels": 16, "method": "mean"})
"""

from __future__ import annotations

import asyncio
import json
from typing import Dict, List, Optional


class ScopeClient:
    """Blocking wrapper over one aiohttp WS connection."""

    def __init__(self, url: str = "ws://127.0.0.1:5656/ws",
                 timeout: float = 300.0):
        self.url = url
        self.timeout = timeout

    def run_step(self, visualization: Optional[Dict] = None,
                 disturbance: Optional[Dict] = None,
                 compressor: Optional[Dict] = None) -> List[dict]:
        """Run one training step; returns all payloads up to and including
        the step_done summary (raises on server-side error payloads)."""
        return asyncio.run(self._run_step_async(
            visualization, disturbance, compressor))

    async def _run_step_async(self, visualization, disturbance, compressor,
                              session=None):
        import aiohttp
        own = session is None
        if own:
            session = aiohttp.ClientSession()
        try:
            async with session.ws_connect(self.url,
                                          timeout=self.timeout) as ws:
                req = {"type": "run_training_step"}
                if visualization is not None:
                    req["visualization"] = visualization
                if disturbance is not None:
                    req["disturbance"] = disturbance
                if compressor is not None:
                    req["compressor"] = compressor
                await ws.send_json(req)
                payloads: List[dict] = []
                while True:
                    msg = await asyncio.wait_for(ws.receive(),
                                                 timeout=self.timeout)
                    if msg.type != aiohttp.WSMsgType.TEXT:
                        raise ConnectionError(
                            f"ws closed mid-step: {msg.type}")
                    data = json.loads(msg.data)
                    if data.get("type") == "error":
                        raise RuntimeError(
                            f"server error: {data.get('message')}")
                    payloads.append(data)
                    if data.get("type") == "step_done":
                        return payloads
        finally:
            if own:
                await session.close()


def validate_payloads(payloads: List[dict],
                      visualization: Optional[Dict] = None) -> None:
    """Contract assertions both sides rely on (golden-payload shape).

    - every capture carries update_type/site/layer_id/result (the "pca"
      frame a step with MLP2 captures ends with is not a capture);
    - exactly one trailing step_done with iteration/loss/grad_norm;
    - every requested FlagType produced at least one capture.
    """
    from megatronapp_tpu_torch.scope.hooks import FlagType

    assert payloads, "no payloads"
    *captures, done = payloads
    assert done.get("type") == "step_done", done
    for key in ("iteration", "loss", "grad_norm"):
        assert key in done, (key, done)
    captures = [c for c in captures if c.get("type") != "pca"]
    for c in captures:
        for key in ("update_type", "site", "layer_id", "result"):
            assert key in c, (key, c)
        assert isinstance(c["result"], list)
    if visualization:
        got = {c["update_type"] for c in captures}
        for name in visualization:
            want = int(FlagType[name])
            assert want in got, (
                f"flag {name} requested but no capture arrived "
                f"(got update_types {sorted(got)})")
