"""Launch MegaScope's training server on the port: the WS endpoint at /ws
driving one training step per request, and the web UI at / (the JAX
package's tools/run_scope_server.py).

    python -m megatronapp_tpu_torch.tools.run_scope_server --device cpu \
        --fp32 --num-layers 2 --hidden-size 64 --num-attention-heads 4 \
        --vocab-size 128 --max-position-embeddings 64 --seq-length 32 \
        --micro-batch-size 2 --global-batch-size 2 --train-iters 1000 \
        [--ws-host 0.0.0.0] [--ws-port 5656]

The model, training and optimizer flags are pretrain_gpt's (the card
unless --device cpu; random weights and mock data from --seed). Needs
aiohttp.
"""

from __future__ import annotations

from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    from megatronapp_tpu_torch.pretrain_gpt import (
        build_parser, configs_from_args,
    )
    from megatronapp_tpu_torch.scope.ws_server import (
        TrainingScopeServer, TrainingScopeSession,
    )
    ap = build_parser()
    ap.prog = "python -m megatronapp_tpu_torch.tools.run_scope_server"
    ap.description = "MegaScope training server (megatronapp_tpu_torch)"
    ap.add_argument("--ws-host", default="0.0.0.0")
    ap.add_argument("--ws-port", type=int, default=5656)
    args = ap.parse_args(argv)
    try:
        import aiohttp  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"the scope server needs aiohttp ({e}); "
                         "TrainingScopeSession runs without it") from e
    model, training, optimizer = configs_from_args(args)
    session = TrainingScopeSession(model, training, optimizer,
                                   device=args.device)
    srv = TrainingScopeServer(session, host=args.ws_host, port=args.ws_port)
    print(f"MegaScope UI: http://{args.ws_host}:{args.ws_port}/ (WS at "
          f"/ws) — send run_training_step or click 'step'")
    srv.run()


if __name__ == "__main__":
    main()
