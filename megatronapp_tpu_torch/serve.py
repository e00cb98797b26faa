"""Launch the text-generation server on the port (the JAX package's
tools/run_text_generation_server.py for the paged dynamic engine and the
static engine).

    python -m megatronapp_tpu_torch.serve --preset llama3-8b \
        --engine dynamic --paged-kv-cache --max-batch 8 \
        --max-seq-len 2048 --kv-block-size 16 --prefill-chunk 32 --port 5000
    python -m megatronapp_tpu_torch.serve --preset llama3-8b \
        --max-seq-len 512 --port 5000       # --engine static, the default

The static engine (the default, as in JAX) generates one request at a time
over a dense cache of --max-seq-len positions and serves MegaScope's
visualization requests on /ws (inference/server.py).

The serving flags keep the names of the JAX package's
config/arguments.py:add_serving_args. The port serves random weights made
on the device from --seed with the NullTokenizer: checkpoint loading,
tokenizer files and every flag outside the ported slices exit with a
message naming what is not ported yet. ``--megakernel-decode`` runs the
fused decode step (ops/fused_decode.py); ``--kv-cache-dtype int8|fp8``
stores the KV pool quantized and ``--quantized-weights`` quantizes the
five matmul kernels of every layer to resident int8 at startup, on the
device (inference/quantization.py). ``--lora-dir DIR`` serves batched
multi-tenant LoRA adapters (``<adapter_id>.npz`` files written by
``inference/lora.py:LoraAdapter.save``) from a device cache of
``--max-resident-adapters`` slots of rank ``--lora-rank``; a request names
its adapter with ``"adapter_id"``. ``--spec-method ngram|draft`` with
``--spec-k K`` serves speculative decoding (``--draft-model PRESET``: the
draft, its weights made from --seed + 1; ``mtp`` warns and decodes
plainly: the port loads no MTP heads). ``--serve-tp N`` serves
tensor-parallel over N ranks, one process each, joined by a gloo group
(parallel/mesh.py): this process is rank 0 and runs the driver and the
server, and it spawns ranks 1..N-1 as followers that step in lockstep with
it (inference/dynamic_engine.py). Rank r computes on cuda:(r mod the card
count), so on a machine with one card every rank shares it. The server
needs ``aiohttp``.
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import socket
from typing import List, Optional

import torch

# Flags of the JAX server that select machinery this slice does not port.
UNPORTED_FLAGS = {
    "--load-dir": "checkpoint loading",
    "--load-quantized": "int8 checkpoints (no int8 artifact of "
                        "tools/checkpoint/quantize.py is in the repository; "
                        "--quantized-weights quantizes at startup)",
    "--tokenizer-name-or-path": "tokenizer files",
    "--megakernel-vmem-budget": "the TPU VMEM budget of the Pallas tile "
                                "planner (the CUDA kernels plan their own "
                                "tiles)",
    "--scan-unroll": "the JAX layer scan (the port runs its layers as a "
                     "Python loop)",
    "--draft-load-dir": "checkpoint loading (the draft's weights are made "
                        "from a seed)",
    "--serve-disagg": "disaggregated serving",
    "--disagg-prefill-slots": "disaggregated serving",
    "--decode-slo-ms": "disaggregated serving",
    "--serve-fleet": "fleet serving",
    "--fleet-migrate": "fleet serving",
    "--fleet-autoscale": "fleet serving",
    "--fleet-procs": "cross-process fleets",
    "--replica-rpc-port": "cross-process fleets",
    "--supervisor": "cross-process fleets",
    "--fleet-prefix-store-mb": "the fleet prefix store",
    "--kv-spill-host-mb": "the host-RAM spill tier",
    "--kv-spill-watermark-blocks": "the host-RAM spill tier",
}


class _Unported(argparse.Action):
    """Accepts the flag (with or without a value) and exits naming it."""

    def __init__(self, option_strings, dest, what: str = "", **kw):
        kw.update(nargs="?", help=argparse.SUPPRESS)
        super().__init__(option_strings, dest, **kw)
        self.what = what

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string}: {self.what} is not ported to "
                     "megatronapp_tpu_torch yet (see ROADMAP.md)")


def build_parser() -> argparse.ArgumentParser:
    from megatronapp_tpu_torch.inference.paged_cache import (
        KV_CACHE_DTYPES, kv_cache_dtype_help,
    )
    from megatronapp_tpu_torch.models.presets import PRESETS
    ap = argparse.ArgumentParser(
        prog="python -m megatronapp_tpu_torch.serve",
        description="text-generation server on the GPU: the static "
                    "engine (MegaScope visualization) or continuous "
                    "batching over a paged KV cache (hand-written "
                    "paged-attention kernel)")
    ap.add_argument("--preset", default="gpt2-125m", choices=sorted(PRESETS))
    ap.add_argument("--tokenizer-type", default="NullTokenizer")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--params-dtype", choices=("bf16", "fp32"),
                    default="bf16",
                    help="weight storage dtype (compute is bf16 either "
                         "way)")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the preset's depth (widths are kept)")
    g = ap.add_argument_group("serving")
    g.add_argument("--engine", choices=["static", "dynamic", "mamba"],
                   default="static",
                   help="static = one generation at a time over a dense "
                        "cache (MegaScope visualization); dynamic = "
                        "continuous batching; mamba is not ported yet")
    g.add_argument("--max-batch", type=int, default=4,
                   help="concurrent decode slots")
    g.add_argument("--paged-kv-cache", action="store_true",
                   help="block-pool paged KV cache + ragged paged "
                        "attention (required by --engine dynamic: its "
                        "dense slot cache is not ported)")
    g.add_argument("--kv-block-size", type=int, default=16,
                   help="tokens per KV block")
    g.add_argument("--num-kv-blocks", type=int, default=None,
                   help="pool size (default: dense capacity)")
    g.add_argument("--no-prefix-caching", action="store_false",
                   dest="prefix_caching",
                   help="disable refcounted shared-prefix block reuse")
    g.add_argument("--kv-cache-dtype", choices=sorted(KV_CACHE_DTYPES),
                   default="bf16",
                   help="paged KV-pool storage dtype — "
                        + kv_cache_dtype_help())
    g.add_argument("--quantized-weights", action="store_true",
                   help="post-training quantization at startup: the five "
                        "matmul kernels of every layer (q, kv, out, fc1, "
                        "fc2) kept int8 on the device with per-column fp32 "
                        "scales, dequantized at matmul entry or inside the "
                        "fused kernels")
    g.add_argument("--prefill-chunk", type=int, default=32,
                   help="chunked-prefill chunk size")
    g.add_argument("--serve-tp", type=int, default=1,
                   help="tensor-parallel degree: the paged-attention "
                        "kernels run head-sharded (MLA: latent-column-"
                        "sharded) over this many ranks with per-rank KV "
                        "pools, one process a rank over a gloo group")
    g.add_argument("--megakernel-decode", action="store_true",
                   help="fused decode step: each decode and chunked-prefill "
                        "layer as the fused QKV, out-projection and MLP "
                        "kernels around paged attention (kept unfused, with "
                        "a warning, where the config is ineligible)")
    g.add_argument("--lora-dir", default=None,
                   help="serve batched multi-tenant LoRA adapters: a "
                        "directory of <adapter_id>.npz files "
                        "(LoraAdapter.save); requests pick one with "
                        "\"adapter_id\"")
    g.add_argument("--lora-rank", type=int, default=8,
                   help="rank of the adapters (the device banks are sized "
                        "A[L, slots, din, R] / B[L, slots, R, dout])")
    g.add_argument("--max-resident-adapters", type=int, default=8,
                   help="adapter slots resident on the device at once "
                        "(LRU-evicted when unpinned)")
    g.add_argument("--spec-method", default="none",
                   choices=["none", "draft", "mtp", "ngram"],
                   help="speculative decoding over the paged engine "
                        "(inference/speculative.py; needs --engine "
                        "dynamic --paged-kv-cache): draft = small draft "
                        "model (--draft-model), mtp = self-draft through "
                        "the model's MTP heads, ngram = model-free "
                        "prompt lookup. Greedy output is bit-identical "
                        "to plain decode; sampling preserves the target "
                        "distribution exactly")
    g.add_argument("--spec-k", type=int, default=4,
                   help="max draft tokens verified per round (the "
                        "verify step runs K+1 ragged queries through "
                        "the multi-query paged-attention kernel)")
    g.add_argument("--draft-model", default=None, choices=sorted(PRESETS),
                   help="models/presets.py preset for --spec-method "
                        "draft (must share the target vocab/tokenizer); "
                        "its weights are made from --seed + 1")
    g.add_argument("--serving-metrics", action="store_true",
                   help="enable the telemetry registry (GET /metrics)")
    g.add_argument("--request-trace", action="store_true",
                   help="enable the request-lifecycle tracer (GET /trace)")
    g.add_argument("--request-trace-capacity", type=int, default=16384,
                   help="ring-buffer record capacity for --request-trace")
    for flag, what in UNPORTED_FLAGS.items():
        g.add_argument(flag, action=_Unported, what=what)
    return ap


def validate_lora_args(args, multi_latent_attention: bool = False):
    """The LoRA flags' parse-time checks, with the JAX package's messages
    (megatronapp_tpu/config/arguments.py:404-432); raises SystemExit."""
    if getattr(args, "lora_dir", None):
        if getattr(args, "engine", "static") != "dynamic":
            raise SystemExit(
                "--lora-dir requires --engine dynamic (the adapter "
                "banks join the dynamic engine's decode scan; the "
                "static engine has no per-row adapter plumbing)")
        if not getattr(args, "paged_kv_cache", False):
            raise SystemExit(
                "--lora-dir requires --paged-kv-cache (the segmented "
                "LoRA delta rides the paged decode/multi-query steps)")
        if multi_latent_attention:
            raise SystemExit(
                "--lora-dir is incompatible with "
                "--multi-latent-attention: MLA factors attention "
                "through latent kernels with no q_kernel/kv_kernel "
                "leaves to adapt — serve MLA models without LoRA")
    rank = getattr(args, "lora_rank", 8)
    if rank < 1:
        raise SystemExit(
            f"--lora-rank must be >= 1 (got {rank}); the HBM banks "
            "are sized A[L, slots, din, R] / B[L, slots, R, dout]")
    max_res = getattr(args, "max_resident_adapters", 8)
    if max_res < 1:
        raise SystemExit(
            f"--max-resident-adapters must be >= 1 (got {max_res}); "
            "slot 0 is the reserved NULL adapter, so at least one "
            "managed slot is needed to serve any adapter at all")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    from megatronapp_tpu_torch.models.presets import PRESETS
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        validate_lora_args(
            args, PRESETS[args.preset]().multi_latent_attention)
    except SystemExit as e:
        ap.error(str(e))
    if args.engine == "mamba":
        ap.error("--engine mamba is not ported yet: the port serves "
                 "--engine static and --engine dynamic --paged-kv-cache")
    if args.engine == "static":
        # The JAX parser's messages where it has one (validate_serving_args).
        if args.megakernel_decode:
            ap.error("--megakernel-decode requires --engine dynamic (the "
                     "fused step is the dynamic engine's decode body)")
        for flag, on in (("--paged-kv-cache", args.paged_kv_cache),
                         ("--kv-cache-dtype", args.kv_cache_dtype != "bf16"),
                         ("--spec-method", args.spec_method != "none"),
                         ("--serve-tp", args.serve_tp != 1)):
            if on:
                ap.error(f"{flag} requires --engine dynamic (the static "
                         "engine decodes over one dense cache on one "
                         "device)")
    elif not args.paged_kv_cache:
        ap.error("--engine dynamic without --paged-kv-cache is the dense "
                 "slot cache, which is not ported yet: pass "
                 "--paged-kv-cache")
    if args.serve_tp < 1:
        ap.error(f"--serve-tp must be >= 1 (got {args.serve_tp})")
    if args.spec_method == "draft" and args.draft_model is None:
        ap.error("--spec-method draft needs --draft-model (a "
                 "models/presets.py preset)")
    if args.serve_tp > 1 and args.spec_method != "none":
        ap.error("--spec-method with --serve-tp > 1: speculative decoding "
                 "under tensor parallelism is not ported yet (ROADMAP.md "
                 "Queue 1 item 1)")
    if args.serve_tp > 1 and args.lora_dir:
        ap.error("--lora-dir with --serve-tp > 1: LoRA serving under "
                 "tensor parallelism is not ported yet (ROADMAP.md Queue 1)")
    if args.tokenizer_type != "NullTokenizer":
        ap.error(f"--tokenizer-type {args.tokenizer_type}: only the "
                 "NullTokenizer is ported (the port serves random "
                 "weights)")
    return args


def rank_device(args: argparse.Namespace, rank: int):
    """The device of tp rank `rank`: --device when given, else cuda:(rank
    mod the card count) — every rank shares the one card of a one-card
    machine."""
    from megatronapp_tpu_torch.utils.device import resolve_device
    if args.device is not None or args.serve_tp == 1:
        return resolve_device(args.device)
    resolve_device(None)
    return torch.device("cuda", rank % torch.cuda.device_count())


def free_init_method() -> str:
    """A tcp://localhost:<port> rendezvous on a port free right now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def join_tp(args: argparse.Namespace, rank: int, init_method: str):
    """Rank `rank`'s MeshContext of the --serve-tp group (None at tp 1)."""
    if args.serve_tp == 1:
        return None
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.parallel.mesh import build_mesh
    return build_mesh(ParallelConfig(tensor_parallel=args.serve_tp),
                      rank=rank, init_method=init_method,
                      device=rank_device(args, rank))


def follower_main(args: argparse.Namespace, rank: int, init_method: str):
    """A --serve-tp follower rank: the same seeded weights, stepping with
    rank 0 until it releases the followers."""
    ctx = join_tp(args, rank, init_method)
    try:
        build_engine(args, ctx).follow()
    finally:
        ctx.close()


def spawn_followers(args: argparse.Namespace, init_method: str):
    """Start ranks 1..serve_tp-1 (spawned processes running
    ``follower_main``); returns them."""
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=follower_main, args=(args, r, init_method),
                        name=f"serve-tp-rank{r}", daemon=True)
             for r in range(1, args.serve_tp)]
    for p in procs:
        p.start()
    return procs


def build_engine(args: argparse.Namespace, ctx=None):
    """The engine the server drives (--engine static or dynamic), with
    random weights from args.seed made on the device (quantized there
    with --quantized-weights, as the JAX server's startup PTQ does:
    tools/run_text_generation_server.py:123-135). ctx: this rank's
    MeshContext under --serve-tp."""
    from megatronapp_tpu_torch.data.tokenizers import NullTokenizer
    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import PRESETS
    from megatronapp_tpu_torch.utils.device import resolve_device
    device = ctx.device if ctx is not None else resolve_device(args.device)
    cfg = PRESETS[args.preset]()
    over = {"params_dtype": (torch.bfloat16 if args.params_dtype == "bf16"
                             else torch.float32)}
    if args.num_layers is not None:
        over["num_layers"] = args.num_layers
    cfg = dataclasses.replace(cfg, **over)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = init_gpt_params(cfg, gen, device)
    draft_params = draft_cfg = None
    if args.spec_method == "draft":
        # The JAX server inits the draft preset from its own key; here
        # from --seed + 1, in the target's params dtype.
        draft_cfg = dataclasses.replace(PRESETS[args.draft_model](),
                                        params_dtype=over["params_dtype"])
        draft_params = init_gpt_params(
            draft_cfg, torch.Generator(device).manual_seed(args.seed + 1),
            device)
    if args.quantized_weights:
        from megatronapp_tpu_torch.inference.quantization import (
            quantize_for_serving,
        )
        params, report = quantize_for_serving(params)
        worst = max(report.values()) if report else 0.0
        print(f"PTQ-quantized {len(report)} kernels at startup (max |w err| "
              f"{worst:.4g}); int8 kept resident")
    if args.engine == "static":
        from megatronapp_tpu_torch.inference.engine import (
            StaticInferenceEngine,
        )
        return StaticInferenceEngine(
            params, cfg, tokenizer=NullTokenizer(cfg.vocab_size),
            max_seq_len=args.max_seq_len, device=device)
    return DynamicInferenceEngine(
        params, cfg, tokenizer=NullTokenizer(cfg.vocab_size),
        max_batch=args.max_batch, max_seq_len=args.max_seq_len,
        block_size=args.kv_block_size, num_blocks=args.num_kv_blocks,
        enable_prefix_caching=args.prefix_caching,
        prefill_chunk=args.prefill_chunk,
        kv_cache_dtype=args.kv_cache_dtype, device=device,
        fused_decode=args.megakernel_decode,
        spec_method=args.spec_method, spec_k=args.spec_k,
        draft_params=draft_params, draft_cfg=draft_cfg,
        adapter_cache=build_adapter_cache(args, cfg, device), ctx=ctx)


def build_adapter_cache(args: argparse.Namespace, cfg, device):
    """The device LoRA cache of --lora-dir (None without it), as the JAX
    server builds it (tools/run_text_generation_server.py:168-187)."""
    if not args.lora_dir:
        return None
    from megatronapp_tpu_torch.inference.lora import (
        AdapterCache, AdapterRegistry,
    )
    registry = AdapterRegistry(args.lora_dir)
    cache = AdapterCache(cfg, registry,
                         max_resident=args.max_resident_adapters,
                         rank=args.lora_rank, device=device)
    print(f"LoRA serving from {args.lora_dir}: {len(registry.ids())} "
          f"adapters on disk, rank {args.lora_rank}, "
          f"{args.max_resident_adapters} resident "
          f"({cache.adapter_nbytes / 2**20:.2f} MiB each)")
    return cache


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    try:
        import aiohttp  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"the server needs aiohttp ({e}); the engine "
                         "itself runs without it") from e
    from megatronapp_tpu_torch.inference.server import TextGenerationServer
    if args.serving_metrics:
        from megatronapp_tpu_torch.utils import metrics as telemetry
        telemetry.enable()
    if args.request_trace:
        from megatronapp_tpu_torch.trace.request_trace import (
            get_request_tracer,
        )
        get_request_tracer().configure(
            enabled=True, capacity=args.request_trace_capacity)
    from megatronapp_tpu_torch.inference.quantization import resident_nbytes
    init_method = free_init_method() if args.serve_tp > 1 else ""
    followers = (spawn_followers(args, init_method) if args.serve_tp > 1
                 else [])
    ctx = join_tp(args, 0, init_method)
    engine = build_engine(args, ctx)
    if args.engine == "static":
        print(f"serving {args.preset} ({engine.cfg.num_layers} layers, "
              f"random weights seed {args.seed}) with the static engine on "
              f"{engine.device} at {args.host}:{args.port} (PUT /api, WS "
              f"/ws with MegaScope visualization; dense cache of "
              f"{engine.max_seq_len} positions, params "
              f"{resident_nbytes(engine.params) / 2**20:.1f} MiB on device"
              f"{' (resident int8)' if args.quantized_weights else ''})")
        server = TextGenerationServer(engine, args.host, args.port)
        try:
            server.run()
        finally:
            server.close()
        return
    tp = "" if ctx is None else (
        f", backend={ctx.backend}, ranks on "
        f"{[str(rank_device(args, r)) for r in range(args.serve_tp)]}, "
        f"tp_paged={engine.tp_paged}, pool "
        f"{engine.pool.bytes_total / 2**20:.1f} MiB a rank")
    print(f"serving {args.preset} ({engine.cfg.num_layers} layers, random "
          f"weights seed {args.seed}) with continuous batching on "
          f"{engine.device} at {args.host}:{args.port} (paged, block "
          f"{args.kv_block_size}, max_batch {args.max_batch}, "
          f"kv={args.kv_cache_dtype}, tp={args.serve_tp}{tp}, params "
          f"{resident_nbytes(engine.params) / 2**20:.1f} MiB on device"
          f"{' (resident int8)' if args.quantized_weights else ''}, "
          f"megakernel={engine.megakernel}, "
          f"lora={'on' if engine.adapters is not None else 'off'}, "
          f"spec={engine.spec_method or 'none'}"
          f"{f' k={engine.spec_k}' if engine.spec_method else ''})")
    server = TextGenerationServer(engine, args.host, args.port)
    try:
        server.run()
    finally:
        server.close()
        engine.release_followers()
        for p in followers:
            p.join(timeout=60)
        if ctx is not None:
            ctx.close()


if __name__ == "__main__":
    main()
