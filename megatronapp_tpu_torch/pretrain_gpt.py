"""GPT pretraining entry point, on one device or on a pp × dp × cp × tp
rank grid (the JAX package's pretrain_gpt.py).

    python -m megatronapp_tpu_torch.pretrain_gpt --preset llama3-8b \
        --num-layers 4 --seq-length 4096 --micro-batch-size 1 \
        --global-batch-size 2 --train-iters 5 --log-interval 1
    python -m megatronapp_tpu_torch.pretrain_gpt --device cpu --fp32 \
        --num-layers 2 --hidden-size 64 --num-attention-heads 4 \
        --vocab-size 128 --max-position-embeddings 64 --seq-length 32 \
        --micro-batch-size 2 --global-batch-size 4 --train-iters 10

    python -m megatronapp_tpu_torch.pretrain_gpt --preset gpt2-125m \
        --attention-impl pallas --flash-head-fold --seq-length 1024 \
        --data-path corpus/text_document --save ckpt --save-interval 100 \
        --eval-interval 100 --eval-iters 10 --metrics-jsonl m.jsonl \
        --micro-batch-size 4 --global-batch-size 8 --train-iters 1000
    python -m megatronapp_tpu_torch.serve --preset gpt2-125m \
        --engine dynamic --paged-kv-cache --load-dir ckpt

Flags keep the names, defaults and messages of the JAX package's
config/arguments.py; this entry honours the subset below, plus --preset
and --device. It trains with random weights from --seed on the card
unless --device cpu, on the .bin/.idx corpus of --data-path (a
GPTDataset, data/gpt_dataset.py) or on mock data from --seed. --save
writes checkpoints (training/checkpointing.py) and resolved_args.json;
--load (or --save again) resumes; --use-checkpoint-args takes the
architecture flags stored with --load. Any other flag of the JAX parser
(parallelism, the rerun machine, heartbeats, ...) exits with a message
naming it.

A rank grid is launched with PyTorch's launcher, one process a rank:

    torchrun --nproc-per-node 4 -m megatronapp_tpu_torch.pretrain_gpt \
        --preset llama3-8b --num-layers 2 --seq-length 4096 \
        --micro-batch-size 1 --global-batch-size 4 \
        --tensor-model-parallel-size 2 --use-distributed-optimizer \
        --train-iters 3

    torchrun --nproc-per-node 2 -m megatronapp_tpu_torch.pretrain_gpt \
        --preset llama3-8b --num-layers 4 --seq-length 4096 \
        --micro-batch-size 1 --global-batch-size 4 \
        --pipeline-model-parallel-size 2 \
        --num-layers-per-virtual-pipeline-stage 1 --train-iters 3

(--pp-schedule 1f1b | vpp | zero-bubble picks the schedule program,
--pp-plan-from-trace lets the planner re-plan it from the traced
ring-hop spans.)

--tp-comm-overlap runs the tp projections through the ring all-gather /
reduce-scatter matmuls of parallel/overlap.py, --fp8 their e4m3 twins
with delayed scaling (training/fp8.py; --fp8-margin,
--fp8-amax-history-len), and --dist-opt-comm ring | bulk returns
ZeRO-1's updated params by the ring (or one all-gather):

    torchrun --nproc-per-node 4 -m megatronapp_tpu_torch.pretrain_gpt \
        --preset llama3-8b --num-layers 2 --seq-length 4096 \
        --micro-batch-size 1 --global-batch-size 4 \
        --tensor-model-parallel-size 2 --tp-comm-overlap --fp8 \
        --dist-opt-comm ring --train-iters 2

FSDP has no flag, as in JAX: training/train.py pretrain_gpt with a ctx
of build_mesh(ParallelConfig(fsdp=True, ...)).

Context parallelism splits every sequence over --context-parallel-size
ranks (ops/context_parallel.py); --cp-comm-type p2p (the ring, in zigzag
order for causal attention), a2a (Ulysses), allgather or a2a+p2p (with
--hierarchical-context-parallel-sizes A2A RING):

    torchrun --nproc-per-node 4 -m megatronapp_tpu_torch.pretrain_gpt \
        --preset llama3-8b --num-layers 2 --seq-length 8192 \
        --micro-batch-size 1 --global-batch-size 1 \
        --context-parallel-size 2 --tensor-model-parallel-size 2 \
        --train-iters 2

A MoE model (--num-experts, or --preset mixtral-8x7b) trains on one
device or on a dp × ep × tp grid: --expert-model-parallel-size splits the
experts over ep ranks and the batch over dp × ep (transformer/moe.py's
all-to-all dispatch; --no-moe-comm-overlap for the bulk exchange):

    torchrun --nproc-per-node 4 -m megatronapp_tpu_torch.pretrain_gpt \
        --preset mixtral-8x7b --num-layers 1 --seq-length 4096 \
        --micro-batch-size 1 --global-batch-size 2 \
        --expert-model-parallel-size 2 --tensor-model-parallel-size 2 \
        --train-iters 2

MegaFBD splits the launcher's world into a forward and a backward half,
dp halved on each (parallel/fbd.py), so world = 2 · pp · (dp/2) · tp:

    torchrun --nproc-per-node 4 -m megatronapp_tpu_torch.pretrain_gpt \
        --preset llama3-8b --num-layers 4 --seq-length 4096 \
        --micro-batch-size 1 --global-batch-size 4 \
        --pipeline-model-parallel-size 2 \
        --forward-backward-disaggregating --train-iters 2

MegaDPP runs in one process over a [pp][dp] grid of stages, each on its
own CUDA stream (runtime/dpp_train.py), with the 'bfc' order:

    python -m megatronapp_tpu_torch.pretrain_gpt --preset llama3-8b \
        --num-layers 4 --seq-length 2048 --micro-batch-size 1 \
        --global-batch-size 4 --pipeline-model-parallel-size 2 \
        --num-layers-per-virtual-pipeline-stage 1 --use-dpp \
        --train-iters 3

(--data-parallel-size sets its dp, default 1; at tp > 1 under torchrun
--use-dpp logs that it runs the static 'bfc' order.) The rank count comes from the launcher's RANK,
WORLD_SIZE, LOCAL_RANK and MASTER_ADDR / MASTER_PORT; dp = world / (tp ·
pp · ep · cp); rank r computes on cuda:
(LOCAL_RANK % device count), or on the CPU with --device cpu. Without the
launcher's environment the world is one rank. The ranks join over gloo,
so several ranks may share one card: that checks kernels, shards and
collectives, never parallel speed.

MegaScan: --trace writes the traced iterations' phase spans (timed by
CUDA events on the card) to --trace-dir; merge and analyse them with

    python -m megatronapp_tpu_torch.trace.aggregate -b trace [-d]
    python -m megatronapp_tpu_torch.trace.analytics --trace-dir trace
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional

import torch

from megatronapp_tpu_torch.config.parallel_config import (
    PP_SCHEDULES, UNPORTED_PARALLEL_FIELDS, ParallelConfig,
    check_context_parallel,
)
from megatronapp_tpu_torch.config.training_config import (
    OptimizerConfig, TrainingConfig,
)
from megatronapp_tpu_torch.config.transformer_config import (
    ActivationKind, NormKind, PositionEmbeddingKind, TransformerConfig,
)

# With --preset, these flags override the preset's fields when given
# (the JAX parser's flag_to_field list).
_PRESET_OVERRIDES = ("num_layers", "hidden_size", "num_attention_heads",
                     "num_query_groups", "ffn_hidden_size", "vocab_size",
                     "max_position_embeddings", "init_method_std")
# The MoE flags → their TransformerConfig fields. Without --preset they
# build the config, as JAX's parser does; with one, a flag given
# overrides the preset's field (JAX's parser leaves the preset's fields,
# and the flag would be accepted and ignored).
_MOE_FIELDS = {"num_experts": "num_moe_experts",
               "moe_router_topk": "moe_router_topk",
               "moe_ffn_hidden_size": "moe_ffn_hidden_size",
               "moe_aux_loss_coeff": "moe_aux_loss_coeff",
               "moe_z_loss_coeff": "moe_z_loss_coeff",
               "moe_expert_capacity_factor": "moe_capacity_factor",
               "moe_layer_freq": "moe_layer_freq",
               "moe_shared_expert_intermediate_size":
                   "moe_shared_expert_intermediate_size"}


def build_parser() -> argparse.ArgumentParser:
    from megatronapp_tpu_torch.models.presets import PRESETS
    ap = argparse.ArgumentParser(
        prog="python -m megatronapp_tpu_torch.pretrain_gpt",
        description="GPT pretraining on the GPU, one device or a pp x dp "
                    "x tp rank grid "
                    "(hand-written flash-attention kernels)")
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device; "
                         "'cpu' runs the kernels' plain versions)")
    g = ap.add_argument_group("model")
    g.add_argument("--num-layers", type=int, default=12)
    g.add_argument("--hidden-size", type=int, default=768)
    g.add_argument("--num-attention-heads", type=int, default=12)
    g.add_argument("--num-query-groups", type=int, default=None)
    g.add_argument("--ffn-hidden-size", type=int, default=None)
    g.add_argument("--kv-channels", type=int, default=None)
    g.add_argument("--vocab-size", type=int, default=50304)
    g.add_argument("--max-position-embeddings", type=int, default=2048)
    g.add_argument("--position-embedding-type", default="rope",
                   choices=[k.value for k in PositionEmbeddingKind])
    g.add_argument("--rotary-base", type=float, default=10000.0)
    g.add_argument("--rotary-percent", type=float, default=1.0)
    g.add_argument("--normalization", default="LayerNorm",
                   choices=[k.value for k in NormKind])
    g.add_argument("--swiglu", action="store_true")
    g.add_argument("--squared-relu", action="store_true")
    g.add_argument("--disable-bias-linear", action="store_true")
    g.add_argument("--add-qkv-bias", action="store_true")
    g.add_argument("--qk-layernorm", action="store_true")
    g.add_argument("--untie-embeddings-and-output-weights",
                   action="store_true")
    g.add_argument("--init-method-std", type=float, default=0.02)
    g = ap.add_argument_group("moe")
    g.add_argument("--num-experts", type=int, default=None)
    g.add_argument("--moe-router-topk", type=int, default=2)
    g.add_argument("--moe-ffn-hidden-size", type=int, default=None)
    g.add_argument("--moe-aux-loss-coeff", type=float, default=0.0)
    g.add_argument("--moe-z-loss-coeff", type=float, default=0.0)
    g.add_argument("--moe-expert-capacity-factor", type=float, default=None)
    g.add_argument("--moe-layer-freq", type=int, default=1)
    g.add_argument("--moe-shared-expert-intermediate-size", type=int,
                   default=None)
    g = ap.add_argument_group("mtp")
    g.add_argument("--mtp-num-layers", type=int, default=None)
    g.add_argument("--mtp-loss-scaling-factor", type=float, default=0.1)
    g = ap.add_argument_group("training")
    g.add_argument("--micro-batch-size", type=int, default=1)
    g.add_argument("--global-batch-size", type=int, default=8)
    g.add_argument("--rampup-batch-size", nargs=3, type=int, default=None,
                   metavar=("START", "INCR", "SAMPLES"),
                   help="linear global-batch rampup (reference "
                        "--rampup-batch-size)")
    g.add_argument("--seq-length", type=int, default=1024)
    g.add_argument("--train-iters", type=int, default=100)
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--log-interval", type=int, default=10)
    g.add_argument("--eval-interval", type=int, default=None)
    g.add_argument("--eval-iters", type=int, default=10)
    g.add_argument("--exit-interval", type=int, default=None)
    g.add_argument("--recompute-granularity", default="selective",
                   choices=["none", "selective", "selective_attn", "full"])
    g.add_argument("--attention-impl", default="auto",
                   choices=["auto", "pallas", "reference"])
    g.add_argument("--flash-min-seq", type=int, default=2048)
    g.add_argument("--flash-head-fold", action="store_true")
    g.add_argument("--bf16", action="store_true", default=True)
    g.add_argument("--fp32", action="store_true",
                   help="disable bf16 compute")
    g = ap.add_argument_group("distributed")
    g.add_argument("--tensor-model-parallel-size", type=int, default=1)
    g.add_argument("--pipeline-model-parallel-size", type=int, default=1)
    g.add_argument("--context-parallel-size", type=int, default=1)
    g.add_argument("--expert-model-parallel-size", type=int, default=1)
    g.add_argument("--no-moe-comm-overlap", action="store_false",
                   dest="moe_comm_overlap",
                   help="disable the chunked latency-hiding MoE "
                        "all-to-all (transformer/moe.py); falls back to "
                        "the bulk two-collective dispatch")
    g.add_argument("--hierarchical-context-parallel-sizes", nargs=2,
                   type=int, default=None, metavar=("A2A", "RING"),
                   help="inner a2a x outer ring sizes for "
                        "cp-comm-type a2a+p2p (reference flag)")
    g.add_argument("--no-cp-comm-overlap", action="store_false",
                   dest="cp_comm_overlap",
                   help="disable the latency-hiding ring-attention path "
                        "(pre-issued KV hops + fused custom_vjp reverse "
                        "ring, ops/context_parallel.py); falls back to "
                        "the plain unrolled ring")
    g.add_argument("--cp-comm-type", default="p2p",
                   choices=["p2p", "a2a", "allgather", "a2a+p2p"])
    g.add_argument("--num-layers-per-virtual-pipeline-stage", type=int,
                   default=None)
    g.add_argument("--pp-schedule", default="1f1b",
                   choices=list(PP_SCHEDULES),
                   help="pipeline schedule program (parallel/schedule.py): "
                        "1f1b (interleaved automatically when vpp > 1), "
                        "vpp (alias requiring "
                        "--num-layers-per-virtual-pipeline-stage), or "
                        "zero-bubble (backward split into B=dgrad / "
                        "W=wgrad; W deferred into bubble slots, the "
                        "weight update fenced on all W done)")
    g.add_argument("--pp-plan-from-trace", action="store_true",
                   help="let the trace-driven planner "
                        "(parallel/schedule.Planner) retune the schedule "
                        "from per-stage step-time EWMAs (MegaScan ring-hop "
                        "spans + whole-step times); re-plans log loudly "
                        "and rebuild the train step")
    g.add_argument("--data-parallel-size", type=int, default=None,
                   help="dp of --use-dpp's one-process stage grid (default "
                        "1); under torchrun it must equal world / (tp x pp x cp)")
    g.add_argument("--forward-backward-disaggregating", action="store_true",
                   help="MegaFBD: the world splits into forward and "
                        "backward halves, dp halved on each "
                        "(parallel/fbd.py)")
    g.add_argument("--use-dpp", action="store_true",
                   help="breadth-first-chunk pipeline order (MegaDPP); at "
                        "tp 1 the readiness-ordered runtime in one process "
                        "(runtime/dpp_train.py)")
    g.add_argument("--sequence-parallel", action="store_true",
                   help="accepted; changes no number (as in JAX, no layer "
                        "reads it)")
    g.add_argument("--use-distributed-optimizer", action="store_true",
                   default=True,
                   help="ZeRO-1 (default on): Adam m/v sharded over dp, "
                        "grads reduce-scattered, params all-gathered")
    g.add_argument("--no-use-distributed-optimizer", action="store_false",
                   dest="use_distributed_optimizer",
                   help="replicate optimizer state on every dp rank")
    g.add_argument("--exp-avg-dtype", default="fp32",
                   help="storage dtype of Adam's first moment: fp32 | bf16 "
                        "(update math fp32; requires "
                        "--use-distributed-optimizer)")
    g.add_argument("--exp-avg-sq-dtype", default="fp32",
                   help="storage dtype of Adam's second moment: fp32 | "
                        "bf16 (requires --use-distributed-optimizer)")
    g.add_argument("--tp-comm-overlap", action="store_true",
                   help="overlap tensor-parallel collectives with the "
                        "dependent GEMMs via manual ring all-gather / "
                        "reduce-scatter matmuls (parallel/overlap.py)")
    g.add_argument("--dist-opt-comm", default="gspmd",
                   choices=["gspmd", "ring", "bulk"],
                   help="how ZeRO-1's updated params return over dp: "
                        "gspmd = the all-gather into the flat buffer; "
                        "ring = the ring all-gather of parallel/overlap.py "
                        "(host-staged hops); bulk = the same all-gather as "
                        "gspmd (JAX's tiled gather)")
    g.add_argument("--fp8", action="store_true",
                   help="fp8 (e4m3) GEMMs with delayed-scaling amax "
                        "history inside the tp-overlap ring matmuls "
                        "(fwd + bwd; parallel/overlap.py). Requires "
                        "--tp-comm-overlap with tp > 1 on a pp==1, "
                        "cp==1, dense non-MLA/non-MoE layout; the amax/"
                        "scale state rides the train state, so "
                        "checkpoints resume bitwise")
    g.add_argument("--fp8-margin", type=int, default=0,
                   help="delayed-scaling margin: scale = FP8_MAX / "
                        "(amax * 2**margin) — headroom against "
                        "inter-step amax growth (TE --fp8-margin)")
    g.add_argument("--fp8-amax-history-len", type=int, default=16,
                   help="amax history window per (layer, site, tensor); "
                        "the scale follows the max over the window "
                        "(TE --fp8-amax-history-len)")
    g = ap.add_argument_group("optimizer")
    g.add_argument("--lr", type=float, default=3e-4)
    g.add_argument("--min-lr", type=float, default=3e-5)
    g.add_argument("--lr-decay-style", default="cosine",
                   choices=["cosine", "linear", "constant"])
    g.add_argument("--lr-warmup-iters", type=int, default=0)
    g.add_argument("--lr-decay-iters", type=int, default=None)
    g.add_argument("--weight-decay", type=float, default=0.01)
    g.add_argument("--adam-beta1", type=float, default=0.9)
    g.add_argument("--adam-beta2", type=float, default=0.95)
    g.add_argument("--adam-eps", type=float, default=1e-8)
    g.add_argument("--clip-grad", type=float, default=1.0)
    g.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    g = ap.add_argument_group("checkpointing")
    g.add_argument("--save", default=None, metavar="DIR")
    g.add_argument("--load", default=None, metavar="DIR")
    g.add_argument("--save-interval", type=int, default=None)
    g.add_argument("--use-checkpoint-args", action="store_true",
                   help="apply args.json stored with the --load checkpoint "
                        "as defaults (explicit flags still override; "
                        "reference --use-checkpoint-args)")
    g = ap.add_argument_group("data")
    g.add_argument("--data-path", default=None,
                   help=".bin/.idx prefix; omit for the mock dataset")
    g = ap.add_argument_group("logging")
    g.add_argument("--tensorboard-dir", default=None)
    g.add_argument("--metrics-jsonl", default=None,
                   help="append per-log-step scalars to this JSONL file")
    g = ap.add_argument_group("fault-tolerance")
    g.add_argument("--exit-signal-handler", action="store_true",
                   help="SIGTERM finishes the in-flight step, force-"
                        "saves an emergency checkpoint (durable + local "
                        "when configured) with resumable side state, "
                        "and exits cleanly; the exit decision is agreed "
                        "across processes")
    g.add_argument("--exit-signal-handler-sigint", action="store_true",
                   help="additionally catch SIGINT (^C) — implies "
                        "--exit-signal-handler")
    g.add_argument("--non-persistent-save-interval", type=int,
                   default=None, metavar="N",
                   help="fast latest-only local checkpoint every N "
                        "steps (LocalCheckpointManager .npz, atomic "
                        "rename) — cheap enough for small N; restore "
                        "prefers the freshest of (local, durable)")
    g.add_argument("--non-persistent-ckpt-dir", default=None,
                   metavar="DIR",
                   help="directory for the local checkpoints (default: "
                        "<--save>/non_persistent)")
    g = ap.add_argument_group("megascan")
    g.add_argument("--trace", action="store_true")
    g.add_argument("--trace-interval", type=int, default=5)
    g.add_argument("--continuous-trace-iterations", type=int, default=2)
    g.add_argument("--trace-dir", default="trace")
    g.add_argument("--trace-granularity", default="full",
                   choices=["full", "schedule", "collective"])
    return ap


_ARGS_FILE = "resolved_args.json"

# The JAX parser's flags of axes the port lacks → the ROADMAP.md item
# that ports them: ParallelConfig's unported fields' flags, and TP
# overlap's two.
UNPORTED_FLAGS = dict(UNPORTED_PARALLEL_FIELDS.values())

# Flags the JAX parser does not have either, and what to use instead.
NOT_JAX_FLAGS = {
    "--use-custom-fsdp": ("FSDP is reached through "
                          "ParallelConfig(fsdp=True), as in JAX, whose CLI "
                          "has no FSDP flag (training/train.py "
                          "pretrain_gpt(..., ctx=build_mesh("
                          "ParallelConfig(fsdp=True, ...))))"),
}

# Args --use-checkpoint-args must NOT resurrect from a stored run: the JAX
# parser's set, and --device (where this invocation runs: a run rehearsed
# with --device cpu resumes on the card unless asked otherwise).
_RUN_CONTROL_ARGS = frozenset({
    "save", "load", "save_interval", "train_iters", "exit_interval",
    "use_checkpoint_args", "config_yaml", "data_path", "metrics_jsonl",
    "tensorboard_dir", "trace", "trace_dir", "log_interval",
    "eval_interval", "eval_iters", "device",
})


def save_resolved_args(args, save_dir: str, layout: Optional[dict] = None):
    """The resolved flag namespace as resolved_args.json beside the
    checkpoints (the JAX package's file and keys), with the grid it ran
    on under "layout" (world, dp, tp, cp, ZeRO-1)."""
    os.makedirs(save_dir, exist_ok=True)
    payload = {k: v for k, v in vars(args).items()
               if isinstance(v, (int, float, str, bool, list, tuple,
                                 type(None)))}
    if layout is not None:
        payload["layout"] = dict(layout)
    with open(os.path.join(save_dir, _ARGS_FILE), "w") as f:
        json.dump(payload, f, indent=1)


def load_saved_args(load_dir: str) -> Optional[dict]:
    path = os.path.join(load_dir, _ARGS_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse with --use-checkpoint-args' stored values as defaults
    (parser defaults < stored values < explicit flags)."""
    ap = build_parser()
    pre, _ = ap.parse_known_args(argv)
    if pre.use_checkpoint_args:
        if not pre.load:
            raise ValueError("--use-checkpoint-args requires --load")
        stored = load_saved_args(pre.load) or {}
        # Architecture / hyperparameter args only: run control stays
        # with this invocation.
        defaults = {k: v for k, v in stored.items()
                    if k not in _RUN_CONTROL_ARGS}
        defaults.pop("layout", None)
        unknown = sorted(set(defaults) - {a.dest for a in ap._actions})
        if unknown:
            raise ValueError(f"unknown config keys: {unknown}")
        ap.set_defaults(**defaults)
    args, rest = ap.parse_known_args(argv)
    if rest:
        flags = [a.split("=")[0] for a in rest if a.startswith("-")]
        for f in flags:
            if f in NOT_JAX_FLAGS:
                ap.error(f"{f}: not a flag of megatronapp_tpu_torch; "
                         f"{NOT_JAX_FLAGS[f]}")
            if f in UNPORTED_FLAGS:
                ap.error(f"{f}: not ported to megatronapp_tpu_torch yet "
                         f"(ROADMAP.md {UNPORTED_FLAGS[f]})")
        ap.error(f"{', '.join(flags or rest)}: not ported to "
                 "megatronapp_tpu_torch yet (the trainer honours the flags "
                 "in --help; see ROADMAP.md)")
    for flag in ("tensor_model_parallel_size",
                 "pipeline_model_parallel_size", "context_parallel_size",
                 "expert_model_parallel_size"):
        if getattr(args, flag) < 1:
            ap.error(f"--{flag.replace('_', '-')} must be >= 1, got "
                     f"{getattr(args, flag)}")
    check_context_parallel(args.seq_length, args.context_parallel_size,
                           args.cp_comm_type,
                           args.hierarchical_context_parallel_sizes)
    low = [f for f, v in (("--exp-avg-dtype", args.exp_avg_dtype),
                          ("--exp-avg-sq-dtype", args.exp_avg_sq_dtype))
           if str(v).lower() not in ("fp32", "float32")]
    if low and not args.use_distributed_optimizer:
        ap.error(f"{'/'.join(low)} bf16 require --use-distributed-optimizer:"
                 " low-precision moments are only supported on the ZeRO-1 "
                 "state layout (the replicated chain stores fp32)")
    if low and args.forward_backward_disaggregating:
        raise ValueError(
            "--exp-avg-dtype/--exp-avg-sq-dtype bf16 are not supported "
            "with --forward-backward-disaggregating: the FBD path runs "
            "the replicated optax chain (ZeRO-1 wiring is a ROADMAP "
            "follow-up)")
    return args


def _ft_fields(args: argparse.Namespace) -> dict:
    """The checkpoint / signal TrainingConfig fields, rejecting what the
    loop cannot resolve at parse time (JAX arguments.py:1005-1020)."""
    npsi = args.non_persistent_save_interval
    if npsi is not None and npsi <= 0:
        raise ValueError(
            f"--non-persistent-save-interval must be a positive step "
            f"count, got {npsi}")
    if npsi and not (args.non_persistent_ckpt_dir or args.save):
        raise ValueError(
            "--non-persistent-save-interval needs a directory: pass "
            "--non-persistent-ckpt-dir or --save (the default is "
            "<--save>/non_persistent)")
    return dict(
        exit_signal_handler=(args.exit_signal_handler
                             or args.exit_signal_handler_sigint),
        exit_signal_handler_sigint=args.exit_signal_handler_sigint,
        non_persistent_save_interval=npsi,
        non_persistent_ckpt_dir=args.non_persistent_ckpt_dir)


def configs_from_args(args: argparse.Namespace):
    """(TransformerConfig, TrainingConfig, OptimizerConfig)."""
    compute = torch.float32 if args.fp32 else torch.bfloat16
    if args.preset:
        from megatronapp_tpu_torch.models.presets import PRESETS
        defaults = build_parser().parse_args([])
        over = {f: getattr(args, f) for f in _PRESET_OVERRIDES
                if getattr(args, f) != getattr(defaults, f)}
        over.update({field: getattr(args, flag)
                     for flag, field in _MOE_FIELDS.items()
                     if getattr(args, flag) != getattr(defaults, flag)})
        if args.mtp_num_layers is not None:
            over.update(mtp_num_layers=args.mtp_num_layers,
                        mtp_loss_scaling_factor=args.mtp_loss_scaling_factor)
        model = dataclasses.replace(PRESETS[args.preset](), **over)
    else:
        activation = ActivationKind.gelu
        if args.swiglu:
            activation = ActivationKind.swiglu
        elif args.squared_relu:
            activation = ActivationKind.squared_relu
        model = TransformerConfig(
            num_layers=args.num_layers, hidden_size=args.hidden_size,
            num_attention_heads=args.num_attention_heads,
            num_query_groups=args.num_query_groups,
            ffn_hidden_size=args.ffn_hidden_size,
            kv_channels=args.kv_channels, vocab_size=args.vocab_size,
            max_position_embeddings=args.max_position_embeddings,
            position_embedding=PositionEmbeddingKind(
                args.position_embedding_type),
            rotary_base=args.rotary_base,
            rotary_percent=args.rotary_percent,
            normalization=NormKind(args.normalization),
            activation=activation,
            add_bias_linear=not args.disable_bias_linear,
            add_qkv_bias=args.add_qkv_bias, qk_layernorm=args.qk_layernorm,
            untie_embeddings_and_output_weights=(
                args.untie_embeddings_and_output_weights),
            init_method_std=args.init_method_std,
            mtp_num_layers=args.mtp_num_layers,
            mtp_loss_scaling_factor=args.mtp_loss_scaling_factor,
            **{field: getattr(args, flag)
               for flag, field in _MOE_FIELDS.items()})
    model = dataclasses.replace(
        model, remat_policy=args.recompute_granularity,
        cp_comm_type=args.cp_comm_type,
        hierarchical_cp_a2a_size=cp_a2a_size(args),
        cp_comm_overlap=args.cp_comm_overlap,
        moe_comm_overlap=args.moe_comm_overlap,
        attention_impl=args.attention_impl,
        flash_min_seq=args.flash_min_seq,
        flash_head_fold=args.flash_head_fold, compute_dtype=compute,
        tp_comm_overlap=args.tp_comm_overlap)
    if args.fp8:
        model = dataclasses.replace(
            model, fp8=True, fp8_margin=args.fp8_margin,
            fp8_amax_history_len=args.fp8_amax_history_len)
    # JAX's parse-time checks of --fp8 and --tp-comm-overlap
    # (config/arguments.py:1183-1225), the trainer's on the flags' grid.
    from megatronapp_tpu_torch.training.train import check_grid_features
    check_grid_features(model, None, ParallelConfig(
        tensor_parallel=args.tensor_model_parallel_size,
        pipeline_parallel=args.pipeline_model_parallel_size,
        context_parallel=args.context_parallel_size,
        forward_backward_disaggregating=args.forward_backward_disaggregating,
        use_dpp=args.use_dpp))
    training = TrainingConfig(
        micro_batch_size=args.micro_batch_size,
        global_batch_size=args.global_batch_size,
        seq_length=args.seq_length, train_iters=args.train_iters,
        seed=args.seed, log_interval=args.log_interval,
        rampup_batch_size=(tuple(args.rampup_batch_size)
                           if args.rampup_batch_size else None),
        eval_interval=args.eval_interval, eval_iters=args.eval_iters,
        exit_interval=args.exit_interval, save_dir=args.save,
        load_dir=args.load, save_interval=args.save_interval,
        metrics_jsonl=args.metrics_jsonl,
        tensorboard_dir=args.tensorboard_dir, **_ft_fields(args),
        trace=args.trace,
        trace_interval=args.trace_interval,
        continuous_trace_iterations=args.continuous_trace_iterations,
        trace_dir=args.trace_dir, trace_granularity=args.trace_granularity)
    optimizer = OptimizerConfig(
        optimizer=args.optimizer, lr=args.lr, min_lr=args.min_lr,
        lr_decay_style=args.lr_decay_style,
        lr_warmup_iters=args.lr_warmup_iters,
        lr_decay_iters=args.lr_decay_iters, weight_decay=args.weight_decay,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_eps=args.adam_eps, clip_grad=args.clip_grad,
        exp_avg_dtype=args.exp_avg_dtype,
        exp_avg_sq_dtype=args.exp_avg_sq_dtype,
        dist_opt_comm=args.dist_opt_comm)
    return model, training, optimizer


def cp_a2a_size(args: argparse.Namespace) -> int:
    """The inner all-to-all size of --cp-comm-type a2a+p2p: the first of
    --hierarchical-context-parallel-sizes, else 2 (JAX's default)."""
    sizes = args.hierarchical_context_parallel_sizes
    return sizes[0] if sizes else 2


def parallel_from_args(args: argparse.Namespace) -> ParallelConfig:
    """The grid's ParallelConfig, with JAX's parse-time rules
    (config/arguments.py:1135-1157): vpp = (layers / pp) /
    --num-layers-per-virtual-pipeline-stage, which must divide the
    layers a stage holds; the schedule's own checks in ParallelConfig."""
    pp = args.pipeline_model_parallel_size
    vpp = 1
    if args.num_layers_per_virtual_pipeline_stage:
        per_stage = configs_from_args(args)[0].num_layers // pp
        if per_stage % args.num_layers_per_virtual_pipeline_stage != 0:
            raise ValueError(
                "--num-layers-per-virtual-pipeline-stage must divide "
                "layers-per-stage")
        vpp = per_stage // args.num_layers_per_virtual_pipeline_stage
    return ParallelConfig(
        tensor_parallel=args.tensor_model_parallel_size,
        pipeline_parallel=pp, virtual_pipeline_parallel=vpp,
        context_parallel=args.context_parallel_size,
        expert_parallel=args.expert_model_parallel_size,
        data_parallel=args.data_parallel_size,
        sequence_parallel=args.sequence_parallel,
        distributed_optimizer=args.use_distributed_optimizer,
        forward_backward_disaggregating=(
            args.forward_backward_disaggregating),
        pipeline_order_policy="bfc" if args.use_dpp else "dfc",
        use_dpp=args.use_dpp,
        pp_schedule=args.pp_schedule,
        pp_plan_from_trace=args.pp_plan_from_trace)


def launch_env(env=None) -> Optional[dict]:
    """The launcher's rank, world size, local rank and meeting point
    (torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
    None without them (the world is then one rank)."""
    env = os.environ if env is None else env
    if "WORLD_SIZE" not in env or "RANK" not in env:
        return None
    return {"rank": int(env["RANK"]), "world_size": int(env["WORLD_SIZE"]),
            "local_rank": int(env.get("LOCAL_RANK", env["RANK"])),
            "init_method": (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                            f"{env['MASTER_PORT']}"
                            if "MASTER_PORT" in env else "env://")}


def rank_device(device: Optional[str], local_rank: int):
    """Rank `local_rank`'s device: cuda:(local_rank % device count), or
    the CPU when device is "cpu" (raises without a card otherwise)."""
    if device is not None and str(device).startswith("cpu"):
        return torch.device("cpu")
    from megatronapp_tpu_torch.utils.device import resolve_device
    resolve_device(None)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def build_grid(args: argparse.Namespace, rank: int, world_size: int,
               init_method: str, local_rank: Optional[int] = None):
    """This rank's MeshContext of the --tensor-model-parallel-size x
    --context-parallel-size x --expert-model-parallel-size x
    --pipeline-model-parallel-size grid over
    world_size ranks (with --forward-backward-disaggregating, of its half
    of the world); None for one rank at tp, cp and pp 1 (the one-device
    trainer) and for --use-dpp at tp = cp = 1 (its runtime places the
    stages in this process)."""
    from megatronapp_tpu_torch.training.train import DPP_ONE_PROCESS
    parallel = parallel_from_args(args)
    dpp = parallel.use_dpp and parallel.pipeline_parallel > 1 and \
        parallel.tensor_parallel == 1 and parallel.context_parallel == 1
    if dpp and world_size > 1:
        raise ValueError(DPP_ONE_PROCESS)
    if dpp:
        return None
    parallel.infer_data_parallel(world_size)
    if world_size == 1 and parallel.tensor_parallel == 1 and \
            parallel.pipeline_parallel == 1 and \
            parallel.context_parallel == 1 and \
            parallel.expert_parallel == 1:
        return None
    dev = rank_device(args.device, rank if local_rank is None
                      else local_rank)
    a2a = cp_a2a_size(args) if args.cp_comm_type == "a2a+p2p" else None
    if parallel.forward_backward_disaggregating:
        from megatronapp_tpu_torch.parallel.fbd import split_fbd_meshes
        return split_fbd_meshes(parallel, rank=rank, init_method=init_method,
                                device=dev, world_size=world_size,
                                cp_a2a_size=a2a)
    from megatronapp_tpu_torch.parallel.mesh import build_mesh
    return build_mesh(parallel, rank=rank, init_method=init_method,
                      device=dev, world_size=world_size, cp_a2a_size=a2a)


def train(args: argparse.Namespace, ctx=None):
    """Train as the entry point does, as one rank of `ctx` (None: one
    device); returns the TrainResult. Every rank of a grid calls it."""
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    model, training, optimizer = configs_from_args(args)
    parallel = parallel_from_args(args)
    # Under MegaFBD the backward half's lead writes and prints.
    lead = ctx is None or (ctx.is_lead and ctx.fbd_role != "forward")
    if args.save and lead:
        layout = {"world": 1 if ctx is None else ctx.world,
                  "dp": 1 if ctx is None else ctx.dp,
                  "tp": 1 if ctx is None else ctx.tp,
                  "cp": 1 if ctx is None else ctx.cp,
                  "ep": 1 if ctx is None else ctx.ep,
                  "zero1": bool(ctx is not None and ctx.batch > 1
                                and args.use_distributed_optimizer)}
        if ctx is not None and ctx.pp > 1:
            layout.update(pp=ctx.pp, vpp=ctx.vpp)
        if ctx is not None and ctx.fbd_role is not None:
            layout.update(world=2 * ctx.world, fbd=True)
        if ctx is None and parallel.use_dpp and \
                parallel.pipeline_parallel > 1:
            layout.update(dpp={"pp": parallel.pipeline_parallel,
                               "vpp": parallel.virtual_pipeline_parallel,
                               "dp": parallel.data_parallel or 1})
        save_resolved_args(args, args.save, layout)
    factory = make_batch_iter_factory(args, training, model)
    result = pretrain_gpt(model, training, optimizer, device=args.device,
                          batch_iter_factory=factory, ctx=ctx,
                          parallel=parallel if ctx is None else None)
    if result.losses and lead:
        print(f"done: final loss {result.losses[-1]:.4f}, "
              f"{result.tokens_per_sec:,.0f} tok/s")
    return result


def make_batch_iter_factory(args: argparse.Namespace,
                            training: TrainingConfig,
                            model: TransformerConfig):
    """The batch-stream factory of --data-path (.bin/.idx): called with the
    resume sample offset, so a restart skips the consumed samples; None
    without --data-path (pretrain_gpt then streams mock batches)."""
    if not args.data_path:
        return None
    from megatronapp_tpu_torch.data.gpt_dataset import (
        GPTDataset, gpt_batches,
    )
    from megatronapp_tpu_torch.data.indexed_dataset import IndexedDataset
    indexed = IndexedDataset(args.data_path)
    num_samples = training.train_iters * training.global_batch_size
    ds = GPTDataset(indexed, training.seq_length, num_samples,
                    seed=training.seed)

    def factory(start_sample_idx: int = 0):
        return gpt_batches(ds, training.global_batch_size,
                           start_idx=start_sample_idx)

    return factory


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    env = launch_env()
    world = 1 if env is None else env["world_size"]
    ctx = build_grid(args, 0 if env is None else env["rank"], world,
                     "tcp://localhost:0" if env is None
                     else env["init_method"],
                     None if env is None else env["local_rank"])
    try:
        return train(args, ctx)
    finally:
        if ctx is not None:
            ctx.close()


if __name__ == "__main__":
    main()
