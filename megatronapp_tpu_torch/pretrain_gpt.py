"""GPT pretraining entry point on one device (the JAX package's
pretrain_gpt.py for the single-device path).

    python -m megatronapp_tpu_torch.pretrain_gpt --preset llama3-8b \
        --num-layers 4 --seq-length 4096 --micro-batch-size 1 \
        --global-batch-size 2 --train-iters 5 --log-interval 1
    python -m megatronapp_tpu_torch.pretrain_gpt --device cpu --fp32 \
        --num-layers 2 --hidden-size 64 --num-attention-heads 4 \
        --vocab-size 128 --max-position-embeddings 64 --seq-length 32 \
        --micro-batch-size 2 --global-batch-size 4 --train-iters 10

Flags keep the names of the JAX package's config/arguments.py; this
entry honours the subset below, plus --preset and --device. It trains on
mock data from --seed with random weights from --seed, on the card unless
--device cpu. Any other flag of the JAX parser (parallelism, checkpoints,
data paths, ...) exits with a message naming it.

MegaScan: --trace writes the traced iterations' phase spans (timed by
CUDA events on the card) to --trace-dir; merge and analyse them with

    python -m megatronapp_tpu_torch.trace.aggregate -b trace [-d]
    python -m megatronapp_tpu_torch.trace.analytics --trace-dir trace
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch

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


def build_parser() -> argparse.ArgumentParser:
    from megatronapp_tpu_torch.models.presets import PRESETS
    ap = argparse.ArgumentParser(
        prog="python -m megatronapp_tpu_torch.pretrain_gpt",
        description="single-device GPT pretraining on the GPU "
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
    g = ap.add_argument_group("training")
    g.add_argument("--micro-batch-size", type=int, default=1)
    g.add_argument("--global-batch-size", type=int, default=8)
    g.add_argument("--seq-length", type=int, default=1024)
    g.add_argument("--train-iters", type=int, default=100)
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--log-interval", type=int, default=10)
    g.add_argument("--recompute-granularity", default="selective",
                   choices=["none", "selective", "selective_attn", "full"])
    g.add_argument("--attention-impl", default="auto",
                   choices=["auto", "pallas", "reference"])
    g.add_argument("--flash-min-seq", type=int, default=2048)
    g.add_argument("--flash-head-fold", action="store_true")
    g.add_argument("--bf16", action="store_true", default=True)
    g.add_argument("--fp32", action="store_true",
                   help="disable bf16 compute")
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
    g = ap.add_argument_group("megascan")
    g.add_argument("--trace", action="store_true")
    g.add_argument("--trace-interval", type=int, default=5)
    g.add_argument("--continuous-trace-iterations", type=int, default=2)
    g.add_argument("--trace-dir", default="trace")
    g.add_argument("--trace-granularity", default="full",
                   choices=["full", "schedule", "collective"])
    return ap


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = build_parser()
    args, rest = ap.parse_known_args(argv)
    if rest:
        flags = [a.split("=")[0] for a in rest if a.startswith("-")]
        ap.error(f"{', '.join(flags or rest)}: not ported to "
                 "megatronapp_tpu_torch yet (the single-device trainer "
                 "honours the flags in --help; see ROADMAP.md)")
    return args


def configs_from_args(args: argparse.Namespace):
    """(TransformerConfig, TrainingConfig, OptimizerConfig)."""
    compute = torch.float32 if args.fp32 else torch.bfloat16
    if args.preset:
        from megatronapp_tpu_torch.models.presets import PRESETS
        defaults = build_parser().parse_args([])
        over = {f: getattr(args, f) for f in _PRESET_OVERRIDES
                if getattr(args, f) != getattr(defaults, f)}
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
            init_method_std=args.init_method_std)
    model = dataclasses.replace(
        model, remat_policy=args.recompute_granularity,
        attention_impl=args.attention_impl,
        flash_min_seq=args.flash_min_seq,
        flash_head_fold=args.flash_head_fold, compute_dtype=compute)
    training = TrainingConfig(
        micro_batch_size=args.micro_batch_size,
        global_batch_size=args.global_batch_size,
        seq_length=args.seq_length, train_iters=args.train_iters,
        seed=args.seed, log_interval=args.log_interval, trace=args.trace,
        trace_interval=args.trace_interval,
        continuous_trace_iterations=args.continuous_trace_iterations,
        trace_dir=args.trace_dir, trace_granularity=args.trace_granularity)
    optimizer = OptimizerConfig(
        optimizer=args.optimizer, lr=args.lr, min_lr=args.min_lr,
        lr_decay_style=args.lr_decay_style,
        lr_warmup_iters=args.lr_warmup_iters,
        lr_decay_iters=args.lr_decay_iters, weight_decay=args.weight_decay,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_eps=args.adam_eps, clip_grad=args.clip_grad)
    return model, training, optimizer


def main(argv: Optional[List[str]] = None):
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    args = parse_args(argv)
    model, training, optimizer = configs_from_args(args)
    result = pretrain_gpt(model, training, optimizer, device=args.device)
    print(f"done: final loss {result.losses[-1]:.4f}, "
          f"{result.tokens_per_sec:,.0f} tok/s")
    return result


if __name__ == "__main__":
    main()
