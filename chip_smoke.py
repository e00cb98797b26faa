"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, all 32 llama3-8b layers
    python3 chip_smoke.py --layers 4 # the same with the served depth cut

Phases, each printing one JSON line:

1. device:  the card (nvidia-smi name and power limit) and the kernel
            builds from the sources in the checkout (one nvcc per source,
            started together; sm_90a).
2. kernels: the bf16-pool paged-attention kernel (split KV) against its
            plain PyTorch version on the card, decode and ragged modes, at
            llama3-8b attention shapes (block sizes 16, 64 and 8; short
            slots in a 2048-position table, so more splits than pages; a
            B 1 chunk at kv 2047 across several splits; the speculative
            verify step, B 8 of S_q 5 with q_lens 1..5 and kv on and one
            past block edges and at 2047 of 2048, also on int8 and fp8
            pools in kv_quant_kernels, at S_q 4 and 5 for the latent kernel
            in mla_kernels, and at 40 rows for the fused kernels, bf16 and
            int8, with LoRA behind its shrink) and one gpt2-125m (MHA,
            D=64) shape; each rerun repeats every bit.
3. reference: a tiny llama-shaped model's chunked-prefill logits on the
            card (bf16, kernel) against the same weights on the CPU
            (fp32, plain versions).
   fused_kernels: the four fused decode-layer kernels (QKV, out-projection,
            fc1, fc2) against their plain versions on the card: llama3-8b
            at 8 and 32 rows, gpt2-125m (LayerNorm, biases, gelu, D 64),
            and a QK-layernorm case with fp32 weights at 5 and 40 rows;
            reruns bit for bit, and every kernel's rows the same bits in
            another batch.
   fused_reference: a tiny llama-shaped model's fused chunked-prefill and
            decode step on the card (bf16, kernels) against the same
            weights on the CPU (fp32, plain versions).
   kv_quant_kernels: the quantized paged-attention kernel (int8 and fp8
            pools with fp32 scale pools; split KV on the tensor cores)
            against its plain version on the same pools: decode and
            ragged at llama3-8b attention shapes, block size 64, short
            slots in a 2048-position table, a chunk at kv 2047, and
            gpt2-125m; within 5e-3, its bf16 output within one ulp of
            bf16(plain) on all but 1 % of the elements (an fp32-grade
            body), reruns bit for bit, each launch's split count.
   fused_int8_kernels: the four fused kernels on resident int8 weights
            against their plain versions: llama3-8b at 8 and 32 rows,
            gpt2-125m, and fp32 norm scales beside int8 weights (the same
            rerun and other-batch checks).
   quant_reference: a tiny llama-shaped model with resident int8 weights,
            int8 and fp8 pools, unfused and fused, on the card (bf16,
            kernels) against the same weights on the CPU (fp32, plain).
   lora_kernels: the LoRA shrink (t = x @ A) and expand (t @ B) kernels
            against their plain versions, alone and as the segmented delta,
            at the five llama3-8b targets, ranks 8 and 16, 8 decode rows on
            mixed adapters and a 32-row chunk of one (NULL rows exactly 0,
            each row alone the same bits, q and kv in one shrink), then the
            four fused kernels with their LoRA epilogue, each behind its
            shrink (bf16 and int8 weights, 8 and 32 rows; a row the same
            bits in another batch).
   lora_reference: the tiny llama-shaped model with 3 adapters, unfused
            and fused, on the card against the CPU.
   mla_kernels: the MLA latent paged-attention kernel against its plain
            version at MLA's widths (klat 512, dpe 64, nq 32, dv 128):
            decode at B 8 with kv up to 1024 and ragged chunks, on bf16,
            int8 and fp8 pools; the fused MLA prologue (two launches) on a
            full-width llama3-8b MLA layer at 8 and 32 rows, q_proj and
            q_lora_rank 1536.
   mla_reference: a tiny MLA llama-shaped model's chunked prefill and
            decode step on the card (bf16, kernels), unfused and fused, on
            a bf16 and an int8 pool, against the CPU (fp32, plain).
   spec_reference: the tiny llama-shaped model and its MLA twin with the
            n-gram proposer, bf16 and int8 pools, unfused and fused: the
            speculative verify step's logits on the card (bf16, kernels)
            against the CPU (fp32, plain versions), and the card's greedy
            speculative streams against its plain ones (each first
            divergence at a near-tie of the plain logits).
   tp_kernels: the two latent tensor-parallel kernels (rows 8 and 9:
            block scores and weighted sum) against their plain versions on
            one rank's 256 latent columns (and row 8 on the pe pool) at
            the mla_kernels shapes with max_seq_len 2048 tables, bf16, int8
            and fp8 pools, and at the weighted sum's split plan's edges
            (lengths one token into a split and on a split's edge, slots at
            kv 1 beside full ones, rows that are not whole row tiles); then
            the two column shards composed (scores summed, mask, fp32
            softmax, weighted sums summed) against the single-device latent
            kernel on the same full pools.
4. train_kernels: the three flash-attention kernels (forward, dq, dk/dv)
            against their fp32 plain versions on the card: llama3-8b
            attention at S 4096, gpt2-125m at S 1024 (causal and
            bidirectional), a ragged S, packed segments and head_fold;
            each forward and backward rerun on the same inputs repeats
            every bit.
5. train_reference: one train step (2 microbatches) of a 2-layer
            llama-shaped model on the card (bf16, kernels) against the
            CPU (fp32, plain versions) from the same weights.
6. train:   pretrain_gpt on llama3-8b at full width, --train-layers deep
            (default 4), S 4096, global batch 2 of micro-batches of 1,
            5 steps, fp32 master params, bf16 compute, mock data: losses,
            launch counts, step time, tokens/s, MFU, peak memory, remat
            "full" against "selective", and two profiled steps' device
            time by kernel family.
   trace_train: MegaScan on that path: pretrain_gpt from train's trained
            weights (no second model), 6 iterations with trace_interval
            3 and continuous_trace_iterations 1, log_interval 1, run
            untraced twice and traced once: every traced iteration's
            spans (iteration, train-step, forward / loss / backward a
            micro-batch, allreduce, optimizer; CUDA events) present,
            closed and nested, the phases covering >= 0.9 of the
            train-step span, that span within 5 % of the iteration's
            host-synchronized wall, the flash launches of every run,
            the traced losses as close to untraced ones as two untraced
            runs are; the per-phase ms of a traced iteration and the
            median step with tracing on and off; the port's aggregate_dir
            and analyze over the file.
   scope_train: MegaScope's TrainingScopeSession.run_step at llama3-8b
            width, 2 layers, S 2048 (flash: no attention_probs), every
            flag on layer 0 and a disturbance on layer 1: the wire
            format (update_type, layer_id, site, result; pca; step_done)
            and finite losses.
   train_gpt2: pretrain_gpt on gpt2-125m (full depth, D 64) with
            --attention-impl pallas --flash-head-fold, S 1024, 3 steps:
            the flash kernels at D 64 on a train path; two profiled
            steps' device time by kernel family.
   scope_reference: the tiny llama-shaped model of phase 3 through the
            static engine with every capture site on, on the card (bf16)
            and the CPU (fp32, plain): greedy streams (a divergence only
            at a near-tie), each payload within SCOPE_REF_TOL of its RMS;
            on the card capture on against off and a scale-0
            disturbance of every site against none, bit for bit.
7. serve:   llama3-8b at full width (random bf16 weights from a seed) behind
            the continuous-batching driver: 8 concurrent greedy requests,
            checked for length, vocabulary, launch counts, a prefix-cache
            hit and a rerun that repeats the streams.
   serve_static: the same weights behind the static engine (serve.py
            --engine static) through the server's in-process visualized
            generation (what /ws runs): 3 prompts, 32 new tokens, every
            site on for two layers, pixels 16: streams with capture equal
            those without, (7 sites x 2 layers + result) x 32 forward
            calls payloads, 20 candidates a token, a 'system' disturbance
            moving the stream and scale 0 not; decode interval with and
            without capture.
   serve_fused: the same weights and requests through an engine built with
            fused_decode=True (--megakernel-decode): the same checks, each
            fused kernel launched once per layer per decode step and
            prefill chunk, and the fused against the unfused streams and
            last-position logits.
   serve_quant: the same weights quantized to resident int8 at startup on
            the card (serve.py --quantized-weights), the same requests
            through the fused engine on int8 pools and the unfused engine
            on fp8 pools: the same checks, each quantized kernel variant
            launched once per layer per step and chunk, and the fused
            against the unfused last-position logits.
   serve_lora: the same weights with an adapter cache (4 slots, rank 8)
            over 5 seeded adapters, the 8 requests on [a0, a1, a2, a3, a4,
            None, a0, None], through the unfused, the fused and the
            int8-weight fused engine: launches (a layer per step and chunk:
            unfused, 4 shrinks (q and kv share one) and 5 expands; fused,
            4 shrinks and one epilogue launch of each fused kernel),
            evictions and pinned waits, clean books, zero-B
            adapters giving the no-adapter streams, adapters changing
            streams, fused against unfused logits, reruns, and the prefix
            hits under adapter-salted keys beside serve's unsalted ones.
   serve_spec: speculative decoding (serve.py --spec-method ngram|draft
            --spec-k 4) on the served llama3-8b, 8 greedy requests (six of
            serve's and two that hold their own continuation): plain, n-gram
            unfused and fused at --layers, a seed-1 2-layer draft model;
            at 4 layers a self-draft (each rejection at a logit near-tie;
            >= 0.9 accepted with those counted as accepted, the plain
            acceptance beside 0.9), n-gram on int8
            (fused) and fp8 pools, fused with LoRA and on resident int8
            weights, a spec-verify drill; the MLA llama3-8b at 4 layers
            (unfused k 4, fused k 3, int8 and fp8 latent pools). Each
            verify round launches the ragged kernel once a layer; pools
            audit clean with every block back; rounds, acceptance, tokens
            per model step, first divergences and decode intervals.
   serve_mla: llama3_8b(multi_latent_attention=True) at full width and
            depth (32 layers, seeded bf16 weights): the 8 requests through
            the unfused engine on a bf16 latent pool, the fused engine on
            bf16 and int8 pools and the unfused engine on an fp8 pool:
            lengths, vocabulary, the latent kernel once a layer a step and
            chunk, the prologue's two kernels in every fused step, a prefix
            hit, reruns, fused against unfused logits; pool and param bytes,
            TTFT and decode interval.
   serve_tp: tensor-parallel serving (serve.py --serve-tp 2) on the one
            card: two spawned ranks share cuda:0 over a gloo group, after
            the parent freed its serving tensors. Each seeds the weights of
            serve / serve_mla (checked by an all-reduced checksum against
            the parent's) and serves the 8 requests, rank 0 through the
            driver and rank 1 in lockstep: the MLA llama3-8b at 32 layers on
            bf16, int8 and fp8 latent pools (rows 8 x2 and 9 x1 a layer a
            step and chunk, row 7 never; two all-reduces a layer), and the
            dense llama3-8b at --layers on a bf16 pool (row 1 on 4 of 8 kv
            heads a rank; one all-gather a layer). Rank streams equal,
            streams and last-position logits against the single-card
            engines, per-rank pool bytes, TTFT and interval (two ranks
            time-sharing one card: not tensor-parallel speed).
8. profile: device time by kernel family through the unfused, the fused
            and the quantized fused engine at the slice's shapes: the
            prefill of one 1008-token prompt, then decode steps with 8
            slots at kv ~1024; then the LoRA engines and the MLA engines
            (unfused and fused). The paged families' device time is also
            given per wrapper call, with the kernels a call launches.
9. times:   each kernel and variant, its plain version, one PyTorch call
            computing the same function (for the LoRA shrink and expand,
            torch.bmm on factors gathered in advance, two for the delta,
            which no one call computes; for the latent kernel SDPA on rows gathered in
            advance and the w_v einsum; for the MLA prologue the GEMM
            alone) and the card's bound, at the shapes the main paths
            launch (the paged rows with their kv split count).
   tp_times: rows 8 and 9 on one rank's latent columns at serve_tp's
            shapes (decode B 8 and a 32-token chunk, kv 1024, bf16, int8
            and fp8 pools), and row 8's launch on the pe pool: kernel and
            library (torch.bmm on gathered pages; for row 9 with the w_v
            einsum) in turns, plain, bound, the weighted sum's split plan
            and the kernels a call launches; the whole two-shard body
            against the single-device latent kernel.

Then the kernel table as one JSON line, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Any failed check exits
non-zero before that line. The script needs the repository beside it and a
CUDA device: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "megatronapp_tpu_torch/csrc/paged_attention.cu"
REPLACES = "megatronapp_tpu/ops/pallas/kernel_gen.py:875"
FLASH_SOURCE = "megatronapp_tpu_torch/csrc/flash_attention.cu"
_FA = "megatronapp_tpu/ops/pallas/flash_attention.py"
FLASH_REPLACES = {
    "fwd": f"{_FA}:395 (_flash_forward; D<128: :342 _flash_forward_t)",
    "bwd_dq": f"{_FA}:1020 (_flash_backward dq; D<128: :1110; "
              "head_fold: :802)",
    "bwd_dkv": f"{_FA}:1050 (_flash_backward dk/dv; D<128: :1139; "
               "head_fold: :824)",
}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak
L2_BYTES = 50 * 2**20           # H100 L2 cache
# bf16 kernel vs fp32 plain version. With q, K and V drawn N(0, 1) at
# D = 128 the scores are about N(0, 1), and a query row that attends n
# positions has an output RMS of about sqrt(e / n): ~1 at n = 1, ~0.05 at
# n = 1000. An absolute tolerance would be loose on long contexts, where
# one misread page of 16 moves an output by ~0.01, so each (query row,
# head) is held to its own scale: |kernel - plain| <= REL_TOL * RMS of the
# plain output over D. The kernel rounds the scaled q, the probabilities
# and the output to bf16 (unit roundoff 2^-8): the first two move an
# element by ~0.002 RMS (random signs), the last by at most 2^-8 of the
# element (<= ~3 RMS), so the worst of 128 elements lands near 0.025 RMS.
REL_TOL = 0.06
FUSED_SOURCE = "megatronapp_tpu_torch/csrc/fused_decode.cu"
_KG = "megatronapp_tpu/ops/pallas/kernel_gen.py"
FUSED_REPLACES = {
    "qkv": f"{_KG}:1261 (_fused_qkv; kv-head-group grid :1357)",
    "out_proj": f"{_KG}:1567 (_fused_out_proj; H-column grid :1581)",
    "mlp_fc1": f"{_KG}:1783 (_fused_mlp_fc1; fc1 half of _fused_mlp :1689)",
    "mlp_fc2": f"{_KG}:1834 (_fused_mlp_fc2; fc2 half of _fused_mlp :1689)",
}
FUSED_KERNELS = tuple(FUSED_REPLACES)
# bf16 fused kernel vs its plain version on the same bf16 inputs, each
# output element held to its own scale: |kernel - plain| <= FUSED_TOL *
# max(|plain element|, RMS of its plain row). Both multiply the same bf16
# operands and sum in fp32 in another order (the kernels on the tensor
# cores, in k order a warp and split order across blocks; ~1e-6 apart),
# then round to bf16 at the same points: the sum, the bias, the QK-norm or
# the activation and its gated product, the residual add. Where the two
# straddle a rounding boundary they round apart by one ulp, at most 2^-7 =
# 0.0078 of the element; up to five such roundings (fc1: sum, bias,
# activation, gated product; and the norm statistics, summed in another
# order, move the normalised input by as much) stack to ~0.04. The
# element's own magnitude is the scale because a row is not Gaussian
# everywhere: swiglu's product of two Gaussians has elements of ~10 RMS,
# where one ulp is 0.06 of the RMS (llama3-8b fc1 at 32 rows: a property
# of the function's values, whatever sums them); the row's RMS is the
# floor for elements near zero, whose error is the absolute rounding of
# the sums that made them.
FUSED_TOL = 0.06
# Timing loops rotate through page tables whose K/V span this many bytes.
TIMED_POOL_BYTES = 3 * L2_BYTES
# Quantized KV pools (kv_cache_dtype) and their page dtypes.
QUANT_KINDS = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
QUANT_REPLACES = (f"{REPLACES} (int8/fp8 pools: k_scales/v_scales; body "
                  "emit_paged_kernel :202-335)")
# Quantized paged kernel vs its plain version on the same int8/fp8 pools
# and scale pools. Neither rounds q or P to bf16 (the TPU kernel's fp32
# body): the plain version dequantizes float(page) x scale and computes in
# fp32; the kernel takes exact bf16 products of q and the codes summed in
# fp32, scales the scores in fp32 and carries P x s_v into P . V as three
# bf16 terms (24 significant bits). They differ by the order of the fp32
# operations (~1e-6 of an output) and by the kernel's bf16 rounding of its
# output, at most 2^-8 = 0.0039 of the element, so each output element is
# held to QUANT_REL_TOL of max(|element|, its (row, head) RMS over D), far
# inside REL_TOL.
# The speculative verify step's shape at spec_k 4 (serve_spec): B 8 slots
# of S_q 5, q_lens mixed over 1..5 (q_len 1 beside full slots), kv on and
# one past block edges and at 2047 in a 2048-position table.
VERIFY_CASE = dict(batch=8, hq=32, hkv=8, d=128, bs=16, s_q=5,
                   q_lens=[1, 5, 1, 5, 2, 3, 4, 5],
                   kv_lens=[16, 17, 32, 33, 1024, 1025, 2047, 5],
                   capacity=2048)
VERIFY_ROWS = 40       # the fused kernels' rows at the verify step, B 8 x 5
QUANT_REL_TOL = 5e-3
# The tighter check of the same comparison: the kernel's bf16 output
# against bf16(the fp32 plain output), element by element. A body that is
# fp32-grade (~1e-7 of the (row, head) RMS from the plain value) rounds to
# another bf16 value only where the fp32 value lies that close to a
# rounding boundary: well under 1 % of the elements, and then by one ulp.
# A body that rounded q or P to bf16 moves each output by ~2^-9 of the RMS
# and flips a large share, by many ulps. An ulp is taken at max(|plain
# element|, 2^-8 of its (row, head) RMS): an element far below its row's
# scale is a sum that cancelled, and fp32's ~1e-7 of the row's scale is
# many ulps of it (up to 36 on the parent's fp32 design and this one
# alike, at elements ~1e-6 of the RMS; flash_probe.py quant-flips), while
# 2^-9 of the RMS is still ~100 ulps at the floor. So at most
# QUANT_FLIP_SHARE of the real elements may differ, none by more than one
# such ulp.
QUANT_FLIP_SHARE = 0.01
# Card (bf16) vs CPU (fp32) logits of phase_quant_reference, as a share of
# their range, by pool dtype (the reasoning is beside the check).
QUANT_REF_TOL = {"int8": 0.05, "fp8": 0.1}
FP32_FLOPS_PER_S = 67e12        # fp32 outside the tensor cores
LORA_SOURCE = "megatronapp_tpu_torch/csrc/lora.cu"
LORA_REPLACES = f"{_KG}:2379 (lora_segmented_delta, def :2328)"
LORA_EPILOGUE_REPLACES = {
    k: f"{v} with its lora= epilogue ({_KG}:1130 _lora_epilogue)"
    for k, v in FUSED_REPLACES.items()}
# The shrink and expand kernels vs their plain versions on the same
# inputs: both take the bf16 x to fp32 and compute (x @ A) @ B in fp32;
# only the order of the sums differs (the shrink adds k in splits of
# 2048 / rank k's or more, each in 256 / rank interleaved parts, the plain
# einsum in its own blocking). Each order's rounding moves a sum by about
# sqrt(din) x
# 2^-24 of its terms' scale (~7e-6 at din 14336; the CPU mirror of the
# shrink's order, ops/cuda/lora.py lora_shrink_split_plain, is within 1e-5
# of JAX's at din <= 400), so each element of t and of the delta is held to
# LORA_TOL of max(|element|, row RMS): ten times that, and 600 times inside
# FUSED_TOL.
LORA_TOL = 1e-4
LORA_RANK = 8
LORA_RANKS = (8, 16)
# A decode batch of 8: NULL rows (1, 6), two rows sharing an adapter (0 and
# 7 on slot 1, 2 and 5 on slot 2) and 4 distinct adapters.
LORA_DECODE_IDS = [1, 0, 2, 3, 4, 2, 0, 1]
# The verify step's 40 rows: each decode slot's adapter on its 5 rows.
LORA_VERIFY_IDS = [i for i in LORA_DECODE_IDS for _ in range(5)]
LORA_ADAPTERS = [f"tenant-{i}" for i in range(5)]
LORA_ROUTE = LORA_ADAPTERS + [None, LORA_ADAPTERS[0], None]
# B ~ N(0, scale^2) (LoraAdapter.random's default 0.05 for lora_reference,
# where it moves the logits by ~0.65 of their range, far past its 0.05
# gate; 0.2 for serve_lora, so that adapters move greedy streams of the
# random llama3-8b).
LORA_REF_SCALE = 0.05
LORA_SERVE_SCALE = 0.2
# Multi-latent attention (slice 6): the latent paged-attention kernels (row
# 7: a split kernel and a combine-and-expand kernel, two launches a call)
# and the fused MLA prologue (row 11, two launches).
MLA_LATENT_SOURCE = "megatronapp_tpu_torch/csrc/paged_latent.cu"
MLA_LATENT_REPLACES = (f"{_KG}:557 (paged_attention_latent, def :456; body "
                       "emit_latent_kernel :338)")
MLA_PROLOGUE_SOURCE = "megatronapp_tpu_torch/csrc/fused_mla.cu"
MLA_PROLOGUE_REPLACES = f"{_KG}:1495 (_fused_mla_qkv, def :1393)"
MLA_LAYERS = 32        # serve_mla's depth: never cut
MLA_SCALE = 1.0 / (128 + 64) ** 0.5
# The latent kernels vs their plain version on the same inputs: both take
# the same q (scaled in fp32 and, on bf16 pools, rounded to bf16) and the
# same fp32 pool values (bf16 widened, or float(page) x row scale), take
# the softmax and sum P x latent in fp32 in other orders (the kernel's P in
# two bf16 terms: 2^-17 of an element; ~1e-6 of an output),
# expand through the same bf16 w_v in fp32 and round the output to bf16
# (at most 2^-8 of the element). Each output element is held to MLA_TOL of
# max(|element|, its (row, head) RMS): between QUANT_REL_TOL's single
# rounding and the 2^-7 of a double one.
MLA_TOL = 0.01
LATENT_TP_SOURCE = "megatronapp_tpu_torch/csrc/latent_tp.cu"
LATENT_TP_REPLACES = {
    "scores": f"{_KG}:617 (_latent_block_scores, def :564)",
    "wsum": f"{_KG}:697 (_latent_block_wsum, def :624)"}
# Rows 8 and 9 against their plain versions: the same fp32 products (exact
# bf16 x bf16, or fp32 x dequantized fp32) summed in other orders over 64
# to 2048 terms; each held to this share of the tensor's max |element|.
TP_PHASE_TOL = 1e-4
# serve_tp: last-position logits against the single-card engine, over the
# logits' range: 32 layers of bf16 roundings, the tp body's fp32 scores
# and probabilities against row 7's online softmax (the serve_mla rule).
TP_LOGIT_TOL = 0.05
TP_TIMEOUT_S = 600          # each collective of the serve_tp group
TP_PHASE_TIMEOUT_S = 900    # serve_tp's wait for a rank's report


class SmokeFailure(RuntimeError):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def only(counts: dict, want: dict) -> dict:
    """The launch counts a run should leave: `want`, and 0 for every other
    key of `counts` (kernel variants the run must not launch)."""
    return {k: want.get(k, 0) for k in counts}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Device time per call of fn(), with the calls queued back to back:
    they are enqueued behind a sleep kernel (~0.1 s at first), so the card
    runs them without waiting for the host between kernels, which paces a
    plain loop (cuda_time_ms) of calls whose kernels run for a few µs. If
    the host had not queued every call before the sleep ended, the window
    is repeated behind a sleep four times longer (twice); then it fails."""
    for _ in range(warmup):
        fn()
    for cycles in (200_000_000, 800_000_000, 3_200_000_000):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / calls
    # Say why: one call's host time, and the first op that waits on the
    # card (PyTorch's sync debug mode raises there).
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        waits = "no PyTorch op waited on the card"
    except RuntimeError as e:
        waits = f"an op waited on the card: {str(e)[:300]}"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    raise SmokeFailure(f"device_ms: the host had not queued the calls of "
                       f"{getattr(fn, '__qualname__', fn)} before the card "
                       f"reached them, behind a sleep of {cycles} cycles "
                       f"(one call: {host_ms:.3f} ms of host time; {waits}; "
                       f"{torch.cuda.memory_reserved()} bytes reserved, "
                       f"{torch.cuda.memory_allocated()} allocated)")


# Calls of a plain version in one device_ms window: a plain version
# launches tens of kernels (the LoRA deltas' gathers and einsums, int8
# dequantization), and more than ~1000 queued launches make the host wait
# for the card.
PLAIN_CALLS = 5


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def make_case(gen, dev, *, batch, hq, hkv, d, bs, kv_lens, s_q=None,
              q_lens=None, pool_bytes=0, capacity=0):
    """Random bf16 q, one K/V pool and R disjoint shuffled page tables
    [R, B, MB] into it ("table" is the first). R is 1 unless pool_bytes
    asks for more: timing loops then rotate through tables whose K/V
    together exceed the L2 cache, so each launch finds its pages cold, as
    a step does moving from layer to layer. MB covers the longest kv_len,
    or `capacity` positions when that is more (an engine's table covers
    max_seq_len)."""
    mb = max(math.ceil(n / bs) for n in list(kv_lens) + [capacity])
    per_table = batch * mb
    block_bytes = 2 * bs * hkv * d * 2                  # K and V, bf16
    r = max(1, math.ceil(pool_bytes / (per_table * block_bytes)))
    nb = r * per_table + 3
    perm = torch.randperm(nb, generator=gen, device="cpu")[:r * per_table]
    tables = perm.reshape(r, batch, mb).to(torch.int32).to(dev)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cpu").to(
            torch.bfloat16).to(dev)

    q = rnd(batch, hq, d) if s_q is None else rnd(batch, s_q, hq, d)
    case = {"q": q, "k": rnd(nb, bs, hkv, d), "v": rnd(nb, bs, hkv, d),
            "tables": tables, "table": tables[0],
            "kv_lens": torch.tensor(kv_lens, dtype=torch.int32, device=dev)}
    if q_lens is not None:
        case["q_lens"] = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    return case


def kv_bytes(case, d, hkv) -> int:
    """Bytes the function must move: each valid K/V row read once (with
    its fp32 scales, for quantized pools), q read once, the output written
    once, plus the page table and lengths."""
    rows = int(case["kv_lens"].sum())
    row_bytes = hkv * d * case["k"].element_size()
    if "k_scales" in case:
        row_bytes += hkv * 4
    return (2 * rows * row_bytes + 2 * case["q"].numel() * 2
            + case["table"].numel() * 4 + case["kv_lens"].numel() * 4
            + (case["q_lens"].numel() * 4 if "q_lens" in case else 0))


def attention_flops(case, hq, d) -> int:
    """QK^T and PV multiply-adds this run's data needs: every query row
    against its own valid (causal) kv positions."""
    kv = case["kv_lens"].tolist()
    if "q_lens" not in case:
        pairs = sum(kv)
    else:
        s_q = case["q"].shape[1]
        pairs = 0
        for n, ql in zip(kv, case["q_lens"].tolist()):
            # real rows s < ql see n - ql + s + 1 positions; padding rows
            # (s >= ql) see all n positions.
            pairs += sum(n - ql + s + 1 for s in range(ql))
            pairs += (s_q - ql) * n
    return 2 * 2 * pairs * hq * d


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(state):
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    t0 = time.perf_counter()
    built = kbuild.build_all([kbuild.source("paged_attention.cu"),
                              kbuild.source("flash_attention.cu"),
                              kbuild.source("fused_decode.cu"),
                              kbuild.source("lora.cu"),
                              kbuild.source("paged_latent.cu"),
                              kbuild.source("fused_mla.cu"),
                              kbuild.source("latent_tp.cu")])
    build_s = time.perf_counter() - t0
    # Registers and barriers ("Used ..."), stack and spills ("... bytes
    # spill stores"; ptxas prints them on a line of their own) per kernel.
    ptxas = {os.path.basename(b["source"]): [
        ln.strip() for ln in b["log"].splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln]
        for b in built}
    state["smi"] = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": state["smi"],
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3), "ptxas": ptxas})


def _compare(case, mode):
    """Kernel vs fp32 plain version, and a rerun on the same inputs bit
    for bit; returns (max abs error, max error over the (row, head)'s
    output RMS, the launch's kv split count)."""
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    ql = case.get("q_lens")

    def kernel():
        return pa.paged_attention(case["q"], case["k"], case["v"],
                                  case["table"], case["kv_lens"], q_lens=ql)
    out, again = kernel(), kernel()
    torch.cuda.synchronize()
    check(torch.equal(out, again),
          f"{mode}: a rerun on the same inputs changed the output")
    ref = pa.paged_attention_plain(
        case["q"].float(), case["k"].float(), case["v"].float(),
        case["table"], case["kv_lens"], q_lens=ql)
    got = out.float()
    if ql is not None:
        # Padding rows (s >= q_len) are finite garbage by contract: hold
        # them to finiteness only, the real rows to the reference.
        s_q = case["q"].shape[1]
        real = (torch.arange(s_q, device=got.device)[None, :]
                < ql[:, None].long())
        check(bool(torch.isfinite(got).all()),
              f"{mode}: non-finite output (padding rows included)")
        got, ref = got[real], ref[real]
    err = (got - ref).abs()                              # [rows, Hq, D]
    scale = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    max_err = float(err.max())
    max_rel = float((err / scale).max())
    check(max_rel <= REL_TOL,
          f"{mode}: error {max_rel} of a (row, head)'s output RMS exceeds "
          f"{REL_TOL} (max abs err {max_err})")
    return max_err, max_rel, pa.launch_split_count(case["q"], case["k"],
                                                   case["table"])


def phase_kernels(state):
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1234)
    before = dict(pa.launches)
    lens = [1, 15, 16, 17, 300, 1000, 2047, 640]
    results = {}
    # llama3-8b attention: Hq 32, Hkv 8, D 128, bs 16, B 8.
    results["decode_llama"] = _compare(make_case(
        gen, dev, batch=8, hq=32, hkv=8, d=128, bs=16, kv_lens=lens),
        "decode llama3-8b")
    q_lens = [1, 15, 16, 17, 32, 32, 7, 3]
    rag_kv = [max(n, ql) for n, ql in zip(lens, q_lens)]
    results["ragged_llama"] = _compare(make_case(
        gen, dev, batch=8, hq=32, hkv=8, d=128, bs=16, kv_lens=rag_kv,
        s_q=32, q_lens=q_lens), "ragged llama3-8b")
    # The engine's own ragged launch: one request per chunk.
    results["ragged_llama_b1"] = _compare(make_case(
        gen, dev, batch=1, hq=32, hkv=8, d=128, bs=16, kv_lens=[1000],
        s_q=32, q_lens=[24]), "ragged llama3-8b B=1")
    # gpt2-125m attention: MHA, Hq = Hkv = 12, D 64.
    results["decode_gpt2"] = _compare(make_case(
        gen, dev, batch=4, hq=12, hkv=12, d=64, bs=16,
        kv_lens=[1, 33, 500, 1024]), "decode gpt2-125m")
    results["ragged_gpt2"] = _compare(make_case(
        gen, dev, batch=4, hq=12, hkv=12, d=64, bs=16,
        kv_lens=[5, 40, 500, 1024], s_q=32, q_lens=[5, 32, 1, 20]),
        "ragged gpt2-125m")
    # Block sizes 64 and 8 (one kv tile is one page, or eight).
    results["decode_llama_bs64"] = _compare(make_case(
        gen, dev, batch=8, hq=32, hkv=8, d=128, bs=64, kv_lens=lens),
        "decode llama3-8b bs 64")
    results["ragged_llama_bs8"] = _compare(make_case(
        gen, dev, batch=8, hq=32, hkv=8, d=128, bs=8, kv_lens=rag_kv,
        s_q=32, q_lens=q_lens), "ragged llama3-8b bs 8")
    # An engine-wide table (max_seq_len 2048): more splits than the short
    # slots have pages, and whole splits past their kv_len.
    results["decode_llama_capacity2048"] = _compare(make_case(
        gen, dev, batch=8, hq=32, hkv=8, d=128, bs=16,
        kv_lens=[1, 3, 16, 17, 33, 64, 65, 100], capacity=2048),
        "decode llama3-8b, short slots in a table of 2048")
    results["ragged_llama_b1_capacity2048"] = _compare(make_case(
        gen, dev, batch=1, hq=32, hkv=8, d=128, bs=16, kv_lens=[40],
        s_q=32, q_lens=[32], capacity=2048), "ragged llama3-8b B=1, kv 40 "
        "of 2048")
    # The longest chunk rows cross several splits.
    results["ragged_llama_b1_kv2047"] = _compare(make_case(
        gen, dev, batch=1, hq=32, hkv=8, d=128, bs=16, kv_lens=[2047],
        s_q=32, q_lens=[32]), "ragged llama3-8b B=1 kv 2047")
    # The speculative verify step: B 8, S_q 5 (k 4), q_lens mixed over
    # 1..5 (slots at q_len 1 beside full ones), kv on and one past block
    # edges and at 2047 of a 2048-position table: many slots, few queries.
    results["ragged_llama_verify_b8"] = _compare(make_case(
        gen, dev, **VERIFY_CASE), "ragged llama3-8b verify B=8 S_q 5")
    # These comparison launches are not main-path launches.
    pa.launches.update(before)
    state["max_abs_err"] = {
        mode: max(v[0] for k, v in results.items() if k.startswith(mode))
        for mode in ("decode", "ragged")}
    emit({"phase": "kernels", "rel_tol": REL_TOL,
          "rerun_bit_identical": True,
          "max_abs_err": {k: v[0] for k, v in results.items()},
          "max_err_over_row_rms": {k: v[1] for k, v in results.items()},
          "kv_splits": {k: v[2] for k, v in results.items()}})


def quantize_case(case, kind):
    """The case with its bf16 K/V pools quantized per (row, kv head) to
    `kind` as the engine writes them (quantize_kv_rows): the pages, their
    fp32 scale pools, and the pools dequantized to bf16 for the library
    yardstick."""
    from megatronapp_tpu_torch.ops.paged_attention import quantize_kv_rows
    out = dict(case)
    for name in ("k", "v"):
        q, s = quantize_kv_rows(case[name], QUANT_KINDS[kind])
        out[name], out[f"{name}_scales"] = q, s
        out[f"{name}_deq"] = (q.float() * s[..., None]).to(torch.bfloat16)
    return out


def bf16_ulps(out, ref, floor):
    """|out - bf16(ref)| for a bf16 out, in bf16 ulps of max(|ref|, floor)
    (element by element; an ulp of x is 2^(floor(log2 x) - 7))."""
    scale = torch.maximum(ref.abs(), floor).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return (out.float() - ref.to(torch.bfloat16).float()).abs() / ulp


def quant_errors(out, case):
    """The quantized kernel's bf16 output on `case` against the plain
    version in fp32 on the same pools, over the real rows (padding rows
    are finite garbage by contract): max abs error, max error over
    max(|element|, (row, head) RMS), the share of elements whose bf16
    differs from bf16(plain), the largest such difference in ulps of
    max(|plain element|, 2^-8 (row, head) RMS), and that element's
    (kernel, plain, (row, head) RMS)."""
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    ql = case.get("q_lens")
    ref = pa.paged_attention_plain(
        case["q"].float(), case["k"], case["v"], case["table"],
        case["kv_lens"], q_lens=ql, k_scales=case["k_scales"],
        v_scales=case["v_scales"])
    if ql is not None:
        real = (torch.arange(out.shape[1], device=out.device)[None, :]
                < ql[:, None].long())
        out, ref = out[real], ref[real]
    got = out.float()
    err = (got - ref).abs()
    rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    ulps = bf16_ulps(out, ref, rms / 256)
    i = int(ulps.argmax())
    return {"max_abs": float(err.max()),
            "rel": float((err / torch.maximum(ref.abs(), rms)).max()),
            "flip_share": float((out.float()
                                 != ref.to(torch.bfloat16).float())
                                .float().mean()),
            "max_ulps": float(ulps.max()),
            "worst_ulp_element": [float(got.flatten()[i]),
                                  float(ref.flatten()[i]),
                                  float(rms.expand_as(ref).flatten()[i])]}


def _compare_quant(case, mode, kind):
    """The quantized kernel twice (one launch a call, the same bits) and
    its plain version in fp32 on the same pools; returns (max abs error,
    max error over max(|element|, (row, head) RMS), the share of real
    elements whose bf16 differs from bf16(plain), the largest such
    difference in ulps, the launch's kv split count)."""
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    ql = case.get("q_lens")
    key = f"{'decode' if ql is None else 'ragged'}_{kind}"
    pools = (case["k"], case["v"], case["table"], case["kv_lens"])
    kw = dict(q_lens=ql, k_scales=case["k_scales"],
              v_scales=case["v_scales"])
    before = pa.launches[key]
    out = pa.paged_attention(case["q"], *pools, **kw)
    again = pa.paged_attention(case["q"], *pools, **kw)
    torch.cuda.synchronize()
    check(pa.launches[key] == before + 2,
          f"kv_quant_kernels {mode}: {key} launched "
          f"{pa.launches[key] - before} times for two calls")
    check(torch.equal(out, again), f"kv_quant_kernels {mode}: the rerun "
          "gave other bits")
    check(bool(torch.isfinite(out).all()),
          f"kv_quant_kernels {mode}: non-finite output")
    e = quant_errors(out, case)
    check(e["rel"] <= QUANT_REL_TOL,
          f"kv_quant_kernels {mode}: error {e['rel']} of max(|element|, row "
          f"RMS) exceeds {QUANT_REL_TOL} (max abs {e['max_abs']})")
    check(e["flip_share"] <= QUANT_FLIP_SHARE and e["max_ulps"] <= 1,
          f"kv_quant_kernels {mode} {kind}: {e['flip_share']} of the "
          f"elements differ from bf16(plain) (at most {QUANT_FLIP_SHARE}), "
          f"by up to {e['max_ulps']} ulps (at most 1; that element's "
          f"kernel, plain, row RMS: {e['worst_ulp_element']}): the body is "
          "not fp32-grade")
    return (e["max_abs"], e["rel"], e["flip_share"], e["max_ulps"],
            pa.launch_split_count(case["q"], case["k"], case["table"]))


def quant_cases() -> dict:
    """phase_kv_quant_kernels' shapes: name → make_case keywords."""
    llama = dict(hq=32, hkv=8, d=128, bs=16)
    gpt2 = dict(hq=12, hkv=12, d=64, bs=16)
    q_lens = [1, 15, 16, 17, 32, 32, 7, 3]
    lens = [1, 15, 16, 17, 300, 1000, 1024, 640]
    return {
        "decode_llama": dict(batch=8, kv_lens=lens, **llama),
        "ragged_llama_b1": dict(batch=1, kv_lens=[1000], s_q=32,
                                q_lens=[24], **llama),
        "ragged_llama": dict(batch=8, kv_lens=[max(n, q) for n, q in
                                               zip(lens, q_lens)],
                             s_q=32, q_lens=q_lens, **llama),
        "decode_llama_bs64": dict(batch=2, kv_lens=[100, 1000],
                                  **dict(llama, bs=64)),
        "decode_gpt2": dict(batch=4, kv_lens=[1, 33, 500, 1024], **gpt2),
        "ragged_gpt2": dict(batch=4, kv_lens=[5, 40, 500, 1024], s_q=32,
                            q_lens=[5, 32, 1, 20], **gpt2),
        # The engine's 2048-position tables: short slots with whole splits
        # past their kv_len, and a chunk whose rows cross every split.
        "decode_llama_capacity2048": dict(
            batch=8, kv_lens=[1, 3, 16, 17, 33, 64, 65, 100], capacity=2048,
            **llama),
        "ragged_llama_b1_kv2047": dict(batch=1, kv_lens=[2047], s_q=32,
                                       q_lens=[32], **llama),
        "ragged_llama_verify_b8": VERIFY_CASE,
    }


def phase_kv_quant_kernels(state):
    """The quantized paged kernel against its plain version, int8 and fp8
    pools, at the shapes of phase_kernels (decode at B 8 with kv up to
    1024, the engine's ragged launch at B 1 and S_q 32, short slots in a
    2048-position table, a chunk at kv 2047), block size 64, and
    gpt2-125m (D 64, MHA): within QUANT_REL_TOL, within the one-ulp /
    QUANT_FLIP_SHARE check, and the same bits on a rerun."""
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(4242)
    before = dict(pa.launches)
    results = {}
    for name, kw in quant_cases().items():
        case = make_case(gen, dev, **kw)
        for kind in QUANT_KINDS:
            results[f"{name}_{kind}"] = _compare_quant(
                quantize_case(case, kind), name, kind)
    pa.launches.update(before)     # not main-path launches
    state["quant_err"] = {
        f"{mode}_{kind}": max(v[0] for k, v in results.items()
                              if k.startswith(mode) and k.endswith(kind))
        for mode in ("decode", "ragged") for kind in QUANT_KINDS}
    emit({"phase": "kv_quant_kernels", "rel_tol": QUANT_REL_TOL,
          "flip_share_limit": QUANT_FLIP_SHARE, "rerun_bit_identical": True,
          "errors": "(max abs, max over max(|plain element|, (row, head) "
                    "RMS), share of real elements whose bf16 differs from "
                    "bf16(plain), largest difference in ulps, kv splits)",
          "cases": results})


def phase_reference(state, dev="cuda"):
    """Tiny llama-shaped model (head_dim 128, GQA group 2): the card's
    bf16 chunked-prefill logits against the CPU's fp32 plain path on the
    same weights."""
    import copy

    from megatronapp_tpu_torch.inference.dynamic_engine import (
        _paged_multiquery_step,
    )
    from megatronapp_tpu_torch.inference.paged_cache import PagedKVCache
    from megatronapp_tpu_torch.models.gpt import (
        gpt_rope_tables, init_gpt_params,
    )
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    from megatronapp_tpu_torch.ops.paged_attention import paged_write_index
    before = dict(pa.launches)
    small = dict(num_layers=2, hidden_size=512, num_attention_heads=4,
                 num_query_groups=2, ffn_hidden_size=1024, vocab_size=512,
                 init_method_std=0.05)
    cfg_ref = llama3_8b(compute_dtype=torch.float32, **small)
    cfg_dev = llama3_8b(params_dtype=torch.bfloat16, **small)
    p_ref = init_gpt_params(cfg_ref, torch.Generator().manual_seed(7), "cpu")
    p_dev = copy.deepcopy(p_ref).to(device=dev, dtype=torch.bfloat16)
    tokens = torch.randint(0, 512, (1, 32),
                           generator=torch.Generator().manual_seed(8))
    starts = torch.zeros(1, dtype=torch.int32)
    counts = torch.full((1,), 32, dtype=torch.int32)
    logits = {}
    for name, p, cfg, d in (("ref", p_ref, cfg_ref, "cpu"),
                            ("dev", p_dev, cfg_dev, dev)):
        pool = PagedKVCache(cfg, 1, 64, block_size=16, device=d)
        pool.admit(0, tokens[0].numpy())
        table = torch.as_tensor(pool.page_table[:1])
        index = paged_write_index(table, starts, counts,
                                  torch.ones(1, dtype=torch.bool), 16, 32)
        out, _, _ = _paged_multiquery_step(
            p, tokens.to(d), pool.pages, table.to(d), starts.to(d),
            counts.to(d), cfg, 64, tuple(t.to(d) for t in index),
            gpt_rope_tables(cfg, 64, device=d))
        logits[name] = out.float().cpu()
    pa.launches.update(before)
    ref, got = logits["ref"], logits["dev"]
    rel = float((got - ref).abs().max() / ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    emit({"phase": "reference", "max_rel_err": rel,
          "argmax_agreement": agree})
    check(bool(torch.isfinite(got).all()), "reference: non-finite logits")
    # bf16 weights and activations through two layers: a few percent of
    # the logit range at most.
    check(rel < 0.05, f"reference: relative logit error {rel} >= 0.05")
    check(agree >= 0.9, f"reference: argmax agreement {agree} < 0.9")


def _fused_layer(cfg, gen, dev):
    """One layer's params on the card with every vector leaf (norm scales
    N(1, 0.1), biases N(0, 0.1)) random, so that none tests as ones or
    zeros."""
    from megatronapp_tpu_torch.transformer.block import init_layer_params
    p = init_layer_params(cfg, gen, dev)
    for name, t in p.named_parameters():
        if t.dim() == 1:
            t.normal_(1.0 if "scale" in name else 0.0, 0.1, generator=gen)
    return p


def _row_errs(got, want):
    """(max abs error, max error over max(|plain element|, its row's
    RMS))."""
    got = got.float().reshape(got.shape[0], -1)
    want = want.float().reshape(want.shape[0], -1)
    err = (got - want).abs()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    scale = torch.maximum(want.abs(), rms).clamp_min(1e-30)
    return float(err.max()), float((err / scale).max())


def _fused_case(name, cfg, p, rows, gen, dev, variant="", lora=None):
    """Each fused kernel once on bf16 inputs against its plain version on
    the same inputs (fc2 is fed the kernel's own y), then once more to
    check that a rerun repeats every bit (the K-split sums in a fixed
    order). variant: the launch counters' suffix of the weights' kind
    ("_int8" for resident int8 weights). lora: the adapter deltas of the
    rows (ops/lora.py), run as the kernels' LoRA epilogue and counted in
    fd.lora_launches, each launch behind one shrink launch. Then a few rows
    of each output are checked to be the same bits in another batch
    (_rows_elsewhere)."""
    from megatronapp_tpu_torch.models.gpt import gpt_rope_tables
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import lora as cl

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)
    x = rnd(rows, cfg.hidden_size)
    attn = rnd(rows, cfg.num_attention_heads * cfg.head_dim)
    cos = sin = None
    if cfg.position_embedding.value == "rope":
        pos = torch.randint(0, 8192, (rows,), generator=gen, device=dev)
        cos_t, sin_t = gpt_rope_tables(cfg, 8192, device=dev)
        cos, sin = cos_t[pos], sin_t[pos]
    res, outs = {}, {}
    counts = fd.launches if lora is None else fd.lora_launches

    def run(kernel, fn, plain, *args):
        key = kernel + variant
        before, shrinks = counts[key], cl.launches["lora_shrink"]
        got = fn(*args, lora=lora)
        again = fn(*args, lora=lora)
        torch.cuda.synchronize()
        check(counts[key] == before + 2,
              f"fused_kernels {name}: {key} launched "
              f"{counts[key] - before} times for two calls")
        check(cl.launches["lora_shrink"] - shrinks == (0 if lora is None
                                                      else 2),
              f"fused_kernels {name}: {key}: "
              f"{cl.launches['lora_shrink'] - shrinks} shrink launches for "
              "two calls")
        got_t = got if isinstance(got, tuple) else (got,)
        again_t = again if isinstance(again, tuple) else (again,)
        check(all(torch.equal(a, b) for a, b in zip(got_t, again_t)),
              f"fused_kernels {name}: {kernel} rerun gave other bits")
        want = plain(*args, lora=lora)
        want_t = want if isinstance(want, tuple) else (want,)
        errs = [_row_errs(a, b) for a, b in zip(got_t, want_t)]
        for a in got_t:
            check(bool(torch.isfinite(a).all()),
                  f"fused_kernels {name}: {kernel} non-finite output")
        res[kernel] = (max(e[0] for e in errs), max(e[1] for e in errs))
        check(res[kernel][1] <= FUSED_TOL,
              f"fused_kernels {name}: {kernel} error {res[kernel][1]} of "
              f"max(|element|, row RMS) exceeds {FUSED_TOL} (max abs "
              f"{res[kernel][0]})")
        outs[kernel] = got
        return got

    run("qkv", fd.fused_qkv, fd.fused_qkv_plain, x, p, cfg, cos, sin)
    run("out_proj", fd.fused_out_proj, fd.fused_out_proj_plain, attn, p,
        cfg, x)
    y = run("mlp_fc1", fd.fused_mlp_fc1, fd.fused_mlp_fc1_plain, x, p, cfg)
    run("mlp_fc2", fd.fused_mlp_fc2, fd.fused_mlp_fc2_plain, y, x, p, cfg)
    _rows_elsewhere(name, cfg, p, lora, (x, attn, y, cos, sin), outs, gen,
                    dev)
    return res


def _rows_elsewhere(name, cfg, p, lora, inputs, outs, gen, dev):
    """A fused kernel gives a row the same bits in another batch: alone
    when the batch has at most 8 rows (a 1-row launch takes the same 8-row
    blocks and K split), else at its place in a batch of as many rows whose
    other rows are other inputs (a row's sums never read another row, and
    the K split reads the row count only through the row block): the
    four kernels, with lora through their LoRA epilogue, the other rows on
    other adapters (a row's t and delta never read another row either)."""
    import numpy as np

    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.lora import LoraRows
    x, attn, y, cos, sin = inputs
    rows = x.shape[0]
    ids = None if lora is None else lora["row_adapter"].ids.tolist()
    for r in sorted({0, 1, rows - 1}):
        if rows <= 8:
            sel = [r]
            pos, new_ids = 0, None if lora is None else [ids[r]]

            def other(t):
                return None if t is None else t[sel].contiguous()
        else:
            pos, new_ids = r, None
            if lora is not None:
                new_ids = [LORA_DECODE_IDS[i % 8] for i in range(1, rows + 1)]
                new_ids[r] = ids[r]

            def other(t):
                if t is None:
                    return None
                o = torch.randn(t.shape, generator=gen, device=dev).to(
                    t.dtype)
                o[r] = t[r]
                return o
        lo = None if lora is None else {
            "row_adapter": LoraRows(np.asarray(new_ids), dev),
            "banks": lora["banks"]}
        ox, oattn, oy, ocos, osin = (other(t) for t in inputs)
        got = {"qkv": fd.fused_qkv(ox, p, cfg, ocos, osin, lo),
               "out_proj": fd.fused_out_proj(oattn, p, cfg, ox, lo),
               "mlp_fc1": fd.fused_mlp_fc1(ox, p, cfg, lo),
               "mlp_fc2": fd.fused_mlp_fc2(oy, ox, p, cfg, lo)}
        for kernel, g in got.items():
            g_t = g if isinstance(g, tuple) else (g,)
            w_t = outs[kernel] if isinstance(outs[kernel], tuple) \
                else (outs[kernel],)
            check(all(torch.equal(a[pos], b[r]) for a, b in zip(g_t, w_t)),
                  f"fused_kernels {name}: {kernel}: row {r} in another "
                  "batch differs from the same row in the batch")


def phase_fused_kernels(state):
    from megatronapp_tpu_torch.models.presets import gpt2_125m, llama3_8b
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(2024)
    before = dict(fd.launches)
    llama = llama3_8b(num_layers=1, params_dtype=torch.bfloat16)
    gpt2 = gpt2_125m(num_layers=1, params_dtype=torch.bfloat16)
    qk = llama3_8b(num_layers=1, hidden_size=1024, num_attention_heads=8,
                   num_query_groups=2, ffn_hidden_size=2048,
                   qk_layernorm=True, params_dtype=torch.float32)
    cases = {}
    for cname, cfg, rows in (("llama3_8b", llama, (8, 32, VERIFY_ROWS)),
                             ("gpt2_125m", gpt2, (8, 32)),
                             ("qk_layernorm_fp32_weights", qk, (5, 40))):
        p = _fused_layer(cfg, gen, dev)
        for r in rows:
            cases[f"{cname}_rows{r}"] = _fused_case(f"{cname} R={r}", cfg, p,
                                                    r, gen, dev)
        del p
    fd.launches.update(before)       # not main-path launches
    torch.cuda.empty_cache()
    state["fused_err"] = {k: max(c[k][0] for c in cases.values())
                          for k in FUSED_KERNELS}
    emit({"phase": "fused_kernels", "rel_tol": FUSED_TOL,
          "errors": "(max abs, max over max(|plain element|, row RMS))",
          "cases": cases})


def phase_fused_int8_kernels(state):
    """The fused kernels on resident int8 weights (quantize_for_serving of
    a random layer) against their plain versions, which dequantize through
    resolve_param to the same bf16 weights, so FUSED_TOL's rule holds
    unchanged: llama3-8b at 8 and 32 rows, gpt2-125m (LayerNorm, biases,
    gelu, D 64), and int8 weights beside fp32 norm scales (QK-layernorm)."""
    from megatronapp_tpu_torch.inference.quantization import (
        quantize_for_serving,
    )
    from megatronapp_tpu_torch.models.presets import gpt2_125m, llama3_8b
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(2025)
    before = dict(fd.launches)
    llama = llama3_8b(num_layers=1, params_dtype=torch.bfloat16)
    gpt2 = gpt2_125m(num_layers=1, params_dtype=torch.bfloat16)
    qk = llama3_8b(num_layers=1, hidden_size=1024, num_attention_heads=8,
                   num_query_groups=2, ffn_hidden_size=2048,
                   qk_layernorm=True, params_dtype=torch.float32)
    cases = {}
    for cname, cfg, rows in (("llama3_8b", llama, (8, 32, VERIFY_ROWS)),
                             ("gpt2_125m", gpt2, (8, 32)),
                             ("qk_layernorm_fp32_vectors", qk, (5, 40))):
        p = quantize_for_serving(_fused_layer(cfg, gen, dev))[0]
        for r in rows:
            cases[f"{cname}_rows{r}"] = _fused_case(
                f"int8 {cname} R={r}", cfg, p, r, gen, dev, "_int8")
        del p
    fd.launches.update(before)       # not main-path launches
    torch.cuda.empty_cache()
    state["fused_int8_err"] = {k: max(c[k][0] for c in cases.values())
                               for k in FUSED_KERNELS}
    emit({"phase": "fused_int8_kernels", "rel_tol": FUSED_TOL,
          "errors": "(max abs, max over max(|plain element|, row RMS))",
          "cases": cases})


def _chunked_prefill(params, cfg, tokens, dev, fused, decode_token=None,
                     kv_cache_dtype="bf16", lora=None, ctx=None):
    """A prompt's chunked prefill (32-token chunks, one slot) through the
    engine's multi-query step on a pool of its own (of `kv_cache_dtype`);
    returns the logits of every real prompt position [P, V] (and, with
    decode_token, the logits of one decode step after it [1, V]). lora:
    (AdapterCache, bank slot) of the slot's adapter. ctx: a tp rank (its
    share of the pool; every rank runs the same chunks)."""
    import numpy as np

    from megatronapp_tpu_torch.inference.dynamic_engine import (
        _paged_decode_step, _paged_multiquery_step,
    )
    from megatronapp_tpu_torch.inference.paged_cache import PagedKVCache
    from megatronapp_tpu_torch.models.gpt import gpt_rope_tables
    from megatronapp_tpu_torch.ops.paged_attention import paged_write_index
    chunk, n = 32, len(tokens)
    msl = 16 * math.ceil((n + 2) / 16)
    pool = PagedKVCache(cfg, 1, msl, block_size=16, device=dev,
                        kv_cache_dtype=kv_cache_dtype,
                        tp=1 if ctx is None else ctx.tp)
    pool.admit(0, np.asarray(tokens))
    table = torch.as_tensor(pool.page_table[:1])
    rope = gpt_rope_tables(cfg, msl, device=dev)
    one = torch.ones(1, dtype=torch.bool)
    out = []

    def lora_of(repeat):
        if lora is None:
            return None
        from megatronapp_tpu_torch.ops.lora import LoraRows
        return {"row_adapter": LoraRows([lora[1]], dev, repeat),
                "banks": lora[0].banks}
    for pos in range(0, n, chunk):
        count = min(chunk, n - pos)
        toks = torch.zeros(1, chunk, dtype=torch.int64)
        toks[0, :count] = torch.as_tensor(tokens[pos:pos + count])
        starts = torch.tensor([pos], dtype=torch.int32)
        counts = torch.tensor([count], dtype=torch.int32)
        index = paged_write_index(table, starts, counts, one, 16, chunk)
        logits, _, _ = _paged_multiquery_step(
            params, toks.to(dev), pool.pages, table.to(dev), starts.to(dev),
            counts.to(dev), cfg, msl, tuple(t.to(dev) for t in index), rope,
            fused=fused, scales=pool.scales, lora=lora_of(chunk), ctx=ctx)
        out.append(logits[0, :count].float().cpu())
    prefill = torch.cat(out)
    if decode_token is None:
        return prefill
    check(pool.ensure_capacity(0, n), "no pool block for the decode step")
    table = torch.as_tensor(pool.page_table[:1])
    lengths = torch.tensor([n], dtype=torch.int32)
    index = paged_write_index(table, lengths, torch.ones(1, dtype=torch.int32),
                              one, 16, 1)
    dec, _ = _paged_decode_step(
        params, torch.tensor([[decode_token]], device=dev), pool.pages,
        table.to(dev), lengths.to(dev), cfg,
        tuple(t.to(dev) for t in index), rope, fused=fused,
        scales=pool.scales, lora=lora_of(1), ctx=ctx)
    return prefill, dec.float().cpu()


def phase_fused_reference(state):
    """The tiny llama-shaped model of phase_reference (head_dim 128, GQA
    group 2, widths the fused kernels take): a 40-token prompt's fused
    chunked prefill (a full chunk of 32 rows and a ragged one of 8) and one
    fused decode step on the card (bf16, kernels) against the same weights
    on the CPU (fp32, plain versions)."""
    import copy

    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    from megatronapp_tpu_torch.ops.fused_decode import (
        megakernel_ineligible_reason,
    )
    before, before_pa = dict(fd.launches), dict(pa.launches)
    small = dict(num_layers=2, hidden_size=512, num_attention_heads=4,
                 num_query_groups=2, ffn_hidden_size=1024, vocab_size=512,
                 init_method_std=0.05)
    cfg_ref = llama3_8b(compute_dtype=torch.float32, **small)
    cfg_dev = llama3_8b(params_dtype=torch.bfloat16, **small)
    p_ref = init_gpt_params(cfg_ref, torch.Generator().manual_seed(7), "cpu")
    p_dev = copy.deepcopy(p_ref).to(device="cuda", dtype=torch.bfloat16)
    reason = megakernel_ineligible_reason(cfg_dev, batch=1, params=p_dev)
    check(reason is None, f"fused_reference: ineligible: {reason}")
    tokens = torch.randint(0, 512, (40,),
                           generator=torch.Generator().manual_seed(8)).tolist()
    ref_pre, ref_dec = _chunked_prefill(p_ref, cfg_ref, tokens, "cpu", True,
                                        decode_token=17)
    for k in fd.launches:
        fd.launches[k] = 0
    got_pre, got_dec = _chunked_prefill(p_dev, cfg_dev, tokens,
                                        torch.device("cuda", 0), True,
                                        decode_token=17)
    launches = dict(fd.launches)
    fd.launches.update(before)
    pa.launches.update(before_pa)
    ref, got = torch.cat([ref_pre, ref_dec]), torch.cat([got_pre, got_dec])
    rel = float((got - ref).abs().max() / ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    emit({"phase": "fused_reference", "max_rel_err": rel,
          "argmax_agreement": agree, "launches": launches})
    check(launches == only(launches, dict.fromkeys(FUSED_KERNELS, 2 * 3)),
          f"fused_reference: expected 2 layers x (2 chunks + 1 decode step) "
          f"launches of each fused kernel, got {launches}")
    check(bool(torch.isfinite(got).all()), "fused_reference: non-finite")
    # As phase_reference: bf16 weights and activations through two layers
    # move the logits by a few percent of their range at most.
    check(rel < 0.05, f"fused_reference: relative logit error {rel} >= 0.05")
    check(agree >= 0.9, f"fused_reference: argmax agreement {agree} < 0.9")


def resident_tree_on(tree, dev, dtype):
    """A copy of a resident-int8 param tree on `dev` with its float leaves
    in `dtype`, except the resident leaves' fp32 scales (nn.Module.to(dtype)
    would cast those too)."""
    import copy

    from megatronapp_tpu_torch.inference.quantization import (
        is_resident_leaf,
    )
    out = copy.deepcopy(tree).to(dev)
    for m in out.modules():
        if is_resident_leaf(m):
            continue
        for t in m._parameters.values():
            if t.is_floating_point():
                t.data = t.data.to(dtype)
    return out


def phase_quant_reference(state):
    """The tiny llama-shaped model of phase_fused_reference with its five
    matmul kernels quantized to resident int8 (quantize_for_serving of the
    fp32 weights): a 40-token prompt's chunked prefill and one decode step
    on int8 and on fp8 pools, unfused and fused, on the card (bf16 compute,
    kernels) against the same int8 weights on the CPU (fp32 compute, plain
    versions)."""
    from megatronapp_tpu_torch.inference.quantization import (
        quantize_for_serving,
    )
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    dev = torch.device("cuda", 0)
    before, before_pa = dict(fd.launches), dict(pa.launches)
    small = dict(num_layers=2, hidden_size=512, num_attention_heads=4,
                 num_query_groups=2, ffn_hidden_size=1024, vocab_size=512,
                 init_method_std=0.05)
    cfg_ref = llama3_8b(compute_dtype=torch.float32, **small)
    cfg_dev = llama3_8b(params_dtype=torch.bfloat16, **small)
    p_ref = quantize_for_serving(init_gpt_params(
        cfg_ref, torch.Generator().manual_seed(7), "cpu"))[0]
    p_dev = resident_tree_on(p_ref, dev, torch.bfloat16)
    tokens = torch.randint(0, 512, (40,),
                           generator=torch.Generator().manual_seed(8)).tolist()
    results = {}
    for kind in QUANT_KINDS:
        for fused in (False, True):
            name = f"{kind}_{'fused' if fused else 'unfused'}"
            ref = torch.cat(_chunked_prefill(
                p_ref, cfg_ref, tokens, "cpu", fused, decode_token=17,
                kv_cache_dtype=kind))
            for counts in (fd.launches, pa.launches):
                counts.update(dict.fromkeys(counts, 0))
            got = torch.cat(_chunked_prefill(
                p_dev, cfg_dev, tokens, dev, fused, decode_token=17,
                kv_cache_dtype=kind))
            launches, paged = dict(fd.launches), dict(pa.launches)
            rel = float((got - ref).abs().max() / ref.abs().max())
            agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
            results[name] = {"max_rel_err": rel, "argmax_agreement": agree}
            # 2 layers x (2 chunks + 1 decode step).
            want = dict.fromkeys((f"{k}_int8" for k in FUSED_KERNELS),
                                 6 if fused else 0)
            check(launches == only(launches, want),
                  f"quant_reference {name}: fused launches {launches}")
            check(paged == only(paged, {f"ragged_{kind}": 4,
                                        f"decode_{kind}": 2}),
                  f"quant_reference {name}: paged launches {paged}")
            check(bool(torch.isfinite(got).all()),
                  f"quant_reference {name}: non-finite logits")
            # As phase_reference: bf16 weights (the int8 bytes dequantized
            # to bf16 here, to fp32 on the CPU) and activations through two
            # layers move the logits by a few percent of their range. fp8
            # pools add to that: e4m3 keeps 3 mantissa bits, so a K/V
            # element that bf16 compute moves by ~2^-9 crosses an fp8
            # rounding point about once in 32 and then moves by a whole
            # step (1/16-1/8 of it). Measured by this phase on an NVIDIA
            # H100 80GB HBM3, 700.00 W: 0.049-0.051 of the range on fp8
            # pools, 0.024-0.025 on int8 (bf16 pools, phase_reference:
            # 0.015). A misread page or scale moves them by the whole
            # range.
            tol = QUANT_REF_TOL[kind]
            check(rel < tol, f"quant_reference {name}: relative logit "
                  f"error {rel} >= {tol}")
            check(agree >= 0.9, f"quant_reference {name}: argmax agreement "
                  f"{agree} < 0.9")
    fd.launches.update(before)
    pa.launches.update(before_pa)
    emit({"phase": "quant_reference", "weights": "resident int8",
          "cases": results})


def _serve_prompts(cfg):
    """The serve phases' 8 prompts (17-700 tokens; the last two share a
    256-token prefix) and the warm-up prompt."""
    import numpy as np
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size - 1, 256)
    lengths = [17, 64, 130, 300, 450, 700]
    prompts = [rng.integers(0, cfg.vocab_size - 1, n) for n in lengths]
    prompts += [np.concatenate([shared, rng.integers(0, cfg.vocab_size - 1,
                                                     n)])
                for n in (40, 200)]
    warm = rng.integers(0, 1000, 20).astype(np.int32)
    return [p.astype(np.int32) for p in prompts], warm


def _serve_once(driver, prompts, max_new, sampling, adapters=None):
    """Submit every prompt from its own thread (prompt i with adapter
    adapters[i], if given); returns (streams, per-request first/last token
    times, t_submit, t_done)."""
    n = len(prompts)
    times = [[] for _ in range(n)]
    rids = [None] * n
    done_events = [None] * n
    errors = []
    barrier = threading.Barrier(n)

    def submit(i):
        try:
            barrier.wait(timeout=60)
            t_sub = time.perf_counter()
            rid, done = driver.submit(
                prompts[i], max_new, sampling,
                token_cb=lambda _r, _t, i=i: times[i].append(
                    time.perf_counter()),
                adapter_id=None if adapters is None else adapters[i])
            times[i].insert(0, t_sub)
            rids[i], done_events[i] = rid, done
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=submit, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    check(not errors, f"serve: submit failed: {errors}")
    for ev in done_events:
        check(ev is not None and ev.wait(timeout=600),
              "serve: a request did not finish")
    t1 = time.perf_counter()
    streams = [driver.result_tokens(rid) for rid in rids]
    return streams, times, t0, t1


def _engine(params, cfg, dev, fused=False, kv_cache_dtype="bf16",
            adapter_cache=None, ctx=None):
    from megatronapp_tpu_torch.data.tokenizers import NullTokenizer
    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    return DynamicInferenceEngine(
        params, cfg, tokenizer=NullTokenizer(cfg.vocab_size), max_batch=8,
        max_seq_len=2048, paged=True, block_size=16, prefill_chunk=32,
        device=dev, fused_decode=fused, kv_cache_dtype=kv_cache_dtype,
        adapter_cache=adapter_cache, ctx=ctx)


# Every serve phase's driver: their parked stepper threads keep the
# engines (params and pools) alive until serve_tp closes them.
_DRIVERS = []


def _driver(engine):
    """A DynamicBatchingDriver over `engine`, recorded in _DRIVERS."""
    from megatronapp_tpu_torch.inference.server import DynamicBatchingDriver
    _DRIVERS.append(DynamicBatchingDriver(engine))
    return _DRIVERS[-1]


def phase_serve(state, layers: int):
    import numpy as np

    from megatronapp_tpu_torch.inference.engine import SamplingParams
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa

    dev = torch.device("cuda", 0)
    cfg = llama3_8b(num_layers=layers, params_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = _engine(params, cfg, dev)
    driver = _driver(engine)
    greedy = SamplingParams(greedy=True)
    max_new = 32
    prompts, warm = _serve_prompts(cfg)

    # Warm-up (cuBLAS handles, allocator) outside the counted run.
    rid, done = driver.submit(warm, 4, greedy)
    check(done.wait(timeout=600), "serve: warm-up did not finish")
    driver.result_tokens(rid)
    hits_before = engine.pool.stats["prefix_hit_tokens"]

    steps_before, chunks_before = engine.decode_steps, engine.prefill_chunks
    for k in pa.launches:
        pa.launches[k] = 0
    torch.cuda.synchronize()
    streams, times, t_start, t_end = _serve_once(driver, prompts, max_new,
                                                 greedy)
    launches = dict(pa.launches)
    decode_steps = engine.decode_steps - steps_before
    prefill_chunks = engine.prefill_chunks - chunks_before
    state["launches"] = launches
    hits = engine.pool.stats["prefix_hit_tokens"] - hits_before
    state["serve_pool_bytes"] = engine.pool.bytes_total
    state["serve_prefix_hit_tokens"] = int(hits)

    for p, s in zip(prompts, streams):
        check(s is not None and len(s) == len(p) + max_new,
              f"serve: stream length {None if s is None else len(s)} != "
              f"{len(p) + max_new}")
        check(np.array_equal(s[:len(p)], p), "serve: prompt not echoed")
        new = s[len(p):]
        check(bool(((new >= 0) & (new < cfg.vocab_size)).all()),
              "serve: out-of-vocab token")
    check(launches["decode"] > 0 and launches["ragged"] > 0,
          f"serve: kernel not launched on the main path: {launches}")
    check(launches["decode"] == decode_steps * layers
          and launches["ragged"] == prefill_chunks * layers,
          f"serve: expected one launch per layer and step, got {launches} "
          f"for {decode_steps} decode steps and {prefill_chunks} prefill "
          f"chunks")
    check(hits > 0, "serve: the shared 256-token prefix never hit the "
          "prefix cache")
    ttft = [(t[1] - t[0]) * 1e3 for t in times]
    iv = [(t[-1] - t[1]) * 1e3 / (len(t) - 2) for t in times]
    total_new = max_new * len(prompts)
    wall = t_end - t_start

    rerun, _, _, _ = _serve_once(driver, prompts, max_new, greedy)
    same = all(np.array_equal(a, b) for a, b in zip(streams, rerun))
    check(same, "serve: the rerun of the same submissions gave other "
          "streams")
    emit({"phase": "serve", "model": "llama3-8b", "layers": layers,
          "full_depth": layers == 32, "params_dtype": "bf16",
          "init_s": round(init_s, 3),
          "param_bytes": sum(p.numel() * p.element_size()
                             for p in params.parameters()),
          "pool_bytes": engine.pool.bytes_total,
          "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
          "max_new_tokens": max_new, "launches": launches,
          "decode_steps": decode_steps, "prefill_chunks": prefill_chunks,
          "decode_launches_per_step": launches["decode"] / decode_steps,
          "ragged_launches_per_chunk": launches["ragged"] / prefill_chunks,
          "prefix_hit_tokens": int(hits),
          "ttft_ms": [round(x, 3) for x in ttft],
          "decode_ms_per_step_by_request": [round(x, 3) for x in iv],
          "tokens_per_s": total_new / wall, "wall_s": wall,
          "rerun_identical": same,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    # The profile phase serves the same weights through an engine of its
    # own; the driver's stepper stays parked on its empty engine.
    state["model"] = (params, cfg, dev)
    state["serve_streams"] = [s[len(p):] for p, s in zip(prompts, streams)]
    # serve_tp's references: the weights' checksum and the 300-token
    # prompt's last-position logits on this single-card engine's step.
    state["serve_checksum"] = _param_checksum(params)
    before = dict(pa.launches)
    state["serve_last_logits"] = _chunked_prefill(
        params, cfg, prompts[3].tolist(), dev, False)[-1]
    pa.launches.update(before)


def phase_serve_fused(state):
    """The serve phase's weights and requests through an engine built with
    fused_decode=True: every decode step and prefill chunk runs each layer
    as the four fused kernels around the paged-attention kernel."""
    import numpy as np

    from megatronapp_tpu_torch.inference.engine import SamplingParams
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    params, cfg, dev = state["model"]
    layers = cfg.num_layers
    engine = _engine(params, cfg, dev, fused=True)
    check(engine.megakernel is True,
          "serve_fused: the engine kept the unfused step (ineligible)")
    driver = _driver(engine)
    greedy = SamplingParams(greedy=True)
    max_new = 32
    prompts, warm = _serve_prompts(cfg)
    rid, done = driver.submit(warm, 4, greedy)
    check(done.wait(timeout=600), "serve_fused: warm-up did not finish")
    driver.result_tokens(rid)
    hits_before = engine.pool.stats["prefix_hit_tokens"]
    steps_before, chunks_before = engine.decode_steps, engine.prefill_chunks
    for counts in (fd.launches, pa.launches):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    streams, times, t_start, t_end = _serve_once(driver, prompts, max_new,
                                                 greedy)
    launches, paged = dict(fd.launches), dict(pa.launches)
    steps = engine.decode_steps - steps_before
    chunks = engine.prefill_chunks - chunks_before
    hits = engine.pool.stats["prefix_hit_tokens"] - hits_before
    state["fused_launches"] = launches
    for p, s in zip(prompts, streams):
        check(s is not None and len(s) == len(p) + max_new
              and np.array_equal(s[:len(p)], p)
              and bool(((s[len(p):] >= 0)
                        & (s[len(p):] < cfg.vocab_size)).all()),
              "serve_fused: a stream of the wrong length or vocabulary")
    want = layers * (steps + chunks)
    check(launches == only(launches, dict.fromkeys(FUSED_KERNELS, want)),
          f"serve_fused: expected {want} launches of each fused kernel "
          f"({layers} layers x ({steps} decode steps + {chunks} prefill "
          f"chunks)), got {launches}")
    check(paged == only(paged, {"decode": layers * steps,
                                "ragged": layers * chunks}),
          f"serve_fused: paged-attention launches {paged} for {steps} "
          f"steps and {chunks} chunks")
    check(hits > 0, "serve_fused: the shared prefix never hit")
    ttft = [(t[1] - t[0]) * 1e3 for t in times]
    iv = [(t[-1] - t[1]) * 1e3 / (len(t) - 2) for t in times]
    wall = t_end - t_start
    rerun, _, _, _ = _serve_once(driver, prompts, max_new, greedy)
    same = all(np.array_equal(a, b) for a, b in zip(streams, rerun))
    check(same, "serve_fused: the rerun gave other streams")
    # Against the unfused serve phase: report (no gate) how far the greedy
    # streams agree. Both are bf16 with other summation orders, so a near
    # tie can flip an argmax, after which a stream goes its own way.
    unfused = state.get("serve_streams")
    match = first = None
    if unfused is not None:
        new = [s[len(p):] for p, s in zip(prompts, streams)]
        match = sum(int((a == b).sum()) for a, b in zip(new, unfused))
        first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                      None) for x, y in zip(new, unfused)]
    # Last-position logits of the 300-token prompt, fused against unfused,
    # both on the card in bf16: gated below.
    prompt = prompts[3].tolist()
    before = dict(fd.launches), dict(pa.launches)
    lf = _chunked_prefill(params, cfg, prompt, dev, True)[-1]
    lu = _chunked_prefill(params, cfg, prompt, dev, False)[-1]
    fd.launches.update(before[0])
    pa.launches.update(before[1])
    state["bf16_fused_logits"] = lf
    state["serve_fused_streams"] = [s[len(p):] for p, s in
                                    zip(prompts, streams)]
    rel = float((lf - lu).abs().max() / lu.abs().max())
    emit({"phase": "serve_fused", "model": "llama3-8b", "layers": layers,
          "full_depth": layers == 32, "megakernel": engine.megakernel,
          "requests": len(prompts), "max_new_tokens": max_new,
          "launches": launches, "paged_attention_launches": paged,
          "decode_steps": steps, "prefill_chunks": chunks,
          "launches_per_kernel_per_layer_and_unit": {
              k: v / (layers * (steps + chunks)) for k, v in launches.items()},
          "prefix_hit_tokens": int(hits),
          "ttft_ms": [round(x, 3) for x in ttft],
          "decode_ms_per_step_by_request": [round(x, 3) for x in iv],
          "tokens_per_s": max_new * len(prompts) / wall, "wall_s": wall,
          "rerun_identical": same,
          "tokens_matching_unfused": match,
          "tokens_total": max_new * len(prompts),
          "first_divergence_by_request": first,
          "last_logits_max_rel_err_vs_unfused": rel,
          "last_logits_argmax_equal": int(lf.argmax()) == int(lu.argmax()),
          "stats": {k: v for k, v in engine.stats_snapshot().items()
                    if k in ("megakernel", "kernel_launches")}})
    # 32 layers of bf16 roundings taken in other orders: the two hidden
    # states drift apart by ~2^-9 relative a rounding, as a random walk
    # over ~10 roundings a layer (sqrt(320) x 2^-9 ~ 0.035 of the state),
    # and the logits inherit that drift; a misread weight, head or row
    # would move them by the whole logit range.
    check(rel < 0.1, f"serve_fused: last-position logits differ from the "
          f"unfused engine's by {rel} of their range (>= 0.1)")


def _serve_quant_run(params, cfg, dev, kind, fused):
    """The serve phases' requests through one engine on `kind` pools
    (fused or not) driven as a server drives it; checks the streams and
    that each layer of each decode step and prefill chunk launched the
    quantized paged kernel once (and, fused, each int8 fused kernel once)
    and nothing else."""
    import numpy as np

    from megatronapp_tpu_torch.inference.engine import SamplingParams
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    name = f"serve_quant {kind} {'fused' if fused else 'unfused'}"
    layers = cfg.num_layers
    engine = _engine(params, cfg, dev, fused=fused, kv_cache_dtype=kind)
    check(engine.megakernel is fused, f"{name}: the engine's step kind")
    driver = _driver(engine)
    greedy = SamplingParams(greedy=True)
    max_new = 32
    prompts, warm = _serve_prompts(cfg)
    rid, done = driver.submit(warm, 4, greedy)
    check(done.wait(timeout=600), f"{name}: warm-up did not finish")
    driver.result_tokens(rid)
    hits_before = engine.pool.stats["prefix_hit_tokens"]
    steps_before, chunks_before = engine.decode_steps, engine.prefill_chunks
    for counts in (fd.launches, pa.launches):
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    streams, times, t_start, t_end = _serve_once(driver, prompts, max_new,
                                                 greedy)
    launches, paged = dict(fd.launches), dict(pa.launches)
    steps = engine.decode_steps - steps_before
    chunks = engine.prefill_chunks - chunks_before
    hits = engine.pool.stats["prefix_hit_tokens"] - hits_before
    for p, s in zip(prompts, streams):
        check(s is not None and len(s) == len(p) + max_new
              and np.array_equal(s[:len(p)], p)
              and bool(((s[len(p):] >= 0)
                        & (s[len(p):] < cfg.vocab_size)).all()),
              f"{name}: a stream of the wrong length or vocabulary")
    want = dict.fromkeys((f"{k}_int8" for k in FUSED_KERNELS),
                         layers * (steps + chunks) if fused else 0)
    check(launches == only(launches, want),
          f"{name}: fused launches {launches}, expected {want} "
          f"({layers} layers x ({steps} decode steps + {chunks} chunks))")
    check(paged == only(paged, {f"decode_{kind}": layers * steps,
                                f"ragged_{kind}": layers * chunks}),
          f"{name}: paged-attention launches {paged} for {steps} steps and "
          f"{chunks} chunks")
    check(hits > 0, f"{name}: the shared prefix never hit")
    wall = t_end - t_start
    rerun, _, _, _ = _serve_once(driver, prompts, max_new, greedy)
    same = all(np.array_equal(a, b) for a, b in zip(streams, rerun))
    check(same, f"{name}: the rerun gave other streams")
    out = {"kv_cache_dtype": kind, "megakernel": engine.megakernel,
           "launches": {k: v for k, v in launches.items() if v},
           "paged_attention_launches": {k: v for k, v in paged.items()
                                        if v},
           "decode_steps": steps, "prefill_chunks": chunks,
           "prefix_hit_tokens": int(hits),
           "ttft_ms": [round((t[1] - t[0]) * 1e3, 3) for t in times],
           "decode_ms_per_step_by_request": [
               round((t[-1] - t[1]) * 1e3 / (len(t) - 2), 3) for t in times],
           "tokens_per_s": max_new * len(prompts) / wall, "wall_s": wall,
           "rerun_identical": same,
           "pool_bytes": engine.pool.bytes_total,
           "stats_param_bytes": engine.stats_snapshot()["param_bytes"]}
    return out, launches, paged


def phase_serve_quant(state):
    """The serve phase's seed-0 weights quantized at startup on the card
    by the code of serve.py --quantized-weights (quantize_for_serving: the
    five matmul kernels of every layer to resident int8), then the same 8
    requests through the fused engine on int8 pools and through the
    unfused engine on fp8 pools."""
    import numpy as np

    from megatronapp_tpu_torch.inference.quantization import (
        quantize_for_serving, resident_nbytes,
    )
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    params, cfg, dev = state["model"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams, report = quantize_for_serving(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    state["qmodel"] = (qparams, cfg, dev)
    runs = {}
    for kind, fused in (("int8", True), ("fp8", False)):
        key = f"{kind}_pools_{'fused' if fused else 'unfused'}"
        runs[key], launches, paged = _serve_quant_run(qparams, cfg, dev,
                                                      kind, fused)
        state["quant_launches"] = {**state.get("quant_launches", {}),
                                   **{k: v for k, v in paged.items() if v}}
        if fused:
            state["fused_int8_launches"] = {
                k[:-len("_int8")]: v for k, v in launches.items()
                if k.endswith("_int8")}
    # Last-position logits of the 300-token prompt on the quantized
    # weights and int8 pools, fused against unfused (gated, the slice-3
    # rule), and their distance from the bf16 fused engine's (printed).
    prompt = _serve_prompts(cfg)[0][3].tolist()
    before = dict(fd.launches), dict(pa.launches)
    lf = _chunked_prefill(qparams, cfg, prompt, dev, True,
                          kv_cache_dtype="int8")[-1]
    lu = _chunked_prefill(qparams, cfg, prompt, dev, False,
                          kv_cache_dtype="int8")[-1]
    fd.launches.update(before[0])
    pa.launches.update(before[1])
    rel = float((lf - lu).abs().max() / lu.abs().max())
    bf16 = state.get("bf16_fused_logits")
    dist = None if bf16 is None else float((lf - bf16).abs().max()
                                           / bf16.abs().max())
    emit({"phase": "serve_quant", "model": "llama3-8b",
          "layers": cfg.num_layers, "full_depth": cfg.num_layers == 32,
          "quantize_s": quant_s, "quantized_kernels": len(report),
          "max_weight_abs_err": max(report.values()),
          "param_bytes_bf16": resident_nbytes(params),
          "param_bytes_resident_int8": resident_nbytes(qparams),
          "runs": runs,
          "last_logits_fused_vs_unfused_int8_max_rel_err": rel,
          "last_logits_argmax_equal": int(lf.argmax()) == int(lu.argmax()),
          "last_logits_vs_bf16_fused_max_rel_err": dist,
          "last_logits_argmax_equal_bf16": (
              None if bf16 is None
              else int(lf.argmax()) == int(bf16.argmax())),
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    check(bool(np.isfinite(lf.numpy()).all()), "serve_quant: non-finite "
          "logits")
    # As serve_fused: 32 layers of bf16 roundings taken in other orders.
    check(rel < 0.1, f"serve_quant: fused int8 last-position logits differ "
          f"from the unfused engine's by {rel} of their range (>= 0.1)")


# ---------------------------------------------------------------------------
# batched LoRA (slice 5)
# ---------------------------------------------------------------------------


def _lora_banks(gen, dev, din, dout, rank, slots=5):
    """One layer's random fp32 banks [slots, din, rank] / [slots, rank,
    dout] with the NULL slot 0 zero, drawn as LoraAdapter.random draws
    (A ~ N(0, 1/din), B ~ N(0, 0.2^2))."""
    a = torch.randn(slots, din, rank, generator=gen, device=dev) / math.sqrt(
        din)
    b = torch.randn(slots, rank, dout, generator=gen, device=dev) * 0.2
    a[0] = 0
    b[0] = 0
    return a.contiguous(), b.contiguous()


def phase_lora_kernels(state):
    """The shrink and expand kernels (row 15) against their plain versions
    on the card at the five llama3-8b targets, ranks 8 and 16: a decode
    batch of 8 rows with mixed ids (NULL rows, two rows sharing an
    adapter, 4 distinct adapters) and a 32-row chunk of one adapter. The
    shrink's t against lora_shrink_plain, the expand of that t against
    lora_expand_plain and the delta (lora_delta: the shrink, then the
    expand) against lora_delta_plain, each under LORA_TOL; one launch of
    each kernel a call, reruns and each row alone the same bits, NULL rows
    exactly 0; q and kv in one shrink launch the bits of their own. Then
    the four fused kernels with their LoRA epilogue (bf16 and resident
    int8 weights, 8 and 32 rows) against their plain versions under
    FUSED_TOL, a row the same bits alone or among other tenants' rows."""
    import numpy as np

    from megatronapp_tpu_torch.inference.lora import lora_target_dims
    from megatronapp_tpu_torch.inference.quantization import (
        quantize_for_serving,
    )
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops import lora as tlo
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import lora as cl
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(2026)
    before = dict(cl.launches), dict(fd.lora_launches)
    cfg = llama3_8b(num_layers=1, params_dtype=torch.bfloat16)
    dims = lora_target_dims(cfg)
    cases = {}
    for rank in LORA_RANKS:
        banks = {t: _lora_banks(gen, dev, din, dout, rank)
                 for t, (din, dout) in dims.items()}
        for label, ids in (("rows8_mixed", LORA_DECODE_IDS),
                           ("rows32_one_adapter", [3] * 32),
                           ("rows40_verify", LORA_VERIFY_IDS)):
            segs = tlo.LoraRows(np.asarray(ids), dev)
            null = torch.tensor(ids, device=dev) == 0
            for target, (din, dout) in dims.items():
                a, b = banks[target]
                name = f"{target}_rank{rank}_{label}"
                x = torch.randn(len(ids), din, generator=gen,
                                device=dev).to(torch.bfloat16)
                n0 = dict(cl.launches)
                t = cl.lora_shrink(x, (a,), segs)[0]
                expanded = cl.lora_expand(t, b, segs)
                got = tlo.lora_delta(x, a, b, segs)
                again = tlo.lora_delta(x, a, b, segs)
                torch.cuda.synchronize()
                n = {k: cl.launches[k] - n0[k] for k in n0}
                check(n == {"lora_shrink": 3, "lora_expand": 3},
                      f"lora_kernels {name}: launches {n} for three shrinks "
                      "and three expands")
                check(torch.equal(got, again) and torch.equal(got, expanded),
                      f"lora_kernels {name}: the rerun gave other bits")
                check(bool(torch.isfinite(got).all())
                      and bool(torch.isfinite(t).all()),
                      f"lora_kernels {name}: non-finite t or delta")
                check(bool((got[null] == 0).all())
                      and bool((t[null] == 0).all()),
                      f"lora_kernels {name}: a NULL row is not exactly 0")
                for r in sorted({0, len(ids) - 1, *range(min(8, len(ids)))}):
                    alone = tlo.lora_delta(x[r:r + 1].contiguous(), a, b,
                                           np.asarray(ids[r:r + 1]))
                    check(torch.equal(alone[0], got[r]),
                          f"lora_kernels {name}: row {r} alone differs from "
                          "the same row in the batch")
                errs = {"shrink": _row_errs(t, tlo.lora_shrink_plain(
                            x, a, segs)),
                        "expand": _row_errs(expanded, tlo.lora_expand_plain(
                            t, b, segs)),
                        "delta": _row_errs(got, tlo.lora_delta_plain(
                            x, a, b, segs))}
                cases[name] = errs
                for part, err in errs.items():
                    check(err[1] <= LORA_TOL,
                          f"lora_kernels {name}: {part} error {err[1]} of "
                          f"max(|element|, row RMS) exceeds {LORA_TOL} (max "
                          f"abs {err[0]})")
            # q and kv share their input: one shrink launch for both gives
            # each the bits of its own launch.
            x = torch.randn(len(ids), cfg.hidden_size, generator=gen,
                            device=dev).to(torch.bfloat16)
            aq, akv = banks["q_kernel"][0], banks["kv_kernel"][0]
            both = cl.lora_shrink(x, (aq, akv), segs)
            check(torch.equal(both[0], cl.lora_shrink(x, (aq,), segs)[0])
                  and torch.equal(both[1], cl.lora_shrink(x, (akv,), segs)[0]),
                  f"lora_kernels rank {rank} {label}: the shared q/kv shrink "
                  "differs from the shrinks of one target")
        del banks
    # The fused kernels with their LoRA epilogue, rank 8.
    p = _fused_layer(cfg, gen, dev)
    epi = {}
    for wname, pp, variant in (("bf16", p, ""),
                               ("int8", quantize_for_serving(p)[0], "_int8")):
        banks = {t: _lora_banks(gen, dev, din, dout, 8)
                 for t, (din, dout) in dims.items()}
        for rows, ids in ((8, LORA_DECODE_IDS), (32, [3] * 32),
                          (VERIFY_ROWS, LORA_VERIFY_IDS)):
            lora = {"row_adapter": tlo.LoraRows(np.asarray(ids), dev),
                    "banks": banks}
            epi[f"{wname}_rows{rows}"] = _fused_case(
                f"lora {wname} R={rows}", cfg, pp, rows, gen, dev, variant,
                lora=lora)
        del banks
    del p
    cl.launches.update(before[0])
    fd.lora_launches.update(before[1])
    torch.cuda.empty_cache()
    state["lora_err"] = {part: max(e[part][0] for e in cases.values())
                         for part in ("shrink", "expand", "delta")}
    state["lora_epilogue_err"] = {
        f"{k}{sfx}": max(c[k][0] for n, c in epi.items() if n.startswith(w))
        for k in FUSED_KERNELS for w, sfx in (("bf16", ""), ("int8", "_int8"))}
    emit({"phase": "lora_kernels", "rel_tol": LORA_TOL,
          "epilogue_rel_tol": FUSED_TOL, "ranks": list(LORA_RANKS),
          "decode_ids": LORA_DECODE_IDS,
          "errors": "(max abs, max over max(|plain element|, row RMS))",
          "segmented": cases, "epilogues_rank8": epi})


def lora_launches_per_layer(fused: bool, units: int) -> dict:
    """The shrink and expand launches of `units` layer runs (a layer in a
    step or a chunk): unfused, one shrink for q and kv, one each for out,
    fc1 and fc2, and five expands (9 a layer); fused, the four shrinks
    before the four fused kernels, whose epilogues expand."""
    return {"lora_shrink": 4 * units, "lora_expand": 0 if fused else 5 * units}


def _lora_reference_cache(cfg, dev, rank=8):
    from megatronapp_tpu_torch.inference.lora import (
        AdapterCache, AdapterRegistry, LoraAdapter,
    )
    reg = AdapterRegistry()
    for i in range(3):
        reg.register(LoraAdapter.random(f"r{i}", cfg, rank=rank, seed=60 + i,
                                        scale=LORA_REF_SCALE))
    cache = AdapterCache(cfg, reg, max_resident=3, rank=rank, device=dev)
    return cache, [cache.acquire(f"r{i}") for i in range(3)] + [0]


def phase_lora_reference(state):
    """The tiny llama-shaped model of phase_fused_reference with 3
    adapters and the NULL one: a 40-token prompt's chunked prefill and one
    decode step per adapter, unfused and fused, on the card (bf16, the
    shrink and expand kernels, or the shrink and the fused kernels'
    epilogue) against the same weights and adapters on the CPU (fp32,
    plain versions)."""
    import copy

    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import lora as cl
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    before = dict(fd.lora_launches), dict(cl.launches), dict(pa.launches)
    small = dict(num_layers=2, hidden_size=512, num_attention_heads=4,
                 num_query_groups=2, ffn_hidden_size=1024, vocab_size=512,
                 init_method_std=0.05)
    cfg_ref = llama3_8b(compute_dtype=torch.float32, **small)
    cfg_dev = llama3_8b(params_dtype=torch.bfloat16, **small)
    p_ref = init_gpt_params(cfg_ref, torch.Generator().manual_seed(7), "cpu")
    p_dev = copy.deepcopy(p_ref).to(device="cuda", dtype=torch.bfloat16)
    dev = torch.device("cuda", 0)
    ref_cache, slots = _lora_reference_cache(cfg_ref, "cpu")
    dev_cache, dev_slots = _lora_reference_cache(cfg_dev, dev)
    check(slots == dev_slots, "lora_reference: slot books differ")
    tokens = torch.randint(0, 512, (40,),
                           generator=torch.Generator().manual_seed(8)).tolist()
    results = {}
    for fused in (False, True):
        step = "fused" if fused else "unfused"
        for counts in (fd.lora_launches, cl.launches):
            counts.update(dict.fromkeys(counts, 0))
        refs = {}
        for slot in slots:
            ref = torch.cat(_chunked_prefill(p_ref, cfg_ref, tokens, "cpu",
                                             fused, decode_token=17,
                                             lora=(ref_cache, slot)))
            got = torch.cat(_chunked_prefill(p_dev, cfg_dev, tokens, dev,
                                             fused, decode_token=17,
                                             lora=(dev_cache, slot)))
            refs[slot] = ref
            rel = float((got - ref).abs().max() / ref.abs().max())
            agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
            results[f"{step}_slot{slot}"] = {"max_rel_err": rel,
                                             "argmax_agreement": agree}
            check(bool(torch.isfinite(got).all()),
                  f"lora_reference {step} slot {slot}: non-finite logits")
            # As phase_reference: bf16 weights and activations through two
            # layers move the logits by a few percent of their range. The
            # argmax agreement is reported, not gated: an adapter makes the
            # logits larger, and their near-ties flip under bf16 (0.93 at
            # worst in a CPU bf16-vs-fp32 run of the plain versions).
            check(rel < 0.05, f"lora_reference {step} slot {slot}: relative "
                  f"logit error {rel} >= 0.05")
        # Each adapter moves the CPU logits by more than the gate above, so
        # a delta the card dropped or misread would fail it.
        effect = min(float((refs[s] - refs[0]).abs().max()
                           / refs[0].abs().max()) for s in slots[:3])
        results[f"{step}_min_adapter_effect"] = effect
        check(effect > 0.05, f"lora_reference {step}: the adapters move the "
              f"logits by only {effect} of their range")
        units = 2 * 3 * len(slots)       # layers x (2 chunks + 1 step) x runs
        want_l = lora_launches_per_layer(fused, units)
        if fused:
            want = {**dict.fromkeys(fd.lora_launches, 0),
                    **dict.fromkeys(FUSED_KERNELS, units)}
            check(dict(fd.lora_launches) == want and
                  dict(cl.launches) == want_l,
                  f"lora_reference fused: launches {dict(fd.lora_launches)},"
                  f" shrink/expand {dict(cl.launches)}, expected {want_l}")
        else:
            check(dict(cl.launches) == want_l and
                  not any(fd.lora_launches.values()),
                  f"lora_reference unfused: shrink/expand launches "
                  f"{dict(cl.launches)}, expected {want_l}")
    fd.lora_launches.update(before[0])
    cl.launches.update(before[1])
    pa.launches.update(before[2])
    emit({"phase": "lora_reference", "adapters": 3, "rank": 8,
          "adapter_scale": LORA_REF_SCALE, "cases": results})


def _lora_cache(state, zero_b=False, max_resident=4):
    """A fresh AdapterCache (rank 8) over serve_lora's five seeded adapters
    (or their zero-B twins) on the model's device."""
    import numpy as np

    from megatronapp_tpu_torch.inference.lora import (
        AdapterCache, AdapterRegistry,
    )
    _, cfg, dev = state["model"]
    reg = state["lora_registry"]
    if zero_b:
        zreg = AdapterRegistry()
        for aid in reg.ids():
            ad = reg.get(aid)
            zreg.register(type(ad)(aid, ad.rank, ad.a, {
                t: np.zeros_like(v) for t, v in ad.b.items()}))
        reg = zreg
    return AdapterCache(cfg, reg, max_resident=max_resident, rank=LORA_RANK,
                        device=dev)


def _serve_lora_run(params, cfg, dev, fused, cache, variant=""):
    """The serve phases' 8 requests on LORA_ROUTE's adapters through one
    engine with `cache`, driven as a server drives it, twice; checks the
    streams, the launches of every step and chunk, the cache's books."""
    import numpy as np

    from megatronapp_tpu_torch.inference.engine import SamplingParams
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import lora as cl
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    name = (f"serve_lora {'fused' if fused else 'unfused'}"
            f"{' int8 weights' if variant else ''}")
    layers = cfg.num_layers
    engine = _engine(params, cfg, dev, fused=fused, adapter_cache=cache)
    check(engine.megakernel is fused, f"{name}: the engine's step kind")
    driver = _driver(engine)
    greedy = SamplingParams(greedy=True)
    max_new = 32
    prompts, warm = _serve_prompts(cfg)
    rid, done = driver.submit(warm, 4, greedy, adapter_id=LORA_ADAPTERS[0])
    check(done.wait(timeout=600), f"{name}: warm-up did not finish")
    driver.result_tokens(rid)
    hits0 = engine.pool.stats["prefix_hit_tokens"]
    steps0, chunks0 = engine.decode_steps, engine.prefill_chunks
    for counts in (fd.launches, fd.lora_launches, pa.launches, cl.launches):
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    streams, times, t_start, t_end = _serve_once(
        driver, prompts, max_new, greedy, adapters=LORA_ROUTE)
    launches = {"fused": dict(fd.launches), "fused_lora":
                dict(fd.lora_launches), "paged": dict(pa.launches),
                "lora": dict(cl.launches)}
    steps = engine.decode_steps - steps0
    chunks = engine.prefill_chunks - chunks0
    hits = engine.pool.stats["prefix_hit_tokens"] - hits0
    for p, s in zip(prompts, streams):
        check(s is not None and len(s) == len(p) + max_new
              and np.array_equal(s[:len(p)], p)
              and bool(((s[len(p):] >= 0)
                        & (s[len(p):] < cfg.vocab_size)).all()),
              f"{name}: a stream of the wrong length or vocabulary")
    units = layers * (steps + chunks)
    want_fused = dict.fromkeys((k + variant for k in FUSED_KERNELS),
                               units if fused else 0)
    check(launches["fused_lora"] == only(launches["fused_lora"], want_fused)
          and not any(launches["fused"].values()),
          f"{name}: fused launches {launches['fused_lora']} (without the "
          f"epilogue {launches['fused']}), expected {want_fused} ({layers} "
          f"layers x ({steps} steps + {chunks} chunks))")
    want_l = lora_launches_per_layer(fused, units)
    check(launches["lora"] == want_l,
          f"{name}: shrink/expand launches {launches['lora']}, expected "
          f"{want_l} ({units} layer runs)")
    check(launches["paged"] == only(launches["paged"], {
        "decode": layers * steps, "ragged": layers * chunks}),
          f"{name}: paged launches {launches['paged']}")
    st = engine.stats_snapshot()["lora"]
    check(st["evictions"] >= 1 and st["pinned_waits"] >= 1,
          f"{name}: no eviction or no pinned wait: {st}")
    cache.audit()
    check(st["pinned"] == 0, f"{name}: {st['pinned']} slots still pinned")
    wall = t_end - t_start
    rerun, _, _, _ = _serve_once(driver, prompts, max_new, greedy,
                                 adapters=LORA_ROUTE)
    same = all(np.array_equal(a, b) for a, b in zip(streams, rerun))
    check(same, f"{name}: the rerun gave other streams")
    cache.audit()
    out = {"megakernel": engine.megakernel, "decode_steps": steps,
           "prefill_chunks": chunks, "prefix_hit_tokens_salted": int(hits),
           "launches": {k: {n: c for n, c in v.items() if c}
                        for k, v in launches.items()},
           "ttft_ms": [round((t[1] - t[0]) * 1e3, 3) for t in times],
           "decode_ms_per_step_by_request": [
               round((t[-1] - t[1]) * 1e3 / (len(t) - 2), 3) for t in times],
           "tokens_per_s": max_new * len(prompts) / wall, "wall_s": wall,
           "rerun_identical": same, "cache": engine.stats_snapshot()["lora"]}
    new = [s[len(p):] for p, s in zip(prompts, streams)]
    return new, out, launches


def _serve_streams(params, cfg, dev, fused, cache=None):
    """The serve phases' 8 greedy streams (new tokens) through one engine,
    every request on LORA_ROUTE's adapter when a cache is given."""
    from megatronapp_tpu_torch.inference.engine import SamplingParams
    driver = _driver(_engine(params, cfg, dev, fused=fused,
                                           adapter_cache=cache))
    prompts, _ = _serve_prompts(cfg)
    streams, _, _, _ = _serve_once(driver, prompts, 32,
                                   SamplingParams(greedy=True),
                                   adapters=None if cache is None
                                   else LORA_ROUTE)
    return [s[len(p):] for p, s in zip(prompts, streams)]


def phase_serve_lora(state):
    """llama3-8b at the served depth (serve's seed-0 bf16 weights) with an
    AdapterCache of 4 resident slots, rank 8, over 5 seeded adapters; the
    serve phases' 8 requests on [a0, a1, a2, a3, a4, None, a0, None]
    through the unfused engine, the fused engine and the fused engine on
    serve_quant's resident-int8 weights. Five distinct adapters in a batch
    of 8 on 4 slots: admission waits on pinned slots and evicts."""
    import numpy as np

    from megatronapp_tpu_torch.inference.lora import (
        AdapterRegistry, LoraAdapter,
    )
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import lora as cl
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    params, cfg, dev = state["model"]
    t0 = time.perf_counter()
    reg = AdapterRegistry()
    for i, aid in enumerate(LORA_ADAPTERS):
        reg.register(LoraAdapter.random(aid, cfg, rank=LORA_RANK,
                                        seed=100 + i,
                                        scale=LORA_SERVE_SCALE))
    state["lora_registry"] = reg
    make_s = time.perf_counter() - t0
    before = (dict(fd.launches), dict(fd.lora_launches), dict(pa.launches),
              dict(cl.launches))
    runs, streams = {}, {}
    engines = [("unfused", params, False, ""), ("fused", params, True, "")]
    if "qmodel" in state:
        engines.append(("fused_int8_weights", state["qmodel"][0], True,
                        "_int8"))
    for key, pp, fused, variant in engines:
        cache = _lora_cache(state)
        streams[key], runs[key], launches = _serve_lora_run(
            pp, cfg, dev, fused, cache, variant)
        for k, v in launches["lora"].items():      # every engine's
            state.setdefault("lora_launches", {}).setdefault(k, 0)
            state["lora_launches"][k] += v
        if key != "unfused":
            state.setdefault("lora_epilogue_launches", {}).update(
                {k: v for k, v in launches["fused_lora"].items() if v})
        if key == "fused":
            state["lora_cache"] = cache        # the times phase's banks
        else:
            del cache
        torch.cuda.empty_cache()
    # Zero-B adapters: the streams of the no-adapter engine of each kind.
    base = {"unfused": state.get("serve_streams"),
            "fused": state.get("serve_fused_streams")}
    if "qmodel" in state:
        base["fused_int8_weights"] = _serve_streams(state["qmodel"][0], cfg,
                                                    dev, True)
    zero_b = {}
    for key, pp, fused, _ in engines:
        if base.get(key) is None:
            continue
        z = _serve_streams(pp, cfg, dev, fused, _lora_cache(state, True))
        zero_b[key] = all(np.array_equal(a, b) for a, b in zip(z, base[key]))
        check(zero_b[key], f"serve_lora {key}: zero-B adapters changed the "
              "greedy streams of the no-adapter engine")
        torch.cuda.empty_cache()
    # At least one real adapter changes its request's greedy stream.
    changed = None
    if base["unfused"] is not None:
        changed = [i for i, a in enumerate(LORA_ROUTE) if a is not None
                   and not np.array_equal(streams["unfused"][i],
                                          base["unfused"][i])]
        check(bool(changed), "serve_lora: no adapter changed its request's "
              "greedy stream")
    # Fused against unfused last-position logits, the same adapter.
    prompt = _serve_prompts(cfg)[0][3].tolist()
    cache = state["lora_cache"]
    slot = cache.acquire(LORA_ADAPTERS[1])
    bl = tuple(dict(c) for c in (fd.launches, fd.lora_launches, pa.launches,
                                 cl.launches))
    lf = _chunked_prefill(params, cfg, prompt, dev, True,
                          lora=(cache, slot))[-1]
    lu = _chunked_prefill(params, cfg, prompt, dev, False,
                          lora=(cache, slot))[-1]
    for c, b in zip((fd.launches, fd.lora_launches, pa.launches,
                     cl.launches), bl):
        c.update(b)
    cache.release(slot)
    cache.audit()
    rel = float((lf - lu).abs().max() / lu.abs().max())
    for c, b in zip((fd.launches, fd.lora_launches, pa.launches,
                     cl.launches), before):
        c.update(b)
    emit({"phase": "serve_lora", "model": "llama3-8b",
          "layers": cfg.num_layers, "full_depth": cfg.num_layers == 32,
          "rank": LORA_RANK, "max_resident": 4,
          "adapters": LORA_ADAPTERS, "route": LORA_ROUTE,
          "adapter_scale": LORA_SERVE_SCALE, "make_adapters_s": make_s,
          "adapter_bytes": cache.adapter_nbytes,
          "bank_bytes": cache.bank_bytes(), "runs": runs,
          "zero_b_streams_equal_no_adapter_engine": zero_b,
          "requests_changed_by_their_adapter": changed,
          # The prefix keys carry the adapter id: the route's two requests
          # that share a 256-token prefix (a0 and None) no longer share its
          # blocks. The serve phase's hits are those of the same prompts
          # under unsalted keys, the keys every request had before.
          "prefix_hit_tokens_salted_by_engine": {
              k: r["prefix_hit_tokens_salted"] for k, r in runs.items()},
          "prefix_hit_tokens_unsalted_same_prompts_serve_phase":
              state.get("serve_prefix_hit_tokens"),
          "last_logits_fused_vs_unfused_max_rel_err": rel,
          "last_logits_argmax_equal": int(lf.argmax()) == int(lu.argmax()),
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    check(bool(np.isfinite(lf.numpy()).all()), "serve_lora: non-finite "
          "logits")
    # As serve_fused: 32 layers of bf16 roundings taken in other orders.
    check(rel < 0.1, f"serve_lora: fused last-position logits differ from "
          f"the unfused engine's by {rel} of their range (>= 0.1)")


def _lora_bytes(rows, ids, din, dout, rank):
    """Bytes the segmented delta must move: x (bf16) read once, one A and
    one B per distinct adapter (fp32; none for the NULL slot), the delta
    (fp32) written once, the row ids and segments."""
    distinct = len({i for i in ids if i != 0})
    return (rows * din * 2 + distinct * (din + dout) * rank * 4
            + rows * dout * 4 + (3 * rows + 2 * distinct + 1) * 4)


def _lora_bound(kind, ids, din, dout, rank, targets=1):
    """(bound ms, bound_by, bytes, flops) of one launch: "shrink" reads x
    (bf16) and `targets` A banks' rows of each distinct adapter and writes
    t; "expand" reads t and B of each distinct adapter and writes the
    delta; "delta" is the two (_lora_bytes). Each also reads the row ids
    and segments; the flops are the FMAs' of the non-NULL rows."""
    rows, live = len(ids), sum(i != 0 for i in ids)
    distinct = len({i for i in ids if i != 0})
    meta = (3 * rows + 2 * distinct + 1) * 4
    if kind == "shrink":
        nbytes = (rows * din * 2 + targets * (distinct * din * rank * 4
                                              + rows * rank * 4) + meta)
        flops = 2 * live * targets * din * rank
    elif kind == "expand":
        nbytes = (rows * rank * 4 + distinct * rank * dout * 4
                  + rows * dout * 4 + meta)
        flops = 2 * live * rank * dout
    else:
        nbytes = _lora_bytes(rows, ids, din, dout, rank)
        flops = 2 * live * rank * (din + dout)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def _lora_times(state):
    """The shrink and expand kernels at the five llama3-8b targets, 8
    decode rows (LORA_DECODE_IDS) and a 32-row chunk of one adapter, rank
    8, rotating through serve_lora's 32 layers of banks (their factors
    span the bank bytes, beyond L2). Per target: the shrink, the expand
    (of a fixed t) and the delta (the two, as lora_delta launches them),
    each beside its plain version, its bound and, as a yardstick the port
    never calls, torch.bmm on factors gathered per row in advance (the
    gather untimed; the delta: two bmm). Then q and kv in one shrink, as
    the unfused layer launches them; layer_sum: the layer as the unfused
    engine runs it (the shared q/kv shrink, the out, fc1 and fc2 shrinks,
    the five expands)."""
    import numpy as np

    from megatronapp_tpu_torch.inference.lora import lora_target_dims
    from megatronapp_tpu_torch.ops import lora as tlo
    from megatronapp_tpu_torch.ops.cuda import lora as cl
    cache = state["lora_cache"]
    _, cfg, dev = state["model"]
    before = dict(cl.launches)
    gen = torch.Generator(dev).manual_seed(78)
    layers = cache.num_layers
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % layers
        return it["i"]

    def timed(kern, plain, lib):
        # plain, kernel, kernel, plain: compare within one card and call.
        p1 = device_ms(plain, calls=PLAIN_CALLS)
        k1 = device_ms(kern)
        k2 = device_ms(kern)
        p2 = device_ms(plain, calls=PLAIN_CALLS)
        return {"kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                "library_ms": device_ms(lib)}

    def bounded(row, kind, ids, din, dout, targets=1):
        b, by, nbytes, flops = _lora_bound(kind, ids, din, dout, LORA_RANK,
                                           targets)
        return {**row, "bound_ms": b, "bound_by": by, "bytes": nbytes,
                "flops": flops}

    for aid in LORA_ADAPTERS[:4]:
        cache.acquire(aid)          # slots 1..4 hold adapters (pinned)
    out = {}
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
    for label, ids in (("rows8_mixed", LORA_DECODE_IDS),
                       ("rows32_one_adapter", [3] * 32)):
        rows = len(ids)
        segs = tlo.LoraRows(np.asarray(ids), dev)
        idx = torch.tensor(ids, device=dev, dtype=torch.long)
        t_fixed = torch.randn(rows, LORA_RANK, generator=gen, device=dev)
        per = {}
        xs = {}
        for target, (din, dout) in lora_target_dims(cfg).items():
            x = torch.randn(rows, din, generator=gen, device=dev).to(
                torch.bfloat16)
            xs[target] = x
            x32 = x.float()[:, None, :]
            gathered = [(cache.banks[target][0][i][idx],
                         cache.banks[target][1][i][idx])
                        for i in range(min(4, layers))]

            def bank(target=target):
                a_all, b_all = cache.banks[target]
                i = nxt()
                return a_all[i], b_all[i]

            def shrink(x=x, bank=bank):
                cl.lora_shrink(x, (bank()[0],), segs)

            def shrink_plain(x=x, bank=bank):
                tlo.lora_shrink_plain(x, bank()[0], segs)

            def shrink_lib(x32=x32, gathered=gathered):
                torch.bmm(x32, gathered[nxt() % len(gathered)][0])

            def expand(bank=bank):
                cl.lora_expand(t_fixed, bank()[1], segs)

            def expand_plain(bank=bank):
                tlo.lora_expand_plain(t_fixed, bank()[1], segs)

            def expand_lib(gathered=gathered):
                torch.bmm(t_fixed[:, None, :],
                          gathered[nxt() % len(gathered)][1])

            def delta(x=x, bank=bank):
                tlo.lora_delta(x, *bank(), segs)

            def delta_plain(x=x, bank=bank):
                tlo.lora_delta_plain(x, *bank(), segs)

            def delta_lib(x32=x32, gathered=gathered):
                a, b = gathered[nxt() % len(gathered)]
                torch.bmm(torch.bmm(x32, a), b)
            per[target] = {
                "shrink": bounded(timed(shrink, shrink_plain, shrink_lib),
                                  "shrink", ids, din, dout),
                "expand": bounded(timed(expand, expand_plain, expand_lib),
                                  "expand", ids, din, dout),
                **bounded(timed(delta, delta_plain, delta_lib), "delta",
                          ids, din, dout),
                "shape": {"rows": rows, "din": din, "dout": dout,
                          "rank": LORA_RANK,
                          "adapters": len({i for i in ids if i})}}
            del gathered
        # q and kv in one shrink launch, as the unfused layer runs them.
        x = xs["q_kernel"]
        x32 = x.float()[:, None, :]
        gq = [(cache.banks["q_kernel"][0][i][idx],
               cache.banks["kv_kernel"][0][i][idx])
              for i in range(min(4, layers))]

        def qkv_shrink(x=x):
            i = nxt()
            cl.lora_shrink(x, (cache.banks["q_kernel"][0][i],
                               cache.banks["kv_kernel"][0][i]), segs)

        def qkv_plain(x=x):
            i = nxt()
            for tg in ("q_kernel", "kv_kernel"):
                tlo.lora_shrink_plain(x, cache.banks[tg][0][i], segs)

        def qkv_lib(x32=x32, gq=gq):
            aq, akv = gq[nxt() % len(gq)]
            torch.bmm(x32, torch.cat([aq, akv], dim=-1))
        din = cfg.hidden_size
        per["qkv_shared_shrink"] = bounded(
            timed(qkv_shrink, qkv_plain, qkv_lib), "shrink", ids, din, 0,
            targets=2)
        del gq
        targets = list(lora_target_dims(cfg))
        shrinks = [per["qkv_shared_shrink"]] + [
            per[t]["shrink"] for t in targets if t not in ("q_kernel",
                                                           "kv_kernel")]
        expands = [per[t]["expand"] for t in targets]
        per["layer_sum"] = {
            "shrink": {k: sum(v[k] for v in shrinks) for k in keys},
            "expand": {k: sum(v[k] for v in expands) for k in keys},
            "delta_unfused_layer": {
                k: sum(v[k] for v in shrinks + expands) for k in keys},
            "delta_one_call_a_target": {
                k: sum(per[t][k] for t in targets) for k in keys}}
        out[label] = per
    for aid in LORA_ADAPTERS[:4]:
        cache.release(cache.slot_of(aid))
    cl.launches.update(before)
    state["lora_times"] = out
    return {"note": "device ms per call (device_ms), 32 layers of banks "
                    "rotated; library_ms: torch.bmm on per-row factors "
                    "gathered in advance (the gather untimed; the delta: "
                    "two bmm; no single PyTorch call computes the segmented "
                    "delta); layer_sum: one layer's launches as the unfused "
                    "engine runs them (shrink: q/kv shared, out, fc1, fc2; "
                    "expand: the five), delta_one_call_a_target: the five "
                    "targets' lora_delta calls",
            **out}


# ---------------------------------------------------------------------------
# multi-latent attention (slice 6)
# ---------------------------------------------------------------------------


def mla_cfg(**over):
    """llama3-8b with multi-latent attention at the config's defaults
    (kv_lora_rank 512, qk_head_dim 128, qk_pos_emb_head_dim 64, v_head_dim
    128, q_lora_rank None), bf16 params."""
    from megatronapp_tpu_torch.models.presets import llama3_8b
    kw = dict(multi_latent_attention=True, params_dtype=torch.bfloat16)
    kw.update(over)
    return llama3_8b(**kw)


def make_latent_case(gen, dev, *, batch, kv_lens, s_q=None, q_lens=None,
                     kind="bf16", nq=32, klat=512, dpe=64, dv=128, bs=16,
                     pool_bytes=0, mb=None):
    """Random q_lat / q_pe, one latent and one roped-key pool (quantized
    by quantize_kv_rows for int8/fp8), w_v as the strided view of a kv_up
    [klat, nq (128 + dv)] that the layers pass, and R disjoint shuffled
    page tables [R, B, MB] (R > 1 when pool_bytes asks for tables whose
    rows exceed the L2 cache, as make_case; MB: the longest kv_len's
    blocks, or `mb`)."""
    from megatronapp_tpu_torch.ops.paged_attention import quantize_kv_rows
    mb = mb or max(math.ceil(n / bs) for n in kv_lens)
    per_table = batch * mb
    block_bytes = bs * (klat + dpe) * (2 if kind == "bf16" else 1)
    r = max(1, math.ceil(pool_bytes / (per_table * block_bytes)))
    nb = r * per_table + 3
    perm = torch.randperm(nb, generator=gen, device="cpu")[:r * per_table]
    tables = perm.reshape(r, batch, mb).to(torch.int32).to(dev)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cpu").to(dev)

    lat, pe = rnd(nb, bs, klat), rnd(nb, bs, dpe)
    case = {"tables": tables, "table": tables[0],
            "kv_lens": torch.tensor(kv_lens, dtype=torch.int32, device=dev)}
    if kind == "bf16":
        case["lat"], case["pe"] = lat.to(torch.bfloat16), pe.to(torch.bfloat16)
    else:
        case["lat"], case["lat_scales"] = quantize_kv_rows(lat,
                                                           QUANT_KINDS[kind])
        case["pe"], case["pe_scales"] = quantize_kv_rows(pe, QUANT_KINDS[kind])
    del lat, pe
    qs = (batch, nq) if s_q is None else (batch, s_q, nq)
    case["q_lat"] = rnd(*qs, klat).to(torch.bfloat16)
    case["q_pe"] = rnd(*qs, dpe).to(torch.bfloat16)
    kv_up = (rnd(klat, nq * (128 + dv)) / klat ** 0.5).to(torch.bfloat16)
    case["w_v"] = kv_up.reshape(klat, nq, 128 + dv)[..., 128:]
    if q_lens is not None:
        case["q_lens"] = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    return case


def _latent_kw(case):
    return {"q_lens": case.get("q_lens"), "softmax_scale": MLA_SCALE,
            "lat_scales": case.get("lat_scales"),
            "pe_scales": case.get("pe_scales")}


def _compare_latent(case, name, kind):
    """The latent kernels twice (two launches a call, counted once; the
    same bits) against their plain version on the same inputs; returns
    (max abs error, max error over max(|element|, (row, head) RMS))."""
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    ql = case.get("q_lens")
    key = ("decode" if ql is None else "ragged") + (
        "" if kind == "bf16" else f"_{kind}")
    args = (case["q_lat"], case["q_pe"], case["lat"], case["pe"],
            case["table"], case["kv_lens"], case["w_v"])
    before = pl.launches[key]
    out = pl.paged_attention_latent(*args, **_latent_kw(case))
    again = pl.paged_attention_latent(*args, **_latent_kw(case))
    torch.cuda.synchronize()
    check(pl.launches[key] == before + 2,
          f"mla_kernels {name}: {key} launched {pl.launches[key] - before} "
          "times for two calls")
    check(torch.equal(out, again), f"mla_kernels {name}: the rerun gave "
          "other bits")
    got = out.float()
    check(bool(torch.isfinite(got).all()),
          f"mla_kernels {name}: non-finite output")
    ref = pl.paged_attention_latent_plain(*args, **_latent_kw(case)).float()
    if ql is not None:    # padding rows are finite garbage by contract
        real = (torch.arange(got.shape[1], device=got.device)[None, :]
                < ql[:, None].long())
        got, ref = got[real], ref[real]
    err = (got - ref).abs()
    rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    rel = float((err / torch.maximum(ref.abs(), rms)).max())
    check(rel <= MLA_TOL, f"mla_kernels {name}: error {rel} of max(|element|"
          f", row RMS) exceeds {MLA_TOL} (max abs {float(err.max())})")
    return float(err.max()), rel


def _mla_layer(cfg, gen, dev):
    """One MLA layer's params on the card, every vector leaf random."""
    from megatronapp_tpu_torch.transformer.block import init_layer_params
    p = init_layer_params(cfg, gen, dev)
    for name, t in p.named_parameters():
        if t.dim() == 1:
            t.normal_(1.0, 0.1, generator=gen)
    return p


def _compare_prologue(p, cfg, rows, gen, dev, name):
    """The fused MLA prologue twice (two launches a call, the same bits)
    against its plain version on the same inputs; returns (max abs error,
    max error over max(|element|, row RMS)) over its four outputs."""
    from megatronapp_tpu_torch.models.gpt import gpt_rope_tables
    from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
    x = torch.randn(rows, cfg.hidden_size, generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.randint(0, 2048, (rows,), generator=gen, device=dev)
    cos_t, sin_t = gpt_rope_tables(cfg, 2048, device=dev)
    cos, sin = cos_t[pos].contiguous(), sin_t[pos].contiguous()
    before = dict(fm.launches)
    got = fm.fused_mla_qkv(x, p, cfg, cos, sin)
    again = fm.fused_mla_qkv(x, p, cfg, cos, sin)
    torch.cuda.synchronize()
    check({k: fm.launches[k] - before[k] for k in before}
          == {"mla_down": 2, "mla_up": 2},
          f"mla_kernels {name}: launches {fm.launches} (before {before})")
    want = fm.fused_mla_qkv_plain(x, p, cfg, cos, sin)
    worst_abs = worst = 0.0
    for out, a2, ref, what in zip(got, again, want,
                                  ("q_lat", "q_pe", "latent", "k_pe")):
        check(torch.equal(out, a2), f"mla_kernels {name}: {what}'s rerun "
              "gave other bits")
        g, r = out.float().reshape(rows, -1), ref.float().reshape(rows, -1)
        check(bool(torch.isfinite(g).all()), f"mla_kernels {name}: "
              f"non-finite {what}")
        err = (g - r).abs()
        rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
        rel = float((err / torch.maximum(r.abs(), rms)).max())
        check(rel <= FUSED_TOL, f"mla_kernels {name}: {what} error {rel} of "
              f"max(|element|, row RMS) exceeds {FUSED_TOL}")
        worst_abs, worst = max(worst_abs, float(err.max())), max(worst, rel)
    return worst_abs, worst


def phase_mla_kernels(state):
    """Row 7 (the latent kernels) against its plain version on the same
    pools at MLA's full widths (klat 512, dpe 64, nq 32, dv 128, block 16):
    decode at B 8 with kv up to 1024 and the engine's ragged launch (B 1,
    S_q 32), and on the engine's 2048-position tables at the split plan's
    edges (kv one position past a split, a split's end, the table's end,
    kv 1 beside full slots; a chunk past and on split edges), on bf16,
    int8 and fp8 pools, and two kernels a call by the profiler's count;
    then row 11 (the fused MLA prologue) on one full-width llama3-8b MLA
    layer at 8 and 32 rows, with q_proj and with q_lora_rank 1536
    (DeepSeek-V2's)."""
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(606)
    before = dict(pl.launches), dict(fm.launches)
    lens = [1, 15, 16, 17, 300, 1000, 1024, 640]
    sms = kbuild.sm_count(dev)
    st = pl.latent_split_plan(8, 32, 2048, 512, sms).split_tokens
    stc = pl.latent_split_plan(2, 1024, 2048, 512, sms).split_tokens
    shapes = {"decode_b8": dict(batch=8, kv_lens=lens),
              "ragged_b1": dict(batch=1, kv_lens=[1000], s_q=32,
                                q_lens=[24]),
              "ragged_b1_full": dict(batch=1, kv_lens=[1024], s_q=32,
                                     q_lens=[32]),
              "ragged_b3_tail": dict(batch=3, kv_lens=[5, 40, 700], s_q=32,
                                     q_lens=[5, 32, 1]),
              "decode_b8_table2048_split_edges": dict(
                  batch=8, mb=128, kv_lens=[st + 1, st, 2 * st, 2 * st - 1,
                                            3 * st + 1, 4 * st, 2048, 16]),
              "decode_b8_table2048_kv1_beside_full": dict(
                  batch=8, mb=128, kv_lens=[1, 2048, 1, 1, 1024, 1, 2048,
                                            1]),
              "ragged_b2_table2048_split_edges": dict(
                  batch=2, mb=128, kv_lens=[stc + 1, 2 * stc], s_q=32,
                  q_lens=[32, 7]),
              # The speculative verify step: B 8 slots of S_q 4 (the fused
              # MLA engine's k 3) and 5 (k 4: 160 query rows a slot, two
              # whole 64-row tiles and a half one), q_lens mixed with
              # q_len 1 beside full slots, kv on and one past block edges
              # and at 2047 of a 2048-position table.
              "ragged_b8_verify_sq4": dict(
                  batch=8, mb=128, s_q=4, q_lens=[1, 4, 1, 4, 2, 3, 4, 4],
                  kv_lens=[16, 17, 32, 33, 1024, 1025, 2047, 4]),
              "ragged_b8_verify_sq5": dict(
                  batch=8, mb=128, s_q=5, q_lens=[1, 5, 1, 5, 2, 3, 4, 5],
                  kv_lens=[16, 17, 32, 33, 1024, 1025, 2047, 5])}
    latent = {}
    for name, kw in shapes.items():
        for kind in ("bf16", "int8", "fp8"):
            latent[f"{name}_{kind}"] = _compare_latent(
                make_latent_case(gen, dev, kind=kind, **kw), name, kind)
            torch.cuda.empty_cache()
    # Two kernels a call by the profiler's count, on a burst of decode and
    # chunk calls alone (bf16 pools).
    kernels_per_call = {}
    for mode, kw in (("decode", shapes["decode_b8"]),
                     ("ragged", shapes["ragged_b1"])):
        case = make_latent_case(gen, dev, **kw)
        args = (case["q_lat"], case["q_pe"], case["lat"], case["pe"],
                case["table"], case["kv_lens"], case["w_v"])
        prof = _device_profile(
            lambda: [pl.paged_attention_latent(*args, **_latent_kw(case))
                     for _ in range(16)], 16,
            calls={"paged_latent": lambda: sum(pl.launches.values())})
        n = prof["kernels_by_family"]["paged_latent"]
        check(prof["paged_latent_calls"] == 16 and n == 32,
              f"mla_kernels: {n} latent kernels for "
              f"{prof['paged_latent_calls']} {mode} calls (two a call)")
        kernels_per_call[mode] = n / 16
        del case
    torch.cuda.empty_cache()
    pgen = torch.Generator(dev).manual_seed(607)
    prologue = {}
    for q, over in (("q_proj", {}), ("q_lora_1536", dict(q_lora_rank=1536))):
        cfg = mla_cfg(num_layers=1, **over)
        p = _mla_layer(cfg, pgen, dev)
        for rows in (8, 32):
            prologue[f"{q}_rows{rows}"] = _compare_prologue(
                p, cfg, rows, pgen, dev, f"{q} {rows} rows")
        del p
    torch.cuda.empty_cache()
    pl.launches.update(before[0])        # not main-path launches
    fm.launches.update(before[1])
    state["mla_latent_err"] = {
        f"{mode}{'' if kind == 'bf16' else '_' + kind}": max(
            v[0] for k, v in latent.items()
            if k.startswith(mode) and k.endswith(kind))
        for mode in ("decode", "ragged") for kind in ("bf16", "int8", "fp8")}
    state["mla_prologue_err"] = max(v[0] for v in prologue.values())
    emit({"phase": "mla_kernels", "latent_tol": MLA_TOL,
          "prologue_tol": FUSED_TOL,
          "latent_kernels_per_call": kernels_per_call,
          "errors": "(max abs, max over max(|plain element|, row RMS))",
          "latent": latent, "prologue": prologue})


def phase_mla_reference(state):
    """A tiny MLA llama-shaped model (hidden 512, 4 heads, klat 128, dqk
    64, dpe 64, dv 64: widths the kernels take): a 40-token prompt's
    chunked prefill (a chunk of 32 rows and one of 8) and one decode step
    on the card (bf16, kernels), unfused and fused, on a bf16 and an int8
    pool, against the same weights on the CPU (fp32, plain versions)."""
    import copy

    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    counters = (pl.launches, fm.launches, fd.launches)
    before = [dict(c) for c in counters]
    small = dict(num_layers=2, hidden_size=512, num_attention_heads=4,
                 num_query_groups=4, ffn_hidden_size=1024, vocab_size=512,
                 init_method_std=0.05, kv_lora_rank=128, qk_head_dim=64,
                 qk_pos_emb_head_dim=64, v_head_dim=64)
    cfg_ref = mla_cfg(compute_dtype=torch.float32,
                      params_dtype=torch.float32, **small)
    cfg_dev = mla_cfg(**small)
    p_ref = init_gpt_params(cfg_ref, torch.Generator().manual_seed(7), "cpu")
    for t in p_ref.parameters():        # norm scales N(1, 0.1), not ones
        if t.dim() == 1:
            t.copy_(1 + 0.1 * torch.randn(
                t.shape, generator=torch.Generator().manual_seed(t.numel())))
    p_dev = copy.deepcopy(p_ref).to(device="cuda", dtype=torch.bfloat16)
    tokens = torch.randint(0, 512, (40,),
                           generator=torch.Generator().manual_seed(8)).tolist()
    dev = torch.device("cuda", 0)
    out, runs = {}, {}
    for kind in ("bf16", "int8"):
        ref_pre, ref_dec = _chunked_prefill(p_ref, cfg_ref, tokens, "cpu",
                                            False, decode_token=17,
                                            kv_cache_dtype=kind)
        ref = torch.cat([ref_pre, ref_dec])
        for fused in (False, True):
            for c in counters:
                c.update(dict.fromkeys(c, 0))
            pre, dec = _chunked_prefill(p_dev, cfg_dev, tokens, dev, fused,
                                        decode_token=17, kv_cache_dtype=kind)
            got = torch.cat([pre, dec])
            name = f"{kind}_{'fused' if fused else 'unfused'}"
            sfx = "" if kind == "bf16" else f"_{kind}"
            want_pl = only(pl.launches, {f"ragged{sfx}": 2 * 2,
                                         f"decode{sfx}": 2})
            want_fm = dict.fromkeys(fm.launches, 2 * 3 if fused else 0)
            want_fd = only(fd.launches, dict.fromkeys(
                ("out_proj", "mlp_fc1", "mlp_fc2"), 2 * 3 if fused else 0))
            check(dict(pl.launches) == want_pl
                  and dict(fm.launches) == want_fm
                  and dict(fd.launches) == want_fd,
                  f"mla_reference {name}: launches {pl.launches} "
                  f"{fm.launches} {fd.launches}, expected {want_pl} "
                  f"{want_fm} {want_fd}")
            rel = float((got - ref).abs().max() / ref.abs().max())
            agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
            out[name] = got
            runs[name] = {"max_rel_err": rel, "argmax_agreement": agree}
            check(bool(torch.isfinite(got).all()),
                  f"mla_reference {name}: non-finite logits")
            # As phase_reference: bf16 weights and activations through two
            # layers; int8 rows add their quantization on both sides.
            check(rel < 0.05, f"mla_reference {name}: relative logit error "
                  f"{rel} >= 0.05")
    for c, b in zip(counters, before):
        c.update(b)
    fused_vs_unfused = {kind: float(
        (out[f"{kind}_fused"] - out[f"{kind}_unfused"]).abs().max()
        / out[f"{kind}_unfused"].abs().max()) for kind in ("bf16", "int8")}
    emit({"phase": "mla_reference", "runs": runs,
          "fused_vs_unfused_max_rel": fused_vs_unfused})


# ---------------------------------------------------------------------------
# speculative decoding (slice 8)
# ---------------------------------------------------------------------------

# The served bound of a logit near-tie: where the card's greedy
# speculative stream leaves its plain stream, the plain logits' top two
# must lie within this (serve_fused's fused-vs-unfused logit bound).
SPEC_TIE_BOUND = 0.1
SPEC_K = 4
SPEC_MLA_FUSED_K = 3        # B 8 x 4 = 32 rows: the MLA prologue's limit
SPEC_SHALLOW_LAYERS = 4     # serve_spec's int8/fp8, LoRA, self-draft, MLA
SPEC_RUN_LEN = 480          # the repeated token of _spec_prompts' two


def _spec_prompts(params, cfg, dev):
    """serve_spec's 8 prompts for one model: the serve phase's first six
    (17-700 tokens) and two that hold their own continuation, so that
    the n-gram proposer has continuations from the first round. A
    48-token pattern repeated four times gives it none here: a
    model of random weights follows no pattern, and the seeded
    llama3-8b's 32 new tokens repeat no earlier token, so lookup finds
    nothing. What it does follow is itself: a prompt of one token t
    repeated 480 times gives every position the same hidden state (every
    value attended is v(t)), and its greedy continuation C (32 tokens)
    stays mostly determined by that long context. Each prompt is C then
    t x 480: at its end the model continues about as C runs, and n-gram
    lookup retrieves C — a document that holds its own answer."""
    import numpy as np

    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    from megatronapp_tpu_torch.inference.engine import SamplingParams
    prompts, _ = _serve_prompts(cfg)
    rng = np.random.default_rng(48)
    bases = [np.full(SPEC_RUN_LEN, int(t), np.int32)
             for t in rng.integers(0, cfg.vocab_size - 1, 2)]
    eng = DynamicInferenceEngine(params, cfg, max_batch=2,
                                 max_seq_len=SPEC_RUN_LEN + 64, device=dev)
    ids = [eng.add_request(b, 32, SamplingParams(greedy=True))
           for b in bases]
    res = eng.run_to_completion()
    del eng
    return prompts[:6] + [np.concatenate([res[r][SPEC_RUN_LEN:], b])
                          .astype(np.int32) for r, b in zip(ids, bases)]


def _first_divergence(streams, plain):
    """Per request, the first generated index where `streams` leaves
    `plain` (None where they agree)."""
    import numpy as np
    out = []
    for a, b in zip(streams, plain):
        diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
        out.append(int(diff[0]) if len(diff) else None)
    return out


def _layer_view(params, n):
    """The first n layers of a model's params, sharing every tensor (a
    cut-depth model without a copy)."""
    from torch import nn

    from megatronapp_tpu_torch.utils.params import ParamTree
    top = dict(params.named_parameters(recurse=False))
    return ParamTree({k: v.data for k, v in top.items()},
                     embedding=params["embedding"],
                     layers=nn.ModuleList(list(params["layers"])[:n]))


def _spec_counters():
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
    from megatronapp_tpu_torch.ops.cuda import lora as cl
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    return {"paged": pa.launches, "latent": pl.launches,
            "fused": fd.launches, "fused_lora": fd.lora_launches,
            "prologue": fm.launches, "lora": cl.launches}


def _spec_launch_checks(name, cfg, engine, got, steps, chunks, rounds,
                        kind, fused, lora, int8_weights):
    """Every layer of every plain decode step, prefill chunk and verify
    round launched its kernels once, and nothing else ran: the ragged
    paged kernel (row 1; row 7 for MLA) once a layer in each chunk and
    each verify round, the decode kernel in each plain step; fused, each
    fused kernel once a layer in each of them (MLA: the prologue's two
    kernels, out-projection and MLP); with adapters, the LoRA shrinks and
    the fused kernels' epilogues (or the expands) likewise."""
    layers = cfg.num_layers
    sfx = "" if kind == "bf16" else f"_{kind}"
    units = layers * (steps + chunks + rounds)
    want = {"paged": {}, "latent": {}, "fused": {}, "fused_lora": {},
            "prologue": {}, "lora": {}}
    attn = "latent" if cfg.multi_latent_attention else "paged"
    want[attn] = {f"decode{sfx}": layers * steps,
                  f"ragged{sfx}": layers * (chunks + rounds)}
    if fused:     # resident int8 weights count under "<kernel>_int8"
        if cfg.multi_latent_attention:
            want["prologue"] = {"mla_down": units, "mla_up": units}
            want["fused"] = dict.fromkeys(
                ("out_proj", "mlp_fc1", "mlp_fc2"), units)
        else:
            want["fused_lora" if lora else "fused"] = dict.fromkeys(
                (k + ("_int8" if int8_weights else "")
                 for k in FUSED_KERNELS), units)
    if lora:
        want["lora"] = lora_launches_per_layer(fused, units)
    for fam, counts in got.items():
        check(counts == only(counts, want[fam]),
              f"{name}: {fam} launches {counts}, expected {want[fam]} "
              f"({layers} layers x ({steps} plain steps + {chunks} chunks "
              f"+ {rounds} verify rounds))")
    check(engine.megakernel is fused, f"{name}: megakernel is "
          f"{engine.megakernel}")


def _rejection_gaps():
    """A context that records, for every rejected greedy draft, the
    target's logit gap between its argmax and the draft token at the
    rejected position (wrapping the verifier the engine calls)."""
    import contextlib

    from megatronapp_tpu_torch.inference import speculative as sp

    @contextlib.contextmanager
    def recording():
        gaps, verify = [], sp._verify_and_sample

        def wrapped(logits, drafts, q_lens, q_probs, rows, *, point_mass):
            a, out = verify(logits, drafts, q_lens, q_probs, rows,
                            point_mass=point_mass)
            for b in range(len(a)):
                if not rows["sampled"][b] and a[b] < q_lens[b] - 1:
                    row = logits[b, int(a[b])].float()
                    gaps.append(float(row.max()
                                      - row[int(drafts[b, int(a[b])])]))
            return a, out
        sp._verify_and_sample = wrapped
        try:
            yield gaps
        finally:
            sp._verify_and_sample = verify
    return recording()


def _spec_run(name, params, cfg, dev, prompts, *, method=None, k=SPEC_K,
              fused=False, kind="bf16", draft=None, cache=None, routes=None,
              max_new=32, drill=False, gaps=None):
    """One engine over `prompts` (32 greedy new tokens each): driven as a
    server drives it (the driver; warm-up first), or, for a `drill` pair,
    stepped directly (a clean run, then one whose spec-verify site fires
    once, which must give the same streams and the same drafts proposed
    and accepted). `gaps`, a _rejection_gaps list, is emptied after the
    warm-up, so it holds the measured requests' rejections. Checks the
    kernels' launches a layer (``_spec_launch_checks``), the pool's audit
    with every block back, and returns the run's figures and streams (new
    tokens)."""
    import numpy as np

    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    from megatronapp_tpu_torch.inference.engine import SamplingParams
    from megatronapp_tpu_torch.inference.quantization import is_resident_leaf
    from megatronapp_tpu_torch.inference.server import DynamicBatchingDriver
    from megatronapp_tpu_torch.utils import chaos
    greedy = SamplingParams(greedy=True)
    kw = dict(max_batch=8, max_seq_len=2048, block_size=16,
              prefill_chunk=32, device=dev, fused_decode=fused,
              kv_cache_dtype=kind, adapter_cache=cache)
    if method is not None:
        kw.update(spec_method=method, spec_k=k)
        if method == "draft":
            kw.update(draft_params=draft[0], draft_cfg=draft[1])
    engine = DynamicInferenceEngine(params, cfg, **kw)
    check(engine.spec_method == method, f"{name}: spec_method "
          f"{engine.spec_method}")
    counters = _spec_counters()
    out = {"method": method, "k": k if method else None,
           "layers": cfg.num_layers, "kv_cache_dtype": kind,
           "megakernel": engine.megakernel}
    if drill:
        streams, stats = [], []
        faults = 0
        for fault in (False, True):
            spec0 = dict(engine.spec_stats)
            ids = [engine.add_request(p, max_new, greedy,
                                      adapter_id=None if routes is None
                                      else routes[i])
                   for i, p in enumerate(prompts)]
            if fault:
                chaos.arm("spec-verify", times=1, after=2)
            try:
                while engine.has_work:
                    try:
                        engine.step()
                    except chaos.ChaosFault:
                        faults += 1
                        engine.pool.audit()
            finally:
                chaos.disarm()
            streams.append([engine.requests.pop(r).tokens[len(p):]
                            for r, p in zip(ids, prompts)])
            stats.append({s: engine.spec_stats[s] - spec0[s]
                          for s in ("rounds", "proposed", "accepted")})
        check(faults == 1, f"{name}: the spec-verify fault fired {faults} "
              "times")
        same = all(np.array_equal(a, b) for a, b in zip(*streams))
        check(same, f"{name}: the spec-verify drill changed the streams")
        check(stats[0] == stats[1], f"{name}: the spec-verify drill changed "
              f"the drafts: {stats[0]} clean, {stats[1]} with the fault")
        engine.pool.audit()
        check(engine.pool.blocks_in_use() == 0,
              f"{name}: {engine.pool.blocks_in_use()} blocks still in use")
        out.update(drill_faults=faults, drill_streams_equal=same,
                   drill_spec=stats)
        del engine
        torch.cuda.empty_cache()
        return out, streams[0]
    driver = DynamicBatchingDriver(engine)
    try:
        rid, done = driver.submit(prompts[0][:20], 4, greedy,
                                  adapter_id=None if routes is None
                                  else routes[0])
        check(done.wait(timeout=600), f"{name}: warm-up did not finish")
        driver.result_tokens(rid)
        spec0 = dict(engine.spec_stats)
        if gaps is not None:
            gaps.clear()
        steps0, chunks0 = engine.decode_steps, engine.prefill_chunks
        draft0 = getattr(engine.proposer, "steps", 0)
        for c in counters.values():
            c.update(dict.fromkeys(c, 0))
        torch.cuda.synchronize()
        streams, times, t0, t1 = _serve_once(driver, prompts, max_new,
                                             greedy, adapters=routes)
        got = {f: dict(c) for f, c in counters.items()}
    finally:
        driver.close()
    spec = {s: engine.spec_stats[s] - spec0[s] for s in spec0}
    steps = engine.decode_steps - steps0
    chunks = engine.prefill_chunks - chunks0
    for p, s in zip(prompts, streams):
        check(s is not None and len(s) == len(p) + max_new
              and np.array_equal(s[:len(p)], p)
              and bool(((s[len(p):] >= 0)
                        & (s[len(p):] < cfg.vocab_size)).all()),
              f"{name}: a stream of the wrong length or vocabulary")
    _spec_launch_checks(
        name, cfg, engine, got, steps, chunks, spec["rounds"], kind, fused,
        cache is not None,
        is_resident_leaf(params["layers"][0]["attention"].get("q_kernel")))
    engine.pool.audit()
    check(engine.pool.blocks_in_use() == 0,
          f"{name}: {engine.pool.blocks_in_use()} blocks still in use")
    if cache is not None:
        cache.audit()
    if method is not None:
        check(spec["rounds"] > 0 and spec["proposed"] > 0,
              f"{name}: no verify round proposed anything: {spec}")
    iv = [(t[-1] - t[1]) * 1e3 / (len(t) - 2) for t in times]
    out.update(
        rounds=spec["rounds"], plain_steps=steps, prefill_chunks=chunks,
        proposed=spec["proposed"], accepted=spec["accepted"],
        acceptance=(spec["accepted"] / spec["proposed"]
                    if spec["proposed"] else None),
        tokens_per_model_step=(spec["emitted_tokens"] / spec["model_steps"]
                               if spec["model_steps"] else None),
        model_steps=spec["model_steps"],
        draft_model_steps=getattr(engine.proposer, "steps", 0) - draft0,
        launches={f: {n: c for n, c in v.items() if c}
                  for f, v in got.items() if any(v.values())},
        verify_launches_per_round_per_layer=(
            (got["latent" if cfg.multi_latent_attention else "paged"]
             [f"ragged{'' if kind == 'bf16' else '_' + kind}"]
             - cfg.num_layers * chunks) / (spec["rounds"] * cfg.num_layers)
            if spec["rounds"] else None),
        decode_interval_ms_median=float(np.median(iv)),
        ttft_ms_median=float(np.median([(t[1] - t[0]) * 1e3
                                        for t in times])),
        wall_s=t1 - t0)
    del engine, driver
    torch.cuda.empty_cache()
    return out, [s[len(p):] for p, s in zip(prompts, streams)]


def _spec_reference_models(dev):
    """phase_reference's tiny llama-shaped model and phase_mla_reference's
    tiny MLA twin: (name, cfg_ref, cfg_dev, params on the CPU in fp32,
    params on the card in bf16)."""
    import copy

    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    small = dict(num_layers=2, hidden_size=512, num_attention_heads=4,
                 num_query_groups=2, ffn_hidden_size=1024, vocab_size=512,
                 init_method_std=0.05)
    mla_small = dict(small, num_query_groups=4, kv_lora_rank=128,
                     qk_head_dim=64, qk_pos_emb_head_dim=64, v_head_dim=64)
    out = []
    for name, cfg_ref, cfg_dev in (
            ("llama", llama3_8b(compute_dtype=torch.float32, **small),
             llama3_8b(params_dtype=torch.bfloat16, **small)),
            ("mla", mla_cfg(compute_dtype=torch.float32,
                            params_dtype=torch.float32, **mla_small),
             mla_cfg(**mla_small))):
        p_ref = init_gpt_params(cfg_ref, torch.Generator().manual_seed(7),
                                "cpu")
        p_dev = copy.deepcopy(p_ref).to(device=dev, dtype=torch.bfloat16)
        out.append((name, cfg_ref, cfg_dev, p_ref, p_dev))
    return out


def phase_spec_reference(state):
    """phase_reference's tiny llama-shaped model and its MLA twin with the
    n-gram proposer, on a bf16 and an int8 pool, unfused and fused: the
    verify step's logits on the card (bf16, kernels) against the CPU
    (fp32, plain versions) on the same admitted prompts and the same
    verify batch (B 4, S_q 5, q_lens mixed), within the reference phase's
    5 % of the logit range; then the card's greedy speculative streams
    against its plain greedy streams, each first divergence reported and
    held to a near-tie of the plain logits (top two within
    SPEC_TIE_BOUND)."""
    import numpy as np

    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    from megatronapp_tpu_torch.inference.engine import SamplingParams
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    counters = _spec_counters()
    before = {f: dict(c) for f, c in counters.items()}
    rng = np.random.default_rng(55)
    prompts = [np.tile(rng.integers(0, 511, 8), 4).astype(np.int32),
               rng.integers(0, 511, 40).astype(np.int32),
               np.tile(rng.integers(0, 511, 5), 6).astype(np.int32),
               rng.integers(0, 511, 17).astype(np.int32)]
    b, s = 4, SPEC_K + 1
    v_tokens = rng.integers(0, 511, (b, s)).astype(np.int32)
    q_lens = np.asarray([1, 5, 3, 5], np.int32)
    greedy = SamplingParams(greedy=True)
    runs = {}

    def engine(p, cfg, d, kind, fused, method=None):
        return DynamicInferenceEngine(
            p, cfg, max_batch=b, max_seq_len=128, block_size=16,
            prefill_chunk=32, device=d, kv_cache_dtype=kind,
            fused_decode=fused, spec_method=method, spec_k=SPEC_K)

    for mname, cfg_ref, cfg_dev, p_ref, p_dev in _spec_reference_models(dev):
        for kind in ("bf16", "int8"):
            for fused in (False, True):
                name = f"{mname}_{kind}_{'fused' if fused else 'unfused'}"
                logits = {}
                for side, p, cfg, d in (("ref", p_ref, cfg_ref, "cpu"),
                                        ("dev", p_dev, cfg_dev, dev)):
                    eng = engine(p, cfg, d, kind, fused, "ngram")
                    check(eng.megakernel is fused,
                          f"spec_reference {name}: megakernel")
                    for pr in prompts:
                        eng.add_request(pr, 16, greedy)
                    eng._admit()
                    for slot in range(b):
                        n = int(eng.lengths[slot])
                        check(eng.pool.extend_capacity(slot, n, s) == s,
                              f"spec_reference {name}: no verify blocks")
                    logits[side] = eng._verify_step(
                        v_tokens, q_lens, np.ones(b, bool)).float().cpu()
                    del eng
                real = (np.arange(s)[None, :] < q_lens[:, None])
                ref, got = logits["ref"][real], logits["dev"][real]
                check(bool(torch.isfinite(got).all()),
                      f"spec_reference {name}: non-finite verify logits")
                rel = float((got - ref).abs().max() / ref.abs().max())
                agree = float((got.argmax(-1) == ref.argmax(-1))
                              .float().mean())
                check(rel < 0.05, f"spec_reference {name}: verify-step "
                      f"logit error {rel} of the range >= 0.05")
                # The card's speculative greedy streams against its plain
                # greedy streams.
                streams = {}
                for method in (None, "ngram"):
                    eng = engine(p_dev, cfg_dev, dev, kind, fused, method)
                    ids = [eng.add_request(pr, 16, greedy) for pr in prompts]
                    res = eng.run_to_completion()
                    eng.pool.audit()
                    check(eng.pool.blocks_in_use() == 0,
                          f"spec_reference {name}: blocks left in use")
                    streams[method] = [res[r][len(pr):]
                                       for r, pr in zip(ids, prompts)]
                    if method:
                        spec = dict(eng.spec_stats)
                    del eng
                div = _first_divergence(streams["ngram"], streams[None])
                gaps = []
                for i, j in enumerate(div):
                    if j is None:
                        continue
                    seq = np.concatenate([prompts[i], streams[None][i][:j]])
                    last = _chunked_prefill(p_dev, cfg_dev, seq.tolist(), dev,
                                            fused, kv_cache_dtype=kind)[-1]
                    top2 = last.topk(2).values
                    gap = float(top2[0] - top2[1])
                    gaps.append(gap)
                    check(gap <= SPEC_TIE_BOUND,
                          f"spec_reference {name}: request {i} leaves the "
                          f"plain stream at token {j}, where the plain "
                          f"logits' top two are {gap} apart (> "
                          f"{SPEC_TIE_BOUND})")
                check(spec["rounds"] > 0 and spec["proposed"] > 0,
                      f"spec_reference {name}: nothing was proposed")
                runs[name] = {"verify_max_rel_err": rel,
                              "verify_argmax_agreement": agree,
                              "first_divergence": div,
                              "top2_gap_at_divergence": gaps,
                              "rounds": spec["rounds"],
                              "proposed": spec["proposed"],
                              "accepted": spec["accepted"]}
    for f, c in counters.items():
        c.update(before[f])
    seconds = time.perf_counter() - t_phase
    state["spec_reference_s"] = seconds
    emit({"phase": "spec_reference", "spec_k": SPEC_K,
          "tie_bound": SPEC_TIE_BOUND, "runs": runs, "seconds": seconds})


def phase_serve_spec(state, layers: int):
    """Speculative decoding on the served model (serve.py --spec-method
    ngram|draft --spec-k 4, with and without --megakernel-decode): serve's
    seed-0 llama3-8b at full width behind the driver, on the serve phase's
    engine settings (max_batch 8, max_seq_len 2048, block 16, chunk 32),
    8 greedy requests (_spec_prompts, built for each model: six of
    serve's and two that hold their own continuation), 32 new tokens
    each:
    (a) plain, then n-gram unfused and fused, all `layers` layers;
    (b) the draft model: llama3_8b(num_layers=2) with seed-1 weights at
        full depth, unfused; and a self-draft at 4 layers (the draft's
        params are the target's own), every rejection at a near-tie of
        the target's logits, at least 0.9 of the drafts accepted with
        those rejections counted as accepted, the plain acceptance beside
        0.9;
    (c) 4 layers: n-gram on int8 (fused) and fp8 pools, fused with
        serve_lora's adapters (cut to the served depth) on LORA_ROUTE, and
        fused on serve_quant's resident int8 weights;
    (d) the MLA llama3-8b (seed 0) at 4 layers with n-gram: unfused at k 4,
        fused at k 3 (B 8 x 4 = 32 rows, the prologue's limit), on int8
        (fused) and fp8 latent pools at k 3; fused at k 4 (40 rows) falls
        back to the unfused step, as the predicate says.
    Every run: its launches a layer, the pool's audit with every block
    back; a spec-verify drill on the 4-layer n-gram engine (the same
    streams and drafts as without the fault). Each run's
    rounds, drafts proposed and accepted, tokens per model step, the first
    divergence from the plain streams of its model and depth (reported
    only), and the median decode interval beside plain's (host clock)."""
    import numpy as np

    from megatronapp_tpu_torch import serve
    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    from megatronapp_tpu_torch.inference.lora import (
        AdapterCache, AdapterRegistry,
    )
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    t_phase = time.perf_counter()
    params, cfg, dev = state["model"]
    check(cfg.num_layers == layers, "serve_spec: the served depth")
    # serve.py's flags, as a user passes them.
    args = serve.parse_args(["--preset", "llama3-8b", "--engine", "dynamic",
                             "--paged-kv-cache", "--spec-method", "ngram",
                             "--spec-k", str(SPEC_K)])
    check((args.spec_method, args.spec_k) == ("ngram", SPEC_K),
          "serve_spec: serve.py's flags")
    runs, plain, prompts = {}, {}, {}

    def run(key, p, c, method=None, **kw):
        model = (c.num_layers, c.multi_latent_attention)
        if model not in prompts:
            prompts[model] = _spec_prompts(p, c, dev)
        out, streams = _spec_run(f"serve_spec {key}", p, c, dev,
                                 prompts[model], method=method, **kw)
        ref = plain.get(model)
        if method is None and ref is None:
            plain[model] = streams
            ref = streams
        if "drill_faults" not in out:
            out["first_divergence_from_plain"] = _first_divergence(streams,
                                                                   ref)
        runs[key] = out
        return out

    # (a) the served depth.
    run("plain", params, cfg)
    run("ngram", params, cfg, args.spec_method, k=args.spec_k)
    run("ngram_fused", params, cfg, "ngram", fused=True)
    # (b) the draft model, full depth; a self-draft at 4 layers.
    dcfg = llama3_8b(num_layers=2, params_dtype=torch.bfloat16)
    dparams = init_gpt_params(dcfg, torch.Generator(dev).manual_seed(1), dev)
    run("draft", params, cfg, "draft", draft=(dparams, dcfg))
    del dparams
    shallow = _layer_view(params, SPEC_SHALLOW_LAYERS)
    scfg = llama3_8b(num_layers=SPEC_SHALLOW_LAYERS,
                     params_dtype=torch.bfloat16)
    run("plain_4_layers", shallow, scfg)
    # The self-draft: the draft's dense plain-PyTorch steps against the
    # target's kernels on the same weights. Their bf16 logits differ by
    # an ulp or two, and a random model's top two logits lie that close
    # (or tie) at ~1 position in 20 (128256 tokens), so the drafts are
    # rejected there, and the drafts after a rejection in its round are
    # lost with it; a fault of the draft machinery (positions, catch-up,
    # stale KV) would reject drafts at clear margins. So every rejection
    # must lie at a near-tie (SPEC_TIE_BOUND), and the acceptance that
    # counts each near-tie rejection as an acceptance (the drafts after
    # it stay lost) must reach 0.9; the plain acceptance is reported
    # beside 0.9.
    with _rejection_gaps() as gaps:
        self_draft = run("self_draft_4_layers", shallow, scfg, "draft",
                         draft=(shallow, scfg), gaps=gaps)
    near = sum(g <= SPEC_TIE_BOUND for g in gaps)
    net = ((self_draft["accepted"] + near) / self_draft["proposed"]
           if self_draft["proposed"] else 0.0)
    self_draft.update(rejections=len(gaps), near_tie_rejections=near,
                      rejection_logit_gaps=sorted(gaps),
                      acceptance_near_ties_accepted=net,
                      acceptance_at_least_0_9=self_draft["acceptance"] >= 0.9)
    check(self_draft["proposed"] > 0 and near == len(gaps),
          f"serve_spec: the self-draft's drafts were rejected where the "
          f"target's argmax led them by {max(gaps, default=0.0)} (> "
          f"{SPEC_TIE_BOUND}): rejection logit gaps {sorted(gaps)}")
    check(net >= 0.9, f"serve_spec: the self-draft accepted {net} of its "
          "drafts with each near-tie rejection counted as accepted (< 0.9)")
    # (c) 4 layers: quantized pools, LoRA, and the spec-verify drill.
    run("ngram_int8_fused_4_layers", shallow, scfg, "ngram", kind="int8",
        fused=True)
    run("ngram_fp8_4_layers", shallow, scfg, "ngram", kind="fp8")
    reg = AdapterRegistry()
    for aid in state["lora_registry"].ids():
        ad = state["lora_registry"].get(aid)
        reg.register(type(ad)(aid, ad.rank, {
            t: v[:SPEC_SHALLOW_LAYERS] for t, v in ad.a.items()}, {
            t: v[:SPEC_SHALLOW_LAYERS] for t, v in ad.b.items()}))
    cache = AdapterCache(scfg, reg, max_resident=4, rank=LORA_RANK,
                         device=dev)
    run("ngram_lora_fused_4_layers", shallow, scfg, "ngram", fused=True,
        cache=cache, routes=LORA_ROUTE)
    del cache
    run("ngram_drill_4_layers", shallow, scfg, "ngram", drill=True)
    if "qmodel" in state:     # serve_quant's resident int8 weights
        run("ngram_int8_weights_fused_4_layers",
            _layer_view(state["qmodel"][0], SPEC_SHALLOW_LAYERS), scfg,
            "ngram", fused=True)
    # (d) MLA at 4 layers.
    mcfg = mla_cfg(num_layers=SPEC_SHALLOW_LAYERS)
    mparams = init_gpt_params(mcfg, torch.Generator(dev).manual_seed(0), dev)
    run("mla_plain_4_layers", mparams, mcfg)
    run("mla_ngram_4_layers", mparams, mcfg, "ngram")
    run("mla_ngram_fused_k3_4_layers", mparams, mcfg, "ngram",
        k=SPEC_MLA_FUSED_K, fused=True)
    run("mla_ngram_int8_fused_k3_4_layers", mparams, mcfg, "ngram",
        k=SPEC_MLA_FUSED_K, kind="int8", fused=True)
    run("mla_ngram_fp8_k3_4_layers", mparams, mcfg, "ngram",
        k=SPEC_MLA_FUSED_K, kind="fp8")
    over = DynamicInferenceEngine(mparams, mcfg, max_batch=8,
                                  max_seq_len=2048, device=dev,
                                  spec_method="ngram", spec_k=SPEC_K,
                                  fused_decode=True)
    fallback = {"mq_rows": over.mq_rows, "megakernel": over.megakernel}
    check(over.mq_rows == 8 * (SPEC_K + 1) and not over.megakernel,
          f"serve_spec: the fused MLA engine at k {SPEC_K} kept "
          f"megakernel={over.megakernel} at {over.mq_rows} rows")
    del over, mparams, shallow
    torch.cuda.empty_cache()
    # The verify rows' launches on the speculative path (kernel_table).
    state["spec_launches"] = {
        "verify": runs["ngram"]["rounds"] * layers,
        "verify_int8": runs["ngram_int8_fused_4_layers"]["rounds"]
        * SPEC_SHALLOW_LAYERS,
        "verify_fp8": runs["ngram_fp8_4_layers"]["rounds"]
        * SPEC_SHALLOW_LAYERS,
        "latent_verify_sq5": runs["mla_ngram_4_layers"]["rounds"]
        * SPEC_SHALLOW_LAYERS,
        "latent_verify": runs["mla_ngram_fused_k3_4_layers"]["rounds"]
        * SPEC_SHALLOW_LAYERS,
        "latent_verify_int8": runs["mla_ngram_int8_fused_k3_4_layers"][
            "rounds"] * SPEC_SHALLOW_LAYERS,
        "latent_verify_fp8": runs["mla_ngram_fp8_k3_4_layers"]["rounds"]
        * SPEC_SHALLOW_LAYERS,
        "fused_verify": runs["ngram_fused"]["rounds"] * layers,
        "fused_int8_verify": runs.get(
            "ngram_int8_weights_fused_4_layers", {}).get("rounds", 0)
        * SPEC_SHALLOW_LAYERS}
    seconds = time.perf_counter() - t_phase
    state["serve_spec_s"] = seconds
    emit({"phase": "serve_spec", "model": "llama3-8b", "layers": layers,
          "spec_k": SPEC_K, "mla_fused_k": SPEC_MLA_FUSED_K,
          "requests": 8,
          "prompt_lens": [len(p) for p in prompts[(layers, False)]],
          "max_new_tokens": 32, "runs": runs,
          "mla_fused_k4_fallback": fallback,
          "note": "decode_interval_ms_median: host clock, median over the "
                  "requests of (last token - first token) / (tokens - 1); "
                  "first_divergence_from_plain: the first generated index "
                  "where a run leaves the plain run of its model and depth "
                  "(reported only; bf16 kernels)",
          "seconds": seconds})


def _serve_mla_run(params, cfg, dev, kind, fused):
    """The serve phases' 8 requests through one MLA engine on `kind` latent
    pools, fused or not, driven as a server drives it, twice; checks the
    streams and that every layer of every decode step and prefill chunk
    launched the latent kernel once (and, fused, the prologue's two
    kernels and the out-projection and MLP kernels once each) and nothing
    else."""
    import numpy as np

    from megatronapp_tpu_torch.inference.engine import SamplingParams
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    name = f"serve_mla {kind} {'fused' if fused else 'unfused'}"
    layers = cfg.num_layers
    engine = _engine(params, cfg, dev, fused=fused, kv_cache_dtype=kind)
    check(engine.megakernel is fused, f"{name}: the engine's step kind")
    driver = _driver(engine)
    greedy = SamplingParams(greedy=True)
    max_new = 32
    prompts, warm = _serve_prompts(cfg)
    rid, done = driver.submit(warm, 4, greedy)
    check(done.wait(timeout=600), f"{name}: warm-up did not finish")
    driver.result_tokens(rid)
    hits0 = engine.pool.stats["prefix_hit_tokens"]
    steps0, chunks0 = engine.decode_steps, engine.prefill_chunks
    counters = (pl.launches, fm.launches, fd.launches, pa.launches)
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    torch.cuda.synchronize()
    streams, times, t_start, t_end = _serve_once(driver, prompts, max_new,
                                                 greedy)
    latent, prologue, fused_k, paged = (dict(c) for c in counters)
    steps = engine.decode_steps - steps0
    chunks = engine.prefill_chunks - chunks0
    hits = engine.pool.stats["prefix_hit_tokens"] - hits0
    for p, s in zip(prompts, streams):
        check(s is not None and len(s) == len(p) + max_new
              and np.array_equal(s[:len(p)], p)
              and bool(((s[len(p):] >= 0)
                        & (s[len(p):] < cfg.vocab_size)).all()),
              f"{name}: a stream of the wrong length or vocabulary")
    sfx = "" if kind == "bf16" else f"_{kind}"
    units = layers * (steps + chunks)
    check(latent == only(latent, {f"decode{sfx}": layers * steps,
                                  f"ragged{sfx}": layers * chunks}),
          f"{name}: latent-kernel launches {latent} for {steps} steps and "
          f"{chunks} chunks of {layers} layers")
    check(prologue == dict.fromkeys(prologue, units if fused else 0),
          f"{name}: prologue launches {prologue}, expected "
          f"{units if fused else 0} of each")
    check(fused_k == only(fused_k, dict.fromkeys(
        ("out_proj", "mlp_fc1", "mlp_fc2"), units if fused else 0)),
          f"{name}: fused out-projection/MLP launches {fused_k}")
    check(not any(paged.values()), f"{name}: GQA paged launches {paged}")
    check(hits > 0, f"{name}: the shared prefix never hit")
    wall = t_end - t_start
    rerun, _, _, _ = _serve_once(driver, prompts, max_new, greedy)
    same = all(np.array_equal(a, b) for a, b in zip(streams, rerun))
    check(same, f"{name}: the rerun gave other streams")
    out = {"kv_cache_dtype": kind, "megakernel": engine.megakernel,
           "latent_launches": {k: v for k, v in latent.items() if v},
           "prologue_launches": {k: v for k, v in prologue.items() if v},
           "fused_launches": {k: v for k, v in fused_k.items() if v},
           "decode_steps": steps, "prefill_chunks": chunks,
           "prefix_hit_tokens": int(hits),
           "ttft_ms": [round((t[1] - t[0]) * 1e3, 3) for t in times],
           "decode_ms_per_step_by_request": [
               round((t[-1] - t[1]) * 1e3 / (len(t) - 2), 3) for t in times],
           "tokens_per_s": max_new * len(prompts) / wall, "wall_s": wall,
           "rerun_identical": same,
           "pool_bytes": engine.pool.bytes_total,
           "stats_param_bytes": engine.stats_snapshot()["param_bytes"]}
    return out, latent, prologue, [s[len(p):] for p, s in zip(prompts,
                                                               streams)]


def phase_serve_mla(state):
    """llama3_8b(multi_latent_attention=True) at full width and full depth
    (32 layers; DeepSeek-V2's latent widths on llama3-8b's body), seeded
    bf16 weights, behind the continuous-batching driver: the serve phases'
    8 greedy requests through the unfused engine on a bf16 latent pool,
    the fused engine on bf16 and int8 pools, and the unfused engine on an
    fp8 pool."""
    import numpy as np

    from megatronapp_tpu_torch.inference.quantization import resident_nbytes
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    dev = torch.device("cuda", 0)
    cfg = mla_cfg(num_layers=MLA_LAYERS)
    counters = (pl.launches, fm.launches, fd.launches, pa.launches)
    before = [dict(c) for c in counters]
    t0 = time.perf_counter()
    params = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state["mla_model"] = (params, cfg, dev)
    runs = {}
    for kind, fused in (("bf16", False), ("bf16", True), ("int8", True),
                        ("fp8", False)):
        key = f"{kind}_pools_{'fused' if fused else 'unfused'}"
        runs[key], latent, prologue, streams = _serve_mla_run(
            params, cfg, dev, kind, fused)
        if (kind, fused) == ("bf16", True):
            # How fragile greedy streams of these random weights are: the
            # fused against the unfused engine on one card.
            fused_equal = sum(np.array_equal(a, b) for a, b in zip(
                streams, state["mla_streams"]["bf16"]))
        else:
            state.setdefault("mla_streams", {})[kind] = streams
            state.setdefault("mla_pool_bytes", {})[kind] = \
                runs[key]["pool_bytes"]
        state.setdefault("mla_launches", {}).update(
            {k: v for k, v in latent.items() if v})
        if fused and kind == "bf16":
            state["mla_prologue_launches"] = sum(prologue.values())
        torch.cuda.empty_cache()
    # Last-position logits of the 300-token prompt, fused against unfused,
    # both on the card in bf16 (the serve_fused rule).
    prompt = _serve_prompts(cfg)[0][3].tolist()
    lf = _chunked_prefill(params, cfg, prompt, dev, True)[-1]
    lu = _chunked_prefill(params, cfg, prompt, dev, False)[-1]
    # serve_tp's references: the unfused single-card logits on each pool
    # dtype, and the weights' checksum.
    state["mla_last_logits"] = {"bf16": lu, **{
        kind: _chunked_prefill(params, cfg, prompt, dev, False,
                               kv_cache_dtype=kind)[-1]
        for kind in ("int8", "fp8")}}
    state["mla_checksum"] = _param_checksum(params)
    for c, b in zip(counters, before):
        c.update(b)
    rel = float((lf - lu).abs().max() / lu.abs().max())
    emit({"phase": "serve_mla", "model": "llama3-8b (multi_latent_attention:"
          " kv_lora_rank 512, qk_head_dim 128, qk_pos_emb_head_dim 64, "
          "v_head_dim 128)", "layers": cfg.num_layers,
          "full_depth": cfg.num_layers == 32, "init_s": init_s,
          "param_bytes": resident_nbytes(params),
          "pool_bytes_bf16": runs["bf16_pools_unfused"]["pool_bytes"],
          "pool_bytes_dense_serve_phase": state.get("serve_pool_bytes"),
          "runs": runs,
          "last_logits_fused_vs_unfused_max_rel_err": rel,
          "bf16_streams_fused_equal_unfused": f"{fused_equal} of 8",
          "last_logits_argmax_equal": int(lf.argmax()) == int(lu.argmax()),
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    check(bool(np.isfinite(lf.numpy()).all()), "serve_mla: non-finite "
          "logits")
    # As serve_fused: 32 layers of bf16 roundings taken in other orders.
    check(rel < 0.1, f"serve_mla: fused last-position logits differ from "
          f"the unfused engine's by {rel} of their range (>= 0.1)")


def _latent_bytes_flops(case):
    """Bytes the latent function must move (each valid latent and roped-key
    row read once with its fp32 row scales when quantized, w_v, q read
    once, the output written once, the page table and lengths) and its
    operations in latent space (scores over klat + dpe, P x latent over
    klat, causal pairs as this run's data needs them, and one expansion
    through w_v a row)."""
    klat, dpe = case["lat"].shape[-1], case["pe"].shape[-1]
    nq, dv = case["w_v"].shape[1], case["w_v"].shape[2]
    kv = case["kv_lens"].tolist()
    rows_q = case["q_lat"].numel() // klat
    if "q_lens" not in case:
        pairs = sum(kv)
    else:
        s_q = case["q_lat"].shape[1]
        pairs = 0
        for n, ql in zip(kv, case["q_lens"].tolist()):
            pairs += sum(n - ql + s + 1 for s in range(ql)) + (s_q - ql) * n
    elem = case["lat"].element_size()
    row = (klat + dpe) * elem + (8 if "lat_scales" in case else 0)
    nbytes = (sum(kv) * row + klat * nq * dv * 2 + rows_q * (klat + dpe) * 2
              + rows_q * dv * 2 + case["table"].numel() * 4 + len(kv) * 8)
    flops = 2 * pairs * nq * (2 * klat + dpe) + 2 * rows_q * klat * dv
    return nbytes, flops


def _sdpa_latent_call(case, nxt):
    """The yardstick the port never calls: SDPA of [q_lat | q_pe] against
    [latent | k_pe] gathered (and dequantized to bf16) in advance for every
    page table, the latent as values, then the w_v einsum."""
    import torch.nn.functional as F
    t = case["tables"].long()
    r, b, mb = t.shape
    bs = case["lat"].shape[1]
    n = int(case["kv_lens"].max())

    def gather(pool, scales):
        rows = pool[t].float()
        if scales is not None:
            rows = rows * scales[t][..., None]
        return rows.to(torch.bfloat16).reshape(r, b, mb * bs, -1)[:, :, :n]

    lat = gather(case["lat"], case.get("lat_scales"))
    k = torch.cat([lat, gather(case["pe"], case.get("pe_scales"))],
                  dim=-1)[:, :, None]                    # [R, B, 1, n, 576]
    v = lat[:, :, None].contiguous()                     # [R, B, 1, n, 512]
    q = torch.cat([case["q_lat"], case["q_pe"]], dim=-1)
    if "q_lens" not in case:
        qq, mask = q[:, :, None], None                   # [B, nq, 1, 576]
    else:
        qq = q.transpose(1, 2)                           # [B, nq, S, 576]
        s_q = q.shape[1]
        pos = torch.arange(n, device=q.device)
        start = (case["kv_lens"] - case["q_lens"]).long()
        abs_q = start[:, None] + torch.arange(s_q, device=q.device)
        mask = (pos[None, None, :] <= abs_q[:, :, None])[:, None]
    w_v = case["w_v"]

    def call():
        i = nxt()
        o = F.scaled_dot_product_attention(qq, k[i], v[i], attn_mask=mask,
                                           scale=MLA_SCALE, enable_gqa=True)
        torch.einsum("bhsk,khd->bshd", o, w_v)
    return call


def _time_latent(case):
    """Row 7 and its SDPA yardstick timed in turns (kernel, library,
    library, kernel), queued behind a sleep (device_ms); the plain version
    before and after; the bound; the split plan."""
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    tables = case["tables"]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % tables.shape[0]
        return it["i"]

    def args():
        return (case["q_lat"], case["q_pe"], case["lat"], case["pe"],
                tables[nxt()], case["kv_lens"], case["w_v"])

    def kernel():
        pl.paged_attention_latent(*args(), **_latent_kw(case))

    def plain():
        pl.paged_attention_latent_plain(*args(), **_latent_kw(case))

    lib = _sdpa_latent_call(case, nxt)
    p1 = device_ms(plain, calls=PLAIN_CALLS)
    k1, l1 = device_ms(kernel), device_ms(lib)
    l2, k2 = device_ms(lib), device_ms(kernel)
    p2 = device_ms(plain, calls=PLAIN_CALLS)
    nbytes, flops = _latent_bytes_flops(case)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    ql = case.get("q_lens")
    return {"kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
            "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
            "library_ms": (l1 + l2) / 2, "library_ms_runs": [l1, l2],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "shape": {"batch": case["q_lat"].shape[0],
                      "kv_len": int(case["kv_lens"][0]),
                      "s_q": 1 if ql is None else case["q_lat"].shape[1],
                      "nq": 32, "klat": 512, "dpe": 64, "dv": 128,
                      "block_size": 16},
            "page_tables_rotated": tables.shape[0], "kernels_per_call": 2,
            "split_plan": pl.latent_split_plan(
                case["q_lat"].shape[0], case["q_lat"][0].numel() // 512,
                tables.shape[-1] * 16, 512,
                kbuild.sm_count(tables.device))._asdict()}


def _mla_latent_times(state):
    """Row 7 at the shapes serve_mla launches it: decode with B 8 at kv
    1024 and the ragged chunk B 1, S_q 32 at kv 1024, and serve_spec's
    fused MLA verify step (B 8, S_q 4 at kv 1024), on bf16, int8 and fp8
    pools, page tables rotated beyond the L2 cache."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(707)
    out = {}
    for kind in ("bf16", "int8", "fp8"):
        for mode, (batch, s_q) in (("decode", (8, None)),
                                   ("ragged", (1, 32)), ("verify", (8, 4))):
            case = make_latent_case(
                gen, dev, batch=batch, kv_lens=[1024] * batch, s_q=s_q,
                q_lens=None if s_q is None else [s_q] * batch, kind=kind,
                pool_bytes=TIMED_POOL_BYTES)
            out[mode + ("" if kind == "bf16" else f"_{kind}")] = \
                _time_latent(case)
            del case
            torch.cuda.empty_cache()
    state["mla_latent_times"] = out
    return {"note": "kernel and library timed in turns, queued behind a "
                    "sleep (device_ms); library_ms: "
                    "scaled_dot_product_attention of [q_lat | "
                    "q_pe] against [latent | k_pe] gathered (dequantized) "
                    "to bf16 in advance, latent as values, then the w_v "
                    "einsum; bounds in latent space", **out}


def _mla_prologue_times(state):
    """Row 11 at 8 (decode) and 32 (chunk) rows, rotating through
    serve_mla's 32 layers so that every launch finds its ~59 MB of weights
    cold; beside it the plain version, the bound and, as the yardstick the
    port never calls, the GEMM alone (x @ [q_proj | kv_down], the
    weights concatenated in advance for 4 layers)."""
    from megatronapp_tpu_torch.models.gpt import gpt_rope_tables
    from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
    params, cfg, dev = state["mla_model"]
    layers = list(params["layers"])
    before = dict(fm.launches)
    gen = torch.Generator(dev).manual_seed(808)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(layers)
        return layers[it["i"]]

    h, nq = cfg.hidden_size, cfg.num_attention_heads
    dqk, dpe, dv, klat = (cfg.qk_head_dim, cfg.qk_pos_emb_head_dim,
                          cfg.v_head_dim, cfg.kv_lora_rank)
    cat = [torch.cat([p["attention"]["q_proj"], p["attention"]["kv_down"]],
                     dim=1) for p in layers[:4]]
    out = {}
    for rows in (8, 32):
        x = torch.randn(rows, h, generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.randint(0, 2048, (rows,), generator=gen, device=dev)
        cos_t, sin_t = gpt_rope_tables(cfg, 2048, device=dev)
        cos, sin = cos_t[pos].contiguous(), sin_t[pos].contiguous()

        def kern():
            fm.fused_mla_qkv(x, nxt(), cfg, cos, sin)

        def plain():
            fm.fused_mla_qkv_plain(x, nxt(), cfg, cos, sin)

        def lib():
            nxt()
            torch.matmul(x, cat[it["i"] % 4])
        p1 = device_ms(plain, calls=PLAIN_CALLS)
        k1 = device_ms(kern)
        k2 = device_ms(kern)
        p2 = device_ms(plain, calls=PLAIN_CALLS)
        lib_ms = device_ms(lib)
        weights = h * (nq * (dqk + dpe) + klat + dpe) + klat * nq * dqk
        nbytes = (2 * (weights + 2 * h + klat) + rows * h * 2
                  + rows * (nq * (klat + dpe) + klat + dpe) * 2
                  + 2 * rows * (dpe // 2) * 4)
        flops = 2 * rows * (h * (nq * (dqk + dpe) + klat + dpe)
                            + nq * dqk * klat)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        out[rows] = {"kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                     "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                     "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "flops": flops,
                     "achieved_bytes_per_s": nbytes / ((k1 + k2) / 2e3)}
    del cat
    fm.launches.update(before)
    state["mla_prologue_times"] = out
    return {"note": "device_ms of the two launches together (mla_down + "
                    "mla_up); library_ms: one torch.matmul of x by [q_proj "
                    "| kv_down] (the GEMM alone)", "rows": out}


# ---------------------------------------------------------------------------
# tensor-parallel serving (rows 8 and 9)
# ---------------------------------------------------------------------------


def _rel_to_row(got, ref):
    """max |got - ref| over max(|ref element|, its row's RMS), and the max
    absolute error."""
    err = (got - ref).abs()
    rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return float(err.max()), float((err / torch.maximum(ref.abs(),
                                                        rms)).max())


def _tp_shard_inputs(case, rank=0, tp=2):
    """Rank `rank`'s latent columns of a make_latent_case: the scaled fp32
    query rows [B, rows, klat/tp] and the roped ones [B, rows, dpe], its
    column view of the latent pool and its w_v rows (views, no copies)."""
    klat = case["lat"].shape[-1]
    cols = slice(rank * klat // tp, (rank + 1) * klat // tp)
    b = case["q_lat"].shape[0]
    q = (case["q_lat"][..., cols].float() * MLA_SCALE).reshape(
        b, -1, cols.stop - cols.start).contiguous()
    qp = (case["q_pe"].float() * MLA_SCALE).reshape(b, q.shape[1],
                                                    -1).contiguous()
    return q, qp, case["lat"][..., cols], case["w_v"][cols]


def _tp_probs(case, q, shard):
    """Masked fp32 probabilities over the table (the tp body's softmax of
    one shard's scores: the inputs of row 9)."""
    from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
    s = lt.latent_block_scores_plain(q, shard, case["table"], case["kv_lens"],
                                     case.get("lat_scales"))
    t = s.shape[-1]
    pos = torch.arange(t, device=s.device)
    valid = pos[None, None, :] < case["kv_lens"].long()[:, None, None]
    s = s.masked_fill(~valid, -1e30)
    return torch.softmax(s, dim=-1).masked_fill(~valid, 0.0).contiguous()


def _compare_tp_case(case, name, kind):
    """Rows 8 and 9 (twice each: one launch a call, the same bits) against
    their plain versions on rank 0's latent columns and on the pe pool;
    then both shards composed (paged_attention_latent_shards) against row
    7's single-device kernel on the same full pools. Returns {what: (max
    abs error, max relative error)}."""
    from megatronapp_tpu_torch.ops import paged_attention as tpa
    from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    sfx = "" if kind == "bf16" else f"_{kind}"
    q, qp, shard, w_v = _tp_shard_inputs(case)
    table, lens = case["table"], case["kv_lens"]
    ls, ps = case.get("lat_scales"), case.get("pe_scales")
    out = {}
    for what, qq, pages, sc in (("scores", q, shard, ls),
                                ("scores_pe", qp, case["pe"], ps)):
        before = lt.launches["scores" + sfx]
        got = lt.latent_block_scores(qq, pages, table, lens, sc)
        again = lt.latent_block_scores(qq, pages, table, lens, sc)
        torch.cuda.synchronize()
        check(lt.launches["scores" + sfx] == before + 2,
              f"tp_kernels {name}: scores{sfx} launched "
              f"{lt.launches['scores' + sfx] - before} times for two calls")
        check(torch.equal(got, again), f"tp_kernels {name}: {what}'s rerun "
              "gave other bits")
        ref = lt.latent_block_scores_plain(qq, pages, table, lens, sc)
        past = (torch.arange(got.shape[-1], device=got.device) // 16 * 16
                )[None, :] >= lens.long()[:, None]
        check(not bool(got.masked_select(past[:, None, :]).any()),
              f"tp_kernels {name}: {what} past kv_len is not 0")
        out[what] = (float((got - ref).abs().max()),
                     float((got - ref).abs().max() / ref.abs().max()))
        check(out[what][1] <= TP_PHASE_TOL, f"tp_kernels {name}: {what} "
              f"error {out[what][1]} of max |element| exceeds "
              f"{TP_PHASE_TOL}")
    p = _tp_probs(case, q, shard)
    before = lt.launches["wsum" + sfx]
    got = lt.latent_block_wsum(p, shard, table, lens, w_v, ls)
    again = lt.latent_block_wsum(p, shard, table, lens, w_v, ls)
    torch.cuda.synchronize()
    check(lt.launches["wsum" + sfx] == before + 2,
          f"tp_kernels {name}: wsum{sfx} launched "
          f"{lt.launches['wsum' + sfx] - before} times for two calls")
    check(torch.equal(got, again), f"tp_kernels {name}: wsum's rerun gave "
          "other bits")
    ref = lt.latent_block_wsum_plain(p, shard, table, lens, w_v, ls)
    out["wsum"] = (float((got - ref).abs().max()),
                   float((got - ref).abs().max() / ref.abs().max()))
    check(out["wsum"][1] <= TP_PHASE_TOL, f"tp_kernels {name}: wsum error "
          f"{out['wsum'][1]} of max |element| exceeds {TP_PHASE_TOL}")
    # The composition: both column shards in turn, partials summed.
    tp_out = tpa.paged_attention_latent_shards(
        case["q_lat"], case["q_pe"], case["lat"], case["pe"], table, lens,
        case["w_v"], 2, **_latent_kw(case)).float()
    row7 = pl.paged_attention_latent(
        case["q_lat"], case["q_pe"], case["lat"], case["pe"], table, lens,
        case["w_v"], **_latent_kw(case)).float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(tp_out).all()), f"tp_kernels {name}: "
          "non-finite composition")
    ql = case.get("q_lens")
    if ql is not None:
        real = (torch.arange(tp_out.shape[1], device=tp_out.device)[None, :]
                < ql[:, None].long())
        tp_out, row7 = tp_out[real], row7[real]
    out["composition_vs_row7"] = _rel_to_row(tp_out, row7)
    check(out["composition_vs_row7"][1] <= MLA_TOL,
          f"tp_kernels {name}: the two-shard composition differs from row "
          f"7 by {out['composition_vs_row7'][1]} of max(|element|, row "
          f"RMS) (> {MLA_TOL})")
    return out


def phase_tp_kernels(state):
    """Rows 8 and 9 against their plain versions at MLA's full widths
    (klat 512 cut into two 256-column shards, dpe 64, nq 32, dv 128, block
    16, MB·bs 2048): decode at B 8 with kv up to 1024 and the ragged
    chunks of phase mla_kernels, on bf16, int8 and fp8 pools; row 8 also
    on the pe pool (d 64); then the two shards composed (row 8 on each
    shard summed, plus row 8 on the pe pool, mask, fp32 softmax, row 9 on
    each shard summed) against row 7's single-device kernel on the same
    full pools (gate: row 7's, MLA_TOL)."""
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(707)
    before = dict(lt.launches), dict(pl.launches)
    lens = [1, 15, 16, 17, 300, 1000, 1024, 640]
    # The weighted sum's split length at decode and at a chunk on these
    # 2048-position tables: lengths one token into a split, on a split's
    # edge, and kv 1 beside full slots (most splits empty).
    sms = kbuild.sm_count(dev)
    st_d = lt.wsum_split_plan(8, 32, 2048, 256, sms).split_tokens
    st_c = lt.wsum_split_plan(1, 32 * 32, 2048, 256, sms).split_tokens
    shapes = {"decode_b8": dict(batch=8, kv_lens=lens),
              "ragged_b1": dict(batch=1, kv_lens=[1000], s_q=32,
                                q_lens=[24]),
              "ragged_b1_full": dict(batch=1, kv_lens=[1024], s_q=32,
                                     q_lens=[32]),
              "ragged_b3_tail": dict(batch=3, kv_lens=[5, 40, 700], s_q=32,
                                     q_lens=[5, 32, 1]),
              "decode_b8_split_edges": dict(
                  batch=8, kv_lens=[st_d + 1, st_d, 2 * st_d, 2 * st_d - 1,
                                    3 * st_d + 1, 4 * st_d, 2048, 16]),
              "decode_b8_kv1_beside_full": dict(
                  batch=8, kv_lens=[1, 1024, 1, 1, 1024, 1, 2048, 1]),
              "ragged_b1_split_edge": dict(batch=1, kv_lens=[st_c + 1],
                                           s_q=32, q_lens=[32]),
              "ragged_b2_on_split_edge": dict(batch=2,
                                              kv_lens=[2 * st_c, st_c],
                                              s_q=32, q_lens=[32, 7]),
              "ragged_b2_rows96": dict(batch=2, kv_lens=[40, 700], s_q=3,
                                       q_lens=[3, 2])}
    res = {}
    for name, kw in shapes.items():
        for kind in ("bf16", "int8", "fp8"):
            # A max_seq_len 2048 table (MB 128) as the engine's: blocks
            # past every kv_len stay in it.
            case = make_latent_case(gen, dev, kind=kind, mb=128, **kw)
            res[f"{name}_{kind}"] = _compare_tp_case(case, name, kind)
            del case
    torch.cuda.empty_cache()
    lt.launches.update(before[0])        # not main-path launches
    pl.launches.update(before[1])
    err = {}
    for kernel, whats in (("scores", ("scores", "scores_pe")),
                          ("wsum", ("wsum",))):
        for mode in ("decode", "ragged"):
            for kind in ("bf16", "int8", "fp8"):
                key = f"{kernel}_{mode}{'' if kind == 'bf16' else '_' + kind}"
                err[key] = max(v[w][0] for k, v in res.items()
                               if k.startswith(mode) and k.endswith(kind)
                               for w in whats)
    state["tp_err"] = err
    emit({"phase": "tp_kernels", "phase_tol": TP_PHASE_TOL,
          "composition_tol": MLA_TOL,
          "split_tokens": {"decode_table2048": st_d, "chunk_table2048": st_c},
          "errors": "(max abs, max abs over max |plain element|; "
                    "composition: over max(|row 7 element|, row RMS))",
          "cases": res})


def _param_checksum(params) -> float:
    """A float64 sum over every leaf of the params (on their device)."""
    return float(sum(t.sum(dtype=torch.float64) for t in params.parameters()))


def _tp_rank(rank, init_method, plan, out_q):
    """One rank of serve_tp (a spawned process on cuda:0): reports its
    results, or its traceback."""
    try:
        rep = _tp_rank_run(rank, init_method, plan)
    except Exception as e:  # noqa: BLE001 — reported to the parent
        import traceback
        rep = {"error": f"{e!r}\n{traceback.format_exc()[-4000:]}"}
    out_q.put((rank, rep))


def _tp_rank_run(rank, init_method, plan):
    import gc

    import numpy as np
    import torch.distributed as dist

    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.inference.engine import SamplingParams
    from megatronapp_tpu_torch.inference.server import DynamicBatchingDriver
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    from megatronapp_tpu_torch.parallel import collectives
    from megatronapp_tpu_torch.parallel.mesh import build_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ctx = build_mesh(ParallelConfig(tensor_parallel=2), rank=rank,
                     init_method=init_method, device=dev,
                     timeout_s=TP_TIMEOUT_S)
    counters = (lt.launches, pl.launches, pa.launches, collectives.calls)
    out = {"device": str(ctx.device), "backend": ctx.backend}
    greedy = SamplingParams(greedy=True)
    for case in plan:
        cfg = (mla_cfg(num_layers=case["layers"]) if case["model"] == "mla"
               else llama3_8b(num_layers=case["layers"],
                              params_dtype=torch.bfloat16))
        t0 = time.perf_counter()
        params = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        mine = _param_checksum(params)
        total = torch.tensor([mine], dtype=torch.float64, device=dev)
        dist.all_reduce(total)
        engine = _engine(params, cfg, dev, kv_cache_dtype=case["kind"],
                         ctx=ctx)
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        rep = {"init_s": init_s, "checksum": mine,
               "checksum_sum": float(total), "tp_paged": engine.tp_paged,
               "megakernel": engine.megakernel,
               "pool_bytes": engine.pool.bytes_total}
        prompts, warm = _serve_prompts(cfg)
        t_start = time.perf_counter()
        if ctx.is_lead:
            driver = DynamicBatchingDriver(engine)
            rid, done = driver.submit(warm, 4, greedy)
            check(done.wait(timeout=900), "serve_tp: warm-up did not finish")
            warm_stream = driver.result_tokens(rid)
            streams, times, t0, t1 = _serve_once(driver, prompts, 32, greedy)
            driver.close()
            del driver
            engine.release_followers()
            rep.update(
                streams=[s.tolist() for s in streams],
                all_streams=sorted([s.tolist() for s in streams]
                                   + [warm_stream.tolist()]),
                ttft_ms=[round((t[1] - t[0]) * 1e3, 3) for t in times],
                decode_ms_per_step_by_request=[
                    round((t[-1] - t[1]) * 1e3 / (len(t) - 2), 3)
                    for t in times],
                tokens_per_s=32 * len(prompts) / (t1 - t0),
                wall_s=t1 - t0)
        else:
            rep["all_streams"] = sorted(v.tolist()
                                        for v in engine.follow().values())
        rep["serve_s"] = time.perf_counter() - t_start
        rep.update(launches={k: v for k, v in lt.launches.items() if v},
                   row7_launches={k: v for k, v in pl.launches.items() if v},
                   row1_launches={k: v for k, v in pa.launches.items() if v},
                   collectives=dict(collectives.calls),
                   decode_steps=engine.decode_steps,
                   prefill_chunks=engine.prefill_chunks,
                   stats_tp=engine.stats_snapshot()["tp"])
        # Last-position logits of the 300-token prompt through the tp
        # step on both ranks (in lockstep: the same chunks).
        logits = _chunked_prefill(params, cfg, prompts[3].tolist(), dev,
                                  False, kv_cache_dtype=case["kind"],
                                  ctx=ctx)[-1]
        rep["last_logits"] = logits.numpy().astype(np.float32)
        rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out[case["name"]] = rep
        # The engine and its params go before the next case's.
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()
        rep["bytes_left"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    ctx.close()
    return out


def _range_rel(got, want) -> float:
    """max |got - want| over the range of want."""
    return float((got - want).abs().max() / (want.max() - want.min()))


def phase_serve_tp(state, layers: int):
    """Tensor-parallel serving on the one card: two ranks, spawned
    processes sharing cuda:0 over a gloo group, after the parent has freed
    its serving tensors. Each rank seeds the full-width weights of serve
    and serve_mla (the same seed on the same card) and checks them by an
    all-reduced checksum against the parent's, then the lead drives the
    serve phases' 8 requests through the driver while the follower steps
    in lockstep: llama3_8b(multi_latent_attention=True) at all 32 layers
    on bf16, int8 and fp8 latent pools (rows 8 and 9), and the dense
    llama3-8b at --layers on a bf16 pool (row 1 on 4 of the 8 kv heads a
    rank). Two ranks time-share one card and gloo stages every collective
    through host memory: the times measure that, not tensor-parallel
    speed."""
    import gc
    import multiprocessing
    import shutil
    import tempfile

    import numpy as np

    for key in ("model", "qmodel", "mla_model", "lora_cache",
                "lora_registry"):
        state.pop(key, None)
    while _DRIVERS:
        _DRIVERS.pop().close()
    gc.collect()
    torch.cuda.empty_cache()
    parent_bytes = torch.cuda.memory_allocated()
    check(parent_bytes < 4 << 30, f"serve_tp: the parent still holds "
          f"{parent_bytes} bytes on the card before spawning the ranks")
    plan = [dict(name=f"mla_{kind}", model="mla", kind=kind,
                 layers=MLA_LAYERS) for kind in ("bf16", "int8", "fp8")]
    plan.append(dict(name="dense_bf16", model="dense", kind="bf16",
                     layers=layers))
    store = os.path.join(tempfile.mkdtemp(prefix="serve_tp_"), "store")
    mp = multiprocessing.get_context("spawn")
    q = mp.Queue()
    procs = [mp.Process(target=_tp_rank, args=(r, f"file://{store}", plan, q))
             for r in range(2)]
    t0 = time.perf_counter()
    for pr in procs:
        pr.start()
    reps = {}
    try:
        for _ in procs:
            rank, rep = q.get(timeout=TP_PHASE_TIMEOUT_S)
            reps[rank] = rep
    except Exception as e:  # noqa: BLE001 — a rank died or hung
        raise SmokeFailure(f"serve_tp: a rank did not report ({e!r}); "
                           f"reports from {sorted(reps)}") from e
    finally:
        for pr in procs:
            pr.join(timeout=120)
            if pr.is_alive():
                pr.kill()
                pr.join(timeout=30)
    wall_s = time.perf_counter() - t0
    shutil.rmtree(os.path.dirname(store), ignore_errors=True)
    for rank, rep in reps.items():
        check("error" not in rep, f"serve_tp: rank {rank} failed: "
              f"{rep.get('error')}")
    r0, r1 = reps[0], reps[1]
    out = {}
    tp_launches = {}
    for case in plan:
        name, kind = case["name"], case["kind"]
        a, b = r0[name], r1[name]
        mla = case["model"] == "mla"
        cfg_layers = case["layers"]
        checksum = state["mla_checksum" if mla else "serve_checksum"]
        for rank, rep in ((0, a), (1, b)):
            check(rep["checksum"] == checksum
                  and rep["checksum_sum"] == 2 * checksum,
                  f"serve_tp {name}: rank {rank}'s weights (checksum "
                  f"{rep['checksum']}, all-reduced {rep['checksum_sum']}) "
                  f"are not the parent's ({checksum})")
            check(rep["tp_paged"] and not rep["megakernel"],
                  f"serve_tp {name}: rank {rank} tp_paged "
                  f"{rep['tp_paged']}, megakernel {rep['megakernel']}")
        check(a["all_streams"] == b["all_streams"],
              f"serve_tp {name}: rank 1's streams differ from rank 0's")
        vocab = mla_cfg().vocab_size
        prompts = _serve_prompts(mla_cfg())[0]
        gen = [np.asarray(s[len(p):]) for p, s in zip(prompts, a["streams"])]
        for p, s in zip(prompts, a["streams"]):
            check(len(s) == len(p) + 32 and s[:len(p)] == p.tolist()
                  and all(0 <= t < vocab for t in s[len(p):]),
                  f"serve_tp {name}: a stream of the wrong length or "
                  "vocabulary")
        units = a["decode_steps"] + a["prefill_chunks"]
        sfx = "" if kind == "bf16" else f"_{kind}"
        for rank, rep in ((0, a), (1, b)):
            units_r = rep["decode_steps"] + rep["prefill_chunks"]
            check(units_r == units, f"serve_tp {name}: rank {rank} ran "
                  f"{units_r} steps and chunks, rank 0 {units}")
            if mla:
                want = {f"scores{sfx}": 2 * cfg_layers * units,
                        f"wsum{sfx}": cfg_layers * units}
                check(rep["launches"] == want and not rep["row7_launches"]
                      and not rep["row1_launches"],
                      f"serve_tp {name}: rank {rank} launched rows 8/9 "
                      f"{rep['launches']}, row 7 {rep['row7_launches']}, "
                      f"row 1 {rep['row1_launches']}; expected {want} for "
                      f"{units} steps and chunks of {cfg_layers} layers")
                check(rep["collectives"]["all_reduce"] == 2 * cfg_layers
                      * units and rep["collectives"]["all_gather"] == 0,
                      f"serve_tp {name}: rank {rank} collectives "
                      f"{rep['collectives']}")
            else:
                want = {"decode": cfg_layers * rep["decode_steps"],
                        "ragged": cfg_layers * rep["prefill_chunks"]}
                check(rep["row1_launches"] == want and not rep["launches"]
                      and not rep["row7_launches"],
                      f"serve_tp {name}: rank {rank} launched row 1 "
                      f"{rep['row1_launches']} (expected {want}), rows "
                      f"8/9 {rep['launches']}, row 7 {rep['row7_launches']}")
                check(rep["collectives"]["all_gather"] == cfg_layers * units
                      and rep["collectives"]["all_reduce"] == 0,
                      f"serve_tp {name}: rank {rank} collectives "
                      f"{rep['collectives']}")
        if mla:
            for k, v in a["launches"].items():
                tp_launches[k] = tp_launches.get(k, 0) + v
            # The rank's pool: half the latent columns, the roped-key and
            # scale pools whole.
            whole = state["mla_pool_bytes"][kind]
            mcfg = mla_cfg(num_layers=MLA_LAYERS)
            lat = (MLA_LAYERS * 8 * 2048 * mcfg.kv_lora_rank
                   * (2 if kind == "bf16" else 1))
            check(a["pool_bytes"] == whole - lat // 2,
                  f"serve_tp {name}: rank pool {a['pool_bytes']} bytes, "
                  f"expected {whole - lat // 2} of the whole {whole}")
            ref_logits = state["mla_last_logits"][kind]
            single = state["mla_streams"][kind]
        else:
            whole = state["serve_pool_bytes"]
            check(2 * a["pool_bytes"] == whole,
                  f"serve_tp {name}: rank pool {a['pool_bytes']} bytes, "
                  f"the whole {whole}")
            ref_logits = state["serve_last_logits"]
            single = state["serve_streams"]
        agree = sum(np.array_equal(x, y) for x, y in zip(gen, single))
        # Where each stream first leaves the single-card one (None: never).
        first_diff = [None if np.array_equal(x, y) else
                      int(np.argmax(np.asarray(x) != np.asarray(y)))
                      for x, y in zip(gen, single)]
        rel = _range_rel(torch.from_numpy(a["last_logits"]), ref_logits)
        rel_ranks = float(np.abs(a["last_logits"] - b["last_logits"]).max())
        check(rel_ranks == 0.0, f"serve_tp {name}: the ranks' logits differ "
              f"by {rel_ranks}")
        check(bool(np.isfinite(a["last_logits"]).all()),
              f"serve_tp {name}: non-finite logits")
        check(rel <= TP_LOGIT_TOL, f"serve_tp {name}: last-position logits "
              f"differ from the single-card engine's by {rel} of their "
              f"range (> {TP_LOGIT_TOL})")
        out[name] = {
            "layers": cfg_layers, "kv_cache_dtype": kind,
            "init_s_by_rank": [a["init_s"], b["init_s"]],
            "rank_streams_equal": True,
            "streams_equal_single_card": f"{agree} of {len(gen)}",
            "first_differing_token_by_stream": first_diff,
            "last_logits_argmax_equal": int(np.argmax(a["last_logits"]))
            == int(ref_logits.argmax()),
            "last_logits_vs_single_card_range_rel": rel,
            "decode_steps": a["decode_steps"],
            "prefill_chunks": a["prefill_chunks"],
            "launches_rank0": a["launches"] or a["row1_launches"],
            "launches_per_layer_per_unit": {
                k: v / (cfg_layers * units)
                for k, v in (a["launches"] or a["row1_launches"]).items()},
            "collectives_rank0": a["collectives"],
            "collectives_per_layer_per_unit": {
                k: a["collectives"][k] / (cfg_layers * units)
                for k in ("all_reduce", "all_gather")},
            "pool_bytes_per_rank": a["pool_bytes"],
            "pool_bytes_single_card": whole,
            "ttft_ms": a["ttft_ms"],
            "decode_ms_per_step_by_request": a[
                "decode_ms_per_step_by_request"],
            "tokens_per_s": a["tokens_per_s"], "wall_s": a["wall_s"],
            "serve_s_by_rank": [a["serve_s"], b["serve_s"]],
            "peak_mem_bytes_by_rank": [a["peak_mem_bytes"],
                                       b["peak_mem_bytes"]],
            "bytes_left_after_case_by_rank": [a["bytes_left"],
                                              b["bytes_left"]],
            "stats_tp": a["stats_tp"]}
        if not mla:
            check(agree == len(gen) or rel <= TP_LOGIT_TOL,
                  f"serve_tp {name}: streams differ from serve's")
    state["tp_launches"] = tp_launches
    emit({"phase": "serve_tp", "tp": 2, "backend": r0["backend"],
          "ranks_devices": [r0["device"], r1["device"]],
          "note": "two ranks time-share one card and gloo stages each "
                  "collective through host memory: TTFT and interval are "
                  "not tensor-parallel speed",
          "parent_bytes_at_spawn": parent_bytes, "wall_s": wall_s,
          "logit_tol": TP_LOGIT_TOL, "runs": out})


def _tp_bytes_flops(case, kernel, rows, d, valid):
    """Bytes the phase must move (each input read once: the query rows or
    the probabilities over the valid tokens, the valid page rows with
    their fp32 row scales when quantized, w_v, the table and lengths; the
    output written once) and its operations, for this run's valid tokens
    (every row of each block below kv_len)."""
    b = case["q_lat"].shape[0]
    elem = case["lat"].element_size()
    row = d * elem + (4 if "lat_scales" in case else 0)
    table = case["table"].numel() * 4 + b * 4
    mbbs = case["table"].shape[1] * 16
    if kernel == "scores":
        nbytes = b * rows * d * 4 + valid * row + table + b * rows * mbbs * 4
        flops = 2 * rows * valid * d
    else:
        nq, dv = case["w_v"].shape[1], case["w_v"].shape[2]
        nbytes = (rows * valid * 4 + valid * row + d * nq * dv * 2 + table
                  + b * rows * dv * 4)
        flops = 2 * rows * valid * d + 2 * b * rows * d * dv
    return nbytes, flops


def _tp_time_case(case):
    """Rows 8 and 9 on rank 0's columns and row 8 on the pe pool (page
    tables rotated beyond the L2 cache): each kernel and its library
    yardstick timed in turns (kernel, library, library, kernel; both
    queued behind a sleep, device_ms), the plain versions, the bounds, the
    weighted sum's split plan and the kernels a call launches; then the
    whole two-shard tp body against row 7 at the same shapes. Library
    calls: row 8 one torch.bmm on pages gathered (dequantized) in advance,
    row 9 torch.bmm of the probabilities on them and the w_v einsum."""
    from megatronapp_tpu_torch.ops import paged_attention as tpa
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    tables = case["tables"]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % tables.shape[0]
        return it["i"]
    q, qp, shard, w_v = _tp_shard_inputs(case)
    b, rows, d = q.shape
    lens, ls, ps = case["kv_lens"], case.get("lat_scales"), \
        case.get("pe_scales")
    p = _tp_probs(case, q, shard)
    valid = sum(16 * math.ceil(n / 16) for n in lens.tolist())
    t = tables.long()

    def gathered(pool, scales):
        """Every table's pool rows gathered (dequantized) to bf16 in
        advance, [R, B, T, width]."""
        g = pool[t].float() if scales is None else \
            pool[t].float() * scales[t][..., None]
        return g.to(torch.bfloat16).reshape(t.shape[0], b, -1,
                                            pool.shape[-1])
    g = gathered(shard, ls)
    gt = g.transpose(-1, -2).contiguous()
    gpt = gathered(case["pe"], ps).transpose(-1, -2).contiguous()
    qb, qpb, pb = (q.to(torch.bfloat16), qp.to(torch.bfloat16),
                   p.to(torch.bfloat16))
    nq = w_v.shape[1]
    calls = {
        "scores": (lambda: lt.latent_block_scores(q, shard, tables[nxt()],
                                                  lens, ls),
                   lambda: lt.latent_block_scores_plain(
                       q, shard, tables[nxt()], lens, ls),
                   lambda: torch.bmm(qb, gt[nxt()]), d),
        "scores_pe": (lambda: lt.latent_block_scores(
                          qp, case["pe"], tables[nxt()], lens, ps),
                      lambda: lt.latent_block_scores_plain(
                          qp, case["pe"], tables[nxt()], lens, ps),
                      lambda: torch.bmm(qpb, gpt[nxt()]), qp.shape[-1]),
        "wsum": (lambda: lt.latent_block_wsum(p, shard, tables[nxt()], lens,
                                              w_v, ls),
                 lambda: lt.latent_block_wsum_plain(p, shard, tables[nxt()],
                                                    lens, w_v, ls),
                 lambda: torch.einsum(
                     "bsnk,knd->bsnd",
                     torch.bmm(pb, g[nxt()]).reshape(b, -1, nq, d), w_v), d)}
    out = {}
    for kernel, (kern, plain, lib, width) in calls.items():
        p1 = device_ms(plain, calls=PLAIN_CALLS)
        k1, l1 = device_ms(kern), device_ms(lib)
        l2, k2 = device_ms(lib), device_ms(kern)
        p2 = device_ms(plain, calls=PLAIN_CALLS)
        nbytes, flops = _tp_bytes_flops(case, kernel.split("_")[0], rows,
                                        width, valid)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        out[kernel] = {"kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                       "library_ms": (l1 + l2) / 2,
                       "library_ms_runs": [l1, l2],
                       "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": ("bytes" if t_bytes >= t_ops
                                    else "operations"),
                       "bytes": nbytes, "flops": flops,
                       "kernels_per_call": 2 if kernel == "wsum" else 1}
    plan = lt.wsum_split_plan(b, rows, tables.shape[-1] * 16, d,
                              kbuild.sm_count(q.device))
    out["wsum"]["split_plan"] = plan._asdict()

    def body():
        tpa.paged_attention_latent_shards(
            case["q_lat"], case["q_pe"], case["lat"], case["pe"],
            tables[nxt()], lens, case["w_v"], 2, **_latent_kw(case))

    def row7():
        pl.paged_attention_latent(
            case["q_lat"], case["q_pe"], case["lat"], case["pe"],
            tables[nxt()], lens, case["w_v"], **_latent_kw(case))
    # The body reads kv_lens on the host once a call, so it is timed
    # host-paced (cuda_time_ms), its kernels behind that read.
    r1, b1, b2, r2 = (cuda_time_ms(row7), cuda_time_ms(body),
                      cuda_time_ms(body), cuda_time_ms(row7))
    out["two_shard_body_ms"] = (b1 + b2) / 2
    out["row7_ms"] = (r1 + r2) / 2
    ql = case.get("q_lens")
    out["shape"] = {"batch": b, "kv_len": int(lens[0]),
                    "s_q": 1 if ql is None else case["q_lat"].shape[1],
                    "rows": rows, "latent_columns": d, "dpe": 64,
                    "nq": nq, "dv": w_v.shape[2], "block_size": 16,
                    "table_tokens": case["table"].shape[1] * 16}
    return out


def phase_tp_times(state):
    """Rows 8 and 9 at the shapes serve_tp launches them (one rank's 256
    latent columns): decode with B 8 at kv 1024 and the chunk B 1, S_q 32
    at kv 1024, on bf16, int8 and fp8 pools, max_seq_len 2048 tables."""
    from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(708)
    before = dict(lt.launches), dict(pl.launches)
    torch.cuda.empty_cache()
    out = {}
    for kind in ("bf16", "int8", "fp8"):
        for mode, (batch, s_q) in (("decode", (8, None)),
                                   ("ragged", (1, 32)), ("verify", (8, 4))):
            case = make_latent_case(
                gen, dev, batch=batch, kv_lens=[1024] * batch, s_q=s_q,
                q_lens=None if s_q is None else [s_q] * batch, kind=kind,
                pool_bytes=TIMED_POOL_BYTES)
            out[mode + ("" if kind == "bf16" else f"_{kind}")] = \
                _tp_time_case(case)
            del case
            torch.cuda.empty_cache()
    lt.launches.update(before[0])
    pl.launches.update(before[1])
    state["tp_times"] = out
    emit({"phase": "tp_times", "nvidia_smi": state.get("smi"),
          "note": "one rank's 256 latent columns (scores_pe: row 8 on "
                  "the pe pool, d 64); kernel and library timed in turns, "
                  "queued behind a sleep; library_ms: row 8 one "
                  "torch.bmm (bf16) on the pages gathered "
                  "(dequantized) in advance, row 9 torch.bmm of the bf16 "
                  "probabilities on them plus the w_v einsum; "
                  "two_shard_body_ms: both shards' rows 8 and 9 in turn "
                  "with the pe scores, mask and softmax (no collective), "
                  "row7_ms: the single-device latent kernel on the same "
                  "inputs", **out})


FAMILIES = ("paged_attention", "paged_latent", "fused", "lora", "gemm",
            "memcpy/memset", "other")


def _family(name: str) -> str:
    name = name.lower()
    if "paged_attention" in name:
        return "paged_attention"
    if "paged_latent" in name:
        return "paged_latent"
    if "lora_shrink_kernel" in name or "lora_expand_kernel" in name:
        return "lora"
    if any(f"fused_{k}_kernel" in name for k in FUSED_KERNELS) \
            or "mla_down_kernel" in name or "mla_up_kernel" in name:
        return "fused"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass",
                               "matmul")):
        return "gemm"
    if "memcpy" in name or "memset" in name:
        return "memcpy/memset"
    return "other"


def _device_profile(fn, units: int, families=FAMILIES,
                    family=None, top_kernels: int = 0,
                    calls=None) -> dict:
    """fn() under torch.profiler (device activity only): the window's
    wall time, device busy time and idle share, and device time and
    kernel count by kernel family, in all and per unit (chunk or step).
    calls {family: a function giving its wrapper's launch count}: the
    family's device time per wrapper call and kernels per call (a call
    may launch more than one kernel)."""
    from torch.profiler import ProfilerActivity, profile
    family = family or _family
    calls = calls or {}
    torch.cuda.synchronize()
    calls0 = {fam: f() for fam, f in calls.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_calls = {fam: f() - calls0[fam] for fam, f in calls.items()}
    ms = dict.fromkeys(families, 0.0)
    n = dict.fromkeys(families, 0)
    by_name = {}
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        fam = family(e.name)
        t = e.time_range.elapsed_us() / 1e3
        ms[fam] += t
        n[fam] += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + t
    busy = sum(ms.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_kernels]
    out = {"units": units, "window_ms": wall_ms,
           "wall_ms_per_unit": wall_ms / units, "device_busy_ms": busy,
           "device_idle_share": (1 - busy / wall_ms) if busy else
           "not measured (the profiler saw no device events)",
           "device_ms_per_unit_by_family": {k: v / units
                                            for k, v in ms.items()},
           "device_ms_by_family": ms, "kernels_by_family": n}
    if top:
        out["top_kernels_ms_per_unit"] = [[name[:90], t / units]
                                          for name, t in top]
    for fam, c in n_calls.items():
        out[f"{fam}_calls"] = c
        out[f"{fam}_ms_per_launch"] = ms[fam] / c if c else None
        out[f"{fam}_kernels_per_call"] = n[fam] / c if c else None
    return out


def _profile_engine(params, cfg, dev, fused, kv_cache_dtype="bf16",
                    adapter_cache=None):
    """One engine's prefill window and decode window (see phase_profile);
    with an adapter cache, the 8 requests wear the cache's first four
    adapters in turn."""
    import numpy as np

    from megatronapp_tpu_torch.inference.engine import SamplingParams
    engine = _engine(params, cfg, dev, fused=fused,
                     kv_cache_dtype=kv_cache_dtype,
                     adapter_cache=adapter_cache)
    route = [None] * 8
    if adapter_cache is not None:
        route = [LORA_ADAPTERS[i % 4] for i in range(8)]
    check(engine.megakernel is fused, "profile: the engine's step kind")
    rng = np.random.default_rng(1)
    prompt_len, chunk, steps = 1008, 32, 16
    prompts = [rng.integers(0, cfg.vocab_size - 1, prompt_len).astype(
        np.int32) for _ in range(8)]
    greedy = SamplingParams(greedy=True)

    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    calls = {"paged_attention": lambda: sum(pa.launches.values()),
             "paged_latent": lambda: sum(pl.launches.values())}
    engine.add_request(prompts[0], 64, greedy, adapter_id=route[0])
    chunks0 = engine.prefill_chunks
    prefill = _device_profile(engine.step, math.ceil(prompt_len / chunk),
                              top_kernels=8, calls=calls)
    check(engine.prefill_chunks - chunks0 == prefill["units"],
          "profile: the prefill window ran another number of chunks")
    for p, a in zip(prompts[1:], route[1:]):
        engine.add_request(p, 64, greedy, adapter_id=a)
    for _ in range(3):              # prefill the other seven, then warm up
        engine.step()
    check(all(r is not None and not r.finished for r in engine.slots),
          "profile: not every slot is decoding")
    steps0 = engine.decode_steps
    decode = _device_profile(lambda: [engine.step() for _ in range(steps)],
                             steps, top_kernels=8, calls=calls)
    check(engine.decode_steps - steps0 == steps,
          "profile: the decode window ran another number of steps")
    kv_after = [int(x) for x in engine.lengths]
    engine.abort_all()
    del engine
    torch.cuda.empty_cache()
    for window in (prefill, decode):
        window["kernels_per_unit"] = sum(
            window["kernels_by_family"].values()) / window["units"]
    return {"prefill_one_prompt": {"prompt_len": prompt_len, "chunk": chunk,
                                   **prefill},
            "decode_8_slots": {"kv_lens_after": kv_after, **decode}}


def phase_profile(state):
    """Where a step's device time goes at the slice's shapes, through the
    serving engine's own step() (called here from the main thread, not
    from the driver's stepper), for the unfused and the fused engine on
    the same weights: the prefill of one 1008-token prompt (32 ragged
    chunks at kv 32..1008; the window also holds that slot's first decode
    step), then 16 decode steps with 8 slots at kv ~1024. Then the same
    windows through the fused engine on the resident-int8 weights of
    serve_quant and int8 pools, and through the unfused and fused LoRA
    engines of serve_lora (the 8 requests on four adapters), and through
    the unfused and fused MLA engines of serve_mla (32 layers)."""
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    params, cfg, dev = state["model"]
    before = dict(fd.launches), dict(pa.launches)
    out = {"unfused": _profile_engine(params, cfg, dev, False),
           "fused": _profile_engine(params, cfg, dev, True)}
    if "qmodel" in state:
        out["fused_int8_weights_int8_pools"] = _profile_engine(
            state["qmodel"][0], cfg, dev, True, kv_cache_dtype="int8")
    if "lora_registry" in state:
        from megatronapp_tpu_torch.ops.cuda import lora as cl
        before_l = dict(fd.lora_launches), dict(cl.launches)
        for name, fused in (("lora_unfused", False), ("lora_fused", True)):
            out[name] = _profile_engine(params, cfg, dev, fused,
                                        adapter_cache=_lora_cache(state))
            torch.cuda.empty_cache()
        fd.lora_launches.update(before_l[0])
        cl.launches.update(before_l[1])
    if "mla_model" in state:
        from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
        from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
        before_m = dict(fm.launches), dict(pl.launches)
        m_params, m_cfg, _ = state["mla_model"]
        for name, fused in (("mla_unfused", False), ("mla_fused", True)):
            out[name] = _profile_engine(m_params, m_cfg, dev, fused)
            torch.cuda.empty_cache()
            # Two kernels a call (mla_kernels checks the count exactly on a
            # burst of calls alone); in these windows of ~70 k kernels the
            # profiler may drop a few records, so here at least 1.95.
            for window in out[name].values():
                calls = window["paged_latent_calls"]
                check(calls > 0 and 1.95 * calls <= window[
                    "kernels_by_family"]["paged_latent"] <= 2 * calls,
                      f"profile {name}: {window['kernels_by_family']} "
                      f"kernels for {calls} latent calls (two a call)")
        fm.launches.update(before_m[0])
        pl.launches.update(before_m[1])
    fd.launches.update(before[0])
    pa.launches.update(before[1])
    emit({"phase": "profile", "model": "llama3-8b",
          "layers": cfg.num_layers, **out})


def _sdpa_call(case, hq, hkv, nxt):
    """One PyTorch attention call on K/V gathered in advance for every
    page table of the case (uniform kv_lens; quantized pools dequantized
    to bf16 in advance), rotating like the kernel: the yardstick; the port
    never calls it."""
    import torch.nn.functional as F
    q = case["q"]
    b = q.shape[0]
    t = case["tables"].long()                             # [R, B, MB]
    r, _, mb = t.shape
    _, bs, _, d = case["k"].shape
    n = int(case["kv_lens"].max())

    def gather(pool):                                     # [R, B, Hkv, n, D]
        return pool[t].reshape(r, b, mb * bs, hkv, d)[:, :, :n] \
            .transpose(2, 3).contiguous()

    k, v = gather(case.get("k_deq", case["k"])), \
        gather(case.get("v_deq", case["v"]))
    if "q_lens" not in case:
        qq = q[:, :, None, :]                              # [B, Hq, 1, D]
        mask = None
    else:
        qq = q.transpose(1, 2)                             # [B, Hq, S, D]
        s_q = q.shape[1]
        pos = torch.arange(n, device=q.device)
        start = (case["kv_lens"] - case["q_lens"]).long()
        abs_q = start[:, None] + torch.arange(s_q, device=q.device)
        mask = (pos[None, None, :] <= abs_q[:, :, None])[:, None]

    def call():
        i = nxt()
        F.scaled_dot_product_attention(qq, k[i], v[i], attn_mask=mask,
                                       enable_gqa=hq != hkv)
    return call


def _time_case(case, hq, hkv, d, bs):
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    ql = case.get("q_lens")
    tables = case["tables"]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % tables.shape[0]
        return it["i"]

    kw = {k: case[k] for k in ("k_scales", "v_scales") if k in case}

    def kernel():
        pa.paged_attention(case["q"], case["k"], case["v"], tables[nxt()],
                           case["kv_lens"], q_lens=ql, **kw)

    def plain():
        pa.paged_attention_plain(case["q"], case["k"], case["v"],
                                 tables[nxt()], case["kv_lens"], q_lens=ql,
                                 **kw)

    lib = _sdpa_call(case, hq, hkv, nxt)
    # plain, kernel, kernel, plain: compare within one card and call. The
    # kernel and the library call run for less than a call's host time, so
    # their calls are queued behind a sleep (device_ms).
    p1 = cuda_time_ms(plain, iters=10)
    k1 = device_ms(kernel)
    k2 = device_ms(kernel)
    p2 = cuda_time_ms(plain, iters=10)
    lib_ms = device_ms(lib)
    nbytes = kv_bytes(case, d, hkv)
    flops = attention_flops(case, hq, d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
            "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
            "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "shape": {"batch": case["q"].shape[0],
                      "kv_len": int(case["kv_lens"][0]), "hq": hq,
                      "hkv": hkv, "d": d, "block_size": bs,
                      "s_q": 1 if ql is None else case["q"].shape[1]},
            "kv_splits": pa.launch_split_count(case["q"], case["k"],
                                               case["table"]),
            "page_tables_rotated": tables.shape[0]}


def phase_times(state):
    """Each mode at the shape the engine launches it: decode with B =
    max_batch = 8 at kv 1024, ragged with B = 1 (the engine prefills one
    request per chunk) and S_q = 32, at kv 1024 and across the prompt
    range, and the speculative verify step (B 8, S_q 5 at kv 1024); ragged
    at B = 8, S_q 32 as a second, labelled row."""
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(99)
    before = dict(pa.launches)
    hq, hkv, d, bs = 32, 8, 128, 16
    # Earlier phases' cached blocks go back to the card, so that the timing
    # windows' allocations never free a cache (a free waits on the card).
    torch.cuda.empty_cache()

    def case(batch, kv, s_q=None):
        return make_case(gen, dev, batch=batch, hq=hq, hkv=hkv, d=d, bs=bs,
                         kv_lens=[kv] * batch, s_q=s_q,
                         q_lens=None if s_q is None else [s_q] * batch,
                         pool_bytes=TIMED_POOL_BYTES)

    rows = {"decode": _time_case(case(8, 1024), hq, hkv, d, bs),
            "ragged": _time_case(case(1, 1024, 32), hq, hkv, d, bs),
            # The speculative verify step at spec_k 4: B 8 of S_q 5.
            "verify": _time_case(case(8, 1024, 5), hq, hkv, d, bs)}
    # Quantized pools hold half the bytes: twice the tables keep their K/V
    # beyond the L2 cache.
    quant = {}
    for kind in QUANT_KINDS:
        for mode, (batch, s_q) in (("decode", (8, None)),
                                   ("ragged", (1, 32)), ("verify", (8, 5))):
            c = make_case(gen, dev, batch=batch, hq=hq, hkv=hkv, d=d, bs=bs,
                          kv_lens=[1024] * batch, s_q=s_q,
                          q_lens=None if s_q is None else [s_q] * batch,
                          pool_bytes=2 * TIMED_POOL_BYTES)
            quant[f"{mode}_{kind}"] = _time_case(quantize_case(c, kind), hq,
                                                 hkv, d, bs)
            del c
    torch.cuda.empty_cache()
    by_kv = {kv: _time_case(case(1, kv, 32), hq, hkv, d, bs)
             for kv in (32, 256, 512)}
    by_kv[1024] = rows["ragged"]
    b8 = _time_case(case(8, 1024, 32), hq, hkv, d, bs)
    pa.launches.update(before)
    state["times"] = rows
    state["quant_times"] = quant
    emit({"phase": "times", "nvidia_smi": state.get("smi"),
          "l2": f"cold: each launch reads pages of another table, the "
                f"tables' K/V spanning >= {TIMED_POOL_BYTES} bytes",
          **rows,
          "quantized_pools": {
              "note": "library_ms: scaled_dot_product_attention on K/V "
                      "gathered and dequantized to bf16 in advance (it "
                      "reads twice the K/V bytes of the quantized pools)",
              **quant},
          "ragged_b1_by_kv": {
              kv: {k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                     "bound_ms")}
              for kv, r in sorted(by_kv.items())},
          "ragged_b8_not_a_main_path_shape": b8,
          "flash_train_shapes": _flash_times(state),
          "fused_llama3_8b": _fused_times(state),
          "fused_int8_llama3_8b": (_fused_times(state, "qmodel")
                                   if "qmodel" in state else None),
          **({"lora_segmented_llama3_8b": _lora_times(state),
              "fused_lora_llama3_8b": _fused_times(state, lora=True),
              "fused_int8_lora_llama3_8b": (
                  _fused_times(state, "qmodel", lora=True)
                  if "qmodel" in state else None)}
             if "lora_cache" in state else {}),
          **({"mla_latent_llama3_8b": _mla_latent_times(state),
              "mla_prologue_llama3_8b": _mla_prologue_times(state)}
             if "mla_model" in state else {})})


def _fused_bytes_flops(cfg, kernel, rows, int8=False, lora_ids=None):
    """Bytes each input read once and each output written once (weights,
    with their fp32 column scales when int8, norm and bias vectors,
    activations, residual, rope rows; with lora_ids, one fp32 A and B per
    distinct adapter and the row ids), and the multiply-add operations of
    the product (and of the deltas' two products)."""
    h, ffn, d = cfg.hidden_size, cfg.ffn_hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_query_groups
    k, n = {"qkv": (h, (nq + 2 * nkv) * d), "out_proj": (nq * d, h),
            "mlp_fc1": (h, 2 * ffn), "mlp_fc2": (ffn, h)}[kernel]
    w = (k * n + n * 4 if int8 else k * n * 2) \
        + (h * 2 if kernel in ("qkv", "mlp_fc1") else 0)
    acts = {"qkv": rows * h + rows * n, "out_proj": rows * (k + 2 * h),
            "mlp_fc1": rows * (h + ffn), "mlp_fc2": rows * (ffn + 2 * h)}
    nbytes = w + acts[kernel] * 2
    if kernel == "qkv":
        nbytes += 2 * rows * (d // 2) * 4
    flops = 2 * rows * k * n
    if lora_ids is not None:
        adapters = len({i for i in lora_ids if i})
        targets = 2 if kernel == "qkv" else 1      # qkv: q's A and kv's A
        nbytes += (adapters * (targets * k + n) * LORA_RANK * 4
                   + rows * 4)
        flops += 2 * sum(i != 0 for i in lora_ids) * LORA_RANK * (
            targets * k + n)
    return nbytes, flops, (k, n)


def _fused_times(state, model="model", lora=False):
    """Each fused kernel at the decode (8 rows), prefill-chunk (32 rows)
    and speculative verify (40 rows: B 8 x 5) shapes of llama3-8b,
    rotating through the served model's 32
    layers so that every launch finds its weights cold (each layer's
    weights of one kernel are 33.6-234.9 MB in bf16, half that in int8;
    L2 is 50 MB). Beside the kernel: its plain version (the unfused
    layer's own ops for the same function: norm, matmul, bias, QK-norm,
    rope, activation, residual), the card's bound and, as a yardstick the
    port never calls, one torch.matmul of the same product (the GEMM
    alone; for resident int8 weights, on the weights dequantized to bf16
    in advance, which are twice the int8 bytes). model: "model" (bf16
    weights) or "qmodel" (serve_quant's resident int8 weights). lora: the
    kernels with their LoRA epilogue, each layer's banks from serve_lora's
    cache (rank 8; the 8 rows on LORA_DECODE_IDS, the 32 on one adapter),
    against the plain versions with the same deltas."""
    from megatronapp_tpu_torch.inference.quantization import (
        is_resident_leaf, resolve_param,
    )
    from megatronapp_tpu_torch.models.gpt import gpt_rope_tables
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    import numpy as np

    from megatronapp_tpu_torch.ops.lora import LoraRows
    params, cfg, dev = state[model]
    layers = list(params["layers"])
    int8 = is_resident_leaf(layers[0]["attention"]["q_kernel"])
    before = dict(fd.launches), dict(fd.lora_launches)
    cache = state["lora_cache"] if lora else None
    if lora:
        for aid in LORA_ADAPTERS[:4]:
            cache.acquire(aid)      # slots 1..4 hold adapters (pinned)
        layer_banks = [{t: (a[i], b[i]) for t, (a, b) in cache.banks.items()}
                       for i in range(len(layers))]
    gen = torch.Generator(dev).manual_seed(77)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(layers)
        return layers[it["i"]]

    def weight(p, kernel):
        return {"qkv": None, "out_proj": p["attention"]["out_kernel"],
                "mlp_fc1": p["mlp"]["fc1_kernel"],
                "mlp_fc2": p["mlp"]["fc2_kernel"]}[kernel]

    out = {}
    for rows in (8, 32, VERIFY_ROWS):
        ids = None
        if lora:
            ids = {8: LORA_DECODE_IDS, 32: [3] * 32,
                   VERIFY_ROWS: LORA_VERIFY_IDS}[rows]
        segs = LoraRows(np.asarray(ids), dev) if lora else None

        def lo():
            return None if not lora else {"row_adapter": segs,
                                          "banks": layer_banks[it["i"]]}

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(
                torch.bfloat16)
        x = rnd(rows, cfg.hidden_size)
        attn = rnd(rows, cfg.num_attention_heads * cfg.head_dim)
        y = rnd(rows, cfg.ffn_hidden_size)
        pos = torch.randint(0, 2048, (rows,), generator=gen, device=dev)
        cos_t, sin_t = gpt_rope_tables(cfg, 2048, device=dev)
        cos, sin = cos_t[pos], sin_t[pos]
        calls = {
            "qkv": (lambda: fd.fused_qkv(x, nxt(), cfg, cos, sin, lo()),
                    lambda: fd.fused_qkv_plain(x, nxt(), cfg, cos, sin,
                                               lo()), x),
            "out_proj": (lambda: fd.fused_out_proj(attn, nxt(), cfg, x, lo()),
                         lambda: fd.fused_out_proj_plain(attn, nxt(), cfg,
                                                         x, lo()), attn),
            "mlp_fc1": (lambda: fd.fused_mlp_fc1(x, nxt(), cfg, lo()),
                        lambda: fd.fused_mlp_fc1_plain(x, nxt(), cfg, lo()),
                        x),
            "mlp_fc2": (lambda: fd.fused_mlp_fc2(y, x, nxt(), cfg, lo()),
                        lambda: fd.fused_mlp_fc2_plain(y, x, nxt(), cfg,
                                                       lo()), y),
        }
        per = {}
        for kernel, (kern, plain, a) in calls.items():
            if kernel == "qkv":   # the product of [Wq | Wkv] as one GEMM
                ws = [torch.cat([resolve_param(p["attention"][w],
                                               torch.bfloat16)
                                 for w in ("q_kernel", "kv_kernel")], dim=1)
                      for p in layers[:4]]
            elif int8:
                ws = [resolve_param(weight(p, kernel), torch.bfloat16)
                      for p in layers[:4]]
            else:
                ws = None

            def lib(a=a, kernel=kernel, ws=ws):
                p = nxt()
                torch.matmul(a, ws[it["i"] % 4] if ws is not None
                             else weight(p, kernel))
            # plain, kernel, kernel, plain: compare within one card and
            # call; device time (see device_ms), and the host-paced loop.
            p1 = device_ms(plain, calls=PLAIN_CALLS)
            k1 = device_ms(kern)
            k2 = device_ms(kern)
            p2 = device_ms(plain, calls=PLAIN_CALLS)
            lib_ms = device_ms(lib)
            loop_ms = cuda_time_ms(kern)
            shrink = {}
            if lora:   # the shrink launch alone, as the wrapper makes it
                shrink["shrink_ms"] = device_ms(
                    lambda kernel=kernel, a=a: fd.lora_shrink_for(
                        kernel, a, nxt(), cfg, lo()))
            del ws
            nbytes, flops, (kk, nn) = _fused_bytes_flops(cfg, kernel, rows,
                                                         int8, ids)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            per[kernel] = {
                "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                "unfused_ops_ms": (p1 + p2) / 2,
                "loop_ms_per_call": loop_ms,
                "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops,
                "shape": {"rows": rows, "k": kk, "n": nn},
                "achieved_bytes_per_s": nbytes / ((k1 + k2) / 2e3),
                **shrink}
        out[rows] = per
    fd.launches.update(before[0])
    fd.lora_launches.update(before[1])
    if lora:
        for aid in LORA_ADAPTERS[:4]:
            cache.release(cache.slot_of(aid))
        cache.audit()
    state[("fused_int8" if int8 else "fused") + ("_lora" if lora else "")
          + "_times"] = out
    return {"note": "kernel, plain and library ms are device time per "
                    "call (device_ms: queued behind a sleep, timed with "
                    "CUDA events); loop_ms_per_call is CUDA "
                    "events around 20 back-to-back calls, paced by the "
                    "host where a kernel is shorter than its launch; "
                    "unfused_ops_ms is the plain version's time: it runs "
                    "the unfused layer's ops for the same function; "
                    "library_ms is one torch.matmul of the product (the "
                    "GEMM alone; QKV, and every int8 kernel: bf16 weights "
                    "made in advance, QKV's [Wq | Wkv] concatenated, 4 "
                    "layers rotated); with lora, kernel_ms holds the "
                    "shrink launch before each fused kernel, and shrink_ms "
                    "is that launch alone", "weights": "resident int8" if int8
            else "bf16", "lora_epilogue": lora, "rows": out}


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------

# bf16 flash kernels against their plain versions, twice.
# 1. Against the fp32 plain version on fp32 copies of the inputs: the
#    output within FLASH_OUT_TOL of each (row, head)'s RMS over D (the
#    bound argued above for the paged kernel: bf16 rounding of the scaled
#    q, of P and of the output); the LSE within FLASH_LSE_TOL absolute
#    (rounding q*scale to bf16 moves a score by ~2^-9 of |q||k| scale,
#    ~0.004 at D 128); each gradient within FLASH_GRAD_TOL of its (batch,
#    head) Frobenius norm. The gradients are held normwise because
#    ds = p (dp - delta) cancels: the rounded q and the bf16 output (which
#    enters delta) move ds by ~0.5 % of its terms, and a row whose
#    gradient nearly cancels (dq of the first causal rows, measured on the
#    card: 0.22 of max(row, head RMS) at one element of row 3, S 4096,
#    while the 99th percentile is 0.006) has no scale of its own.
# 2. Against the plain version on the same bf16 inputs fed the kernels'
#    own LSE and delta, which repeats the kernels' roundings: every
#    element within FLASH_SAME_TOL of max(its (row, head) RMS, its head's
#    RMS) — what is left is summation order and the bf16 rounding of the
#    results (measured: 0.016 for dq at S 4096).
FLASH_OUT_TOL = 0.06
FLASH_LSE_TOL = 0.02
FLASH_GRAD_TOL = 0.02
FLASH_SAME_TOL = 0.06
TRAIN_FAMILIES = ("flash_fwd", "flash_bwd", "gemm", "memcpy/memset",
                  "other")


def _train_family(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_fwd"
    if "flash_bwd" in low:
        return "flash_bwd"
    fam = _family(name)
    return "other" if fam in ("paged_attention", "fused") else fam


def _flash_inputs(gen, dev, b, s, hq, hkv, d, segments=False):
    """bf16 q, and k/v as the two halves of one [B, S, 2 Hkv, D] tensor
    (strided views, as the attention layer splits its fused projection),
    a cotangent g and optional packed segment ids."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    q = rnd(b, s, hq, d)
    k, v = rnd(b, s, 2 * hkv, d).split(hkv, dim=2)
    seg = None
    if segments:
        seg = torch.sort(torch.randint(0, 4, (b, s), generator=gen),
                         dim=1).values.to(dev, torch.int32)
    return q, k, v, rnd(b, s, hq, d), seg


def _errs(got, ref, grad: bool):
    """(max abs error, max error over max(row RMS, head RMS) for grads or
    over the row RMS for outputs, max per-(batch, head) normwise error)."""
    err = (got.float() - ref.float()).abs()
    ref = ref.float()
    scale = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    if grad:
        scale = torch.maximum(
            scale, ref.pow(2).mean(dim=(1, 3), keepdim=True).sqrt())
    norm = (err.pow(2).sum(dim=(1, 3)) / ref.pow(2).sum(dim=(1, 3))).sqrt()
    return (float(err.max()), float((err / scale.clamp_min(1e-30)).max()),
            float(norm.max()))


def _flash_case(name, q, k, v, g, seg, causal, head_fold=False):
    """The three kernels on bf16 inputs against the plain versions (see
    the tolerances above), and the forward and the backward each run twice
    on the same inputs: each out, lse, dq, dk and dv element has one
    writer and a fixed order of sums, so the rerun must repeat every bit.
    head_fold goes through the autograd Function with flash_head_fold set
    (the model's path); the rest call the wrappers."""
    from megatronapp_tpu_torch.ops import flash_attention as ofa
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    out, lse = fa.flash_forward(q, k, v, causal, None, seg)
    out2, lse2 = fa.flash_forward(q, k, v, causal, None, seg)
    torch.cuda.synchronize()
    check(torch.equal(out, out2) and torch.equal(lse, lse2),
          f"train_kernels {name}: a rerun of the forward on the same inputs "
          "changed out or lse")
    del out2, lse2

    def backward():
        if not head_fold:
            return fa.flash_backward(q, k, v, out, lse, g, causal, None, seg)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out_f = ofa.flash_attention(*leaves, causal=causal, segment_ids=seg,
                                    head_fold=True)
        out_f.backward(g)
        check(torch.equal(out_f, out), f"train_kernels {name}: the "
              "autograd path's output differs from the kernel's")
        return [t.grad for t in leaves]

    grads = backward()
    rerun = backward()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, rerun)),
          f"train_kernels {name}: a rerun of the backward on the same "
          "inputs changed dq, dk or dv")
    del rerun
    for t in (out, *grads):
        check(bool(torch.isfinite(t).all()),
              f"train_kernels {name}: non-finite output")
    res = {}
    f32 = [t.float() for t in (q, k, v, g)]
    ref_out, ref_lse = fa.flash_forward_plain(*f32[:3], causal, None, seg)
    ref = fa.flash_backward_plain(
        *f32, ref_lse, fa.attention_delta(ref_out, f32[3]), causal, None,
        seg)
    res["rerun_bit_identical"] = True
    res["fp32"] = {"out": _errs(out, ref_out, False),
                   "lse_abs": float((lse - ref_lse).abs().max())}
    for key, got, want in zip(("dq", "dk", "dv"), grads, ref):
        res["fp32"][key] = _errs(got, want, True)
    del ref, ref_out, ref_lse, f32
    same_out, _ = fa.flash_forward_plain(q, k, v, causal, None, seg)
    same = fa.flash_backward_plain(q, k, v, g, lse,
                                   fa.attention_delta(out, g), causal, None,
                                   seg)
    res["same_inputs"] = {"out": _errs(out, same_out, False)}
    for key, got, want in zip(("dq", "dk", "dv"), grads, same):
        res["same_inputs"][key] = _errs(got, want, True)
    del same, same_out
    torch.cuda.empty_cache()
    r32, rsame = res["fp32"], res["same_inputs"]
    check(r32["lse_abs"] <= FLASH_LSE_TOL,
          f"train_kernels {name}: lse error {r32['lse_abs']}")
    check(r32["out"][1] <= FLASH_OUT_TOL and rsame["out"][1] <= FLASH_OUT_TOL,
          f"train_kernels {name}: out errors {r32['out']} / "
          f"{rsame['out']} over the row RMS exceed {FLASH_OUT_TOL}")
    for key in ("dq", "dk", "dv"):
        check(r32[key][2] <= FLASH_GRAD_TOL,
              f"train_kernels {name}: {key} normwise error vs fp32 "
              f"{r32[key]} exceeds {FLASH_GRAD_TOL}")
        check(rsame[key][1] <= FLASH_SAME_TOL,
              f"train_kernels {name}: {key} error vs the same-input plain "
              f"version {rsame[key]} exceeds {FLASH_SAME_TOL}")
    return res


def phase_train_kernels(state):
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(4321)
    before = dict(fa.launches)
    cases = {
        # name: (b, s, hq, hkv, d, causal, segments, head_fold)
        "llama3_8b_s4096_causal": (1, 4096, 32, 8, 128, True, False, False),
        "gpt2_125m_s1024_causal": (2, 1024, 12, 12, 64, True, False, False),
        "gpt2_125m_s1024_bidirectional": (2, 1024, 12, 12, 64, False, False,
                                          False),
        "ragged_s1000_gqa": (2, 1000, 8, 2, 128, True, False, False),
        "packed_segments_d64": (2, 1024, 12, 4, 64, True, True, False),
        "packed_segments_d128_bidirectional": (1, 777, 8, 8, 128, False,
                                               True, False),
        "head_fold_d64_gqa": (2, 1024, 12, 6, 64, True, False, True),
    }
    results = {}
    for name, (b, s, hq, hkv, d, causal, segments, fold) in cases.items():
        q, k, v, g, seg = _flash_inputs(gen, dev, b, s, hq, hkv, d,
                                        segments)
        results[name] = _flash_case(name, q, k, v, g, seg, causal, fold)
    fa.launches.update(before)
    r32 = [r["fp32"] for r in results.values()]
    state["flash_err"] = {
        "fwd": max(r["out"][0] for r in r32),
        "bwd_dq": max(r["dq"][0] for r in r32),
        "bwd_dkv": max(max(r["dk"][0], r["dv"][0]) for r in r32)}
    emit({"phase": "train_kernels", "tolerances": {
        "fp32_out_over_row_rms": FLASH_OUT_TOL, "fp32_lse_abs": FLASH_LSE_TOL,
        "fp32_grad_normwise_per_head": FLASH_GRAD_TOL,
        "same_inputs_over_max_row_head_rms": FLASH_SAME_TOL},
        "errors": "(max abs, max over scale, max normwise per head)",
        "cases": {n: {"shape": dict(zip(
            ("b", "s", "hq", "hkv", "d", "causal", "segments",
             "head_fold"), cases[n])), **r} for n, r in results.items()}})


def _train_step_run(cfg, params, batches, dev):
    """Two optimizer steps of the port's train step from `params` on
    `dev`; returns the steps' metrics."""
    from megatronapp_tpu_torch.config.training_config import OptimizerConfig
    from megatronapp_tpu_torch.training.optimizer import Optimizer
    from megatronapp_tpu_torch.training.train import gpt_microbatch_loss
    from megatronapp_tpu_torch.training.train_step import (
        TrainState, make_train_step, named_trainable, to_device_batch,
    )
    opt = Optimizer(OptimizerConfig(lr=1e-3), 10)
    params.requires_grad_(True)
    st = TrainState(params, opt.init(named_trainable(params)))
    step = make_train_step(gpt_microbatch_loss(cfg), opt)
    return [step(st, to_device_batch(b, dev)) for b in batches]


def phase_train_reference(state):
    """A 2-layer llama-shaped model (head_dim 128, GQA group 2, flash
    forced at S 256): two train steps on the card (bf16 compute, kernels)
    against the CPU (fp32, plain versions) from the same fp32 weights."""
    import copy

    from megatronapp_tpu_torch.data.mock import mock_batches
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    from megatronapp_tpu_torch.training.train import reshape_global_batch
    small = dict(num_layers=2, hidden_size=512, num_attention_heads=4,
                 num_query_groups=2, ffn_hidden_size=1024, vocab_size=512,
                 init_method_std=0.05, attention_impl="pallas")
    cfg_ref = llama3_8b(compute_dtype=torch.float32, **small)
    cfg_dev = llama3_8b(**small)
    p_ref = init_gpt_params(cfg_ref, torch.Generator().manual_seed(17),
                            "cpu")
    p_dev = copy.deepcopy(p_ref).to("cuda")
    it = mock_batches(256, 512, 4, seed=3)
    fields = ("tokens", "labels", "loss_mask")
    batches = [reshape_global_batch({k: v for k, v in next(it).items()
                                     if k in fields}, 2) for _ in range(2)]
    for k in fa.launches:
        fa.launches[k] = 0
    dev_m = _train_step_run(cfg_dev, p_dev, batches, torch.device("cuda", 0))
    launches = dict(fa.launches)
    ref_m = _train_step_run(cfg_ref, p_ref, batches, torch.device("cpu"))
    fa.launches.update({k: 0 for k in fa.launches})
    rel = [{k: abs(d[k] - r[k]) / abs(r[k]) for k in ("loss", "grad_norm")}
           for d, r in zip(dev_m, ref_m)]
    emit({"phase": "train_reference", "card": dev_m, "cpu": ref_m,
          "rel_err": rel, "launches": launches,
          "tolerances": {"loss": 0.01, "grad_norm": 0.05}})
    check(launches == {"fwd": 8, "bwd_dq": 8, "bwd_dkv": 8},
          f"train_reference: expected 2 layers x 2 micro x 2 steps launches "
          f"of each kernel, got {launches}")
    # bf16 weights and activations through two layers move the loss by a
    # fraction of a percent and the gradient norm by a few percent.
    for r in rel:
        check(r["loss"] < 0.01 and r["grad_norm"] < 0.05,
              f"train_reference: card vs CPU relative errors {r}")


def phase_train(state, layers: int):
    """pretrain_gpt on llama3-8b at full width, `layers` deep."""
    import gc

    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu_torch.data.mock import mock_batches
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    from megatronapp_tpu_torch.training.optimizer import Optimizer
    from megatronapp_tpu_torch.training.train import (
        gpt_microbatch_loss, pretrain_gpt, reshape_global_batch,
    )
    from megatronapp_tpu_torch.training.train_step import (
        make_train_step, to_device_batch,
    )
    from megatronapp_tpu_torch.utils.flops import flops_per_token
    dev = torch.device("cuda", 0)
    cfg = llama3_8b(num_layers=layers)
    seq, micro, gbs, steps = 4096, 1, 2, 5
    train_cfg = TrainingConfig(micro_batch_size=micro, global_batch_size=gbs,
                               seq_length=seq, train_iters=steps,
                               log_interval=1, seed=1234)
    opt_cfg = OptimizerConfig()
    lines = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in fa.launches:
        fa.launches[k] = 0
    t0 = time.perf_counter()
    res = pretrain_gpt(cfg, train_cfg, opt_cfg, device=dev,
                       log_fn=lines.append)
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    num_micro = gbs // micro
    losses = [m["loss"] for m in res.log]
    # Random untied head: logits ~ N(0, std^2 H) after the final norm, so
    # the expected first loss is ln V + std^2 H / 2 (12.58 here).
    expected0 = math.log(cfg.vocab_size) + (
        cfg.init_method_std ** 2 * cfg.hidden_size / 2)
    step_ms = [m["step_time_ms"] for m in res.log[1:]]
    mean_ms = sum(step_ms) / len(step_ms)
    tok_s = gbs * seq / (mean_ms / 1e3)
    fpt = flops_per_token(cfg, seq)
    # Beyond the main path (these launches are not counted there): two
    # steps under each remat policy from the trained state, for the peak
    # memory, the second step's time and the launches of one step ("full"
    # recomputes each layer's forward), then two profiled steps.
    import dataclasses
    opt = Optimizer(opt_cfg, steps + 6)
    batch = next(mock_batches(seq, cfg.vocab_size, gbs, seed=99))
    batch = to_device_batch(reshape_global_batch(
        {k: batch[k] for k in ("tokens", "labels", "loss_mask")},
        num_micro), dev)
    remat = {}
    for policy in ("selective", "full"):
        step_fn = make_train_step(gpt_microbatch_loss(
            dataclasses.replace(cfg, remat_policy=policy)), opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_fn(res.state, batch)
        fa.launches.update({k: 0 for k in fa.launches})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_fn(res.state, batch)
        torch.cuda.synchronize()
        remat[policy] = {"step_ms": (time.perf_counter() - t1) * 1e3,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "launches": dict(fa.launches)}
    step_fn = make_train_step(gpt_microbatch_loss(cfg), opt)
    prof = _device_profile(lambda: [step_fn(res.state, batch)
                                    for _ in range(2)], 2,
                           TRAIN_FAMILIES, _train_family, top_kernels=15)
    fa.launches.update({k: 0 for k in fa.launches})
    state["train_launches"] = launches
    params_n = sum(p.numel() for p in res.state.params.parameters())
    # trace_train starts from these weights (no second model is built).
    state["train_model"] = (res.state.params, cfg)
    res.state.opt_state = None
    del res, batch, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train", "model": "llama3-8b", "layers": layers,
          "full_width": True, "params": params_n, "seq_length": seq,
          "micro_batch_size": micro, "global_batch_size": gbs,
          "steps": steps, "params_dtype": "fp32", "compute_dtype": "bf16",
          "losses": losses, "expected_first_loss": expected0,
          "log": lines, "launches": launches, "wall_s": wall,
          "step_ms": step_ms, "mean_step_ms_after_first": mean_ms,
          "tokens_per_s": tok_s, "flops_per_token": fpt,
          "mfu": tok_s * fpt / BF16_FLOPS_PER_S,
          "peak_mem_bytes": peak, "remat_one_step": remat,
          "profiled_steps": prof})
    check(all(math.isfinite(x) for x in losses),
          f"train: non-finite loss in {losses}")
    check(abs(losses[0] - expected0) < 0.5,
          f"train: first loss {losses[0]} not within 0.5 of {expected0}")
    want = layers * num_micro * steps
    check(launches == {"fwd": want, "bwd_dq": want, "bwd_dkv": want},
          f"train: expected {want} launches of each flash kernel "
          f"(layers x micro x steps), got {launches}")
    one = layers * num_micro
    check(remat["selective"]["launches"] == dict.fromkeys(launches, one)
          and remat["full"]["launches"] == {"fwd": 2 * one, "bwd_dq": one,
                                            "bwd_dkv": one},
          f"train: remat launches {remat} (full recomputes the forward)")


# trace_train: phases that must cover a traced train-step, and the share.
TRACE_PHASES = ("forward", "loss", "backward", "allreduce", "optimizer")
TRACE_COVER = 0.9
TRACE_WALL_TOL = 0.05


def _union_us(spans):
    """Length of the union of [ts, ts + dur) intervals."""
    total, end = 0.0, -math.inf
    for ts, dur in sorted(spans):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


def _trace_checks(recs, num_micro, iters):
    """Every traced iteration's records: each span of the step present
    (forward, loss, backward once a microbatch), every B closed by its E
    in order, each phase inside its train-step. Returns {iteration:
    {"train_step_us", "cover", phase: [ms, ...]}}."""
    out = {}
    for it in iters:
        mine = [r for r in recs if r["iteration"] == it]
        opened, spans = {}, []
        for r in mine:
            if r["ph"] == "B":
                check(r["name"] not in opened,
                      f"trace_train: {r['name']} opened twice at {it}")
                opened[r["name"]] = r["ts"]
            elif r["ph"] == "E":
                check(r["name"] in opened,
                      f"trace_train: {r['name']} E without B at {it}")
                spans.append((r["name"], opened.pop(r["name"]), r["ts"]))
        check(not opened, f"trace_train: unclosed spans {opened} at {it}")
        names = [n for n, _, _ in spans]
        want = {"iteration": 1, "train-step": 1, "allreduce": 1,
                "optimizer": 1, "forward": num_micro, "loss": num_micro,
                "backward": num_micro}
        check({n: names.count(n) for n in want} == want
              and len(names) == sum(want.values()),
              f"trace_train: iteration {it} spans {names}")
        (_, s0, s1), = [s for s in spans if s[0] == "train-step"]
        phases = [(b, e - b) for n, b, e in spans if n in TRACE_PHASES]
        for n, b, e in spans:
            if n in TRACE_PHASES:
                check(s0 <= b <= e <= s1,
                      f"trace_train: {n} [{b}, {e}] outside train-step "
                      f"[{s0}, {s1}] at {it}")
        entry = {"train_step_us": s1 - s0,
                 "cover": _union_us(phases) / (s1 - s0)}
        for n, b, e in spans:
            entry.setdefault(n, []).append((e - b) / 1e3)
        out[it] = entry
    return out


def phase_trace_train(state):
    """MegaScan on the train path: pretrain_gpt from train's trained
    llama3-8b weights (no second model), 6 iterations, trace_interval 3,
    continuous_trace_iterations 1 (iterations 0 and 3 traced), log_interval
    1 (each step's host-synchronized wall time), run untraced twice and
    traced once, each from the same weights and a fresh optimizer."""
    import gc
    import shutil
    import statistics

    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    from megatronapp_tpu_torch.trace.aggregate import aggregate_dir
    from megatronapp_tpu_torch.trace.analytics import analyze
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    dev = torch.device("cuda", 0)
    params, cfg = state.pop("train_model")
    start = {k: v.detach().clone() for k, v in params.state_dict().items()}
    seq, micro, gbs, iters = 4096, 1, 2, 6
    num_micro = gbs // micro
    trace_dir = os.path.join(REPO, "build", "trace_smoke")
    shutil.rmtree(trace_dir, ignore_errors=True)
    runs = {}
    for name in ("untraced", "untraced_again", "traced"):
        with torch.no_grad():
            params.load_state_dict(start)
        train_cfg = TrainingConfig(
            micro_batch_size=micro, global_batch_size=gbs, seq_length=seq,
            train_iters=iters, log_interval=1, seed=1234,
            trace=name == "traced", trace_dir=trace_dir, trace_interval=3,
            continuous_trace_iterations=1)
        fa.launches.update({k: 0 for k in fa.launches})
        gc.collect()
        torch.cuda.empty_cache()
        res = pretrain_gpt(cfg, train_cfg, OptimizerConfig(), device=dev,
                           params=params, log_fn=lambda s: None)
        runs[name] = {"losses": [m["loss"] for m in res.log],
                      "step_ms": [m["step_time_ms"] for m in res.log],
                      "launches": dict(fa.launches)}
        del res
    fa.launches.update({k: 0 for k in fa.launches})
    del start, params
    gc.collect()
    torch.cuda.empty_cache()
    fname = ("benchmark-data-1-pipeline-1-tensor-1-process-0.json")
    with open(os.path.join(trace_dir, fname)) as f:
        recs = json.load(f)
    iters_traced = sorted({r["iteration"] for r in recs})
    spans = _trace_checks(recs, num_micro, iters_traced)
    trace = aggregate_dir(trace_dir)
    report = analyze(trace_dir)
    traced, u1, u2 = (runs[k]["losses"] for k in ("traced", "untraced",
                                                  "untraced_again"))
    spread = max(abs(a - b) for a, b in zip(u1, u2))
    diff = max(abs(a - b) for a, b in zip(traced, u1))
    wall = {it: runs["traced"]["step_ms"][it] for it in iters_traced}
    step_span = {it: spans[it]["train_step_us"] / 1e3 for it in iters_traced}
    last = iters_traced[-1]
    per_phase = {n: spans[last][n] for n in ("train-step",)
                 + TRACE_PHASES}
    on = statistics.median(
        ms for i, ms in enumerate(runs["traced"]["step_ms"]) if i)
    off = statistics.median(
        ms for i, ms in enumerate(runs["untraced"]["step_ms"]) if i)
    on_traced = statistics.median(
        runs["traced"]["step_ms"][i] for i in iters_traced if i)
    want = cfg.num_layers * num_micro * iters
    emit({"phase": "trace_train", "model": "llama3-8b",
          "layers": cfg.num_layers, "seq_length": seq,
          "global_batch_size": gbs, "micro_batch_size": micro,
          "iterations": iters, "trace_interval": 3,
          "continuous_trace_iterations": 1,
          "traced_iterations": iters_traced, "records": len(recs),
          "per_phase_ms_traced_iteration": {"iteration": last,
                                            **per_phase},
          "phase_cover": {it: spans[it]["cover"] for it in iters_traced},
          "train_step_span_ms": step_span,
          "host_synced_wall_ms": wall,
          "median_step_ms_tracing_on": on,
          "median_step_ms_tracing_off": off,
          "median_traced_step_ms": on_traced,
          "losses": runs, "untraced_loss_spread": spread,
          "traced_vs_untraced_loss_diff": diff,
          "x_events": len([e for e in trace["traceEvents"]
                           if e.get("ph") == "X"]),
          "analytics_phases": report["phases"],
          "analytics_iteration_time": report["iteration_time"]})
    check(iters_traced == [0, 3],
          f"trace_train: traced iterations {iters_traced} != [0, 3]")
    for it in iters_traced:
        check(spans[it]["cover"] >= TRACE_COVER,
              f"trace_train: phases cover {spans[it]['cover']:.3f} of "
              f"train-step at {it} (< {TRACE_COVER})")
        check(abs(step_span[it] - wall[it]) <= TRACE_WALL_TOL * wall[it],
              f"trace_train: train-step span {step_span[it]:.3f} ms vs "
              f"host-synchronized wall {wall[it]:.3f} ms at {it}")
    check(all(math.isfinite(x) for x in traced),
          f"trace_train: non-finite loss in {traced}")
    # Tracing adds only events and a synchronization: the traced losses
    # agree with the untraced run as closely as two untraced runs do.
    check(diff <= spread,
          f"trace_train: traced losses {traced} differ from untraced {u1} "
          f"by {diff} (two untraced runs: {spread})")
    for name, r in runs.items():
        check(r["launches"] == {"fwd": want, "bwd_dq": want,
                                "bwd_dkv": want},
              f"trace_train: {name} flash launches {r['launches']} != "
              f"{want} each (layers x micro x iterations)")


def _scope_prompts(vocab, lengths, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab - 1, n).astype(np.int32) for n in lengths]


# MegaScope: every FlagType a layer has, and the sites it turns on.
SCOPE_VIZ_FLAGS = ("QKV_mat_mul", "RawAttentionScore", "ContextLayer",
                   "MLP1", "MLP2", "Result")
SCOPE_LAYER_SITES = 7      # qkv_q, qkv_k, qkv_v, attention_probs,
#                            context, mlp1, mlp2 (+ result once a forward)
# Card (bf16) vs CPU (fp32) captures of scope_reference, each compressed
# payload held to this share of its own (CPU) RMS: bf16 weights and
# activations through two layers of width 512 move a value by well under
# a percent of its scale (the logits of phase_reference stay within 5 % of
# their range), and a 16-pixel mean averages that further.
SCOPE_REF_TOL = 0.1


def _capture_run(engine, prompt, n, sampling, viz=None, disturbance=None,
                 seed=0):
    """One generation through the static engine with `viz` flags and a
    disturbance config; returns (stream, per-step masked logits, the
    capture payloads as (site, layer, array))."""
    import numpy as np

    from megatronapp_tpu_torch.scope.disturbance import get_disturbance
    from megatronapp_tpu_torch.scope.tensor_tracer import get_tensor_tracer
    caps, logits = [], []
    tt = get_tensor_tracer()
    try:
        if viz:
            tt.set_flags_from_config(viz)
            tt.activate(lambda s, l, a: caps.append((s, l, np.asarray(a))),
                        pixels=16)
        if disturbance is not None:
            get_disturbance().configure(disturbance, seed=seed)
        out = engine.generate(prompt[None], n, sampling,
                              token_callback=lambda s, t, lg: logits.append(
                                  lg))
    finally:
        tt.deactivate()
        tt.clear_records()
        get_disturbance().clear()
    return out[0], logits, caps


def phase_scope_reference(state):
    """MegaScope on a tiny llama-shaped model (phase_reference's): the
    static engine's greedy stream and every capture payload on the card
    (bf16) against the same weights on the CPU (fp32, plain), each payload
    within SCOPE_REF_TOL of its RMS over the forward calls both sides ran
    on the same tokens (to the first divergence, which must sit at a
    near-tie of the CPU's logits); on the card, capture on against off
    and a scale-0 disturbance of every site against none, bit for bit."""
    import copy

    import numpy as np

    from megatronapp_tpu_torch.inference.engine import (
        SamplingParams, StaticInferenceEngine,
    )
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    small = dict(num_layers=2, hidden_size=512, num_attention_heads=4,
                 num_query_groups=2, ffn_hidden_size=1024, vocab_size=512,
                 init_method_std=0.05)
    cfg_ref = llama3_8b(compute_dtype=torch.float32, **small)
    cfg_dev = llama3_8b(params_dtype=torch.bfloat16, **small)
    p_ref = init_gpt_params(cfg_ref, torch.Generator().manual_seed(7), "cpu")
    p_dev = copy.deepcopy(p_ref).to(device="cuda", dtype=torch.bfloat16)
    prompt = _scope_prompts(512, [24], 11)[0]
    n, greedy = 8, SamplingParams(greedy=True)
    viz = {f: [0, 1] for f in SCOPE_VIZ_FLAGS}
    eng = {"ref": StaticInferenceEngine(p_ref, cfg_ref, max_seq_len=40,
                                        device="cpu"),
           "dev": StaticInferenceEngine(p_dev, cfg_dev, max_seq_len=40,
                                        device="cuda")}
    runs = {k: _capture_run(e, prompt, n, greedy, viz)
            for k, e in eng.items()}
    (s_ref, lg_ref, c_ref), (s_dev, lg_dev, c_dev) = runs["ref"], runs["dev"]
    new_ref, new_dev = s_ref[len(prompt):], s_dev[len(prompt):]
    diverge = next((i for i in range(n) if new_ref[i] != new_dev[i]), n)
    gap = None
    if diverge < n:
        lg = lg_ref[diverge][0]
        gap = float((lg[new_ref[diverge]] - lg[new_dev[diverge]])
                    / (lg.max() - lg.min()))
    per_call = SCOPE_LAYER_SITES * 2 + 1
    check(len(c_ref) == len(c_dev) == per_call * n,
          f"scope_reference: {len(c_ref)} / {len(c_dev)} payloads != "
          f"{per_call} x {n}")
    calls = min(diverge + 1, n)
    worst = {}
    for (s1, l1, a1), (s2, l2, a2) in zip(c_ref[:per_call * calls],
                                          c_dev[:per_call * calls]):
        check((s1, l1, a1.shape) == (s2, l2, a2.shape),
              f"scope_reference: payload {(s1, l1, a1.shape)} vs "
              f"{(s2, l2, a2.shape)}")
        rms = float(np.sqrt(np.mean(a1.astype(np.float64) ** 2)))
        err = float(np.abs(a2 - a1).max()) / max(rms, 1e-30)
        worst[s1] = max(worst.get(s1, 0.0), err)
    # Card only: capture off, and every site disturbed at scale 0.
    s_off, lg_off, c_off = _capture_run(eng["dev"], prompt, n, greedy)
    zero = {s: {"kind": "noise1", "scale": 0.0}
            for s in ("weight", "calculation", "system")}
    s_zero, lg_zero, _ = _capture_run(eng["dev"], prompt, n, greedy,
                                      disturbance=zero)
    same_off = (np.array_equal(s_off, s_dev) and not c_off and all(
        np.array_equal(a, b) for a, b in zip(lg_off, lg_dev)))
    same_zero = np.array_equal(s_zero, s_off) and all(
        np.array_equal(a, b) for a, b in zip(lg_zero, lg_off))
    emit({"phase": "scope_reference", "prompt_len": len(prompt),
          "new_tokens": n, "payloads": len(c_dev),
          "payloads_per_forward": per_call, "compared_forward_calls": calls,
          "first_divergence": diverge if diverge < n else None,
          "divergence_gap_of_range": gap,
          "worst_err_over_rms_by_site": worst,
          "tolerance_of_rms": SCOPE_REF_TOL,
          "capture_on_off_bitwise": same_off,
          "zero_disturbance_bitwise": same_zero})
    check(diverge >= 1, "scope_reference: the card's first token differs "
          "from the CPU's")
    check(gap is None or abs(gap) < 0.05,
          f"scope_reference: first divergence at token {diverge} is not a "
          f"near-tie ({gap} of the logit range)")
    for site, err in worst.items():
        check(err <= SCOPE_REF_TOL,
              f"scope_reference: {site} payload {err:.4f} of its RMS off "
              f"the CPU's (> {SCOPE_REF_TOL})")
    check(same_off, "scope_reference: capture changed the card's stream "
          "or logits")
    check(same_zero, "scope_reference: a scale-0 disturbance changed the "
          "card's stream or logits")
    del eng, p_dev


def phase_serve_static(state, layers: int):
    """The static engine behind the server (serve.py --engine static) on
    serve's llama3-8b weights (full width, `layers` deep), through the
    server's in-process visualized generation (TextGenerationServer.
    generate_streaming, what /ws runs): 3 prompts, 32 new tokens each,
    plain and with every site on for layers 0 and 1 (pixels 16); then a
    'system' disturbance and the same at scale 0."""
    import numpy as np

    from megatronapp_tpu_torch.data.tokenizers import NullTokenizer
    from megatronapp_tpu_torch.inference.engine import StaticInferenceEngine
    from megatronapp_tpu_torch.inference.server import TextGenerationServer
    params, cfg, dev = state["model"]
    max_new = 32
    prompts = _scope_prompts(cfg.vocab_size, [17, 64, 130], 5)
    engine = StaticInferenceEngine(
        params, cfg, tokenizer=NullTokenizer(cfg.vocab_size),
        max_seq_len=max(len(p) for p in prompts) + max_new, device=dev)
    srv = TextGenerationServer(engine)
    viz = {f: [0, 1] for f in SCOPE_VIZ_FLAGS}

    def run(prompt, **extra):
        frames, stamps = [], []

        def emit_frame(p):
            frames.append(p)
            if p.get("type") == "token":
                stamps.append(time.perf_counter())

        req = {"prompt": " ".join(map(str, prompt)),
               "tokens_to_generate": max_new, "greedy": True, **extra}
        text = srv.generate_streaming(req, emit_frame)[0]
        toks = [f["token"] for f in frames if f.get("type") == "token"]
        caps = [f for f in frames if "update_type" in f]
        iv = (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
        return text, toks, caps, frames, iv

    run(prompts[0][:8], visualization=viz)           # warm-up
    rows = []
    for p in prompts:
        t_plain, toks_plain, caps_plain, _, iv_plain = run(p)
        t_viz, toks_viz, caps, frames, iv_viz = run(
            p, visualization=viz, compressor={"pixels": 16})
        cands = [f for f in frames if f.get("type") == "token"]
        rows.append({"prompt_len": len(p), "stream_equal":
                     toks_viz == toks_plain and t_viz == t_plain,
                     "payloads": len(caps), "plain_payloads":
                     len(caps_plain),
                     "candidates_each": sorted({len(f["candidates"])
                                                for f in cands}),
                     "pixels": sorted({np.asarray(c["result"]).shape[-1]
                                       for c in caps}),
                     "decode_ms_plain": iv_plain,
                     "decode_ms_capture": iv_viz,
                     "tokens": toks_plain})
    sysd = {"system": {"kind": "noise1", "scale": 0.5}}
    _, toks_noise, _, _, _ = run(prompts[0], disturbance=sysd,
                                 random_seed=1, visualization={"Result": [0]})
    _, toks_zero, _, _, _ = run(prompts[0], disturbance={
        "system": {"kind": "noise1", "scale": 0.0}}, random_seed=1,
        visualization={"Result": [0]})
    want = (SCOPE_LAYER_SITES * 2 + 1) * max_new
    emit({"phase": "serve_static", "model": "llama3-8b", "layers": layers,
          "full_width": True, "params_dtype": "bf16",
          "max_seq_len": engine.max_seq_len, "max_new_tokens": max_new,
          "visualization": viz, "requests": [
              {k: v for k, v in r.items() if k != "tokens"} for r in rows],
          "expected_payloads": want,
          "system_disturbance_changed_stream": toks_noise != rows[0][
              "tokens"],
          "zero_disturbance_same_stream": toks_zero == rows[0]["tokens"]})
    for r in rows:
        check(r["stream_equal"], "serve_static: the stream with capture "
              f"differs from the stream without (prompt {r['prompt_len']})")
        check(len(r["tokens"]) == max_new and all(
            0 <= t < cfg.vocab_size for t in r["tokens"]),
            f"serve_static: stream {r['tokens']}")
        check(r["payloads"] == want and r["plain_payloads"] == 0,
              f"serve_static: {r['payloads']} payloads != {want} "
              f"(({SCOPE_LAYER_SITES} sites x 2 layers + result) x "
              f"{max_new} forward calls)")
        check(r["candidates_each"] == [20] and r["pixels"] == [16],
              f"serve_static: candidates {r['candidates_each']}, pixels "
              f"{r['pixels']}")
    check(toks_noise != rows[0]["tokens"],
          "serve_static: a 'system' disturbance left the stream unchanged")
    check(toks_zero == rows[0]["tokens"],
          "serve_static: a scale-0 disturbance changed the stream")
    del srv, engine


def phase_scope_train(state):
    """TrainingScopeSession.run_step at llama3-8b width, 2 layers, S 2048
    (the flash kernels run: attention_probs is never formed there), every
    flag on layer 0 and a 'calculation' disturbance on layer 1, then a
    plain step: JAX's wire format (update_type, layer_id, site, result,
    then step_done) and finite losses."""
    import gc

    import numpy as np

    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    from megatronapp_tpu_torch.scope.client import validate_payloads
    from megatronapp_tpu_torch.scope.hooks import _SITE_TO_FLAG
    from megatronapp_tpu_torch.scope.ws_server import TrainingScopeSession
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama3_8b(num_layers=2)
    session = TrainingScopeSession(
        cfg, TrainingConfig(micro_batch_size=1, global_batch_size=1,
                            seq_length=2048, train_iters=10),
        OptimizerConfig(), device="cuda")
    viz = {f: [0] for f in SCOPE_VIZ_FLAGS}
    fa.launches.update({k: 0 for k in fa.launches})
    t0 = time.perf_counter()
    frames = session.run_step(
        viz, {"calculation": {"kind": "noise2", "scale": 0.05,
                              "layers": [1]}}, {"pixels": 16})
    step_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    plain = session.run_step()
    fa.launches.update({k: 0 for k in fa.launches})
    caps = [f for f in frames if "update_type" in f]
    emit({"phase": "scope_train", "model": "llama3-8b", "layers": 2,
          "seq_length": 2048, "visualization": viz,
          "frames": [{k: (np.asarray(v).shape if k == "result" else v)
                      for k, v in f.items() if k != "points"}
                     for f in frames],
          "step_s_with_capture": step_s, "flash_launches": launches,
          "plain_step": plain})
    validate_payloads(frames, {f: l for f, l in viz.items()
                               if f != "RawAttentionScore"})
    check([(c["site"], c["layer_id"]) for c in caps] == [
        ("qkv_q", 0), ("qkv_k", 0), ("qkv_v", 0), ("context", 0),
        ("mlp1", 0), ("mlp2", 0), ("result", -1)],
        f"scope_train: captures {[(c['site'], c['layer_id']) for c in caps]}")
    for c in caps:
        check(c["update_type"] == int(_SITE_TO_FLAG[c["site"]])
              and np.asarray(c["result"]).shape[-1] == 16
              and bool(np.isfinite(np.asarray(c["result"])).all()),
              f"scope_train: payload {c['site']} {c['update_type']}")
    check(frames[-1]["type"] == "step_done" and frames[-2]["type"] == "pca"
          and math.isfinite(frames[-1]["loss"])
          and plain == [plain[-1]] and math.isfinite(plain[-1]["loss"]),
          f"scope_train: summaries {frames[-1]} / {plain}")
    check(launches == {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2},
          f"scope_train: flash launches {launches} != 2 each")
    del session
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_gpt2(state):
    """pretrain_gpt on gpt2-125m at full width and depth (MHA, D 64, tied
    embeddings) as a user runs it with --attention-impl pallas
    --flash-head-fold: S 1024, global batch 8 of micro-batches of 4, 3
    steps, which runs the flash kernels at D 64 (the TPU kernels' D < 128
    and head-fold variants) on a train path; then two profiled steps'
    device time by kernel family (host-clock steps of this small model
    spread wider than a kernel's gain)."""
    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu_torch.data.mock import mock_batches
    from megatronapp_tpu_torch.models.presets import gpt2_125m
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    from megatronapp_tpu_torch.training.optimizer import Optimizer
    from megatronapp_tpu_torch.training.train import (
        gpt_microbatch_loss, pretrain_gpt, reshape_global_batch,
    )
    from megatronapp_tpu_torch.training.train_step import (
        make_train_step, to_device_batch,
    )
    from megatronapp_tpu_torch.utils.flops import flops_per_token
    dev = torch.device("cuda", 0)
    cfg = gpt2_125m(attention_impl="pallas", flash_head_fold=True)
    seq, micro, gbs, steps = 1024, 4, 8, 3
    lines = []
    for k in fa.launches:
        fa.launches[k] = 0
    res = pretrain_gpt(cfg, TrainingConfig(
        micro_batch_size=micro, global_batch_size=gbs, seq_length=seq,
        train_iters=steps, log_interval=1, seed=1234), OptimizerConfig(),
        device=dev, log_fn=lines.append)
    launches = dict(fa.launches)
    # Beyond the main path (not counted there): two profiled steps.
    batch = next(mock_batches(seq, cfg.vocab_size, gbs, seed=99))
    batch = to_device_batch(reshape_global_batch(
        {k: batch[k] for k in ("tokens", "labels", "loss_mask")},
        gbs // micro), dev)
    step_fn = make_train_step(gpt_microbatch_loss(cfg),
                              Optimizer(OptimizerConfig(), steps + 6))
    step_fn(res.state, batch)
    prof = _device_profile(lambda: [step_fn(res.state, batch)
                                    for _ in range(2)], 2,
                           TRAIN_FAMILIES, _train_family, top_kernels=10)
    fa.launches.update({k: 0 for k in fa.launches})
    losses = [m["loss"] for m in res.log]
    expected0 = math.log(cfg.vocab_size) + (
        cfg.init_method_std ** 2 * cfg.hidden_size / 2)
    step_ms = [m["step_time_ms"] for m in res.log[1:]]
    tok_s = gbs * seq / (sum(step_ms) / len(step_ms) / 1e3)
    state["train_gpt2_launches"] = launches
    del res, batch, step_fn
    torch.cuda.empty_cache()
    emit({"phase": "train_gpt2", "model": "gpt2-125m",
          "layers": cfg.num_layers, "seq_length": seq,
          "micro_batch_size": micro, "global_batch_size": gbs,
          "steps": steps, "attention_impl": "pallas",
          "flash_head_fold": True, "losses": losses,
          "expected_first_loss": expected0, "log": lines,
          "launches": launches, "step_ms": step_ms, "tokens_per_s": tok_s,
          "mfu": tok_s * flops_per_token(cfg, seq) / BF16_FLOPS_PER_S,
          "profiled_steps": prof})
    check(all(math.isfinite(x) for x in losses),
          f"train_gpt2: non-finite loss in {losses}")
    check(abs(losses[0] - expected0) < 0.5,
          f"train_gpt2: first loss {losses[0]} not within 0.5 of "
          f"{expected0}")
    want = cfg.num_layers * (gbs // micro) * steps
    check(launches == {"fwd": want, "bwd_dq": want, "bwd_dkv": want},
          f"train_gpt2: expected {want} launches of each flash kernel, "
          f"got {launches}")


def _attn_bytes_flops(q, k, causal, kernel):
    """Bytes each input read once and each output written once, and the
    multiply-add operations this run's (causal) pairs need."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    pairs = b * (s * (s + 1) // 2 if causal else s * s)
    qb, kvb, rows = b * s * hq * d * 2, b * s * hkv * d * 2, b * hq * s * 4
    if kernel == "fwd":   # q, k, v → out, lse; QK and PV
        return 2 * qb + 2 * kvb + rows, 2 * 2 * pairs * hq * d
    if kernel == "bwd_dq":   # q, k, v, g, lse, delta → dq; s, dp, dq
        return 3 * qb + 2 * kvb + 2 * rows, 3 * 2 * pairs * hq * d
    # q, k, v, g, lse, delta → dk, dv; s, dp, dv, dk
    return 2 * qb + 4 * kvb + 2 * rows, 4 * 2 * pairs * hq * d


FLASH_TIMED_SHAPES = {
    # name: (b, s, hq, hkv, d): the two train paths' attention shapes.
    "llama3_8b": (1, 4096, 32, 8, 128),
    "gpt2_125m": (4, 1024, 12, 12, 64),
}


def _flash_time_shape(b, s, hq, hkv, d):
    """The flash kernels at one causal shape, their plain versions on the
    same bf16 inputs, and PyTorch's scaled_dot_product_attention as the
    yardstick (timed only; the port never calls it)."""
    import torch.nn.functional as F

    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    dev = torch.device("cuda", 0)
    q, k, v, g, _ = _flash_inputs(torch.Generator().manual_seed(5), dev,
                                  b, s, hq, hkv, d)
    out, lse = fa.flash_forward(q, k, v, True)
    delta = fa.attention_delta(out, g)
    bargs = (q, k, v, g, lse, delta, True)
    calls = {
        "fwd": (lambda: fa.flash_forward(q, k, v, True),
                lambda: fa.flash_forward_plain(q, k, v, True)),
        "bwd_dq": (lambda: fa.flash_bwd_dq(*bargs),
                   lambda: fa.flash_bwd_dq_plain(*bargs)),
        "bwd_dkv": (lambda: fa.flash_bwd_dkv(*bargs),
                    lambda: fa.flash_bwd_dkv_plain(*bargs)),
    }
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    gt = g.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=hq != hkv)

    def sdpa_fwd():
        with torch.no_grad():
            sdpa()

    lib_out = sdpa()

    def sdpa_bwd():
        torch.autograd.grad(lib_out, (qt, kt, vt), gt, retain_graph=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), gt)

    # Kernels and library calls queued behind a sleep (device_ms): at the
    # D 64 shape a call runs for less than its host time.
    lib_fwd = device_ms(sdpa_fwd, calls=10)
    lib_bwd = device_ms(sdpa_bwd, calls=10)
    lib_fwd_bwd = device_ms(sdpa_fwd_bwd, calls=10)
    rows = {}
    for name, (kern, plain) in calls.items():
        # plain, kernel, kernel, plain: compare within one card and call.
        p1 = cuda_time_ms(plain, iters=3, warmup=1)
        k1 = device_ms(kern, calls=10)
        k2 = device_ms(kern, calls=10)
        p2 = cuda_time_ms(plain, iters=3, warmup=1)
        nbytes, flops = _attn_bytes_flops(q, k, True, name)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        rows[name] = {
            "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
            "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
            "library_ms": lib_fwd if name == "fwd" else lib_bwd,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}
    return {"shape": {"b": b, "s": s, "hq": hq, "hkv": hkv, "d": d,
                      "causal": True},
            "library": {"sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
                        "sdpa_fwd_bwd_ms": lib_fwd_bwd,
                        "note": "the backward computes dq, dk and dv in "
                                "one call; it is the library time of both "
                                "backward kernels"},
            **rows}


def _flash_times(state):
    """Each flash kernel at both train paths' shapes; the llama3-8b rows
    (the main train path) go to the kernel table."""
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    before = dict(fa.launches)
    out = {name: _flash_time_shape(*shape)
           for name, shape in FLASH_TIMED_SHAPES.items()}
    fa.launches.update(before)
    state["flash_times"] = {k: out["llama3_8b"][k]
                            for k in ("fwd", "bwd_dq", "bwd_dkv")}
    return out


def kernel_table(state):
    launches = state.get("launches", {})
    out = []
    for mode in ("decode", "ragged"):
        t = state.get("times", {}).get(mode, {})
        out.append({
            "name": f"paged_attention_{mode}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": launches.get(mode),
            "max_abs_err": state.get("max_abs_err", {}).get(mode),
            "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms")})
    for kind in QUANT_KINDS:
        for mode in ("decode", "ragged"):
            key = f"{mode}_{kind}"
            t = state.get("quant_times", {}).get(key, {})
            out.append({
                "name": f"paged_attention_{key}", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": QUANT_REPLACES,
                "launches": state.get("quant_launches", {}).get(key),
                "max_abs_err": state.get("quant_err", {}).get(key),
                "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
                "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
                "library_ms": t.get("library_ms")})
    # The speculative verify step's shapes (serve_spec's launches).
    spec = state.get("spec_launches", {})
    for kind in ("", "_int8", "_fp8"):
        t = (state.get("times", {}).get("verify", {}) if not kind else
             state.get("quant_times", {}).get(f"verify{kind}", {}))
        out.append({
            "name": f"paged_attention_verify{kind} (B 8, S_q 5)",
            "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": QUANT_REPLACES if kind else REPLACES,
            "launches": spec.get(f"verify{kind}"),
            "max_abs_err": (state.get("quant_err", {}).get(f"ragged{kind}")
                            if kind else state.get("max_abs_err", {}).get(
                                "ragged")),
            "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms")})
    for variant, times, launches, errs in (
            ("", "fused_times", "fused_launches", "fused_err"),
            ("_int8", "fused_int8_times", "fused_int8_launches",
             "fused_int8_err")):
        for kernel in FUSED_KERNELS:
            t = state.get(times, {}).get(8, {}).get(kernel, {})
            out.append({
                "name": f"fused_{kernel}{variant}", "route": "cuda",
                "source": FUSED_SOURCE,
                "replaces": FUSED_REPLACES[kernel] + (
                    " (resident int8 weights)" if variant else ""),
                "launches": state.get(launches, {}).get(kernel),
                "max_abs_err": state.get(errs, {}).get(kernel),
                "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
                "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
                "library_ms": t.get("library_ms")})
    for variant, times, errs in (("", "fused_times", "fused_err"),
                                 ("_int8", "fused_int8_times",
                                  "fused_int8_err")):
        for kernel in FUSED_KERNELS:
            t = state.get(times, {}).get(VERIFY_ROWS, {}).get(kernel, {})
            out.append({
                "name": f"fused_{kernel}{variant}_verify ({VERIFY_ROWS} "
                        "rows)", "route": "cuda", "source": FUSED_SOURCE,
                "replaces": FUSED_REPLACES[kernel] + (
                    " (resident int8 weights)" if variant else ""),
                "launches": spec.get(f"fused{variant}_verify"),
                "max_abs_err": state.get(errs, {}).get(kernel),
                "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
                "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
                "library_ms": t.get("library_ms")})
    lt = state.get("lora_times", {}).get("rows8_mixed", {}).get(
        "layer_sum", {})
    for kind, other, what in (
            ("shrink", "expand", "t = x @ A: one layer's four launches"),
            ("expand", "shrink", "t @ B: one layer's five launches")):
        t = lt.get(kind, {})
        out.append({
            "name": f"lora_{kind} ({what}, 8 rows)", "route": "cuda",
            "source": LORA_SOURCE,
            "replaces": f"{LORA_REPLACES}, with lora_{other}",
            "launches": state.get("lora_launches", {}).get(f"lora_{kind}"),
            "max_abs_err": state.get("lora_err", {}).get(kind),
            "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": "bytes",
            "library_ms": t.get("library_ms")})
    for variant, times in (("", "fused_lora_times"),
                           ("_int8", "fused_int8_lora_times")):
        for kernel in FUSED_KERNELS:
            t = state.get(times, {}).get(8, {}).get(kernel, {})
            out.append({
                "name": f"fused_{kernel}{variant}_lora", "route": "cuda",
                "source": FUSED_SOURCE,
                "replaces": LORA_EPILOGUE_REPLACES[kernel] + (
                    " (resident int8 weights)" if variant else ""),
                "launches": state.get("lora_epilogue_launches", {}).get(
                    kernel + variant),
                "max_abs_err": state.get("lora_epilogue_err", {}).get(
                    kernel + variant),
                "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
                "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
                "library_ms": t.get("library_ms")})
    for kind in ("", "_int8", "_fp8"):
        for mode in ("decode", "ragged"):
            key = mode + kind
            t = state.get("mla_latent_times", {}).get(key, {})
            out.append({
                "name": f"paged_attention_latent_{key}", "route": "cuda",
                "source": MLA_LATENT_SOURCE,
                "replaces": MLA_LATENT_REPLACES + (
                    f" ({kind[1:]} pools: lat_scales/pe_scales)"
                    if kind else ""),
                "launches": state.get("mla_launches", {}).get(key),
                "max_abs_err": state.get("mla_latent_err", {}).get(key),
                "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
                "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
                "library_ms": t.get("library_ms")})
    for kind in ("", "_int8", "_fp8"):
        t = state.get("mla_latent_times", {}).get(f"verify{kind}", {})
        out.append({
            "name": f"paged_attention_latent_verify{kind} (B 8, S_q 4)",
            "route": "cuda", "source": MLA_LATENT_SOURCE,
            "replaces": MLA_LATENT_REPLACES + (
                f" ({kind[1:]} pools: lat_scales/pe_scales)" if kind
                else ""),
            "launches": spec.get(f"latent_verify{kind}"),
            "max_abs_err": state.get("mla_latent_err", {}).get(
                f"ragged{kind}"),
            "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms")})
    for kernel in ("scores", "wsum"):
        for kind in ("", "_int8", "_fp8"):
            for mode in ("decode", "ragged"):
                t = state.get("tp_times", {}).get(mode + kind, {}).get(
                    kernel, {})
                out.append({
                    "name": f"latent_block_{kernel}_{mode}{kind}",
                    "route": "cuda", "source": LATENT_TP_SOURCE,
                    "replaces": LATENT_TP_REPLACES[kernel] + (
                        f" ({kind[1:]} pools: per-row scales)"
                        if kind else ""),
                    "launches": state.get("tp_launches", {}).get(
                        kernel + kind),
                    "max_abs_err": state.get("tp_err", {}).get(
                        f"{kernel}_{mode}{kind}"),
                    "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
                    "bound_ms": t.get("bound_ms"),
                    "bound_by": t.get("bound_by"),
                    "library_ms": t.get("library_ms")})
    t = state.get("mla_prologue_times", {}).get(8, {})
    out.append({
        "name": "fused_mla_qkv (launches: mla_down + mla_up, 8 rows)",
        "route": "cuda", "source": MLA_PROLOGUE_SOURCE,
        "replaces": MLA_PROLOGUE_REPLACES,
        "launches": state.get("mla_prologue_launches"),
        "max_abs_err": state.get("mla_prologue_err"),
        "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
        "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
        "library_ms": t.get("library_ms")})
    for kernel in ("fwd", "bwd_dq", "bwd_dkv"):
        t = state.get("flash_times", {}).get(kernel, {})
        out.append({
            "name": f"flash_{kernel}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[kernel],
            "launches": state.get("train_launches", {}).get(kernel),
            "max_abs_err": state.get("flash_err", {}).get(kernel),
            "ms": t.get("kernel_ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms")})
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="llama3-8b depth for the serve and profile phases "
                         "(widths are never cut)")
    ap.add_argument("--train-layers", type=int, default=4,
                    help="llama3-8b depth for the train phase (full width; "
                         "full depth does not fit one card's 80 GB with "
                         "fp32 params, grads and Adam state)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False) — this smoke runs only on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import megatronapp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {}
    try:
        phase_device(state)
        phase_kernels(state)
        phase_reference(state)
        phase_fused_kernels(state)
        phase_fused_reference(state)
        phase_kv_quant_kernels(state)
        phase_fused_int8_kernels(state)
        phase_quant_reference(state)
        phase_lora_kernels(state)
        phase_lora_reference(state)
        phase_mla_kernels(state)
        phase_mla_reference(state)
        phase_spec_reference(state)
        phase_tp_kernels(state)
        phase_train_kernels(state)
        phase_train_reference(state)
        phase_train(state, args.train_layers)
        phase_trace_train(state)
        phase_scope_train(state)
        phase_train_gpt2(state)
        phase_scope_reference(state)
        phase_serve(state, args.layers)
        phase_serve_static(state, args.layers)
        phase_serve_fused(state)
        phase_serve_quant(state)
        phase_serve_lora(state)
        phase_serve_spec(state, args.layers)
        phase_serve_mla(state)
        phase_profile(state)
        phase_times(state)
        phase_tp_times(state)
        phase_serve_tp(state, args.layers)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit(kernel_table(state))
    print(state.get("smi") or nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
