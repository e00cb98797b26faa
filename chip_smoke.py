"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, all 32 llama3-8b layers
    python3 chip_smoke.py --layers 4 # the same with the served depth cut

Phases, each printing one JSON line:

1. device:  the card (nvidia-smi name and power limit) and the kernel
            build from the sources in the checkout (nvcc, sm_90a).
2. kernels: the paged-attention kernel against its plain PyTorch version
            on the card, decode and ragged modes, at llama3-8b attention
            shapes and one gpt2-125m (MHA, D=64) shape.
3. reference: a tiny llama-shaped model's chunked-prefill logits on the
            card (bf16, kernel) against the same weights on the CPU
            (fp32, plain versions).
4. serve:   llama3-8b at full width (random bf16 weights from a seed) behind
            the continuous-batching driver: 8 concurrent greedy requests,
            checked for length, vocabulary, launch counts, a prefix-cache
            hit and a rerun that repeats the streams.
5. profile: device time by kernel family through the same engine at the
            slice's shapes: the prefill of one 1008-token prompt, then
            decode steps with 8 slots at kv ~1024.
6. times:   the kernel, its plain version, one PyTorch attention call and
            the card's bound, at the shapes the engine launches.

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
# Timing loops rotate through page tables whose K/V span this many bytes.
TIMED_POOL_BYTES = 3 * L2_BYTES


class SmokeFailure(RuntimeError):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
              q_lens=None, pool_bytes=0):
    """Random bf16 q, one K/V pool and R disjoint shuffled page tables
    [R, B, MB] into it ("table" is the first). R is 1 unless pool_bytes
    asks for more: timing loops then rotate through tables whose K/V
    together exceed the L2 cache, so each launch finds its pages cold, as
    a step does moving from layer to layer."""
    mb = max(math.ceil(n / bs) for n in kv_lens)
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
    """Bytes the function must move: each valid K/V row read once, q read
    once, the output written once, plus the page table and lengths."""
    rows = int(case["kv_lens"].sum())
    return (2 * rows * hkv * d * 2 + 2 * case["q"].numel() * 2
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
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    t0 = time.perf_counter()
    built = pa.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "ptxas info" in ln]
    state["smi"] = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": state["smi"],
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3), "ptxas": ptxas})


def _compare(case, mode):
    """Kernel vs fp32 plain version; returns (max abs error, max error
    over the (row, head)'s output RMS)."""
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    ql = case.get("q_lens")
    out = pa.paged_attention(case["q"], case["k"], case["v"],
                             case["table"], case["kv_lens"], q_lens=ql)
    torch.cuda.synchronize()
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
    return max_err, max_rel


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
    # These comparison launches are not main-path launches.
    pa.launches.update(before)
    state["max_abs_err"] = {
        mode: max(v[0] for k, v in results.items() if k.startswith(mode))
        for mode in ("decode", "ragged")}
    emit({"phase": "kernels", "rel_tol": REL_TOL,
          "max_abs_err": {k: v[0] for k, v in results.items()},
          "max_err_over_row_rms": {k: v[1] for k, v in results.items()}})


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


def _serve_once(driver, prompts, max_new, sampling):
    """Submit every prompt from its own thread; returns (streams,
    per-request first/last token times, t_submit, t_done)."""
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
                    time.perf_counter()))
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


def _engine(params, cfg, dev):
    from megatronapp_tpu_torch.data.tokenizers import NullTokenizer
    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    return DynamicInferenceEngine(
        params, cfg, tokenizer=NullTokenizer(cfg.vocab_size), max_batch=8,
        max_seq_len=2048, paged=True, block_size=16, prefill_chunk=32,
        device=dev)


def phase_serve(state, layers: int):
    import numpy as np

    from megatronapp_tpu_torch.inference.engine import SamplingParams
    from megatronapp_tpu_torch.inference.server import DynamicBatchingDriver
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
    driver = DynamicBatchingDriver(engine)
    greedy = SamplingParams(greedy=True)
    max_new = 32

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size - 1, 256)
    lengths = [17, 64, 130, 300, 450, 700]
    prompts = [rng.integers(0, cfg.vocab_size - 1, n) for n in lengths]
    prompts += [np.concatenate([shared, rng.integers(0, cfg.vocab_size - 1,
                                                     n)])
                for n in (40, 200)]
    prompts = [p.astype(np.int32) for p in prompts]

    # Warm-up (cuBLAS handles, allocator) outside the counted run.
    rid, done = driver.submit(rng.integers(0, 1000, 20).astype(np.int32), 4,
                              greedy)
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


FAMILIES = ("paged_attention", "gemm", "memcpy/memset", "other")


def _family(name: str) -> str:
    name = name.lower()
    if "paged_attention" in name:
        return "paged_attention"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass",
                               "matmul")):
        return "gemm"
    if "memcpy" in name or "memset" in name:
        return "memcpy/memset"
    return "other"


def _device_profile(fn, units: int) -> dict:
    """fn() under torch.profiler (device activity only): the window's
    wall time, device busy time and idle share, and device time and
    kernel count by kernel family, in all and per unit (chunk or step)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = dict.fromkeys(FAMILIES, 0.0)
    n = dict.fromkeys(FAMILIES, 0)
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        fam = _family(e.name)
        ms[fam] += e.time_range.elapsed_us() / 1e3
        n[fam] += 1
    busy = sum(ms.values())
    return {"units": units, "window_ms": wall_ms,
            "wall_ms_per_unit": wall_ms / units, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else
            "not measured (the profiler saw no device events)",
            "device_ms_per_unit_by_family": {k: v / units
                                             for k, v in ms.items()},
            "device_ms_by_family": ms, "kernels_by_family": n,
            "paged_attention_ms_per_launch":
                ms["paged_attention"] / n["paged_attention"]
                if n["paged_attention"] else None}


def phase_profile(state):
    """Where a step's device time goes at the slice's shapes, through the
    serving engine's own step() (called here from the main thread, not
    from the driver's stepper): the prefill of one 1008-token prompt (32
    ragged chunks at kv 32..1008; the window also holds that slot's first
    decode step), then 16 decode steps with 8 slots at kv ~1024."""
    import numpy as np

    from megatronapp_tpu_torch.inference.engine import SamplingParams
    params, cfg, dev = state.pop("model")
    engine = _engine(params, cfg, dev)
    rng = np.random.default_rng(1)
    prompt_len, chunk, steps = 1008, 32, 16
    prompts = [rng.integers(0, cfg.vocab_size - 1, prompt_len).astype(
        np.int32) for _ in range(8)]
    greedy = SamplingParams(greedy=True)

    engine.add_request(prompts[0], 64, greedy)
    chunks0 = engine.prefill_chunks
    prefill = _device_profile(engine.step, math.ceil(prompt_len / chunk))
    check(engine.prefill_chunks - chunks0 == prefill["units"],
          "profile: the prefill window ran another number of chunks")
    for p in prompts[1:]:
        engine.add_request(p, 64, greedy)
    for _ in range(3):              # prefill the other seven, then warm up
        engine.step()
    check(all(r is not None and not r.finished for r in engine.slots),
          "profile: not every slot is decoding")
    steps0 = engine.decode_steps
    decode = _device_profile(lambda: [engine.step() for _ in range(steps)],
                             steps)
    check(engine.decode_steps - steps0 == steps,
          "profile: the decode window ran another number of steps")
    kv_after = [int(x) for x in engine.lengths]
    engine.abort_all()
    del engine
    torch.cuda.empty_cache()
    emit({"phase": "profile", "model": "llama3-8b",
          "layers": cfg.num_layers,
          "prefill_one_prompt": {"prompt_len": prompt_len, "chunk": chunk,
                                 **prefill},
          "decode_8_slots": {"kv_lens_after": kv_after, **decode}})


def _sdpa_call(case, hq, hkv, nxt):
    """One PyTorch attention call on K/V gathered in advance for every
    page table of the case (uniform kv_lens), rotating like the kernel:
    the yardstick; the port never calls it."""
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

    k, v = gather(case["k"]), gather(case["v"])
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

    def kernel():
        pa.paged_attention(case["q"], case["k"], case["v"], tables[nxt()],
                           case["kv_lens"], q_lens=ql)

    def plain():
        pa.paged_attention_plain(case["q"], case["k"], case["v"],
                                 tables[nxt()], case["kv_lens"], q_lens=ql)

    lib = _sdpa_call(case, hq, hkv, nxt)
    # plain, kernel, kernel, plain: compare within one card and call.
    p1 = cuda_time_ms(plain, iters=10)
    k1 = cuda_time_ms(kernel)
    k2 = cuda_time_ms(kernel)
    p2 = cuda_time_ms(plain, iters=10)
    lib_ms = cuda_time_ms(lib)
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
            "page_tables_rotated": tables.shape[0]}


def phase_times(state):
    """Each mode at the shape the engine launches it: decode with B =
    max_batch = 8 at kv 1024, ragged with B = 1 (the engine prefills one
    request per chunk) and S_q = 32, at kv 1024 and across the prompt
    range; ragged at B = 8 as a second, labelled row."""
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(99)
    before = dict(pa.launches)
    hq, hkv, d, bs = 32, 8, 128, 16

    def case(batch, kv, s_q=None):
        return make_case(gen, dev, batch=batch, hq=hq, hkv=hkv, d=d, bs=bs,
                         kv_lens=[kv] * batch, s_q=s_q,
                         q_lens=None if s_q is None else [s_q] * batch,
                         pool_bytes=TIMED_POOL_BYTES)

    rows = {"decode": _time_case(case(8, 1024), hq, hkv, d, bs),
            "ragged": _time_case(case(1, 1024, 32), hq, hkv, d, bs)}
    by_kv = {kv: _time_case(case(1, kv, 32), hq, hkv, d, bs)
             for kv in (32, 256, 512)}
    by_kv[1024] = rows["ragged"]
    b8 = _time_case(case(8, 1024, 32), hq, hkv, d, bs)
    pa.launches.update(before)
    state["times"] = rows
    emit({"phase": "times", "nvidia_smi": state.get("smi"),
          "l2": f"cold: each launch reads pages of another table, the "
                f"tables' K/V spanning >= {TIMED_POOL_BYTES} bytes",
          **rows,
          "ragged_b1_by_kv": {
              kv: {k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                     "bound_ms")}
              for kv, r in sorted(by_kv.items())},
          "ragged_b8_not_a_main_path_shape": b8})


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
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="llama3-8b depth for the serve and profile phases "
                         "(widths are never cut)")
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
        phase_serve(state, args.layers)
        phase_profile(state)
        phase_times(state)
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
