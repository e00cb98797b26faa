"""Measurements of the attention kernels on one CUDA card that the smoke
run (chip_smoke.py) does not make. From the repository root:

    python3 -m megatronapp_tpu_torch.tools.flash_probe fwd-tiles
        flash_fwd built with each of its tile choices (64 or 128 q rows a
        block, 64 or 128 kv rows a ring stage; copies of the source under
        build/, FwdTiles fixed to each), timed in turns at
        FLASH_TIMED_SHAPES; the choices that keep the kv tile compared bit
        for bit (out and lse).
    python3 -m megatronapp_tpu_torch.tools.flash_probe dkv-rows
        flash_bwd_dkv built with 64 and with 128 kv rows a block (copies
        of the source under build/, dkv_rows<D>() fixed to each), timed in
        turns (64, 128, 128, 64) at FLASH_TIMED_SHAPES; the two results
        compared bit for bit.
    python3 -m megatronapp_tpu_torch.tools.flash_probe paged-splits
        the paged-attention kernel on bf16, int8 and fp8 pools with its kv
        split count fixed to each of a few values, timed in turns at the
        times phase's decode (B 8) and ragged (B 1, S_q 32) shapes at kv
        1024, and with the engine's 2048-position tables, L2-cold; each
        count's output against the first count's.
    python3 -m megatronapp_tpu_torch.tools.flash_probe quant-flips --parent DIR
        the quantized paged kernel of the checkout in DIR (built from its
        own csrc/) and of this one on chip_smoke.py's kv_quant_kernels
        cases: each one's errors against the fp32 plain version, the share
        of elements whose bf16 differs from bf16(plain) and by how many
        ulps (chip_smoke.quant_errors).
    python3 -m megatronapp_tpu_torch.tools.flash_probe prologue-variants
        the fused MLA prologue built with other ring depths, stage sizes
        and tile widths (copies of the source under build/), each timed in
        turns at 8 and 32 rows over 4 full-width MLA layers (L2-cold), with
        mla_down's and mla_up's device time apart (torch.profiler).
    python3 -m megatronapp_tpu_torch.tools.flash_probe fused-variants
        the four fused kernels (QKV, out-projection, fc1, fc2: one
        tensor-core tile core in fused_decode.cu) built with other ring
        stage sizes and depths (deeper rings and longer stages for fc1's
        and fc2's long K too), the norm statistics shared once a launch at
        both row blocks or at none, and ablations that stub one piece each
        (the norm statistics, the split sums, the normalisation, the mma;
        their outputs are not the function's), copies of the source under
        build/; then the K-split plan at other blocks an SM. Each timed in
        turns at llama3-8b's shapes, 8 and 32 rows, bf16 and resident int8
        weights, over 8 layers (L2-cold), with each kernel's (K, tiles)
        and ksplit; each output against the source's own.
    python3 -m megatronapp_tpu_torch.tools.flash_probe lora-splits
        the LoRA shrink kernel with its k's a split (kper) fixed to each of
        a few values, timed in turns at the llama3-8b LoRA targets' din
        (4096 and fc2's 14336), rank 8, 8 rows on chip_smoke.py's mixed
        adapters and a 32-row chunk of one, rotating through 32 layers of
        banks (L2-cold); each count's t against the default's.
    python3 -m megatronapp_tpu_torch.tools.flash_probe latent-splits
        the tensor-parallel latent kernels (rows 8 and 9) at chip_smoke.py's
        tp_times shapes (one rank's 256 latent columns; decode B 8 and a
        B 1, S_q 32 chunk at kv 1024; bf16, int8 and fp8 pools; page
        tables rotated beyond the L2 cache). Row 9 with its split plan
        forced to each of a few token-split counts (and row tiles at the
        chunk), each with the splits added by the second launch and by a
        thread-block cluster of a unit's splits in distributed shared
        memory (cluster: patched into a copy of the source, as
        _LATENT_CLUSTER says); row 8 built with other
        block tiles and ring depths (copies of the source under build/,
        kScoreTiles and kScoreRing fixed to each); both kernels also with
        ablations that stub one piece each (page reads, the products, the
        stores, the second launch's gather, its programmatic dependent
        launch; their outputs are not the function's). Each variant timed in turns (and again in reverse), its
        output against the first variant's; the default plan's device time
        by kernel (torch.profiler).
    python3 -m megatronapp_tpu_torch.tools.flash_probe paged-latent-splits
        the MLA latent kernel (row 7: split kernel + combine-and-expand)
        at chip_smoke.py's times shapes (decode B 8 and a B 1, S_q 32
        chunk at kv 1024; bf16, int8 and fp8 pools; page tables rotated
        beyond the L2 cache), on 1024- and 2048-position tables: its split
        plan forced to 4, 8 and 16 splits (and 32- or 64-row tiles at the
        chunk); copies of the source under build/ with P in the other
        counts of 1-3 bf16 terms (kPTerms), and (kTiles) three 32-token
        ring stages at 32 rows (decode) or two at 64 rows (the chunk); on
        1024-position tables, ablations
        that stub one piece each (page reads, the score products, the
        P.latent products, the partials' stores, the combine's gather, its
        products, its programmatic dependent launch, the whole combine;
        their outputs are not the function's). Each variant timed in turns
        (and again in reverse), its error against the plain version
        (chip_smoke.py's rule: max |out - plain| over max(|plain element|,
        row RMS)); each kernel's device time (torch.profiler, with and
        without the dependent launch) and the launch floor.
    python3 -m megatronapp_tpu_torch.tools.flash_probe paged-latent-timeline
        row 7 with a timeline patched into a copy of the source (thread 0
        of every block records %globaltimer at entry and exit and clock64
        at each phase: the split kernel's prologue, kv_len, the first
        stage's loads landing, its scores, softmax and P.latent, the
        partials' stores; the combine's w_v staging, its wait, weights,
        gather, expansion and stores), at the times shapes on bf16 and
        int8 pools: per phase the median and largest cycles over blocks,
        and when the blocks of each kernel started and ended.
    python3 -m megatronapp_tpu_torch.tools.flash_probe fused-ab --parent DIR
        the four fused kernels of the checkout in DIR and of this one,
        each tree's own wrappers, split plan and kernels (chip_smoke.py's
        _fused_times: 8 and 32 rows, bf16 and resident int8 weights, over
        8 llama3-8b layers, L2-cold) in turns (parent, change, change,
        parent), one process a run; --rounds N runs that order N times.
    python3 -m megatronapp_tpu_torch.tools.flash_probe ab --parent DIR
        chip_smoke.py's train, train_gpt2 and profile phases (the profile
        on llama3-8b at 32 layers: unfused, fused and fused on resident
        int8 weights and int8 pools; then the LoRA engines of serve_lora's
        five adapters, unfused and fused; then the MLA engines, unfused
        and fused) of the checkout in DIR (e.g. the parent commit, unpacked
        with git archive) and of this one in turns (parent, change,
        change, parent), one process a run; --skip-train leaves out the
        two train phases, --bf16-only the int8, LoRA and MLA engines
        (llama3-8b unfused and fused on bf16 weights only), --rounds N
        runs that order N times.
    python3 -m megatronapp_tpu_torch.tools.flash_probe static-ab --parent DIR
        chip_smoke.py's serve_static phase (the static engine on llama3-8b
        at 32 layers: each prompt's decode interval without and with
        MegaScope capture on layers 0 and 1) of the checkout in DIR and of
        this one in turns (parent, change, change, parent), one process a
        run; --rounds N runs that order N times.

Kernel times are device time per call with the calls queued behind a
sleep (chip_smoke.device_ms): at the D 64 shape a call is shorter than
its host time. Each command prints JSON lines. Nothing runs on import,
and nothing falls back to the CPU: without a card the commands fail.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def _ptxas(log: str):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def _build_variants(name: str, rule: str, variants: dict) -> dict:
    """Copies of csrc/<name> (and every header) under build/flash_probe/,
    `rule` replaced by each variant's text, built by nvcc in parallel;
    returns {variant: ctypes.CDLL} and prints each build's ptxas lines."""
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    with open(kbuild.source(name)) as f:
        text = f.read()
    if rule not in text:
        raise RuntimeError(f"`{rule}` not found in {name}")
    return _build_sources(name, {key: text.replace(rule, repl)
                                 for key, repl in variants.items()})


def _build_sources(name: str, texts: dict) -> dict:
    """Each {variant: source text} of csrc/<name> written under
    build/flash_probe/<variant>/ beside copies of every header and built
    by nvcc in parallel; returns {variant: ctypes.CDLL} and prints each
    build's ptxas lines."""
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    procs = {}
    for key, text in texts.items():
        out = os.path.join(REPO, "build", "flash_probe",
                           str(key).replace(" ", ""))
        os.makedirs(out, exist_ok=True)
        for hdr in os.listdir(kbuild.CSRC):
            if hdr.endswith(kbuild.HEADER_SUFFIXES):
                with open(os.path.join(kbuild.CSRC, hdr)) as f, \
                        open(os.path.join(out, hdr), "w") as g:
                    g.write(f.read())
        src = os.path.join(out, name)
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out, name.replace(".cu", ".so"))
        procs[key] = (lib, subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        print(json.dumps({"variant": str(key), "ptxas": _ptxas(log)}),
              flush=True)
        libs[key] = ctypes.CDLL(lib)
    return libs


def fwd_tiles():
    import torch

    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    choices = [(64, 64), (128, 64), (64, 128), (128, 128)]
    libs = _build_variants(
        "flash_attention.cu",
        "static constexpr int kQ = D == 128 ? 128 : 64, kKV = kQ;",
        {c: f"static constexpr int kQ = {c[0]}, kKV = {c[1]};"
         for c in choices})
    dev = torch.device("cuda", 0)
    for name, (b, s, hq, hkv, d) in cs.FLASH_TIMED_SHAPES.items():
        q, k, v, _, _ = cs._flash_inputs(torch.Generator().manual_seed(5),
                                         dev, b, s, hq, hkv, d)
        outs, times = {}, {c: [] for c in choices}
        for c in choices + choices[::-1]:
            kbuild._libs[fa.SOURCE] = libs[c]
            outs[c] = fa.flash_forward(q, k, v, True)
            times[c].append(cs.device_ms(
                lambda: fa.flash_forward(q, k, v, True), calls=10))
        torch.cuda.synchronize()
        same = {f"kv{kv}": all(torch.equal(x, y) for x, y in zip(
            outs[(64, kv)], outs[(128, kv)])) for kv in (64, 128)}
        print(json.dumps({
            "shape": name, "ms": {f"q{c[0]}_kv{c[1]}": t
                                  for c, t in times.items()},
            "bit_identical_same_kv_tile": same}), flush=True)
    kbuild._libs.pop(fa.SOURCE, None)


def paged_splits():
    import torch

    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(99)
    plan = pa.launch_split_count
    # name: (batch, s_q, kv, table capacity, split counts); the engine's
    # tables cover max_seq_len 2048 positions.
    shapes = {"decode_b8_kv1024": (8, None, 1024, 0, [1, 2, 4, 8, 16]),
              "ragged_b1_sq32_kv1024": (1, 32, 1024, 0, [1, 4, 8, 16]),
              "decode_b8_kv1024_table2048": (8, None, 1024, 2048,
                                             [2, 4, 8, 16]),
              "ragged_b1_sq32_kv1008_table2048": (1, 32, 1008, 2048,
                                                  [4, 8, 16, 32])}
    try:
        for name, (batch, s_q, kv, cap, counts) in shapes.items():
            for kind in ("bf16", *cs.QUANT_KINDS):
                # One-byte pools: twice the tables keep K/V beyond the L2.
                case = cs.make_case(
                    gen, dev, batch=batch, hq=32, hkv=8, d=128, bs=16,
                    kv_lens=[kv] * batch, s_q=s_q,
                    q_lens=None if s_q is None else [s_q] * batch,
                    pool_bytes=cs.TIMED_POOL_BYTES * (1 if kind == "bf16"
                                                      else 2),
                    capacity=cap)
                if kind != "bf16":
                    case = cs.quantize_case(case, kind)
                kw = {k: case[k] for k in ("k_scales", "v_scales")
                      if k in case}
                tables, it = case["tables"], {"i": 0}

                def call():
                    it["i"] = (it["i"] + 1) % tables.shape[0]
                    return pa.paged_attention(
                        case["q"], case["k"], case["v"], tables[it["i"]],
                        case["kv_lens"], q_lens=case.get("q_lens"), **kw)
                outs, times = {}, {n: [] for n in counts}
                for n in counts + counts[::-1]:
                    pa.launch_split_count = lambda *a, n=n: n
                    it["i"] = -1
                    outs[n] = call()
                    times[n].append(cs.device_ms(call))
                pa.launch_split_count = plan
                torch.cuda.synchronize()
                print(json.dumps({
                    "shape": name, "pool": kind, "planned_splits": plan(
                        case["q"], case["k"], case["table"]),
                    "ms": {str(n): t for n, t in times.items()},
                    "max_abs_diff_vs_first": {
                        str(n): float((outs[n].float()
                                       - outs[counts[0]].float())
                                      .abs().max()) for n in counts}}),
                    flush=True)
                del case, outs
                torch.cuda.empty_cache()
    finally:
        pa.launch_split_count = plan


def _build_tree(tree: str, name: str) -> ctypes.CDLL:
    """csrc/<name> of the checkout `tree` (with its own headers) built by
    nvcc under build/flash_probe/tree/; its ptxas lines printed."""
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    out = os.path.join(REPO, "build", "flash_probe", "tree")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, name.replace(".cu", ".so"))
    proc = subprocess.run(
        [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", lib,
         os.path.join(os.path.abspath(tree), "megatronapp_tpu_torch", "csrc",
                      name)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tree}/{name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    print(json.dumps({"tree": tree, "ptxas": _ptxas(proc.stdout
                                                    + proc.stderr)}),
          flush=True)
    return ctypes.CDLL(lib)


def quant_flips(parent: str):
    import torch

    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import paged_attention as pa
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    pa._kernel()
    libs = {"parent": _build_tree(parent, "paged_attention.cu"),
            "change": kbuild._libs[pa.SOURCE]}
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(4242)
    try:
        for name, kw in cs.quant_cases().items():
            case = cs.make_case(gen, dev, **kw)
            for kind in cs.QUANT_KINDS:
                qc = cs.quantize_case(case, kind)
                for tree, lib in libs.items():
                    kbuild._libs[pa.SOURCE] = lib
                    out = pa.paged_attention(
                        qc["q"], qc["k"], qc["v"], qc["table"],
                        qc["kv_lens"], q_lens=qc.get("q_lens"),
                        k_scales=qc["k_scales"], v_scales=qc["v_scales"])
                    print(json.dumps({"case": name, "pool": kind,
                                      "tree": tree,
                                      **cs.quant_errors(out, qc)}),
                          flush=True)
    finally:
        kbuild._libs[pa.SOURCE] = libs["change"]


# fused_mla.cu's tiling constants that prologue-variants sets.
_PROLOGUE_KNOBS = ("kNarrow", "kKc", "kStages")


def prologue_variants():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from megatronapp_tpu_torch.models.gpt import (
        gpt_rope_tables, init_gpt_params,
    )
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import fused_mla as fm
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    # (kNarrow, kKc, kStages); the first is the source's own.
    choices = [(64, 128, 4), (64, 128, 3), (64, 128, 6), (64, 64, 8),
               (32, 128, 4)]
    with open(kbuild.source("fused_mla.cu")) as f:
        text = f.read()
    lines = {k: next(ln for ln in text.splitlines()
                     if ln.startswith(f"constexpr int {k} = "))
             for k in _PROLOGUE_KNOBS}
    variants = {}
    for c in choices:
        block = text
        for k, v in zip(_PROLOGUE_KNOBS, c):
            block = block.replace(lines[k], f"constexpr int {k} = {v};")
        variants[c] = block
    libs = _build_sources("fused_mla.cu", variants)
    dev = torch.device("cuda", 0)
    cfg = cs.mla_cfg(num_layers=4)
    layers = list(init_gpt_params(cfg, torch.Generator(dev).manual_seed(0),
                                  dev)["layers"])
    gen = torch.Generator(dev).manual_seed(808)
    cos_t, sin_t = gpt_rope_tables(cfg, 2048, device=dev)
    for rows in (8, 32):
        x = torch.randn(rows, cfg.hidden_size, generator=gen,
                        device=dev).to(torch.bfloat16)
        pos = torch.randint(0, 2048, (rows,), generator=gen, device=dev)
        cos, sin = cos_t[pos].contiguous(), sin_t[pos].contiguous()
        it = {"i": 0}

        def call():
            it["i"] = (it["i"] + 1) % len(layers)
            return fm.fused_mla_qkv(x, layers[it["i"]], cfg, cos, sin)
        times, split, outs = {c: [] for c in choices}, {}, {}
        for c in choices + choices[::-1]:
            kbuild._libs[fm.SOURCE] = libs[c]
            it["i"] = -1
            outs[c] = call()
            times[c].append(cs.device_ms(call))
            if c not in split:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(8):
                        call()
                    torch.cuda.synchronize()
                split[c] = {}
                for e in prof.events():
                    if e.device_type != torch.autograd.DeviceType.CUDA:
                        continue
                    k = "mla_down" if "mla_down" in e.name else (
                        "mla_up" if "mla_up" in e.name else "other")
                    split[c][k] = split[c].get(k, 0.0) \
                        + e.time_range.elapsed_us() / 1e3 / 8
        torch.cuda.synchronize()
        first = outs[choices[0]]
        print(json.dumps({
            "rows": rows,
            "variants": {"narrow{}_kc{}_stages{}".format(*c): {
                "ms": times[c], "ms_by_kernel": split[c],
                "max_abs_diff_vs_first": max(
                    float((a.float() - b.float()).abs().max())
                    for a, b in zip(outs[c], first))} for c in choices}}),
            flush=True)
    kbuild._libs.pop(fm.SOURCE, None)


# fused_decode.cu's tile-core knobs that fused-variants sets (the ring's
# stage k and stage count; the row block from which QKV and fc1 share
# their norm statistics, with or without a K split: 8 shares at both row
# blocks, 64 at none, each block then computing its own), the
# ring shapes it tries beside the source's (64-k stages deeper; for the
# long-K fc1 and fc2, 128-k stages 3 and 4 deep and 256-k stages), and
# the ablations it builds: each replaces one piece of mma_tile's text (the
# norm statistics, the split sums, the in-place normalisation, the mma) by
# a stand-in that costs nothing, so its time apart shows; their outputs
# are not the function's.
_FUSED_KNOBS = ("kStageK", "kStages", "kSharedStatsRb")
_FUSED_RINGS = (("64", "4"), ("64", "3"), ("128", "3"), ("128", "4"),
                ("256", "2"))
_FUSED_ABLATIONS = {
    "nostats": [("rn::row_moments<8>(a.x + (size_t)row * a.k, a.k, a.norm, "
                 "lane, mean, ss);", "mean = 0.f; ss = (float)a.k;")],
    "nosums": [("for (int sp0 = 1; sp0 < a.ksplit; sp0 += kBatch) {",
                "for (int sp0 = a.ksplit; sp0 < a.ksplit; sp0 += kBatch) {")],
    "nonorm": [("    if (norm) {\n      // bf16(norm(x)) in place",
                "    if (false) {\n      // bf16(norm(x)) in place")],
    "nomma": [("tc::mma_bf16(acc[nb], af, bx[nb][2 * h], bx[nb][2 * h + 1]);",
               "acc[nb][0] += __uint_as_float(af[0] ^ bx[nb][2 * h]);")],
}


def fused_shape(cfg, kernel):
    """(K, tiles) of a fused kernel: its contraction and the 128-column
    tiles of its grid (gated fc1: 64 gate and 64 value columns a tile)."""
    from megatronapp_tpu_torch.ops.activations import is_gated
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    h, d, ffn = cfg.hidden_size, cfg.head_dim, cfg.ffn_hidden_size
    nq, nkv = cfg.num_attention_heads, cfg.num_query_groups
    return {"qkv": (h, (nq + 2 * nkv) * d // fd.TILE),
            "out_proj": (nq * d, h // fd.TILE),
            "mlp_fc1": (h, ffn // (fd.TILE // 2 if is_gated(cfg.activation)
                                   else fd.TILE)),
            "mlp_fc2": (ffn, h // fd.TILE)}[kernel]


def fused_variants():
    import re

    import torch

    from megatronapp_tpu_torch.inference.quantization import (
        quantize_for_serving,
    )
    from megatronapp_tpu_torch.models.gpt import (
        gpt_rope_tables, init_gpt_params,
    )
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import fused_decode as fd
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    with open(kbuild.source("fused_decode.cu")) as f:
        text = f.read()
    lines = {k: re.search(rf"^constexpr (?:int|bool) {k} = (\w+);.*$", text,
                          re.M) for k in _FUSED_KNOBS}
    if not all(lines.values()) or not all(
            old in text for pairs in _FUSED_ABLATIONS.values()
            for old, _ in pairs):
        raise RuntimeError("fused-variants: the knobs are not in the source")
    own = tuple(lines[k].group(1) for k in _FUSED_KNOBS) + ("full",)
    # (kStageK, kStages, kSharedStatsRb, ablation); the first is the
    # source's.
    choices = [own]
    for c in [own[:2] + (rb, "full") for rb in ("8", "64")] + [
            (k, n, own[2], "full") for k, n in _FUSED_RINGS] + [
            own[:3] + (a,) for a in _FUSED_ABLATIONS]:
        if c not in choices:
            choices.append(c)
    variants = {}
    for c in choices:
        block = text
        for k, v in zip(_FUSED_KNOBS, c):
            block = block.replace(lines[k].group(0), lines[k].group(0).replace(
                f"{k} = {lines[k].group(1)};", f"{k} = {v};"))
        for old, repl in _FUSED_ABLATIONS.get(c[3], ()):
            block = block.replace(old, repl)
        variants["_".join(c)] = block
    libs = _build_sources("fused_decode.cu", variants)
    dev = torch.device("cuda", 0)
    cfg = llama3_8b(num_layers=8, params_dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    kinds = {"bf16": list(params["layers"]),
             "int8": list(quantize_for_serving(params)[0]["layers"])}
    gen = torch.Generator(dev).manual_seed(808)
    cos_t, sin_t = gpt_rope_tables(cfg, 2048, device=dev)
    own_stage, own_waves = fd.STAGE_K, fd.SPLIT_WAVES
    plans = [("variant", "_".join(c), int(c[0]), own_waves) for c in choices]
    plans += [("split_waves", str(w), own_stage, w) for w in (1, 3, 4)
              if w != own_waves]
    try:
        for rows in (8, 32):
            x = torch.randn(rows, cfg.hidden_size, generator=gen,
                            device=dev).to(torch.bfloat16)
            attn = torch.randn(rows, cfg.hidden_size, generator=gen,
                               device=dev).to(torch.bfloat16)
            y = torch.randn(rows, cfg.ffn_hidden_size, generator=gen,
                            device=dev).to(torch.bfloat16)
            pos = torch.randint(0, 2048, (rows,), generator=gen, device=dev)
            cos, sin = cos_t[pos].contiguous(), sin_t[pos].contiguous()
            for kind, layers in kinds.items():
                it = {"i": 0}

                def nxt():
                    it["i"] = (it["i"] + 1) % len(layers)
                    return layers[it["i"]]
                calls = {"qkv": lambda: fd.fused_qkv(x, nxt(), cfg, cos, sin),
                         "out_proj": lambda: fd.fused_out_proj(
                             attn, nxt(), cfg, x),
                         "mlp_fc1": lambda: fd.fused_mlp_fc1(x, nxt(), cfg),
                         "mlp_fc2": lambda: fd.fused_mlp_fc2(
                             y, x, nxt(), cfg)}
                times = {(p[0], p[1], k): [] for p in plans for k in calls}
                outs = {}
                for what, key, stage_k, waves in plans + plans[::-1]:
                    kbuild._libs[fd.SOURCE] = libs[
                        key if what == "variant" else "_".join(own)]
                    fd.STAGE_K, fd.SPLIT_WAVES = stage_k, waves
                    for k, fn in calls.items():
                        it["i"] = -1
                        outs[(what, key, k)] = fn()
                        times[(what, key, k)].append(cs.device_ms(fn))
                torch.cuda.synchronize()
                sms = kbuild.sm_count(dev)
                for k in calls:
                    first = outs[("variant", "_".join(own), k)]
                    first = first if isinstance(first, tuple) else (first,)
                    rec = {}
                    for what, key, stage_k, waves in plans:
                        o = outs[(what, key, k)]
                        o = o if isinstance(o, tuple) else (o,)
                        fd.STAGE_K, fd.SPLIT_WAVES = stage_k, waves
                        kk, tiles = fused_shape(cfg, k)
                        rec[f"{what}:{key}"] = {
                            "ms": times[(what, key, k)],
                            "k_tiles": [kk, tiles],
                            "ksplit": fd.tile_split_plan(rows, kk, tiles,
                                                         sms)[2],
                            "max_abs_diff_vs_own": max(
                                float((a.float() - b.float()).abs().max())
                                for a, b in zip(o, first))}
                    print(json.dumps({"rows": rows, "weights": kind,
                                      "kernel": k, "own": "_".join(own),
                                      "runs": rec}), flush=True)
    finally:
        fd.STAGE_K, fd.SPLIT_WAVES = own_stage, own_waves
        kbuild._libs.pop(fd.SOURCE, None)


def dkv_rows():
    import torch

    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    libs = _build_variants("flash_attention.cu",
                           "return D == 128 ? 128 : 64;",
                           {rows: f"return {rows};" for rows in (64, 128)})
    dev = torch.device("cuda", 0)
    for name, (b, s, hq, hkv, d) in cs.FLASH_TIMED_SHAPES.items():
        q, k, v, g, _ = cs._flash_inputs(torch.Generator().manual_seed(5),
                                         dev, b, s, hq, hkv, d)
        kbuild._libs[fa.SOURCE] = libs[128]
        out, lse = fa.flash_forward(q, k, v, True)
        args = (q, k, v, g, lse, fa.attention_delta(out, g), True)
        grads, times = {}, {64: [], 128: []}
        for rows in (64, 128, 128, 64):
            kbuild._libs[fa.SOURCE] = libs[rows]
            grads[rows] = fa.flash_bwd_dkv(*args)
            times[rows].append(cs.device_ms(
                lambda: fa.flash_bwd_dkv(*args), calls=10))
        torch.cuda.synchronize()
        print(json.dumps({
            "shape": name, "rows64_ms": times[64], "rows128_ms": times[128],
            "bit_identical": all(torch.equal(x, y) for x, y in
                                 zip(grads[64], grads[128]))}), flush=True)
    kbuild._libs.pop(fa.SOURCE, None)


def _turns(parent: str, code: str, rounds: int = 1):
    """`code` run by a fresh interpreter in the checkout `parent` and in
    this one in turns (parent, change, change, parent; `rounds` times),
    one process a run; yields (tree, record) for each JSON line printed."""
    trees = {"parent": os.path.abspath(parent), "change": REPO}
    for which in ("parent", "change", "change", "parent") * rounds:
        proc = subprocess.run([sys.executable, "-c", code], cwd=trees[which],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the {which} run failed:\n"
                               f"{proc.stderr[-3000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                yield which, json.loads(line)


def fused_ab(parent: str, rounds: int = 1):
    code = ("import json, sys; sys.path.insert(0, '.'); import torch, "
            "chip_smoke as c\n"
            "from megatronapp_tpu_torch.inference.quantization import "
            "quantize_for_serving\n"
            "from megatronapp_tpu_torch.models.gpt import init_gpt_params\n"
            "from megatronapp_tpu_torch.models.presets import llama3_8b\n"
            "dev = torch.device('cuda', 0)\n"
            "cfg = llama3_8b(num_layers=8, params_dtype=torch.bfloat16)\n"
            "p = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0), "
            "dev)\n"
            "s = {'model': (p, cfg, dev)}\n"
            "print(json.dumps({'bf16': c._fused_times(s)}))\n"
            "s['model'] = (quantize_for_serving(p)[0], cfg, dev)\n"
            "print(json.dumps({'int8': c._fused_times(s)}))\n")
    print(json.dumps({"nvidia_smi": _smoke().nvidia_smi_line()}), flush=True)
    for which, rec in _turns(parent, code, rounds):
        for weights, r in rec.items():
            for rows, per in r["rows"].items():
                for kernel, v in per.items():
                    print(json.dumps({
                        "tree": which, "weights": weights, "rows": int(rows),
                        "kernel": kernel, "kernel_ms": v["kernel_ms"],
                        "kernel_ms_runs": v["kernel_ms_runs"],
                        "library_ms": v["library_ms"],
                        "bound_ms": v["bound_ms"]}), flush=True)


def static_ab(parent: str, rounds: int = 1):
    code = ("import sys; sys.path.insert(0, '.'); import torch, "
            "chip_smoke as c\n"
            "from megatronapp_tpu_torch.models.gpt import init_gpt_params\n"
            "from megatronapp_tpu_torch.models.presets import llama3_8b\n"
            "dev = torch.device('cuda', 0)\n"
            "cfg = llama3_8b(num_layers=32, params_dtype=torch.bfloat16)\n"
            "p = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0), "
            "dev)\n"
            "c.phase_serve_static({'model': (p, cfg, dev)}, 32)\n")
    print(json.dumps({"nvidia_smi": _smoke().nvidia_smi_line()}), flush=True)
    for which, rec in _turns(parent, code, rounds):
        if rec.get("phase") != "serve_static":
            continue
        for r in rec["requests"]:
            print(json.dumps({
                "tree": which, "prompt_len": r["prompt_len"],
                "decode_ms_plain": r["decode_ms_plain"],
                "decode_ms_capture": r["decode_ms_capture"],
                "payloads": r["payloads"],
                "stream_equal": r["stream_equal"]}), flush=True)


def ab(parent: str, skip_train: bool = False, bf16_only: bool = False,
       rounds: int = 1):
    code = ("import sys; sys.path.insert(0, '.'); import torch, chip_smoke "
            "as c; torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; s = {}\n"
            "from megatronapp_tpu_torch.ops.cuda import build as kb\n"
            "kb.build_all([kb.source(n) for n in ('flash_attention.cu', "
            "'paged_attention.cu', 'fused_decode.cu', 'lora.cu', "
            "'paged_latent.cu', 'fused_mla.cu')])\n"
            + ("" if skip_train else
               "c.phase_train(s, 4); c.phase_train_gpt2(s)\n")
            + "from megatronapp_tpu_torch.models.gpt import init_gpt_params\n"
            "from megatronapp_tpu_torch.models.presets import llama3_8b\n"
            "from megatronapp_tpu_torch.inference.quantization import "
            "quantize_for_serving\n"
            "from megatronapp_tpu_torch.inference.lora import "
            "AdapterRegistry, LoraAdapter\n"
            "dev = torch.device('cuda', 0)\n"
            "cfg = llama3_8b(num_layers=32, params_dtype=torch.bfloat16)\n"
            "p = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0), "
            "dev)\n"
            "s['model'] = (p, cfg, dev)\n"
            + ("" if bf16_only else
               "reg = AdapterRegistry()\n"
               "for i, aid in enumerate(c.LORA_ADAPTERS):\n"
               "    reg.register(LoraAdapter.random(aid, cfg, "
               "rank=c.LORA_RANK, seed=100 + i, "
               "scale=c.LORA_SERVE_SCALE))\n"
               "s['lora_registry'] = reg\n"
               "s['qmodel'] = (quantize_for_serving(p)[0], cfg, dev)\n"
               "m = c.mla_cfg(num_layers=c.MLA_LAYERS)\n"
               "s['mla_model'] = (init_gpt_params(m, torch.Generator(dev)"
               ".manual_seed(0), dev), m, dev)\n")
            + "c.phase_profile(s)")
    keys = ("step_ms", "mean_step_ms_after_first", "tokens_per_s", "mfu",
            "peak_mem_bytes", "launches")
    window_keys = ("device_ms_per_unit_by_family", "device_busy_ms",
                   "wall_ms_per_unit", "device_idle_share",
                   "paged_attention_ms_per_launch",
                   "paged_latent_ms_per_launch", "kernels_per_unit")
    for which, rec in _turns(parent, code, rounds):
        if rec.get("phase") == "profile":
            for eng, windows in rec.items():
                if not isinstance(windows, dict):
                    continue
                for win, w in windows.items():
                    print(json.dumps({
                        "tree": which, "phase": "profile",
                        "engine": eng, "window": win,
                        **{k: w.get(k) for k in window_keys}}),
                        flush=True)
            continue
        row = {"tree": which, "phase": rec.get("phase"),
               **{k: rec.get(k) for k in keys}}
        prof = rec.get("profiled_steps")
        if prof:
            row["device_ms_per_step"] = prof["device_ms_per_unit_by_family"]
            row["device_idle_share"] = prof["device_idle_share"]
        print(json.dumps(row), flush=True)


def lora_splits():
    import numpy as np
    import torch

    from megatronapp_tpu_torch.ops import lora as tlo
    from megatronapp_tpu_torch.ops.cuda import lora as cl
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(909)
    rank, layers = cs.LORA_RANK, 32
    for din in (4096, 14336):
        kpers = [cl.shrink_k_per_split(rank, din)]
        kpers += [k for k in (64, 128, 256, 512, 1024, 2048) if k != kpers[0]]
        a_all = torch.randn(layers, 5, din, rank, generator=gen,
                            device=dev) / din ** 0.5
        a_all[:, 0] = 0
        for label, ids in (("rows8_mixed", cs.LORA_DECODE_IDS),
                           ("rows32_one_adapter", [3] * 32)):
            segs = tlo.LoraRows(np.asarray(ids), dev)
            x = torch.randn(len(ids), din, generator=gen, device=dev).to(
                torch.bfloat16)
            it = {"i": 0}
            times, outs = {k: [] for k in kpers}, {}
            for kper in kpers + kpers[::-1]:
                def call(kper=kper):
                    it["i"] = (it["i"] + 1) % layers
                    return cl.lora_shrink(x, (a_all[it["i"]],), segs,
                                          kper=kper)
                it["i"] = -1
                outs[kper] = call()
                times[kper].append(cs.device_ms(call))
            torch.cuda.synchronize()
            first = outs[kpers[0]]
            print(json.dumps({
                "din": din, "rows": label, "rank": rank,
                "ms": {str(k): t for k, t in times.items()},
                "splits": {str(k): -(-din // k) for k in kpers},
                "max_rel_diff_vs_default": {
                    str(k): float(((outs[k] - first).abs()
                                   / first.abs().clamp_min(1e-6)).max())
                    for k in kpers}}), flush=True)
            del outs
        del a_all
        torch.cuda.empty_cache()


def _kernels_us(fn, keys, calls: int = 20) -> dict:
    """Device µs a call of fn() spends in each kernel whose name holds one
    of `keys` (torch.profiler over `calls` calls queued behind a sleep)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    us = dict.fromkeys(keys, 0.0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(200_000_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        for k in keys:
            if k in e.name:
                us[k] += e.time_range.elapsed_us() / calls
    return us


# Row 9's cluster combine, patched into a copy of csrc/latent_tp.cu: the
# splits of a (slot, row tile, column block) are one thread-block cluster
# (at most 16); each block keeps its partial in shared memory, block k adds
# a k-th of the unit's tile over the live splits in split order
# (distributed shared memory) into split 0's workspace slot, and the
# expansion reads that slot alone. The same bits as the second launch's
# combine; slower (PERF.md §6), so the source does not keep it.
_LATENT_CLUSTER = [
    ("#include <type_traits>",
     "#include <cooperative_groups.h>\n#include <type_traits>"),
    # Blocks past the valid blocks still meet the cluster's barriers.
    ("  if (s0 >= s1) return;\n", ""),
    ("  // The fp32 partial of this split.\n", """\
  {
    namespace cg = cooperative_groups;
    constexpr int kLdU = kWsumCols + 4;
    cg::cluster_group cluster = cg::this_cluster();
    tc::cp_async_wait<0>();
    __syncthreads();   // the ring is free
    float* part = reinterpret_cast<float*>(smem_raw);   // [TM][kLdU]
    if (wcols > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int nt = 0; nt < kWarpCols / 8; ++nt)
          if (nt * 8 < wcols)
            *reinterpret_cast<float2*>(part + (wm * 16 + g + 8 * i) * kLdU + wc + nt * 8 + 2 * t4) =
                make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
    }
    cluster.sync();
    const int live = live_splits(tv, p), c4 = ncols / 4, elems = TM * c4;
    const int per = (elems + p.splits - 1) / p.splits, e1 = min(elems, (split + 1) * per);
    float* u = p.ws + ((size_t)b * p.rows + r0) * p.dl + c0;
    for (int e = split * per + tid; e < e1 && live > 0; e += kThr) {
      const int r = e / c4, col = (e % c4) * 4;
      if (r0 + r >= p.rows) continue;
      float* src = part + r * kLdU + col;
      float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, 0));
      for (int k = 1; k < live; ++k) {
        const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, k));
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
      *reinterpret_cast<float4*>(u + (size_t)r * p.dl + col) = v;
    }
    cluster.sync();   // no block leaves while its partial is read
    return;
  }
"""),
    ("      live = live_splits(tv, p);", "      live = min(tv, 1);"),
    ("  kernel<<<dim3(p.splits, (unsigned)y, p.batch), TM * 8, smem, st>>>(p);"
     "\n  return (int)cudaGetLastError();", """\
  if (p.splits > 16 || (size_t)TM * (kWsumCols + 4) * sizeof(float) > smem)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             p.splits > 8);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, (unsigned)y, p.batch);
  cfg.blockDim = dim3(TM * 8);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, p);""")]


def latent_splits():
    import torch

    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(710)
    sms = kbuild.sm_count(dev)
    with open(lt.SOURCE) as f:
        text = f.read()
    tiles_rule = "kScoreTiles[2] = {{32, 64, 4}, {64, 128, 2}};"
    kc_rule = "constexpr int kScoreKC = 128;"
    ring_rule = "constexpr int kScoreRing = 2;"
    # Row 8's variants, label: (decode tile, chunk tile: rows, tokens, warp
    # groups; columns of d a stage, ring stages); the first is the source.
    shapes = {"d32x64x4_c64x128x2": ("{32, 64, 4}", "{64, 128, 2}", 128, 2),
              "d32x64x1_c64x128x1": ("{32, 64, 1}", "{64, 128, 1}", 128, 2),
              "d32x32x4_c32x128x2": ("{32, 32, 4}", "{32, 128, 2}", 128, 2),
              "d32x64x4_c64x128x2_kc64_ring4": ("{32, 64, 4}", "{64, 128, 2}",
                                                64, 4)}
    source = next(iter(shapes))
    texts = {k: text.replace(tiles_rule, f"kScoreTiles[2] = {{{a}, {b}}};")
             .replace(kc_rule, f"constexpr int kScoreKC = {kc};")
             .replace(ring_rule, f"constexpr int kScoreRing = {ring};")
             for k, (a, b, kc, ring) in shapes.items()}
    # Ablations of the source, each stubbing one piece (their outputs are
    # not the function's): row 8's "scores_*", row 9's "wsum_*".
    ablations = {
        "scores_no_page_reads": [
            ("const bool live = off >= 0 && col < p.d;",
             "const bool live = false;")],
        "scores_no_mma": [
            ("    for (int kk = kg; kk < ksteps; kk += KS) {",
             "    for (int kk = kg; kk < 0; kk += KS) {")],
        "scores_no_store": [
            ("      if (r >= p.rows) continue;\n      float* o = out",
             "      if (r >= 0) continue;\n      float* o = out")],
        "wsum_no_latent_reads": [
            ("const bool live = t < s1 && pc * EPP < ncols;",
             "const bool live = false;")],
        "wsum_no_split_mma": [("      if (tb + kk * 16 >= s1) break;",
                               "      break;")],
        "wsum_no_gather": [("      live[e] = i < total ? live_s[r] : 0;",
                            "      live[e] = 0;")],
        "wsum_no_expand_mma": [
            ("  for (int kk = warp; kk < p.dl / 16; kk += kExpWarps) {",
             "  for (int kk = warp; kk < 0; kk += kExpWarps) {")],
        "wsum_no_pdl": [
            ("  return (int)tc::launch_pdl(latent_wsum_expand_kernel, grid, "
             "dim3(kExpThreads), smem, st, p);",
             "  latent_wsum_expand_kernel<<<grid, kExpThreads, smem, st>>>(p);"
             "\n  return (int)cudaGetLastError();")]}
    patches = {**ablations, "wsum_cluster": _LATENT_CLUSTER}
    for rule in (tiles_rule, kc_rule, ring_rule,
                 *(r for v in patches.values() for r, _ in v)):
        if text.count(rule) != 1:
            raise RuntimeError(f"`{rule}` not found once in latent_tp.cu")
    for k, rules in patches.items():
        texts[k] = text
        for rule, repl in rules:
            texts[k] = texts[k].replace(rule, repl)
    libs = _build_sources("latent_tp.cu", texts)
    plan = lt.wsum_split_plan
    floor = torch.zeros(1, device=dev)
    print(json.dumps({"launch_floor_ms (a one-element add_)":
                      cs.device_ms(lambda: floor.add_(1))}), flush=True)

    def forced(row_tile, splits, tokens):
        stages = -(-tokens // lt.WSUM_STAGE)
        per = -(-stages // splits)
        return lt.WsumPlan(row_tile, per * lt.WSUM_STAGE, -(-stages // per))

    def turns(variants, run):
        """{label: [ms, ms]} over the variants in order, then reversed;
        {label: max |out - first variant's out|}."""
        outs, times = {}, {k: [] for k in variants}
        labels = list(variants)
        for k in labels + labels[::-1]:
            outs[k], t = run(k)
            times[k].append(t)
        torch.cuda.synchronize()
        first = outs[labels[0]]
        return times, {k: float((v - first).abs().max())
                       for k, v in outs.items()}
    try:
        for kind in ("bf16", "int8", "fp8"):
            for mode, (batch, s_q) in (("decode", (8, None)),
                                       ("chunk", (1, 32))):
                case = cs.make_latent_case(
                    gen, dev, batch=batch, kv_lens=[1024] * batch, s_q=s_q,
                    q_lens=None if s_q is None else [s_q] * batch,
                    kind=kind, pool_bytes=cs.TIMED_POOL_BYTES)
                q, qp, shard, w_v = cs._tp_shard_inputs(case)
                p = cs._tp_probs(case, q, shard)
                b, rows, d = q.shape
                tables, lens = case["tables"], case["kv_lens"]
                ls = case.get("lat_scales")
                it = {"i": 0}

                def nxt():
                    it["i"] = (it["i"] + 1) % tables.shape[0]
                    return tables[it["i"]]
                tokens = tables.shape[-1] * 16
                base = plan(b, rows, tokens, d, sms)
                # {label: (plan, source copy)}, the default plan first.
                variants = {}
                for n in sorted({base.splits, 4, 8, 16}):
                    for tile in ((base.row_tile,) if mode == "decode"
                                 else lt.WSUM_ROW_TILES):
                        for key, combine in ((source, "second"),
                                             ("wsum_cluster", "cluster")):
                            v = forced(tile, n, tokens)
                            label = (f"rows{v.row_tile}_splits{v.splits}_"
                                     f"{combine}")
                            variants.setdefault(label, (v, key))
                default = f"rows{base.row_tile}_splits{base.splits}_second"
                variants = {default: variants.pop(default), **variants}

                variants.update({k: (base, k) for k in ablations
                                 if k.startswith("wsum_")})

                def run_wsum(label):
                    v, key = variants[label]
                    kbuild._libs[lt.SOURCE] = libs[key]
                    lt.wsum_split_plan = lambda *a, v=v: v
                    it["i"] = -1
                    out = lt.latent_block_wsum(p, shard, nxt(), lens, w_v,
                                               ls)
                    call = lambda: lt.latent_block_wsum(  # noqa: E731
                        p, shard, nxt(), lens, w_v, ls)
                    return out, cs.device_ms(call)
                times, diff = turns(variants, run_wsum)
                lt.wsum_split_plan = plan
                kbuild._libs[lt.SOURCE] = libs[source]
                split_us = _kernels_us(
                    lambda: lt.latent_block_wsum(p, shard, nxt(), lens, w_v,
                                                 ls),
                    ("latent_wsum_split_kernel", "latent_wsum_expand_kernel"))
                print(json.dumps({
                    "kernel": "wsum", "shape": mode, "pool": kind,
                    "plan": base._asdict(), "ms": times,
                    "default_plan_kernel_us": split_us,
                    "max_abs_diff_vs_first": diff}), flush=True)

                def run_scores(label):
                    kbuild._libs[lt.SOURCE] = libs[label]
                    it["i"] = -1
                    out = lt.latent_block_scores(q, shard, nxt(), lens, ls)
                    call = lambda: lt.latent_block_scores(  # noqa: E731
                        q, shard, nxt(), lens, ls)
                    return out, cs.device_ms(call)
                times, diff = turns(
                    [*shapes, *(k for k in ablations
                                if k.startswith("scores_"))], run_scores)
                kbuild._libs.pop(lt.SOURCE, None)
                print(json.dumps({
                    "kernel": "scores", "shape": mode, "pool": kind,
                    "ms": times, "max_abs_diff_vs_first": diff}),
                    flush=True)
                del case, p
                torch.cuda.empty_cache()
    finally:
        lt.wsum_split_plan = plan
        kbuild._libs.pop(lt.SOURCE, None)


_LATENT_TILES = ("constexpr Tile kTiles[3] = {{32, 64, 8, 64, 2}, {32, 32, 8, 80, 3}, "
                 "{64, 32, 16, 64, 3}};")
_LATENT_ABLATIONS = {
    "no_page_reads": [("      const bool live = tb + r < s1;\n      const long long row",
                       "      const bool live = false;\n      const long long row")],
    "no_score_mma": [("      int kk = kg;\n", "      int kk = all_steps;\n")],
    "no_pv_mma": [("    if (wcols > 0) {\n#pragma unroll\n      for (int kk = 0;",
                   "    if (wcols < 0) {\n#pragma unroll\n      for (int kk = 0;")],
    "no_partial_store": [("  if (wcols > 0) {\n    float* wa",
                          "  if (wcols < 0) {\n    float* wa")],
    "no_gather": [("      if (k < live) x[k] = __ldcg(",
                   "      if (k < 0) x[k] = __ldcg(")],
    "no_expand_mma": [("  for (int kk = 0; kk < nc / 16; ++kk) {\n    uint32_t a[kUTerms][4], bw[4];",
                       "  for (int kk = 0; kk < 0; ++kk) {\n    uint32_t a[kUTerms][4], bw[4];")],
    "no_pdl": [("  return (int)tc::launch_pdl(kernel, grid, dim3(kCombThreads), smem, st, p);",
                "  kernel<<<grid, kCombThreads, smem, st>>>(p);\n"
                "  return (int)cudaGetLastError();")],
    "no_combine": [("  if (err != 0) return err;\n  const long long z",
                    "  if (err != 0 || p.klat > 0) return err;\n"
                    "  const long long z")]}


def paged_latent_splits():
    import torch

    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(711)
    sms = kbuild.sm_count(dev)
    with open(pl.SOURCE) as f:
        text = f.read()
    terms_rule = f"constexpr int kPTerms = {pl.P_TERMS};"
    for rule in (terms_rule, _LATENT_TILES,
                 *(r for v in _LATENT_ABLATIONS.values() for r, _ in v)):
        if text.count(rule) != 1:
            raise RuntimeError(f"`{rule}` not found once in paged_latent.cu")
    texts = {"source": text,
             "stage32": text.replace(_LATENT_TILES, _LATENT_TILES.replace(
                 "{32, 64, 8, 64, 2}", "{32, 32, 8, 64, 3}")),
             "ring2": text.replace(_LATENT_TILES, _LATENT_TILES.replace(
                 "{64, 32, 16, 64, 3}", "{64, 32, 16, 64, 2}"))}
    for n in (1, 2, 3):
        if n != pl.P_TERMS:
            texts[f"pterms{n}"] = text.replace(
                terms_rule, f"constexpr int kPTerms = {n};")
    for k, rules in _LATENT_ABLATIONS.items():
        texts[k] = text
        for rule, repl in rules:
            texts[k] = texts[k].replace(rule, repl)
    libs = _build_sources("paged_latent.cu", texts)
    plan = pl.latent_split_plan
    floor = torch.zeros(1, device=dev)
    print(json.dumps({"launch_floor_ms (a one-element add_)":
                      cs.device_ms(lambda: floor.add_(1))}), flush=True)

    def forced(row_tile, splits, tokens):
        stage = pl.STAGE_TOKENS[row_tile]
        stages = -(-tokens // stage)
        per = -(-stages // splits)
        return pl.LatentPlan(row_tile, per * stage, -(-stages // per))
    try:
        for table in (1024, 2048):
            for kind in ("bf16", "int8", "fp8"):
                for mode, (batch, s_q) in (("decode", (8, None)),
                                           ("chunk", (1, 32))):
                    case = cs.make_latent_case(
                        gen, dev, batch=batch, kv_lens=[1024] * batch,
                        s_q=s_q, q_lens=None if s_q is None else [s_q] * batch,
                        kind=kind, mb=table // 16,
                        pool_bytes=cs.TIMED_POOL_BYTES)
                    tables, kw = case["tables"], cs._latent_kw(case)
                    it = {"i": 0}

                    def nxt():
                        it["i"] = (it["i"] + 1) % tables.shape[0]
                        return tables[it["i"]]

                    def args():
                        return (case["q_lat"], case["q_pe"], case["lat"],
                                case["pe"], nxt(), case["kv_lens"],
                                case["w_v"])
                    rows = (s_q or 1) * 32
                    base = plan(batch, rows, table, 512, sms)
                    variants = {f"rows{base.row_tile}_splits{base.splits}":
                                (base, "source")}
                    for tile in ((32,) if mode == "decode" else (32, 64)):
                        for n in (4, 8, 16):
                            v = forced(tile, n, table)
                            variants.setdefault(
                                f"rows{v.row_tile}_splits{v.splits}",
                                (v, "source"))
                    for n in (1, 2, 3):
                        if n != pl.P_TERMS:
                            variants[f"pterms{n}"] = (base, f"pterms{n}")
                    if base.row_tile == 32:
                        variants["stage32_ring3"] = (base, "stage32")
                    else:
                        variants["ring2"] = (base, "ring2")
                    if table == 1024:
                        variants.update({k: (base, k)
                                         for k in _LATENT_ABLATIONS})
                    it["i"] = -1
                    ref = pl.paged_attention_latent_plain(*args(), **kw)

                    def run(label):
                        v, key = variants[label]
                        kbuild._libs[pl.SOURCE] = libs[key]
                        pl.latent_split_plan = lambda *a, v=v: v
                        it["i"] = -1
                        out = pl.paged_attention_latent(*args(), **kw)
                        ms = cs.device_ms(
                            lambda: pl.paged_attention_latent(*args(), **kw))
                        return out, ms
                    labels = list(variants)
                    times = {k: [] for k in labels}
                    errs = {}
                    for k in labels + labels[::-1]:
                        out, t = run(k)
                        times[k].append(t)
                        if k not in errs:
                            got, want = out.float(), ref.float()
                            rms = want.pow(2).mean(-1, keepdim=True).sqrt()
                            errs[k] = float(((got - want).abs()
                                             / torch.maximum(want.abs(), rms))
                                            .max())
                    pl.latent_split_plan = plan
                    names = ("paged_latent_split_kernel",
                             "paged_latent_combine_kernel")
                    us = {}
                    for key in ("source", "no_pdl"):
                        kbuild._libs[pl.SOURCE] = libs[key]
                        us[key] = _kernels_us(
                            lambda: pl.paged_attention_latent(*args(), **kw),
                            names)
                    kbuild._libs.pop(pl.SOURCE, None)
                    print(json.dumps({
                        "shape": mode, "pool": kind, "table_tokens": table,
                        "plan": base._asdict(),
                        "plans": {k: v[0]._asdict()
                                  for k, v in variants.items()},
                        "ms": times, "rel_err_vs_plain": errs,
                        "kernel_us_by_profiler": us}), flush=True)
                    del case, ref
                    torch.cuda.empty_cache()
    finally:
        pl.latent_split_plan = plan
        kbuild._libs.pop(pl.SOURCE, None)


# Row 7's timeline marks, patched into a copy of csrc/paged_latent.cu:
_LATENT_MARKS_HEAD = """
__device__ unsigned long long g_marks[2][2048][10];
__device__ __forceinline__ void mark(int k, int i) {
  if (threadIdx.x == 0) {
    const unsigned bid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    if (bid >= 2048) return;
    unsigned long long t;
    if (i == 0 || i == 9)
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    else
      t = clock64();
    g_marks[k][bid][i] = t;
  }
}
extern "C" int paged_latent_marks(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_marks, sizeof(g_marks));
}
extern "C" int paged_latent_marks_clear() {
  static unsigned long long zeros[2][2048][10];
  return (int)cudaMemcpyToSymbol(g_marks, zeros, sizeof(zeros));
}
"""
_LATENT_MARKS = [   # (rule, its replacement)
    ('#include "tensor_core.cuh"\n',
     '#include "tensor_core.cuh"\n' + _LATENT_MARKS_HEAD),
    ("  // kv_len and the page rows of the first RING stages, read together;\n",
     "  mark(0, 0);\n  mark(0, 1);\n"
     "  // kv_len and the page rows of the first RING stages, read together;\n"),
    ("  tc::pdl_trigger();   // the combine may start staging w_v\n",
     "  tc::pdl_trigger();   // the combine may start staging w_v\n  mark(0, 2);\n"),
    ("  for (int r = tid; r < TM; r += kThr) {\n    m_s[r] = kNegInf;",
     "  mark(0, 3);\n  for (int r = tid; r < TM; r += kThr) {\n    m_s[r] = kNegInf;"),
    ("    __syncthreads();   // stage j has landed; every warp is done with stage j - 1\n",
     "    __syncthreads();   // stage j has landed; every warp is done with stage j - 1\n"
     "    if (j == 0) mark(0, 4);\n"),
    ("    // Masks and the online softmax, LPR lanes a row (warps past the rows\n",
     "    if (j == 0) mark(0, 5);\n"
     "    // Masks and the online softmax, LPR lanes a row (warps past the rows\n"),
    ("    // acc = acc x corr + P . latent (P's terms smallest first).\n",
     "    if (j == 0) mark(0, 6);\n"
     "    // acc = acc x corr + P . latent (P's terms smallest first).\n"),
    ("  // This split's unnormalised acc and (m, l) a row.\n",
     "  mark(0, 7);\n  // This split's unnormalised acc and (m, l) a row.\n"),
    ("make_float2(m_s[r], l_s[r]);\n}\n",
     "make_float2(m_s[r], l_s[r]);\n  __syncthreads();\n  mark(0, 8);\n"
     "  mark(0, 9);\n}\n"),
    ("  // w_v[c0 : c0 + nc, h, d0 : d0 + 128], zeros past dv (an input: no wait\n",
     "  mark(1, 0);\n  mark(1, 1);\n"
     "  // w_v[c0 : c0 + nc, h, d0 : d0 + 128], zeros past dv (an input: no wait\n"),
    ("  tc::pdl_wait();   // the split kernel's partials are complete and visible\n",
     "  mark(1, 2);\n"
     "  tc::pdl_wait();   // the split kernel's partials are complete and visible\n"
     "  mark(1, 3);\n"),
    ("  // u: each row's live splits weighed and added in split order, / max(l,\n",
     "  mark(1, 4);\n"
     "  // u: each row's live splits weighed and added in split order, / max(l,\n"),
    ("  // This quarter's partial tile = u[:, c0 : c0 + nc] . w_v rows, warp w\n",
     "  mark(1, 5);\n"
     "  // This quarter's partial tile = u[:, c0 : c0 + nc] . w_v rows, warp w\n"),
    ("  __threadfence();   // the partial is visible before the count says so\n",
     "  mark(1, 6);\n"
     "  __threadfence();   // the partial is visible before the count says so\n"),
    ("  if (!last_s) return;\n",
     "  mark(1, 7);\n  if (!last_s) {\n    mark(1, 9);\n    return;\n  }\n"),
    ("__float2bfloat16(vv[j]);\n  }\n}\n",
     "__float2bfloat16(vv[j]);\n  }\n  __syncthreads();\n  mark(1, 9);\n}\n")]
_SPLIT_PHASES = ("q_issue_kv_len", "first_loads_issued", "landed",
                 "scores", "softmax", "pv_and_later_stages", "stores")
_COMBINE_PHASES = ("stage_w_v", "wait", "gather_loads_and_weights",
                   "weigh_and_terms", "expand", "partial_store_and_count")


def paged_latent_timeline():
    import numpy as np
    import torch

    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import paged_latent as pl
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    with open(pl.SOURCE) as f:
        text = f.read()
    for rule, repl in _LATENT_MARKS:
        if text.count(rule) != 1:
            raise RuntimeError(f"`{rule}` not found once in paged_latent.cu")
        text = text.replace(rule, repl)
    lib = _build_sources("paged_latent.cu", {"timeline": text})["timeline"]
    kbuild._libs[pl.SOURCE] = lib
    read = lib.paged_latent_marks
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(712)
    try:
        for kind in ("bf16", "int8"):
            for mode, (batch, s_q) in (("decode", (8, None)),
                                       ("chunk", (1, 32))):
                case = cs.make_latent_case(
                    gen, dev, batch=batch, kv_lens=[1024] * batch, s_q=s_q,
                    q_lens=None if s_q is None else [s_q] * batch,
                    kind=kind, pool_bytes=cs.TIMED_POOL_BYTES)
                kw = cs._latent_kw(case)
                tables = case["tables"]

                def call(i):
                    pl.paged_attention_latent(
                        case["q_lat"], case["q_pe"], case["lat"], case["pe"],
                        tables[i % tables.shape[0]], case["kv_lens"],
                        case["w_v"], **kw)
                for i in range(5):
                    call(i)
                torch.cuda.synchronize()
                lib.paged_latent_marks_clear()
                torch.cuda._sleep(50_000_000)
                call(5)
                torch.cuda.synchronize()
                marks = np.zeros((2, 2048, 10), dtype=np.uint64)
                if read(marks.ctypes.data) != 0:
                    raise RuntimeError("reading the marks failed")
                marks = marks.astype(np.int64)
                out = {"shape": mode, "pool": kind}
                t0 = marks[0][marks[0][:, 0] > 0][:, 0].min()
                for k, names in ((0, _SPLIT_PHASES), (1, _COMBINE_PHASES)):
                    m = marks[k][marks[k][:, 0] > 0]
                    full = m[m[:, len(names) + 1] > 0]
                    ns = (m[:, 9] - m[:, 0]).astype(float)
                    cyc = (m[:, len(names) + 1] - m[:, 1]).astype(float)
                    ok = (m[:, 9] > 0) & (m[:, len(names) + 1] > 0)
                    ghz = float(np.median(cyc[ok] / ns[ok])) if ok.any() \
                        else None
                    ph = {}
                    for i, name in enumerate(names):
                        sel = m[m[:, i + 2] > 0]
                        d = (sel[:, i + 2] - sel[:, i + 1]).astype(float)
                        if len(d):
                            ph[name] = {"median_cycles": float(np.median(d)),
                                        "max_cycles": float(d.max()),
                                        "blocks": int(len(d))}
                    out["split" if k == 0 else "combine"] = {
                        "blocks": int(len(m)),
                        "blocks_to_the_end": int(len(full)),
                        "sm_ghz": ghz,
                        "start_us": [float((m[:, 0].min() - t0) / 1e3),
                                     float((m[:, 0].max() - t0) / 1e3)],
                        "end_us": [float((m[ok, 9].min() - t0) / 1e3),
                                   float((m[ok, 9].max() - t0) / 1e3)]
                        if ok.any() else None,
                        "block_us_median": float(np.median(ns[ok])) / 1e3
                        if ok.any() else None,
                        "phases": ph}
                print(json.dumps(out), flush=True)
                del case
                torch.cuda.empty_cache()
    finally:
        kbuild._libs.pop(pl.SOURCE, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("fwd-tiles")
    sub.add_parser("dkv-rows")
    sub.add_parser("paged-splits")
    sub.add_parser("prologue-variants")
    sub.add_parser("fused-variants")
    sub.add_parser("lora-splits")
    sub.add_parser("latent-splits")
    sub.add_parser("paged-latent-splits")
    sub.add_parser("paged-latent-timeline")
    p_flips = sub.add_parser("quant-flips")
    p_flips.add_argument("--parent", required=True,
                         help="a checkout whose quantized kernel runs first")
    p_fab = sub.add_parser("fused-ab")
    p_fab.add_argument("--parent", required=True,
                       help="a checkout whose fused kernels run first")
    p_fab.add_argument("--rounds", type=int, default=1,
                       help="times to run parent, change, change, parent")
    p_sab = sub.add_parser("static-ab")
    p_sab.add_argument("--parent", required=True,
                       help="a checkout whose serve_static phase runs first")
    p_sab.add_argument("--rounds", type=int, default=1,
                       help="times to run parent, change, change, parent")
    p_ab = sub.add_parser("ab")
    p_ab.add_argument("--parent", required=True,
                      help="a checkout whose chip_smoke.py runs first")
    p_ab.add_argument("--skip-train", action="store_true",
                      help="profile phase only")
    p_ab.add_argument("--bf16-only", action="store_true",
                      help="profile the bf16 unfused and fused engines only")
    p_ab.add_argument("--rounds", type=int, default=1,
                      help="times to run parent, change, change, parent")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    {"fwd-tiles": fwd_tiles, "dkv-rows": dkv_rows,
     "paged-splits": paged_splits, "prologue-variants": prologue_variants,
     "fused-variants": fused_variants,
     "quant-flips": lambda: quant_flips(args.parent),
     "fused-ab": lambda: fused_ab(args.parent, args.rounds),
     "static-ab": lambda: static_ab(args.parent, args.rounds),
     "lora-splits": lora_splits,
     "latent-splits": latent_splits,
     "paged-latent-splits": paged_latent_splits,
     "paged-latent-timeline": paged_latent_timeline,
     "ab": lambda: ab(args.parent, args.skip_train, args.bf16_only,
                      args.rounds)}[args.cmd]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
