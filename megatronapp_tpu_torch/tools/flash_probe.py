"""Two measurements of the flash-attention backward pair on one CUDA card
that the smoke run (chip_smoke.py) does not make. From the repository
root:

    python3 -m megatronapp_tpu_torch.tools.flash_probe dkv-rows
        flash_bwd_dkv built with 64 and with 128 kv rows a block (copies
        of the source under build/, dkv_rows<D>() fixed to each), timed in
        turns (64, 128, 128, 64) at FLASH_TIMED_SHAPES; the two results
        compared bit for bit.
    python3 -m megatronapp_tpu_torch.tools.flash_probe ab --parent DIR
        chip_smoke.py's train and train_gpt2 phases of the checkout in DIR
        (e.g. the parent commit, unpacked with git archive) and of this
        one in turns (parent, change, change, parent), one process a run.

Each prints JSON lines. Nothing runs on import, and nothing falls back to
the CPU: without a card the commands fail.
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


def dkv_rows():
    import torch

    from megatronapp_tpu_torch.ops.cuda import build as kbuild
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    cs = _smoke()
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    with open(fa.SOURCE) as f:
        text = f.read()
    rule = "return D == 128 ? 128 : 64;"
    if rule not in text:
        raise RuntimeError(f"dkv-rows: `{rule}` not found in {fa.SOURCE}")
    libs, procs = {}, {}
    for rows in (64, 128):
        out = os.path.join(REPO, "build", "flash_probe", f"rows{rows}")
        os.makedirs(out, exist_ok=True)
        for name in os.listdir(kbuild.CSRC):
            if name.endswith(kbuild.HEADER_SUFFIXES):
                with open(os.path.join(kbuild.CSRC, name)) as f, \
                        open(os.path.join(out, name), "w") as g:
                    g.write(f.read())
        src = os.path.join(out, "flash_attention.cu")
        with open(src, "w") as f:
            f.write(text.replace(rule, f"return {rows};"))
        procs[rows] = (os.path.join(out, "flash_attention.so"), subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o",
             os.path.join(out, "flash_attention.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for rows, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"dkv-rows: nvcc failed at {rows} rows:\n{log}")
        print(json.dumps({"rows": rows, "ptxas": _ptxas(log)}), flush=True)
        libs[rows] = ctypes.CDLL(lib)
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
            times[rows].append(cs.cuda_time_ms(
                lambda: fa.flash_bwd_dkv(*args), iters=20))
        torch.cuda.synchronize()
        print(json.dumps({
            "shape": name, "rows64_ms": times[64], "rows128_ms": times[128],
            "bit_identical": all(torch.equal(x, y) for x, y in
                                 zip(grads[64], grads[128]))}), flush=True)
    kbuild._libs.pop(fa.SOURCE, None)


def ab(parent: str):
    code = ("import sys; sys.path.insert(0, '.'); import torch, chip_smoke "
            "as c; torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; s = {}; "
            "c.phase_train(s, 4); c.phase_train_gpt2(s)")
    keys = ("step_ms", "mean_step_ms_after_first", "tokens_per_s", "mfu",
            "peak_mem_bytes", "launches")
    trees = {"parent": os.path.abspath(parent), "change": REPO}
    for which in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "-c", code], cwd=trees[which],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"ab: the {which} run failed:\n"
                               f"{proc.stderr[-3000:]}")
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            row = {"tree": which, "phase": rec.get("phase"),
                   **{k: rec.get(k) for k in keys}}
            prof = rec.get("profiled_steps")
            if prof:
                row["device_ms_per_step"] = prof["device_ms_per_unit_by_family"]
                row["device_idle_share"] = prof["device_idle_share"]
            print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("dkv-rows")
    p_ab = sub.add_parser("ab")
    p_ab.add_argument("--parent", required=True,
                      help="a checkout whose chip_smoke.py runs first")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.cmd == "dkv-rows":
        dkv_rows()
    else:
        ab(args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
