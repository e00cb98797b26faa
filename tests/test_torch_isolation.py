"""The port stands apart from the JAX package and from the CPU.

- importing every module of megatronapp_tpu_torch (and chip_smoke.py)
  pulls in neither jax nor megatronapp_tpu, and neither that, nor the
  native data helpers, a corpus, a GPTDataset and a checkpointed
  pretrain_gpt open or dlopen any file under megatronapp_tpu/;
- entry points default to the card and raise where there is none (the
  MegaScan / MegaScope ones too: the static engine, traced pretrain_gpt,
  the training scope session);
- a tensor that is not on the CPU never reaches a kernel's plain version;
- the weight converter refuses leaves it does not place;
- on a card (tests marked cuda; no jax needed there), the paged, flash
  and fused kernels launch and match their plain versions, the quantized
  paged kernel (int8 and fp8 pools), the resident-int8 fused kernels, the
  segmented LoRA kernel, the fused kernels' LoRA epilogues, the MLA
  latent kernel (bf16, int8 and fp8 pools), the fused MLA prologue and
  the two latent tensor-parallel kernels (block scores and weighted sum)
  included;
- the tensor-parallel group (build_mesh) and the tp engine default to the
  card and raise without one;
- the training grid (a dp × tp build_mesh, pretrain_gpt.py's build_grid
  under a launcher's environment) takes the card too and raises without
  one before a group is joined; an expert-parallel one as well;
- the converter refuses a MoE leaf it does not place.
"""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import megatronapp_tpu_torch
from megatronapp_tpu_torch.models.convert import params_from_jax
from megatronapp_tpu_torch.ops.cuda import paged_attention as cuda_pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(megatronapp_tpu_torch.__file__)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="megatronapp_tpu_torch."))


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert {"megatronapp_tpu_torch.inference.dynamic_engine",
            "megatronapp_tpu_torch.parallel.mesh",
            "megatronapp_tpu_torch.parallel.collectives",
            "megatronapp_tpu_torch.config.parallel_config",
            "megatronapp_tpu_torch.ops.cuda.latent_tp",
            "megatronapp_tpu_torch.training.train",
            "megatronapp_tpu_torch.pretrain_gpt",
            "megatronapp_tpu_torch.ops.cuda.flash_attention",
            "megatronapp_tpu_torch.inference.speculative",
            "megatronapp_tpu_torch.trace.tracer",
            "megatronapp_tpu_torch.trace.aggregate",
            "megatronapp_tpu_torch.trace.dependency",
            "megatronapp_tpu_torch.trace.detect",
            "megatronapp_tpu_torch.trace.analytics",
            "megatronapp_tpu_torch.scope.hooks",
            "megatronapp_tpu_torch.scope.disturbance",
            "megatronapp_tpu_torch.scope.tensor_tracer",
            "megatronapp_tpu_torch.scope.ws_server",
            "megatronapp_tpu_torch.scope.client",
            "megatronapp_tpu_torch.tools.run_scope_server",
            "megatronapp_tpu_torch.data.indexed_dataset",
            "megatronapp_tpu_torch.data.helpers",
            "megatronapp_tpu_torch.data.blended",
            "megatronapp_tpu_torch.training.checkpointing",
            "megatronapp_tpu_torch.training.train_state",
            "megatronapp_tpu_torch.training.num_microbatches_calculator",
            "megatronapp_tpu_torch.training.metrics",
            "megatronapp_tpu_torch.training.signals",
            "megatronapp_tpu_torch.transformer.mtp",
            "megatronapp_tpu_torch.parallel.sharding",
            "megatronapp_tpu_torch.parallel.schedule",
            "megatronapp_tpu_torch.parallel.pipeline",
            "megatronapp_tpu_torch.parallel.fbd",
            "megatronapp_tpu_torch.runtime.dpp",
            "megatronapp_tpu_torch.runtime.dpp_train",
            "megatronapp_tpu_torch.training.distributed_optimizer",
            "megatronapp_tpu_torch.ops.cross_entropy",
            "megatronapp_tpu_torch.ops.context_parallel",
            "megatronapp_tpu_torch.transformer.moe",
            "megatronapp_tpu_torch.parallel.overlap",
            "megatronapp_tpu_torch.training.fp8"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'megatronapp_tpu' or "
        "m.startswith('megatronapp_tpu.'))\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_the_port_opens_no_file_of_the_jax_package(tmp_path):
    """Importing every module, building and running the native data
    helpers, writing and reading a corpus and a GPTDataset, a checkpoint
    round trip and a two-step pretrain_gpt on it: no file under
    megatronapp_tpu/ is opened or dlopened (the JAX tree holds a built
    libdata_helpers.so the port must never load)."""
    code = (
        "import importlib, os, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"jax_dir = os.path.join({REPO!r}, 'megatronapp_tpu') + os.sep\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen', 'os.listdir') and args:\n"
        "        path = args[0]\n"
        "        if isinstance(path, (str, bytes, os.PathLike)):\n"
        "            path = os.path.abspath(os.fsdecode(path))\n"
        "            if path.startswith(jax_dir):\n"
        "                seen.append((event, path))\n"
        "sys.addaudithook(hook)\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "import numpy as np, torch\n"
        "from megatronapp_tpu_torch.data import helpers\n"
        "from megatronapp_tpu_torch.data.gpt_dataset import GPTDataset\n"
        "from megatronapp_tpu_torch.data.indexed_dataset import (\n"
        "    IndexedDataset, IndexedDatasetWriter)\n"
        "assert helpers.native_available()\n"
        f"prefix = {str(tmp_path / 'c')!r}\n"
        "with IndexedDatasetWriter(prefix, np.uint16) as w:\n"
        "    for i in range(20):\n"
        "        w.add_document(np.arange(5 + i) % 100)\n"
        "ds = GPTDataset(IndexedDataset(prefix), 8, 30, seed=1)\n"
        "from megatronapp_tpu_torch.config.training_config import (\n"
        "    OptimizerConfig, TrainingConfig)\n"
        "from megatronapp_tpu_torch.config.transformer_config import (\n"
        "    TransformerConfig)\n"
        "from megatronapp_tpu_torch.data.gpt_dataset import gpt_batches\n"
        "from megatronapp_tpu_torch.training.train import pretrain_gpt\n"
        "cfg = TransformerConfig(num_layers=1, hidden_size=32,\n"
        "    num_attention_heads=2, vocab_size=128,\n"
        "    max_position_embeddings=16, compute_dtype=torch.float32)\n"
        f"tc = TrainingConfig(micro_batch_size=2, global_batch_size=2,\n"
        f"    seq_length=8, train_iters=2, save_dir={str(tmp_path / 'k')!r},\n"
        "    save_interval=1)\n"
        "for _ in range(2):\n"
        "    pretrain_gpt(cfg, tc, OptimizerConfig(), device='cpu',\n"
        "        batch_iter_factory=lambda c: gpt_batches(ds, 2, c),\n"
        "        log_fn=lambda s: None)\n"
        "print('SEEN', seen)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SEEN []" in out.stdout, out.stdout[-3000:]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "megatronapp_tpu"), (
                    f"{path} imports {n}")


def test_engine_defaults_to_the_card_and_raises_without_one(monkeypatch):
    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama3_8b(num_layers=1, hidden_size=64, num_attention_heads=4,
                    num_query_groups=2, ffn_hidden_size=128,
                    vocab_size=128)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynamicInferenceEngine(params, cfg, max_seq_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_mla_engine_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama3_8b(num_layers=1, hidden_size=64, num_attention_heads=4,
                    num_query_groups=4, ffn_hidden_size=128,
                    vocab_size=128, multi_latent_attention=True,
                    kv_lora_rank=32, qk_head_dim=16, qk_pos_emb_head_dim=8,
                    v_head_dim=16)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynamicInferenceEngine(params, cfg, max_seq_len=32)
    eng = DynamicInferenceEngine(params, cfg, max_seq_len=32, device="cpu")
    assert [tuple(p.shape[-1:]) for p in eng.pool.pages] == [(32,), (8,)]


def test_serve_entry_point_raises_without_a_card(monkeypatch):
    from megatronapp_tpu_torch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parse_args(["--preset", "gpt2-125m", "--engine", "dynamic",
                             "--paged-kv-cache", "--num-layers", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_engine(args)


def test_pretrain_gpt_entry_point_raises_without_a_card(monkeypatch):
    from megatronapp_tpu_torch import pretrain_gpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--num-layers", "1", "--hidden-size", "64",
            "--num-attention-heads", "4", "--vocab-size", "128",
            "--seq-length", "16", "--train-iters", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_gpt.main(argv)


@pytest.mark.parametrize("argv,msg", [
    (["--engine", "mamba"], "not ported"),
    (["--engine", "dynamic"], "--paged-kv-cache"),
    (["--engine", "dynamic", "--lora-dir", "x"], "LoRA"),
    (["--engine", "dynamic", "--paged-kv-cache", "--serve-disagg"],
     "disaggregated serving"),
    (["--engine", "dynamic", "--paged-kv-cache", "--megakernel-vmem-budget",
      "1000"], "VMEM budget"),
    (["--engine", "dynamic", "--paged-kv-cache", "--load-quantized", "x"],
     "int8 checkpoints"),
])
def test_serve_flags_outside_the_slice_exit(argv, msg, capsys):
    from megatronapp_tpu_torch import serve
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    assert msg in capsys.readouterr().err


def test_serve_engine_static_parses():
    """--engine static is ported (and the default, as in JAX): it parses
    without --paged-kv-cache."""
    from megatronapp_tpu_torch import serve
    assert serve.parse_args(["--engine", "static"]).engine == "static"
    assert serve.parse_args([]).engine == "static"


def test_megascan_and_megascope_entry_points_raise_without_a_card(
        monkeypatch, tmp_path):
    """The static engine, traced pretrain_gpt, the training scope session
    and the static server's engine default to the card and raise without
    one; device="cpu" builds them."""
    from megatronapp_tpu_torch import pretrain_gpt, serve
    from megatronapp_tpu_torch.config.training_config import (
        OptimizerConfig, TrainingConfig,
    )
    from megatronapp_tpu_torch.inference.engine import StaticInferenceEngine
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.scope.ws_server import TrainingScopeSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama3_8b(num_layers=1, hidden_size=64, num_attention_heads=4,
                    num_query_groups=2, ffn_hidden_size=128,
                    vocab_size=128)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticInferenceEngine(params, cfg, max_seq_len=32)
    assert StaticInferenceEngine(params, cfg, max_seq_len=32,
                                 device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainingScopeSession(cfg, TrainingConfig(), OptimizerConfig())
    argv = ["--num-layers", "1", "--hidden-size", "64",
            "--num-attention-heads", "4", "--vocab-size", "128",
            "--seq-length", "16", "--train-iters", "1", "--trace",
            "--trace-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_gpt.main(argv)
    args = serve.parse_args(["--preset", "gpt2-125m", "--num-layers", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_engine(args)


def test_serve_megakernel_decode_parses():
    """--megakernel-decode is ported: it parses and reaches the engine."""
    from megatronapp_tpu_torch import serve
    args = serve.parse_args(["--engine", "dynamic", "--paged-kv-cache",
                             "--megakernel-decode"])
    assert args.megakernel_decode is True
    assert serve.parse_args(["--engine", "dynamic",
                             "--paged-kv-cache"]).megakernel_decode is False


def test_serve_quantized_flags_parse():
    """--kv-cache-dtype int8|fp8 and --quantized-weights are ported: they
    parse and reach the engine; --load-quantized still exits, naming why."""
    from megatronapp_tpu_torch import serve
    args = serve.parse_args(["--engine", "dynamic", "--paged-kv-cache",
                             "--kv-cache-dtype", "fp8",
                             "--quantized-weights"])
    assert args.kv_cache_dtype == "fp8" and args.quantized_weights is True
    args = serve.parse_args(["--engine", "dynamic", "--paged-kv-cache"])
    assert args.kv_cache_dtype == "bf16" and args.quantized_weights is False
    with pytest.raises(SystemExit):
        serve.parse_args(["--engine", "dynamic", "--paged-kv-cache",
                          "--load-quantized", "x"])


def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch):
    """The wrapper takes the plain version only for CPU tensors: any
    other device goes to the kernel path, which raises for what it cannot
    launch (here a meta tensor) instead of falling back."""
    def no_plain(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(cuda_pa, "paged_attention_plain", no_plain)
    q = torch.empty(2, 4, 64, device="meta")
    pools = torch.empty(6, 4, 2, 64, device="meta")
    table = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    lens = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pa.paged_attention(q, pools, pools, table, lens)


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernel(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")

    def no_plain(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(cuda_pa, "paged_attention_plain", no_plain)
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 128, generator=g).to(dev, torch.bfloat16)
    kp = torch.randn(6, 16, 2, 128, generator=g).to(dev, torch.bfloat16)
    table = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32,
                         device=dev)
    lens = torch.tensor([5, 40], dtype=torch.int32, device=dev)
    before = cuda_pa.launches["decode"]
    out = cuda_pa.paged_attention(q, kp, kp, table, lens)
    torch.cuda.synchronize()
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert cuda_pa.launches["decode"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d,hq,hkv,s,causal,segments", [
    (128, 8, 2, 200, True, False), (64, 4, 4, 130, False, True),
    (128, 8, 2, 1000, True, False)])
def test_flash_kernels_match_plain_versions(d, hq, hkv, s, causal,
                                            segments):
    """bf16 kernels (one launch each) against the plain versions: on the
    same bf16 inputs, fed the kernels' own LSE and delta, each element
    within 0.06 of max(its row's RMS, its head's RMS); against fp32, each
    gradient within 0.02 of its head's norm (chip_smoke.py argues both).
    A second backward on the same inputs repeats every bit (one writer per
    element, a fixed order of sums)."""
    from megatronapp_tpu_torch.ops.cuda import flash_attention as fa
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(6)
    q, k, v, go = (torch.randn(2, s, h, d, generator=g).to(dev, torch.bfloat16)
                   for h in (hq, hkv, hkv, hq))
    seg = (torch.sort(torch.randint(0, 3, (2, s), generator=g), dim=1)
           .values.to(dev, torch.int32) if segments else None)
    before = dict(fa.launches)
    out, lse = fa.flash_forward(q, k, v, causal, None, seg)
    grads = fa.flash_backward(q, k, v, out, lse, go, causal, None, seg)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    rerun = fa.flash_backward(q, k, v, out, lse, go, causal, None, seg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, rerun))
    same = fa.flash_backward_plain(q, k, v, go, lse,
                                   fa.attention_delta(out, go), causal,
                                   None, seg)
    f32 = [t.float() for t in (q, k, v, go)]
    ref_out, ref_lse = fa.flash_forward_plain(*f32[:3], causal, None, seg)
    ref = fa.flash_backward_plain(*f32, ref_lse,
                                  fa.attention_delta(ref_out, f32[3]),
                                  causal, None, seg)
    row = ref_out.pow(2).mean(-1, keepdim=True).sqrt()
    assert float(((out.float() - ref_out).abs() / row).max()) < 0.06
    for got, s_ref, f_ref in zip(grads, same, ref):
        err = (got.float() - s_ref.float()).abs()
        s_ref = s_ref.float()
        scale = torch.maximum(s_ref.pow(2).mean(-1, keepdim=True).sqrt(),
                              s_ref.pow(2).mean((1, 3), keepdim=True).sqrt())
        assert float((err / scale).max()) < 0.06
        norm = ((got.float() - f_ref).pow(2).sum((1, 3))
                / f_ref.pow(2).sum((1, 3))).sqrt()
        assert float(norm.max()) < 0.02


def _jax_tree(cfg):
    """A minimal JAX-layout param tree (numpy leaves) for `cfg`."""
    h, L = cfg.hidden_size, cfg.num_layers
    nq, nkv, d, f = (cfg.num_attention_heads, cfg.num_query_groups,
                     cfg.head_dim, cfg.ffn_hidden_size)
    z = np.zeros
    return {
        "embedding": {"word": z((cfg.vocab_size, h), np.float32)},
        "final_ln_scale": z((h,), np.float32),
        "output": z((h, cfg.vocab_size), np.float32),
        "block": {
            "ln1_scale": z((L, h), np.float32),
            "ln2_scale": z((L, h), np.float32),
            "attention": {"q_kernel": z((L, h, nq * d), np.float32),
                          "kv_kernel": z((L, h, 2 * nkv * d), np.float32),
                          "out_kernel": z((L, nq * d, h), np.float32)},
            "mlp": {"fc1_kernel": z((L, h, 2 * f), np.float32),
                    "fc2_kernel": z((L, f, h), np.float32)},
        },
    }


@pytest.mark.parametrize("where", ["top", "embedding", "block",
                                   "attention", "mlp"])
def test_convert_raises_on_unknown_leaf(where):
    from megatronapp_tpu_torch.models.presets import llama3_8b
    cfg = llama3_8b(num_layers=2, hidden_size=64, num_attention_heads=4,
                    num_query_groups=2, ffn_hidden_size=128,
                    vocab_size=128)
    t = _jax_tree(cfg)
    params_from_jax(t, cfg)                    # the known tree converts
    extra = np.zeros((2, 4), np.float32)
    {"top": t, "embedding": t["embedding"], "block": t["block"],
     "attention": t["block"]["attention"],
     "mlp": t["block"]["mlp"]}[where]["mystery"] = extra
    with pytest.raises(KeyError, match="unknown leaf"):
        params_from_jax(t, cfg)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card_or_the_repo(alone, tmp_path):
    """No CUDA device: non-zero exit, no result line. A directory holding
    only chip_smoke.py cannot succeed either."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, os.path.join(cwd, "chip_smoke.py"))
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=120, cwd=cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.cuda
def test_fused_kernels_match_plain_versions():
    """Each kernel, launched once on llama3-8b-shaped bf16 tensors (widths
    cut to 1024), within 0.06 of max(|element|, its row's RMS) of its plain
    version on the same inputs (chip_smoke.py FUSED_TOL argues the
    bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import fused_decode as cuda_fd
    dev = torch.device("cuda", 0)
    cfg = llama3_8b(num_layers=1, hidden_size=1024, num_attention_heads=8,
                    num_query_groups=2, ffn_hidden_size=2048,
                    vocab_size=256, params_dtype=torch.bfloat16)
    p = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0),
                        dev)["layers"][0]
    g = torch.Generator().manual_seed(1)
    for rows in (8, 32):
        x = torch.randn(rows, 1024, generator=g).to(dev, torch.bfloat16)
        cos, sin = (torch.randn(rows, 64, generator=g).to(dev)
                    for _ in range(2))
        before = dict(cuda_fd.launches)
        got = [*cuda_fd.fused_qkv(x, p, cfg, cos, sin),
               cuda_fd.fused_out_proj(x, p, cfg, x),
               cuda_fd.fused_mlp_fc1(x, p, cfg)]
        got.append(cuda_fd.fused_mlp_fc2(got[-1], x, p, cfg))
        want = [*cuda_fd.fused_qkv_plain(x, p, cfg, cos, sin),
                cuda_fd.fused_out_proj_plain(x, p, cfg, x),
                cuda_fd.fused_mlp_fc1_plain(x, p, cfg)]
        want.append(cuda_fd.fused_mlp_fc2_plain(got[-2], x, p, cfg))
        torch.cuda.synchronize()
        assert {k: cuda_fd.launches[k] - before[k] for k in before} == {
            k: int(not k.endswith("_int8")) for k in before}
        for a, b in zip(got, want):
            a, b = a.float().reshape(rows, -1), b.float().reshape(rows, -1)
            rms = b.pow(2).mean(dim=-1, keepdim=True).sqrt()
            scale = torch.maximum(b.abs(), rms)
            assert float(((a - b).abs() / scale).max()) <= 0.06


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_paged_kernel_matches_plain_version(kind):
    """The quantized paged kernel (one launch a call, counted by mode and
    pool dtype) against its plain version on the same quantized pools:
    both dequantize float(page) × scale and compute in fp32, so each
    output element is held to 5e-3 of max(|element|, its (row, head)
    RMS): the kernel's bf16 output rounding (chip_smoke.py QUANT_REL_TOL
    argues the bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from megatronapp_tpu_torch.ops.paged_attention import quantize_kv_rows
    dt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kind]
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(3)
    pools = [quantize_kv_rows(torch.randn(12, 16, 2, 128, generator=g).to(
        dev), dt) for _ in range(2)]
    (kq, ks), (vq, vs) = pools
    table = torch.arange(12, dtype=torch.int32, device=dev).reshape(2, 6)
    lens = torch.tensor([7, 90], dtype=torch.int32, device=dev)
    for q, q_lens in ((torch.randn(2, 8, 128, generator=g), None),
                      (torch.randn(2, 5, 8, 128, generator=g),
                       torch.tensor([5, 3], dtype=torch.int32, device=dev))):
        q = q.to(dev, torch.bfloat16)
        mode = "decode" if q_lens is None else "ragged"
        before = cuda_pa.launches[f"{mode}_{kind}"]
        out = cuda_pa.paged_attention(q, kq, vq, table, lens, q_lens=q_lens,
                                      k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        assert cuda_pa.launches[f"{mode}_{kind}"] == before + 1
        ref = cuda_pa.paged_attention_plain(q.float(), kq, vq, table, lens,
                                            q_lens=q_lens, k_scales=ks,
                                            v_scales=vs)
        got = out.float()
        if q_lens is not None:
            real = torch.arange(5, device=dev)[None, :] < q_lens[:, None]
            got, ref = got[real], ref[real]
        rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
        scale = torch.maximum(ref.abs(), rms)
        assert float(((got - ref).abs() / scale).max()) <= 5e-3


@pytest.mark.cuda
def test_resident_int8_fused_kernels_match_plain_versions():
    """The fused kernels on resident int8 weights (launches counted as
    "<kernel>_int8"), llama3-8b-shaped with widths cut to 1024, within 0.06
    of max(|element|, row RMS) of their plain versions (FUSED_TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from megatronapp_tpu_torch.inference.quantization import (
        quantize_for_serving,
    )
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import fused_decode as cuda_fd
    dev = torch.device("cuda", 0)
    cfg = llama3_8b(num_layers=1, hidden_size=1024, num_attention_heads=8,
                    num_query_groups=2, ffn_hidden_size=2048,
                    vocab_size=256, params_dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    p = quantize_for_serving(params)[0]["layers"][0]
    g = torch.Generator().manual_seed(1)
    for rows in (8, 32):
        x = torch.randn(rows, 1024, generator=g).to(dev, torch.bfloat16)
        cos, sin = (torch.randn(rows, 64, generator=g).to(dev)
                    for _ in range(2))
        before = dict(cuda_fd.launches)
        got = [*cuda_fd.fused_qkv(x, p, cfg, cos, sin),
               cuda_fd.fused_out_proj(x, p, cfg, x),
               cuda_fd.fused_mlp_fc1(x, p, cfg)]
        got.append(cuda_fd.fused_mlp_fc2(got[-1], x, p, cfg))
        want = [*cuda_fd.fused_qkv_plain(x, p, cfg, cos, sin),
                cuda_fd.fused_out_proj_plain(x, p, cfg, x),
                cuda_fd.fused_mlp_fc1_plain(x, p, cfg)]
        want.append(cuda_fd.fused_mlp_fc2_plain(got[-2], x, p, cfg))
        torch.cuda.synchronize()
        assert {k: cuda_fd.launches[k] - before[k] for k in before} == {
            k: int(k.endswith("_int8")) for k in before}
        for a, b in zip(got, want):
            a, b = a.float().reshape(rows, -1), b.float().reshape(rows, -1)
            rms = b.pow(2).mean(dim=-1, keepdim=True).sqrt()
            scale = torch.maximum(b.abs(), rms)
            assert float(((a - b).abs() / scale).max()) <= 0.06


@pytest.mark.cuda
def test_lora_kernel_matches_plain_version():
    """The segmented LoRA delta (csrc/lora.cu; one shrink and one expand
    launch a call) against lora_delta_plain on the same inputs, both fp32
    after the bf16 x: each element within 1e-4 of max(|element|, its row's
    RMS) (chip_smoke.py LORA_TOL argues the bound); NULL rows exactly 0;
    each row the same bits alone as in the mixed batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from megatronapp_tpu_torch.ops import lora as tlo
    from megatronapp_tpu_torch.ops.cuda import lora as cuda_lora
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(5)
    for din, dout, rank, ids in ((1024, 2048, 8, [1, 0, 2, 3, 4, 2, 0, 1]),
                                 (2048, 640, 16, [3] * 32)):
        a = (torch.randn(5, din, rank, generator=g) / din ** 0.5).to(dev)
        b = (torch.randn(5, rank, dout, generator=g) * 0.2).to(dev)
        a[0], b[0] = 0, 0
        x = torch.randn(len(ids), din, generator=g).to(dev, torch.bfloat16)
        before = dict(cuda_lora.launches)
        got = tlo.lora_delta(x, a, b, np.asarray(ids))
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in cuda_lora.launches.items()} \
            == {"lora_shrink": 1, "lora_expand": 1}
        want = tlo.lora_delta_plain(x, a, b,
                                    torch.tensor(ids, device=dev))
        rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
        scale = torch.maximum(want.abs(), rms).clamp_min(1e-30)
        assert float(((got - want).abs() / scale).max()) <= 1e-4
        null = torch.tensor(ids, device=dev) == 0
        assert bool((got[null] == 0).all())
        for r in (0, len(ids) - 1):
            alone = tlo.lora_delta(x[r:r + 1].contiguous(), a, b,
                                   np.asarray(ids[r:r + 1]))
            assert torch.equal(alone[0], got[r])


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_lora_epilogue_kernels_match_plain_versions(weights):
    """The four fused kernels with their LoRA epilogue (counted in
    lora_launches), llama3-8b-shaped with widths cut to 1024, within 0.06
    of max(|element|, row RMS) of their plain versions with the same
    deltas (FUSED_TOL); a batch of NULL rows gives the bits of the kernels
    without the epilogue."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from megatronapp_tpu_torch.inference.lora import lora_target_dims
    from megatronapp_tpu_torch.inference.quantization import (
        quantize_for_serving,
    )
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import fused_decode as cuda_fd
    from megatronapp_tpu_torch.ops.lora import LoraRows
    dev = torch.device("cuda", 0)
    cfg = llama3_8b(num_layers=1, hidden_size=1024, num_attention_heads=8,
                    num_query_groups=2, ffn_hidden_size=2048,
                    vocab_size=256, params_dtype=torch.bfloat16)
    params = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    if weights == "int8":
        params = quantize_for_serving(params)[0]
    p = params["layers"][0]
    g = torch.Generator().manual_seed(2)
    banks = {}
    for t, (din, dout) in lora_target_dims(cfg).items():
        a = (torch.randn(5, din, 8, generator=g) / din ** 0.5).to(dev)
        b = (torch.randn(5, 8, dout, generator=g) * 0.2).to(dev)
        a[0], b[0] = 0, 0
        banks[t] = (a, b)
    sfx = "_int8" if weights == "int8" else ""
    for rows, ids in ((8, [1, 0, 2, 3, 4, 2, 0, 1]), (32, [3] * 32)):
        lora = {"row_adapter": LoraRows(np.asarray(ids), dev),
                "banks": banks}
        null = {"row_adapter": LoraRows(np.zeros(rows, np.int32), dev),
                "banks": banks}
        x = torch.randn(rows, 1024, generator=g).to(dev, torch.bfloat16)
        cos, sin = (torch.randn(rows, 64, generator=g).to(dev)
                    for _ in range(2))
        before = dict(cuda_fd.lora_launches)
        got = [*cuda_fd.fused_qkv(x, p, cfg, cos, sin, lora),
               cuda_fd.fused_out_proj(x, p, cfg, x, lora),
               cuda_fd.fused_mlp_fc1(x, p, cfg, lora)]
        got.append(cuda_fd.fused_mlp_fc2(got[-1], x, p, cfg, lora))
        want = [*cuda_fd.fused_qkv_plain(x, p, cfg, cos, sin, lora),
                cuda_fd.fused_out_proj_plain(x, p, cfg, x, lora),
                cuda_fd.fused_mlp_fc1_plain(x, p, cfg, lora)]
        want.append(cuda_fd.fused_mlp_fc2_plain(got[-2], x, p, cfg, lora))
        torch.cuda.synchronize()
        assert {k: cuda_fd.lora_launches[k] - before[k] for k in before} \
            == {k: int(k.endswith("_int8") == bool(sfx)) for k in before}
        for a, b in zip(got, want):
            a, b = a.float().reshape(rows, -1), b.float().reshape(rows, -1)
            rms = b.pow(2).mean(dim=-1, keepdim=True).sqrt()
            scale = torch.maximum(b.abs(), rms)
            assert float(((a - b).abs() / scale).max()) <= 0.06
        y = cuda_fd.fused_mlp_fc1(x, p, cfg)
        assert torch.equal(cuda_fd.fused_mlp_fc1(x, p, cfg, null), y)
        assert torch.equal(cuda_fd.fused_mlp_fc2(y, x, p, cfg, null),
                           cuda_fd.fused_mlp_fc2(y, x, p, cfg))
        assert all(torch.equal(u, v) for u, v in zip(
            cuda_fd.fused_qkv(x, p, cfg, cos, sin, null),
            cuda_fd.fused_qkv(x, p, cfg, cos, sin)))


def _latent_case(dev, kind, ragged, g, b=3, nq=8, klat=512, dpe=64, dv=128,
                 bs=16, mb=8):
    """Inputs of the latent kernel at MLA's widths: pools (quantized by
    quantize_kv_rows for int8/fp8), and w_v as the strided view of a
    kv_up [klat, nq * (dqk + dv)] that the layers pass."""
    from megatronapp_tpu_torch.ops.paged_attention import quantize_kv_rows
    nb = b * mb + 1
    pools = [torch.randn(nb, bs, d, generator=g).to(dev) for d in (klat, dpe)]
    scales = [None, None]
    if kind == "bf16":
        pools = [p.to(torch.bfloat16) for p in pools]
    else:
        dt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kind]
        pools, scales = zip(*(quantize_kv_rows(p, dt) for p in pools))
    kv_up = torch.randn(klat, nq * (128 + dv), generator=g).to(
        dev, torch.bfloat16) / klat ** 0.5
    w_v = kv_up.reshape(klat, nq, 128 + dv)[..., 128:]
    table = (1 + torch.randperm(nb - 1, generator=g)[:b * mb]).reshape(
        b, mb).to(dev, torch.int32)
    lens = torch.tensor([1, 37, bs * mb], dtype=torch.int32, device=dev)
    s_q = 7 if ragged else None
    shape = (b, s_q, nq) if ragged else (b, nq)
    q_lat = torch.randn(*shape, klat, generator=g).to(dev, torch.bfloat16)
    q_pe = torch.randn(*shape, dpe, generator=g).to(dev, torch.bfloat16)
    q_lens = (torch.tensor([1, 7, 5], dtype=torch.int32, device=dev)
              if ragged else None)
    return (q_lat, q_pe, *pools, table, lens, w_v), q_lens, scales


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_latent_kernel_matches_plain_version(kind):
    """The MLA latent kernels (csrc/paged_latent.cu; a split and a combine
    launch a call, counted once by mode and pool dtype), decode and ragged,
    against their plain version on the same inputs: both take the same
    rounded q and fp32 pool values and sum in fp32 in other orders, then
    round the output to bf16, so each element is held to 0.01 of
    max(|element|, its (row, head) RMS) (chip_smoke.py MLA_TOL argues the
    bound); a rerun repeats every bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from megatronapp_tpu_torch.ops.cuda import paged_latent as cuda_pl
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(7)
    sfx = "" if kind == "bf16" else f"_{kind}"
    for ragged in (False, True):
        args, q_lens, (ls, ps) = _latent_case(dev, kind, ragged, g)
        key = ("ragged" if ragged else "decode") + sfx
        before = cuda_pl.launches[key]
        kw = dict(q_lens=q_lens, softmax_scale=1 / 192 ** 0.5,
                  lat_scales=ls, pe_scales=ps)
        out = cuda_pl.paged_attention_latent(*args, **kw)
        again = cuda_pl.paged_attention_latent(*args, **kw)
        torch.cuda.synchronize()
        assert cuda_pl.launches[key] == before + 2
        assert torch.equal(out, again)
        ref = cuda_pl.paged_attention_latent_plain(*args, **kw).float()
        got = out.float()
        if ragged:
            real = torch.arange(7, device=dev)[None, :] < q_lens[:, None]
            got, ref = got[real], ref[real]
        rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
        scale = torch.maximum(ref.abs(), rms)
        assert bool(torch.isfinite(got).all())
        assert float(((got - ref).abs() / scale).max()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("q_lora_rank", [None, 384])
def test_fused_mla_prologue_matches_plain_version(q_lora_rank):
    """The fused MLA prologue (csrc/fused_mla.cu, two launches a call) on
    MLA-shaped bf16 tensors (widths cut to hidden 1024, 8 heads), 8 and 32
    rows, with rope and YaRN's m², within 0.06 of max(|element|, row RMS)
    of its plain version (FUSED_TOL); a rerun repeats every bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.ops.cuda import fused_mla as cuda_mla
    dev = torch.device("cuda", 0)
    cfg = llama3_8b(num_layers=1, hidden_size=1024, num_attention_heads=8,
                    num_query_groups=8, ffn_hidden_size=2048,
                    vocab_size=256, params_dtype=torch.bfloat16,
                    multi_latent_attention=True, q_lora_rank=q_lora_rank,
                    position_embedding="yarn", rope_scaling_factor=4.0)
    p = init_gpt_params(cfg, torch.Generator(dev).manual_seed(0),
                        dev)["layers"][0]
    g = torch.Generator().manual_seed(1)
    for t in p.parameters():
        if t.dim() == 1:
            t.copy_(1 + 0.1 * torch.randn(t.shape, generator=g))
    for rows in (8, 32):
        x = torch.randn(rows, 1024, generator=g).to(dev, torch.bfloat16)
        cos, sin = (torch.randn(rows, 32, generator=g).to(dev)
                    for _ in range(2))
        before = dict(cuda_mla.launches)
        got = cuda_mla.fused_mla_qkv(x, p, cfg, cos, sin)
        again = cuda_mla.fused_mla_qkv(x, p, cfg, cos, sin)
        want = cuda_mla.fused_mla_qkv_plain(x, p, cfg, cos, sin)
        torch.cuda.synchronize()
        assert {k: cuda_mla.launches[k] - before[k] for k in before} == {
            "mla_down": 2, "mla_up": 2}
        for a, a2, b in zip(got, again, want):
            assert torch.equal(a, a2)
            a, b = a.float().reshape(rows, -1), b.float().reshape(rows, -1)
            rms = b.pow(2).mean(dim=-1, keepdim=True).sqrt()
            scale = torch.maximum(b.abs(), rms)
            assert float(((a - b).abs() / scale).max()) <= 0.06


def test_tp_group_and_engine_default_to_the_card(monkeypatch):
    """build_mesh with no device resolves the card before joining the
    group, and the tp engine and serve.py's --serve-tp ranks take the
    card too: without one each raises (no group is joined)."""
    from megatronapp_tpu_torch import serve
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.inference.dynamic_engine import (
        DynamicInferenceEngine,
    )
    from megatronapp_tpu_torch.models.gpt import init_gpt_params
    from megatronapp_tpu_torch.models.presets import llama3_8b
    from megatronapp_tpu_torch.parallel.mesh import MeshContext, build_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh(ParallelConfig(tensor_parallel=2), rank=0,
                   init_method="file:///nonexistent/never-joined")
    cfg = llama3_8b(num_layers=1, hidden_size=64, num_attention_heads=4,
                    num_query_groups=2, ffn_hidden_size=128,
                    vocab_size=128)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ctx = MeshContext(group=None, parallel=ParallelConfig(tensor_parallel=2),
                      rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynamicInferenceEngine(params, cfg, max_seq_len=32, ctx=ctx,
                               device="cuda")
    args = serve.parse_args(["--engine", "dynamic", "--paged-kv-cache",
                             "--serve-tp", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.rank_device(args, 1)


def test_training_grid_defaults_to_the_card(monkeypatch):
    """A dp × tp grid with no device, and pretrain_gpt.py's ranks under
    a launcher's environment (RANK, WORLD_SIZE, ...), resolve the card
    before joining a group: without one each raises."""
    from megatronapp_tpu_torch import pretrain_gpt
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.parallel.mesh import build_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh(ParallelConfig(tensor_parallel=2), rank=0, world_size=4,
                   init_method="file:///nonexistent/never-joined")
    for k, v in {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_gpt.main(["--tensor-model-parallel-size", "2",
                           "--num-layers", "1", "--hidden-size", "64",
                           "--num-attention-heads", "4"])


def test_pipeline_grid_defaults_to_the_card(monkeypatch):
    """A pp × dp × tp grid with no device, and pretrain_gpt.py's pipeline
    ranks under a launcher's environment, resolve the card before
    joining a group: without one each raises."""
    from megatronapp_tpu_torch import pretrain_gpt
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.parallel.mesh import build_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh(ParallelConfig(pipeline_parallel=2, tensor_parallel=2,
                                  virtual_pipeline_parallel=2,
                                  pp_schedule="zero-bubble"), rank=0,
                   world_size=4, init_method="file:///nonexistent/never")
    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_gpt.main(["--pipeline-model-parallel-size", "2",
                           "--num-layers-per-virtual-pipeline-stage", "1",
                           "--num-layers", "4", "--hidden-size", "64",
                           "--num-attention-heads", "4"])


def test_context_parallel_grid_defaults_to_the_card(monkeypatch):
    """A pp × dp × cp × tp grid (hierarchical inner groups included) with
    no device, and pretrain_gpt.py's cp ranks under a launcher's
    environment, resolve the card before joining a group: without one
    each raises."""
    from megatronapp_tpu_torch import pretrain_gpt
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.parallel.mesh import build_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh(ParallelConfig(context_parallel=4, tensor_parallel=2),
                   rank=0, world_size=8, cp_a2a_size=2,
                   init_method="file:///nonexistent/never")
    for k, v in {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_gpt.main(["--context-parallel-size", "2",
                           "--tensor-model-parallel-size", "2",
                           "--num-layers", "1", "--hidden-size", "64",
                           "--num-attention-heads", "4",
                           "--seq-length", "64"])


def test_expert_parallel_grid_defaults_to_the_card(monkeypatch):
    """A dp × ep × tp grid with no device, and pretrain_gpt.py's ep ranks
    under a launcher's environment, resolve the card before joining a
    group: without one each raises."""
    from megatronapp_tpu_torch import pretrain_gpt
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.parallel.mesh import build_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh(ParallelConfig(expert_parallel=2, tensor_parallel=2),
                   rank=0, world_size=8,
                   init_method="file:///nonexistent/never")
    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_gpt.main(["--expert-model-parallel-size", "2",
                           "--num-experts", "4", "--num-layers", "1",
                           "--hidden-size", "64",
                           "--num-attention-heads", "4",
                           "--seq-length", "64"])


@pytest.mark.parametrize("where", ["block", "moe"])
def test_convert_raises_on_unknown_moe_leaf(where):
    from megatronapp_tpu_torch.models.presets import mixtral_8x7b
    cfg = mixtral_8x7b(num_layers=2, hidden_size=64, num_attention_heads=4,
                       num_query_groups=2, ffn_hidden_size=128,
                       moe_ffn_hidden_size=128, vocab_size=128,
                       num_moe_experts=4)
    t = _jax_tree(cfg)
    mlp = t["block"].pop("mlp")
    z = np.zeros
    t["block"]["moe"] = {
        "router_kernel": z((2, 64, 4), np.float32),
        "fc1_kernel": z((2, 4) + mlp["fc1_kernel"].shape[1:], np.float32),
        "fc2_kernel": z((2, 4) + mlp["fc2_kernel"].shape[1:], np.float32)}
    got = params_from_jax(t, cfg)              # the known tree converts
    assert tuple(got["layers"][0]["moe"]["fc1_kernel"].shape) == (4, 64,
                                                                   256)
    {"block": t["block"], "moe": t["block"]["moe"]}[where]["mystery"] = \
        np.zeros((2, 4), np.float32)
    with pytest.raises(KeyError, match="unknown leaf"):
        params_from_jax(t, cfg)


def test_serve_tp_parses_and_refuses_lora(capsys):
    from megatronapp_tpu_torch import serve
    args = serve.parse_args(["--engine", "dynamic", "--paged-kv-cache",
                             "--serve-tp", "2", "--megakernel-decode"])
    assert args.serve_tp == 2 and args.megakernel_decode
    assert "--serve-tp" not in serve.UNPORTED_FLAGS
    with pytest.raises(SystemExit):
        serve.parse_args(["--engine", "dynamic", "--paged-kv-cache",
                          "--serve-tp", "2", "--lora-dir", "x"])
    assert "LoRA serving under tensor parallelism" in capsys.readouterr().err
    assert serve.free_init_method().startswith("tcp://localhost:")


# (batch, blocks a table, lengths, query rows): a short table, and decode
# rows on a 1024-position table that the weighted sum splits over 16
# blocks a slot, with lengths one token into a split, on a split's edge
# and at kv 1 beside full slots.
LATENT_TP_SHAPES = {
    "small": (3, 8, [5, 40, 128], 64),
    "multi_split": (8, 64, [1, 65, 64, 1000, 1024, 129, 640, 17], 32),
}


def _latent_tp_inputs(kind, shape):
    from megatronapp_tpu_torch.ops.paged_attention import quantize_kv_rows
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)
    b, mb, lens, rows = LATENT_TP_SHAPES[shape]
    bs, nb = 16, b * mb + 6
    table = torch.randperm(nb, generator=gen)[:b * mb].reshape(b, mb).to(
        torch.int32).to(dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    whole = torch.randn(nb, bs, 512, generator=gen).to(dev)
    if kind == "bf16":
        pages, scales = whole.to(torch.bfloat16), None
    else:
        dt = torch.int8 if kind == "int8" else torch.float8_e4m3fn
        pages, scales = quantize_kv_rows(whole, dt)
    return dev, gen, table, lens, pages[..., 256:], scales, rows


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(LATENT_TP_SHAPES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_latent_block_scores_kernel_matches_plain_version(kind, shape):
    """Row 8 on a column shard (a strided view) of a whole pool: the
    kernel launches and matches its plain version (products exact on both
    sides; fp32 sums in other orders)."""
    from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev, gen, table, lens, pages, scales, rows = _latent_tp_inputs(kind,
                                                                   shape)
    q = torch.randn(table.shape[0], rows, 256, generator=gen).to(dev)
    before = lt.launches[f"scores{'' if kind == 'bf16' else '_' + kind}"]
    got = lt.latent_block_scores(q, pages, table, lens, scales)
    torch.cuda.synchronize()
    assert lt.launches[f"scores{'' if kind == 'bf16' else '_' + kind}"] \
        == before + 1
    want = lt.latent_block_scores_plain(q, pages, table, lens, scales)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(LATENT_TP_SHAPES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_latent_block_wsum_kernel_matches_plain_version(kind, shape):
    """Row 9 on the same shard through a strided w_v view: the kernel
    launches (two kernels, one count) and matches its plain version."""
    from megatronapp_tpu_torch.ops.cuda import latent_tp as lt
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev, gen, table, lens, pages, scales, rows = _latent_tp_inputs(kind,
                                                                   shape)
    b, mb = table.shape
    p = torch.softmax(torch.randn(b, rows, mb * 16, generator=gen),
                      -1).to(dev)
    kv_up = (torch.randn(512, 32 * 256, generator=gen) / 16).to(
        torch.bfloat16).to(dev)
    w_v = kv_up.reshape(512, 32, 256)[256:, :, 128:]
    before = lt.launches[f"wsum{'' if kind == 'bf16' else '_' + kind}"]
    got = lt.latent_block_wsum(p, pages, table, lens, w_v, scales)
    torch.cuda.synchronize()
    assert lt.launches[f"wsum{'' if kind == 'bf16' else '_' + kind}"] \
        == before + 1
    want = lt.latent_block_wsum_plain(p, pages, table, lens, w_v, scales)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
