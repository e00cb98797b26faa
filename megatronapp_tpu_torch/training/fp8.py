"""fp8 (e4m3) training with delayed-scaling amax history: the port's
copy of the JAX package's training/fp8.py.

The tp-overlap ring matmuls (parallel/overlap.py) own every training
GEMM of a layer under ``tp_comm_overlap``; their fp8 twins quantize both
operands to e4m3 with scales taken from an amax HISTORY, and this module
owns that machinery:

- **State.** One fp32 history row per (layer, site, tensor):
  ``hist [L, n_tensors, H]``, slot 0 the most recent step's amax, H =
  ``cfg.fp8_amax_history_len``; beside it ``sat [L, n_tensors]``, the
  saturated elements counted since step 0. Sites a layer
  (``SITE_TENSORS``): attention ``qkv`` (x, the q and kv weights, their
  two cotangents: 5 tensors), attention ``out``, mlp ``fc1`` and mlp
  ``fc2`` (input, weight, cotangent: 3 each). The layout is JAX's, so the
  state checkpoints under the same leaf paths (``fp8/block/<mod>/<site>/
  hist``).
- **Scales.** ``fp8_scale_from_hist``: FP8_MAX / (max(hist) · 2^margin),
  1.0 while the history is empty, derived at every use.
- **Transport.** JAX returns the rolled history as the "cotangent" of the
  fp8 input of its custom VJPs. A torch ``autograd.Function`` cannot
  hand a gradient to a tensor that is not an input of the loss, so the
  port's ring Functions pass their observations to the step's
  ``Fp8Step`` instead (``Fp8Site.observe``, called from each Function's
  backward): the rolled history of the site and the step's saturation
  counts, combined over microbatches with ``fp8_accumulate`` (max for the
  histories, a sum for the counts), as JAX's step combines the fp8 half
  of its gradients. The train step installs ``fp8_carry_sat(old,
  observed)`` when the step is finite and keeps the old state when it is
  skipped; the state never meets grad scaling, the norm or the
  optimizer.
- **The GEMM.** ``fp8_gemm`` multiplies e4m3 operands with fp32
  accumulation and applies the combined descale 1/(s_a · s_b): on the
  CPU as JAX does (codes upcast to fp32, an fp32 matmul), on the card
  through ``torch._scaled_mm`` on the e4m3 operands (JAX's fp8 GEMM is
  an XLA dot, not a Pallas kernel, so the port needs no kernel of its
  own here). A shape ``_scaled_mm`` refuses raises: there is no fallback
  on the card. ``gemm_calls`` counts the card's calls.

Scope (``fp8_ineligible_reason``, JAX's words): tp > 1 with the rings on,
pp 1, cp 1, dense non-MLA, non-MoE layers without MTP, FBD or DPP.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from megatronapp_tpu_torch.utils import metrics as telemetry

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0          # e4m3fn finfo max (overflow is NaN, not inf)

# Per-layer fp8 sites and their tensor counts: [input, weight_0..n-1,
# grad_0..n-1] for the all-gather-matmul sites (fused QKV has two
# weights), [input, weight, grad] for the matmul-reduce-scatter sites.
SITE_TENSORS = {
    ("attention", "qkv"): 5,
    ("attention", "out"): 3,
    ("mlp", "fc1"): 3,
    ("mlp", "fc2"): 3,
}

# torch._scaled_mm calls on the card (chip_smoke.py reads them).
gemm_calls = {"fp8_gemm": 0}


def fp8_scale_from_hist(hist: torch.Tensor, margin: int) -> torch.Tensor:
    """Delayed scale per tensor: hist [..., H] → scale [...] (FP8_MAX /
    (amax · 2^margin); 1.0 while the history is empty)."""
    amax = hist.amax(dim=-1)
    return torch.where(amax > 0.0, FP8_MAX / (amax * (2.0 ** margin)),
                       torch.ones_like(amax))


def fp8_quantize(x: torch.Tensor, scale: torch.Tensor) -> tuple:
    """Saturating e4m3 cast of x · scale: (x_fp8, amax fp32 0-d,
    saturated-element count fp32 0-d), over the elements of x. The clip
    is load-bearing: e4m3fn overflows to NaN."""
    x32 = x.float() * scale
    amax = x.abs().amax().float()
    sat = (x32.abs() > FP8_MAX).sum().float()
    q = x32.clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)
    return q, amax, sat


def rolled_hist(hist: torch.Tensor, amaxes: torch.Tensor) -> torch.Tensor:
    """Every row shifted right by one, this step's amaxes in slot 0:
    hist [n, H], amaxes [n] → [n, H]."""
    return torch.cat([amaxes[:, None], hist[:, :-1]], dim=1)


def init_fp8_state(cfg, device=None) -> Dict:
    """The per-run fp8 state: {"block": {mod: {site: {"hist": [L, n, H],
    "sat": [L, n]}}}}, zeros, fp32 (JAX's tree)."""
    layers = cfg.num_layers
    h = int(getattr(cfg, "fp8_amax_history_len", 16))
    out: Dict = {"block": {}}
    for (mod, site), n in SITE_TENSORS.items():
        out["block"].setdefault(mod, {})[site] = {
            "hist": torch.zeros((layers, n, h), dtype=torch.float32,
                                device=device),
            "sat": torch.zeros((layers, n), dtype=torch.float32,
                               device=device)}
    return out


def fp8_ineligible_reason(cfg, parallel) -> Optional[str]:
    """Why fp8 may NOT run: None when eligible, else the first failed
    predicate by name (JAX's words). Checked at parse time
    (pretrain_gpt.py) and by the trainer."""
    if not getattr(cfg, "fp8", False):
        return "cfg.fp8 off"
    if not getattr(cfg, "tp_comm_overlap", False):
        return ("--fp8 requires --tp-comm-overlap: the fp8 GEMMs live "
                "inside the ring all-gather / reduce-scatter matmul "
                "bodies (parallel/overlap.py)")
    tp = getattr(parallel, "tensor_parallel", 1)
    if tp <= 1:
        return (f"--fp8 requires --tensor-model-parallel-size > 1 "
                f"(got {tp}): with tp == 1 no ring matmul ever runs, "
                "so fp8 would silently be a no-op")
    if getattr(parallel, "pipeline_parallel", 1) > 1:
        return ("--fp8 does not support pipeline parallelism yet: the "
                "ambient-manual tp-sharded stage rings keep bf16 "
                "(amax state threading through the pp scan is the "
                "recorded follow-up)")
    if getattr(parallel, "context_parallel", 1) > 1:
        return ("--fp8 requires context_parallel == 1 (the GSPMD "
                "overlap rings are cp==1-only — tp_overlap_eligible)")
    if cfg.is_moe:
        return ("--fp8 does not support MoE layers: expert GEMMs "
                "dispatch outside the tp rings")
    if cfg.multi_latent_attention:
        return ("--fp8 does not support MLA: the dense MLA projections "
                "only ring inside the pp stage body, which keeps bf16")
    if getattr(cfg, "heterogeneous_layers_config_json", None):
        return "--fp8 does not support heterogeneous per-layer configs"
    if cfg.mtp_num_layers:
        return ("--fp8 does not support MTP depth modules yet (their "
                "layer bodies run outside the fp8-threaded block scan)")
    if getattr(parallel, "forward_backward_disaggregating", False):
        return ("--fp8 is not supported with "
                "--forward-backward-disaggregating (the FBD executor "
                "path does not thread the fp8 state)")
    if getattr(parallel, "use_dpp", False):
        return ("--fp8 is not wired into the host-driven DPP runtime "
                "(--use-dpp)")
    return None


def _tree_map(fn, *trees, key=None):
    """fn(key, *leaves) over nested dicts of tensors (key: the leaf's own
    name, "hist" or "sat")."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees), key=k)
                for k in trees[0]}
    return fn(key, *trees)


def fp8_zeros_like(fp8_state):
    return _tree_map(lambda _, t: torch.zeros_like(t), fp8_state)


def fp8_accumulate(acc, new):
    """Two microbatches' observations combined: histories by elementwise
    max (both are the old history rolled, their own amax in slot 0),
    saturation counts summed."""
    return _tree_map(lambda k, a, b: a + b if k == "sat"
                     else torch.maximum(a, b), acc, new)


def fp8_carry_sat(old_state, new_obs):
    """The step's observations as the next state: the histories as
    rolled, the saturation counts added to the old ones (cumulative since
    step 0)."""
    return _tree_map(lambda k, old, new: old + new if k == "sat" else new,
                     old_state, new_obs)


def flat_fp8(fp8_state, prefix: str = "fp8") -> Dict[str, torch.Tensor]:
    """{"fp8/block/<mod>/<site>/<hist|sat>": tensor}: the state's leaves
    under their checkpoint paths (the live tensors)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        else:
            out[path] = t
    walk(fp8_state, prefix)
    return out


class Fp8Site:
    """One (layer, site) of a step: its history [n, H] (the state's, not
    a copy), the margin, and where its observations go."""

    def __init__(self, step: "Fp8Step", layer: int, mod: str, site: str):
        self.step, self.layer, self.mod, self.site = step, layer, mod, site
        self.hist = step.state["block"][mod][site]["hist"][layer]
        self.margin = step.margin

    def observe(self, rolled: torch.Tensor, sats: torch.Tensor) -> None:
        self.step.observe(self.layer, self.mod, self.site, rolled, sats)


class Fp8Step:
    """A train (or eval) step's view of the fp8 state: ``site(layer, mod,
    site)`` for the ring Functions, and the observations their backwards
    made (``observed``: the state's tree, combined over microbatches with
    fp8_accumulate's rules; None before the first)."""

    def __init__(self, state: Dict, margin: int = 0):
        self.state, self.margin = state, int(margin)
        self.observed: Optional[Dict] = None

    def site(self, layer: int, mod: str, site: str) -> Fp8Site:
        return Fp8Site(self, layer, mod, site)

    @torch.no_grad()
    def observe(self, layer: int, mod: str, site: str,
                rolled: torch.Tensor, sats: torch.Tensor) -> None:
        if self.observed is None:
            self.observed = fp8_zeros_like(self.state)
        leaves = self.observed["block"][mod][site]
        leaves["hist"][layer] = torch.maximum(leaves["hist"][layer], rolled)
        leaves["sat"][layer] += sats


def fp8_gemm(a: torch.Tensor, b: torch.Tensor, inv: torch.Tensor
             ) -> torch.Tensor:
    """(a @ b) · inv in fp32 for e4m3 operands a [M, K], b [K, N] and the
    combined descale inv (fp32 0-d). CPU tensors: the codes upcast to fp32
    and multiplied (JAX's GEMM). CUDA tensors: ``torch._scaled_mm`` on the
    e4m3 operands with fp32 accumulation; a shape it refuses raises."""
    if a.device.type != "cuda":
        return (a.float() @ b.float()) * inv
    gemm_calls["fp8_gemm"] += 1
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return torch._scaled_mm(a.contiguous(), b.t().contiguous().t(),
                            scale_a=inv.float().reshape(()), scale_b=one,
                            out_dtype=torch.float32)


def export_fp8_metrics(fp8_state, cfg) -> None:
    """The /metrics gauges (JAX's names): per site the current scale (the
    smallest over layers and tensors), the largest amax in the window
    and the cumulative saturated elements, and the history depth. No-op
    unless telemetry is enabled."""
    import numpy as np
    if not telemetry.enabled():
        return
    margin = int(getattr(cfg, "fp8_margin", 0))
    telemetry.set_gauge("fp8_amax_history_len",
                        int(getattr(cfg, "fp8_amax_history_len", 16)))
    for mod, sites in fp8_state["block"].items():
        for site, leaves in sites.items():
            hist = leaves["hist"].detach().cpu().numpy()     # [L, n, H]
            amax = np.max(hist, axis=-1)
            scale = np.where(amax > 0.0,
                             FP8_MAX / np.maximum(amax, 1e-30)
                             / (2.0 ** margin), 1.0)
            telemetry.set_gauge(f"fp8_amax_{mod}_{site}", float(hist.max()))
            telemetry.set_gauge(f"fp8_scale_{mod}_{site}",
                                float(scale.min()))
            telemetry.set_gauge(
                f"fp8_saturated_{mod}_{site}",
                float(np.sum(leaves["sat"].detach().cpu().numpy())))
