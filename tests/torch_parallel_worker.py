"""One rank of the port's pp × dp × ep × cp × tp training grid, for
tests/test_torch_parallel_*.py, tests/test_torch_pipeline.py,
tests/test_torch_pp_schedule.py, tests/test_torch_fbd.py,
tests/test_torch_context_parallel.py, tests/test_torch_cp_train.py and
tests/test_torch_ep_train.py (spawned; it imports torch and the port
only, so a rank starts without JAX). A case's "par" holds its fields of
ParallelConfig beside tp (pipeline_parallel, virtual_pipeline_parallel,
pp_schedule, pipeline_order_policy, pp_plan_from_trace,
context_parallel, expert_parallel, forward_backward_disaggregating: a
MegaFBD world, parallel/fbd.py split_fbd_meshes), and "cp_a2a" the inner
all-to-all size of an 'a2a+p2p' grid. A case with "expect_error" reports the exception it
raised as {"raised": repr}.

``spawn_ranks`` starts ``world`` processes once; ``run_rank`` then runs
each case whose grid has this rank: it joins the case's gloo group
through a FileStore of its own (a case of 2 ranks leaves ranks 2 and 3
idle), runs the case's kind and reports, and leaves the group.
"""

import contextlib
import os
import signal

import numpy as np
import torch


def _grid(case, rank, store):
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.parallel.mesh import build_mesh
    par = ParallelConfig(tensor_parallel=case["tp"],
                         distributed_optimizer=case.get("zero1", True),
                         **case.get("par", {}))
    if par.forward_backward_disaggregating:
        from megatronapp_tpu_torch.parallel.fbd import split_fbd_meshes
        return split_fbd_meshes(par, rank=rank, world_size=case["world"],
                                init_method=f"file://{store}."
                                f"{case['name']}", device="cpu",
                                timeout_s=60,
                                cp_a2a_size=case.get("cp_a2a"))
    return build_mesh(par, rank=rank, world_size=case["world"],
                      init_method=f"file://{store}.{case['name']}",
                      device="cpu", timeout_s=60,
                      cp_a2a_size=case.get("cp_a2a"))


def _np(t):
    return t.detach().float().numpy().copy()


def _grads(case, ctx):
    """One accumulation of the case's microbatches through this rank's
    shards (ZeRO-1 off: every rank keeps the whole dp sum): the dp-summed
    grads gathered whole, this rank's own grads of
    the tp-replicated leaves, its loss shares and its rows' logits
    gathered over tp."""
    from megatronapp_tpu_torch.config.training_config import OptimizerConfig
    from megatronapp_tpu_torch.models.convert import params_from_jax
    from megatronapp_tpu_torch.models.gpt import gpt_forward, gpt_loss
    from megatronapp_tpu_torch.parallel.collectives import gather_from_tp
    from megatronapp_tpu_torch.parallel.sharding import (
        gather_leaf, segment_counts, tp_dim,
    )
    from megatronapp_tpu_torch.training.distributed_optimizer import (
        DistributedOptimizer,
    )
    from megatronapp_tpu_torch.training.train import dp_rows
    cfg = case["cfg"]
    params = params_from_jax(case["params"], cfg, ctx=ctx)
    params.requires_grad_(True)
    opt = DistributedOptimizer(OptimizerConfig(), 10, ctx)
    named = dict(params.named_parameters())
    opt.init(named)
    opt.zero_grad()
    batch = dp_rows(case["batch"], ctx)
    num_micro = batch["tokens"].shape[0]
    losses = []
    for i in range(num_micro):
        micro = {k: torch.from_numpy(v[i]) for k, v in batch.items()}
        loss, _ = gpt_loss(params, micro["tokens"], micro["labels"],
                           micro["loss_mask"], cfg, ctx=ctx)
        loss.backward()
        losses.append(float(loss))
    own = {n: _np(p.grad) for n, p in named.items()
           if ctx.tp == 1 or tp_dim(n) is None}
    opt.reduce_grads(1.0 / num_micro)
    segs = segment_counts(named)
    full = {n: _np(gather_leaf(p.grad, n, segs[n], ctx))
            for n, p in named.items()}
    with torch.no_grad():
        logits, _ = gpt_forward(params, torch.from_numpy(
            batch["tokens"][0]), cfg, ctx=ctx)
        logits = _np(gather_from_tp(logits, ctx))
    return {"grads": full, "own": own, "losses": losses, "logits": logits}


def _ce(case, ctx):
    """The cross entropy of this rank's dp rows and vocabulary columns of
    the case's logits, for each z-loss coefficient: its loss share, its
    rows' per-token loss and d loss / d logits gathered over tp."""
    from megatronapp_tpu_torch.ops.cross_entropy import cross_entropy_loss
    from megatronapp_tpu_torch.parallel.collectives import all_gather_cat
    logits, targets, mask = case["logits"], case["targets"], case["mask"]
    rows = logits.shape[0] // ctx.dp
    cols = logits.shape[-1] // ctx.tp
    r = slice(ctx.dp_rank * rows, (ctx.dp_rank + 1) * rows)
    c = slice(ctx.tp_rank * cols, (ctx.tp_rank + 1) * cols)
    out = {}
    for z in case["z_losses"]:
        x = torch.from_numpy(logits[r, :, c].copy()).requires_grad_()
        loss, tok = cross_entropy_loss(x, torch.from_numpy(targets[r]),
                                       torch.from_numpy(mask[r]), z,
                                       ctx=ctx)
        loss.backward()
        out[z] = {"loss": float(loss), "per_token": _np(tok),
                  "grad": _np(all_gather_cat(x.grad, ctx, "tp", -1))}
    return out


def _train(case, ctx):
    """pretrain_gpt on the case's grid from the case's params (or the
    seeded init) on mock data: per-step metrics, and the params and
    moments this rank holds."""
    from megatronapp_tpu_torch.models.convert import params_from_jax
    from megatronapp_tpu_torch.training.train import pretrain_gpt
    cfg = case["cfg"]
    params = (None if case.get("params") is None
              else params_from_jax(case["params"], cfg, ctx=ctx))
    lines = [] if case.get("keep_log") else None
    res = pretrain_gpt(cfg, case["train"], case["opt"], device="cpu",
                       params=params, ctx=ctx,
                       log_fn=(lambda s: None) if lines is None
                       else lines.append,
                       batch_iter=case.get("batch_iter"))
    out = {"losses": [m["loss"] for m in res.log],
           "grad_norms": [m["grad_norm"] for m in res.log],
           "mtp_losses": [m.get("mtp_loss") for m in res.log],
           "fwd_losses": [m.get("fwd_loss") for m in res.log],
           "shipped": [m.get("shipped_bytes") for m in res.log],
           "consumed": res.consumed_samples,
           "local_params": sum(p.numel() for p in
                               res.state.params.parameters()),
           "interrupted": res.interrupted, "step": res.state.step,
           "eval_losses": res.eval_losses}
    if res.state.fp8 is not None:
        from megatronapp_tpu_torch.training.fp8 import flat_fp8
        out["fp8"] = {k: _np(t) for k, t in flat_fp8(res.state.fp8).items()}
    named = dict(res.state.params.named_parameters())
    if "embedding.word" in named:
        # A tied model's copy of the word embedding on this stage.
        out["word"] = _np(named["embedding.word"])
    if lines is not None:
        out["log"] = lines
    if case.get("flat"):
        out["params"] = _np(torch.cat([p.reshape(-1) for p in
                                       res.state.params.parameters()]))
        out["mu"] = _np(res.state.opt_state["mu"])
        out["nu"] = _np(res.state.opt_state["nu"])
    return out


def _roundtrip(case, ctx):
    """shard_tree then gather_tree of the case's full tree, bitwise."""
    from megatronapp_tpu_torch.models.convert import params_from_jax
    from megatronapp_tpu_torch.parallel.sharding import (
        gather_tree, shard_tree,
    )
    full = params_from_jax(case["params"], case["cfg"])
    local = shard_tree(full, ctx)
    back = dict(gather_tree(local, ctx).named_parameters())
    return {"same": {n: bool(torch.equal(back[n], p))
                     for n, p in full.named_parameters()},
            "local_shapes": {n: tuple(p.shape)
                             for n, p in local.named_parameters()}}


class _SignalAt:
    """A global-batch stream that sends this process SIGTERM when batch
    `at` is taken (one rank's preemption notice)."""

    def __init__(self, inner, at):
        self.inner, self.at, self.n = inner, at, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.n == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return next(self.inner)


def _signal(case, ctx, rank):
    from megatronapp_tpu_torch.data.mock import mock_batches
    tc = case["train"]
    stream = mock_batches(tc.seq_length, case["cfg"].vocab_size,
                          tc.global_batch_size, seed=tc.seed)
    if rank == case["signal_rank"]:
        stream = _SignalAt(stream, case["signal_at"])
    return _train(dict(case, batch_iter=stream), ctx)


def packed_stream(tc, vocab, packed_from):
    """The mock stream of TrainingConfig tc whose batches from
    `packed_from` on carry segment_ids (two segments a row)."""
    from megatronapp_tpu_torch.data.mock import mock_batches
    seg = np.repeat(np.arange(2, dtype=np.int32), tc.seq_length // 2)[None]
    for i, b in enumerate(mock_batches(tc.seq_length, vocab,
                                       tc.global_batch_size, seed=tc.seed)):
        if i >= packed_from:
            b = dict(b, segment_ids=np.tile(seg, (len(b["tokens"]), 1)))
        yield b


def _packed(case, ctx):
    """_train on packed_stream, counting this rank's collectives."""
    stream = packed_stream(case["train"], case["cfg"].vocab_size,
                           case["packed_from"])
    return _trace(dict(case, batch_iter=stream), ctx)


def _trace(case, ctx):
    from megatronapp_tpu_torch.parallel import collectives
    collectives.reset_counts()
    out = _train(case, ctx)
    out["traffic"] = {k: dict(v) for k, v in collectives.traffic.items()}
    return out


def _whole_grads(named, ctx):
    """Every leaf's reduced grad gathered whole (over tp, then every
    stage), by its one-device path, as numpy."""
    from megatronapp_tpu_torch.parallel.sharding import (
        gather_leaf, gather_stages, segment_counts,
    )
    segs = segment_counts(named)
    whole = {n: gather_leaf(p.grad, n, segs[n], ctx)
             for n, p in named.items()}
    if ctx.pp > 1:
        whole = gather_stages({} if ctx.dp_rank or ctx.tp_rank else whole,
                              ctx)
    return {n: _np(t) for n, t in whole.items()}


def _pp_grads(case, ctx):
    """One accumulation of the case's [M, mb, S] batch through
    gpt_pipeline_loss on this rank's stage (ZeRO-1 off): the loss (the
    last stage's dp share, zeros elsewhere), and every leaf's dp-summed
    grad gathered whole."""
    from megatronapp_tpu_torch.config.training_config import OptimizerConfig
    from megatronapp_tpu_torch.models.convert import params_from_jax
    from megatronapp_tpu_torch.models.gpt import gpt_pipeline_loss
    from megatronapp_tpu_torch.training.distributed_optimizer import (
        DistributedOptimizer,
    )
    from megatronapp_tpu_torch.training.train import dp_rows
    cfg = case["cfg"]
    params = params_from_jax(case["params"], cfg, ctx=ctx)
    params.requires_grad_(True)
    opt = DistributedOptimizer(
        OptimizerConfig(), 10, ctx,
        tied_embedding=not cfg.untie_embeddings_and_output_weights)
    named = dict(params.named_parameters())
    opt.init(named)
    opt.zero_grad()
    batch = {k: torch.from_numpy(v.copy())
             for k, v in dp_rows(case["batch"], ctx).items()}
    loss, _ = gpt_pipeline_loss(params, batch, cfg, ctx,
                                schedule=ctx.parallel.pp_schedule,
                                order_policy=ctx.parallel
                                .pipeline_order_policy)
    opt.reduce_grads(1.0)
    return {"loss": float(loss), "grads": _whole_grads(named, ctx),
            "names": sorted(named)}


def _split(case, ctx):
    """This rank's place in a MegaFBD world."""
    return {"role": ctx.fbd_role, "twin": ctx.twin_rank, "dp": ctx.dp,
            "tp": ctx.tp, "pp": ctx.pp, "grid_rank": ctx.grid_rank,
            "world_ranks": ctx.world_ranks, "tp_ranks": ctx.tp_ranks,
            "dp_ranks": ctx.dp_ranks, "cp": ctx.cp, "cp_rank": ctx.cp_rank,
            "tp_rank": ctx.tp_rank, "cp_ranks": ctx.cp_ranks,
            "cp_next": ctx.cp_next_rank, "cp_prev": ctx.cp_prev_rank,
            "cp_a2a_ranks": ctx.cp_a2a_ranks,
            "cp_outer_ranks": ctx.cp_outer_ranks, "ep": ctx.ep,
            "ep_rank": ctx.ep_rank, "ep_ranks": ctx.ep_ranks,
            "dp_rank": ctx.dp_rank, "batch_rank": ctx.batch_rank,
            "batch_ranks": ctx.batch_ranks}


def _fbd(case, ctx):
    """_trace, with every block_forward call this rank made recorded as
    (grad enabled, output requires grad): a MegaFBD rank's forwards."""
    import megatronapp_tpu_torch.models.gpt as gpt
    orig, calls = gpt.block_forward, []

    def probe(*a, **k):
        out = orig(*a, **k)
        calls.append((torch.is_grad_enabled(), out[0].requires_grad))
        return out

    gpt.block_forward = probe
    try:
        out = _trace(case, ctx)
    finally:
        gpt.block_forward = orig
    out.update(forwards=calls, role=ctx.fbd_role, stage=ctx.pp_rank)
    return out


def _cp_attn(case, ctx):
    """ops/context_parallel.py context_attention on the case's whole
    inputs for each of its runs {key: (mode, causal, overlap, a2a_size,
    zigzag, segments)}: the whole output and the whole input grads of
    sum(out · dout) (a 'p2p_zigzag' run permutes the inputs into zigzag
    order and the output back), with the collectives it counted."""
    from megatronapp_tpu_torch.ops.context_parallel import (
        context_attention, zigzag_indices, zigzag_inverse_indices,
    )
    from megatronapp_tpu_torch.parallel import collectives
    out = {}
    for key, (mode, causal, overlap, a2a, zz, segs) in case["runs"].items():
        q, k, v, do = (torch.from_numpy(case[n][key].copy())
                       for n in ("q", "k", "v", "do"))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        seg = None if not segs else torch.from_numpy(case["seg"][key])
        s = q.shape[1]
        args = (q, k, v)
        if zz:
            idx = torch.from_numpy(zigzag_indices(s, ctx.cp)).long()
            args = tuple(x[:, idx] for x in args)
        collectives.reset_counts()
        o = context_attention(*args, ctx, mode, causal=causal,
                              segment_ids=seg, a2a_size=a2a,
                              overlap_ring=overlap)
        if zz:
            o = o[:, torch.from_numpy(zigzag_inverse_indices(
                s, ctx.cp)).long()]
        (o * do).sum().backward()
        out[key] = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
                    "dv": _np(v.grad),
                    "traffic": {n: dict(t) for n, t in
                                collectives.traffic.items()}}
    return out


def _refuse(case, ctx):
    """A refusal under cp (expect_error): 'mla' and 'mtp' through
    gpt_loss, 'mask' through the layer with an explicit mask."""
    from megatronapp_tpu_torch.models.gpt import gpt_loss, init_gpt_params
    cfg = case["cfg"]
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             ctx)
    tokens = torch.zeros((1, 16), dtype=torch.long)
    if case["what"] == "mask":
        from megatronapp_tpu_torch.transformer.attention import (
            attention_forward,
        )
        x = torch.zeros((1, 8, cfg.hidden_size))
        mask = torch.ones((1, 1, 8, 8), dtype=torch.bool)
        attention_forward(params["layers"][0]["attention"], x, cfg,
                          attention_mask=mask, ctx=ctx)
    gpt_loss(params, tokens, tokens, None, cfg, ctx=ctx)
    return {"raised": None}


def _rows(a, ctx):
    """This rank's dp rows (dim 0) of a whole numpy array, as a tensor."""
    n = a.shape[0] // ctx.dp
    return torch.from_numpy(a[ctx.dp_rank * n:(ctx.dp_rank + 1) * n].copy())


def _cols(t, ctx):
    n = t.shape[-1] // ctx.tp
    return t[..., ctx.tp_rank * n:(ctx.tp_rank + 1) * n]


_BULK = {}


def _bulk_forms():
    """JAX's bulk forward forms (_bulk_ag_mm: one all-gather of x, then
    the GEMMs; _bulk_mm_rs: the whole partial product, then an unfused
    reduce-scatter ring) as subclasses of the ring Functions, keeping
    their fused ring backward: the reference the ring forms are held
    against."""
    if _BULK:
        return _BULK
    from megatronapp_tpu_torch.parallel import collectives
    from megatronapp_tpu_torch.parallel import overlap as ov

    class BulkAgMm(ov._AgMm):
        @staticmethod
        def forward(fctx, ctx, xl, *ws):
            fctx.mesh = ctx
            fctx.save_for_backward(xl, *ws)
            x_full = collectives.all_gather_cat(xl, ctx, "tp", 1)
            return tuple(x_full @ w for w in ws)

    class BulkMmRs(ov._MmRs):
        @staticmethod
        def forward(fctx, ctx, yl, wl):
            fctx.mesh = ctx
            fctx.save_for_backward(yl, wl)
            tp, me = ctx.tp, ctx.tp_rank
            full = yl @ wl
            sc = full.shape[1] // tp

            def chunk(c):
                return full[:, c * sc:(c + 1) * sc]

            acc = chunk((me + 1) % tp)
            for step in range(1, tp):
                moving = collectives.axis_ring_hop(
                    ctx, [acc.contiguous()], "tp").wait()[0]
                acc = moving + chunk((me + 1 + step) % tp)
            return acc

    _BULK.update(_AgMm=BulkAgMm, _MmRs=BulkMmRs)
    return _BULK


@contextlib.contextmanager
def _forms(bulk: bool):
    """The public ring functions with the bulk forward forms in place of
    the ring ones while `bulk`."""
    from megatronapp_tpu_torch.parallel import overlap as ov
    if not bulk:
        yield
        return
    saved = {k: getattr(ov, k) for k in _bulk_forms()}
    for k, v in _bulk_forms().items():
        setattr(ov, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ov, k, v)


def _ring_run(run, ctx, fp8_site=None):
    """One parallel/overlap.py primitive run of a case (see
    tests/test_torch_overlap.py): this rank's output, input grads and
    weight-shard grads. The Functions leave a rank its own batch rows'
    wgrads (the trainer's flat-buffer reduction sums them over dp), so
    they are summed over the batch group here, as JAX's rings sum them."""
    from megatronapp_tpu_torch.parallel import collectives
    from megatronapp_tpu_torch.parallel.overlap import (
        all_gather_matmul, matmul_reduce_scatter, tp_columns, tp_rows,
    )

    def dw(w):
        return _np(collectives.all_reduce(w.grad, ctx, "batch"))

    kind = run["kind"]
    with _forms(not run.get("overlap", True)):
        if kind in ("ag", "ag2"):
            x = _rows(run["x"], ctx).requires_grad_()
            ws = [tp_columns(torch.from_numpy(w), ctx).requires_grad_()
                  for w in run["ws"]]
            ys = all_gather_matmul(x, tuple(ws), ctx, fp8=fp8_site)
            loss = sum((y * _cols(_rows(c, ctx), ctx)).sum()
                       for y, c in zip(ys, run["coefs"]))
            loss.backward()
            return {"ys": [_np(y) for y in ys], "dx": _np(x.grad),
                    "dws": [dw(w) for w in ws]}
        if kind == "rs":
            y = _cols(_rows(run["y"], ctx), ctx).contiguous() \
                .requires_grad_()
            w = tp_rows(torch.from_numpy(run["w"]), ctx).requires_grad_()
            out = matmul_reduce_scatter(y, w, ctx, fp8=fp8_site)
            (out * _rows(run["coef"], ctx)).sum().backward()
            return {"out": _np(out), "dy": _np(y.grad), "dw": dw(w)}
        # "chain": sum(mm_rs(ag_mm(x, w), w2) ** 2)
        x = _rows(run["x"], ctx).requires_grad_()
        w = tp_columns(torch.from_numpy(run["w"]), ctx).requires_grad_()
        w2 = tp_rows(torch.from_numpy(run["w2"]), ctx).requires_grad_()
        out = matmul_reduce_scatter(all_gather_matmul(x, w, ctx), w2, ctx)
        (out ** 2).sum().backward()
        return {"out": _np(out), "dx": _np(x.grad), "dw": dw(w),
                "dw2": dw(w2)}


def _overlap(case, ctx):
    """Each run of the case through the ring primitives, with the
    collectives it counted."""
    from megatronapp_tpu_torch.parallel import collectives
    out = {}
    for key, run in case["runs"].items():
        collectives.reset_counts()
        out[key] = _ring_run(run, ctx)
        out[key]["traffic"] = {k: dict(v) for k, v in
                               collectives.traffic.items()}
    return out


def _fp8_rings(case, ctx):
    """The fp8 ring Functions on each run with a fresh Fp8Step over the
    case's history: outputs, grads, and the step's observations."""
    from megatronapp_tpu_torch.parallel import collectives
    from megatronapp_tpu_torch.training.fp8 import Fp8Step
    out = {}
    for key, run in case["runs"].items():
        n = run["hist"].shape[0]
        state = {"block": {"m": {"s": {
            "hist": torch.from_numpy(run["hist"][None].copy()),
            "sat": torch.zeros((1, n))}}}}
        step = Fp8Step(state, run.get("margin", 0))
        collectives.reset_counts()
        rep = _ring_run(run, ctx, fp8_site=step.site(0, "m", "s"))
        obs = step.observed["block"]["m"]["s"]
        rep.update(hist=_np(obs["hist"][0]), sat=_np(obs["sat"][0]),
                   traffic={k: dict(v) for k, v in
                            collectives.traffic.items()})
        out[key] = rep
    return out


def _spans(case, ctx):
    """The chain run of the case inside one traced iteration (the tracer
    on this rank's CPU clock): its span records; then the same run
    untraced, whose records must be none."""
    import tempfile

    from megatronapp_tpu_torch.trace.tracer import get_tracer
    tracer = get_tracer()
    tracer.configure(enabled=True, trace_dir=tempfile.mkdtemp(),
                     interval=1, continuous_iterations=1, rank=ctx.rank)
    try:
        tracer.iteration_begin(0)
        _ring_run(case["run"], ctx)
        tracer.iteration_end(0)
        recs = tracer.drain()
    finally:
        tracer.configure(enabled=False)
    _ring_run(case["run"], ctx)
    return {"records": [{k: r[k] for k in ("name", "ph", "tid", "args")}
                        for r in recs if "overlap" in r["name"]],
            "after": len(tracer.drain())}


def _layers_overlap(case, ctx):
    """mlp_forward / attention_forward with tp_comm_overlap off and on,
    on this rank's shards of the case's whole params: the max abs
    difference of the outputs and of every param shard's and the input's
    grads of sum(out²), and the largest magnitudes."""
    import dataclasses

    from megatronapp_tpu_torch.models.gpt import gpt_rope_tables
    from megatronapp_tpu_torch.parallel.sharding import shard_tree
    from megatronapp_tpu_torch.transformer.attention import (
        attention_forward,
    )
    from megatronapp_tpu_torch.transformer.mlp import mlp_forward
    from megatronapp_tpu_torch.utils.params import ParamTree
    cfg0 = case["cfg"]

    def tree(leaves):
        return ParamTree({k: torch.from_numpy(np.asarray(v, np.float32))
                          for k, v in leaves.items()})

    res = []
    for on in (False, True):
        cfg = dataclasses.replace(cfg0, tp_comm_overlap=on)
        p = shard_tree(tree(case["params"]), ctx)
        p.requires_grad_(True)
        x = _rows(case["x"], ctx).requires_grad_()
        if case["layer"] == "mlp":
            out = mlp_forward(p, x, cfg, ctx=ctx)
        else:
            cos, sin = gpt_rope_tables(cfg, x.shape[1])
            out, _ = attention_forward(p, x, cfg, cos, sin, ctx=ctx)
        (out ** 2).sum().backward()
        res.append({"out": out.detach(), "dx": x.grad,
                    **{n: q.grad for n, q in p.named_parameters()}})
    a, b = res
    return {"diff": {k: float((a[k] - b[k]).abs().max()) for k in a},
            "scale": {k: float(a[k].abs().max()) for k in a}}


KINDS = {"grads": _grads, "train": _train, "roundtrip": _roundtrip,
         "trace": _trace, "ce": _ce, "pp_grads": _pp_grads,
         "split": _split, "fbd": _fbd, "cp_attn": _cp_attn,
         "refuse": _refuse, "overlap": _overlap, "fp8_rings": _fp8_rings,
         "spans": _spans, "layers_overlap": _layers_overlap}


def run_rank(rank, store, cases, out_q):
    torch.set_num_threads(1)
    report = {}
    try:
        for case in cases:
            if rank >= case["world"]:
                continue
            ctx = _grid(case, rank, store)
            try:
                if case["kind"] == "signal":
                    report[case["name"]] = _signal(case, ctx, rank)
                elif case["kind"] == "packed":
                    report[case["name"]] = _packed(case, ctx)
                else:
                    report[case["name"]] = KINDS[case["kind"]](case, ctx)
            except Exception as e:  # noqa: BLE001 — a case meant to raise
                if not case.get("expect_error"):
                    raise
                report[case["name"]] = {"raised": repr(e)}
            finally:
                ctx.close()
    except Exception as e:  # noqa: BLE001 — reported to the test
        import traceback
        report = {"error": f"{e!r}\n{traceback.format_exc()}"}
    out_q.put((rank, report))


def start_ranks(world, store, cases):
    """Start ``run_rank`` on `world` spawned processes (the caller may
    work meanwhile); ``collect`` waits for their reports."""
    import multiprocessing
    mp = multiprocessing.get_context("spawn")
    q = mp.Queue()
    procs = [mp.Process(target=run_rank, args=(r, store, cases, q))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, q


def collect(started, timeout=300):
    """[report of rank r] of started ranks. Raises with a rank's
    traceback if one failed."""
    procs, q = started
    world = len(procs)
    out = {}
    try:
        for _ in range(world):
            rank, rep = q.get(timeout=timeout)
            out[rank] = rep
    finally:
        for p in procs:
            p.join(timeout=timeout)
            if p.is_alive():
                p.kill()
    for rank, rep in out.items():
        if "error" in rep:
            raise RuntimeError(f"rank {rank} failed: {rep['error']}")
    return [out[r] for r in range(world)]


def spawn_ranks(world, store, cases, timeout=300):
    """start_ranks, then collect."""
    return collect(start_ranks(world, store, cases), timeout)


def np_tree(tree):
    """A JAX param tree as nested dicts of numpy arrays (picklable)."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)
