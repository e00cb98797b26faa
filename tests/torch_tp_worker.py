"""One tensor-parallel rank of the port's paged serving engine, for
tests/test_torch_tp_engine.py (spawned; it imports torch and the port
only, so a rank starts without JAX).

``run_rank`` joins a gloo group through a FileStore path, then serves
each case in turn: rank 0 submits the prompts and runs the engine to
completion, the other ranks ``follow()`` it, and every rank reports its
streams, pool books and bytes and the collectives it ran.
"""

import numpy as np
import torch


def run_rank(rank, tp, store, cases, out_q):
    from megatronapp_tpu_torch.config.parallel_config import ParallelConfig
    from megatronapp_tpu_torch.inference import dynamic_engine as tde
    from megatronapp_tpu_torch.inference.engine import SamplingParams
    from megatronapp_tpu_torch.models.convert import params_from_jax
    from megatronapp_tpu_torch.parallel import collectives
    from megatronapp_tpu_torch.parallel.mesh import build_mesh

    torch.set_num_threads(1)
    report = {}
    try:
        ctx = build_mesh(ParallelConfig(tensor_parallel=tp), rank=rank,
                         init_method=f"file://{store}", device="cpu",
                         timeout_s=60)
        for case in cases:
            params = params_from_jax(case["params"], case["cfg"], "cpu")
            calls0 = dict(collectives.calls)
            eng = tde.DynamicInferenceEngine(params, case["cfg"],
                                             device="cpu", ctx=ctx,
                                             **case["engine"])
            if ctx.is_lead:
                ids = [eng.add_request(p, case["max_new"],
                                       SamplingParams(greedy=True))
                       for p in case["prompts"]]
                res = eng.run_to_completion()
                eng.release_followers()
                streams = [res[i].tolist() for i in ids]
            else:
                res = eng.follow()
                streams = [res[i].tolist() for i in sorted(res)]
            eng.pool.audit()
            report[case["name"]] = {
                "streams": streams, "stats": dict(eng.pool.stats),
                "tp_paged": eng.tp_paged, "megakernel": eng.megakernel,
                "pool_bytes": eng.pool.bytes_total,
                "pool_shapes": [tuple(p.shape) for p in eng.pool.pages],
                "scale_shapes": [tuple(s.shape)
                                 for s in (eng.pool.scales or ())],
                "decode_steps": eng.decode_steps,
                "prefill_chunks": eng.prefill_chunks,
                "calls": {k: collectives.calls[k] - calls0[k]
                          for k in calls0},
                "snapshot_tp": eng.stats_snapshot()["tp"]}
        ctx.close()
    except Exception as e:  # noqa: BLE001 — reported to the test
        import traceback
        report = {"error": f"{e!r}\n{traceback.format_exc()}"}
    out_q.put((rank, report))


def spawn_ranks(tp, store, cases, timeout=120):
    """Run ``run_rank`` on tp spawned processes; returns [report of rank
    r]. Raises with a rank's traceback if one failed."""
    import multiprocessing
    mp = multiprocessing.get_context("spawn")
    q = mp.Queue()
    procs = [mp.Process(target=run_rank, args=(r, tp, store, cases, q))
             for r in range(tp)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(tp):
            rank, rep = q.get(timeout=timeout)
            out[rank] = rep
    finally:
        for p in procs:
            p.join(timeout=timeout)
            if p.is_alive():
                p.kill()
    for rank, rep in out.items():
        if "error" in rep:
            raise RuntimeError(f"tp rank {rank} failed: {rep['error']}")
    return [out[r] for r in range(tp)]


def np_tree(tree):
    """A JAX param tree as nested dicts of numpy arrays (picklable)."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)
