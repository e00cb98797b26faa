"""The port's context-parallel attention (ops/context_parallel.py)
against the JAX package's, fp32 on the CPU.

One spawn of four gloo ranks (FileStores under the test's tmp dir;
tests/torch_parallel_worker.py imports no jax) runs ``context_attention``
at cp 2 (ranks 0-1) and at cp 4 (ranks 0-3, inner all-to-all groups of
2); JAX's ``context_attention`` runs in the test process on 2 or 4 of
the 8 virtual CPU devices. Both sides take the same fp32 numpy inputs
from a seed (B 2, S 32, 8 q / 4 kv heads, D 8) and the same output
cotangent, and hold the whole output and the input grads of sum(out ·
dout) to within 1e-4 absolute (JAX's own tests hold its modes to dense
at 2e-4):

- every mode, causal and bidirectional, at cp 2 and cp 4: the
  contiguous ring with its save-little backward ('p2p') and without it
  ('p2p' at overlap off: autograd through the rounds), the zigzag ring
  (inputs permuted into zigzag order on both sides, the output back),
  Ulysses ('a2a'), 'allgather' and the hierarchical 'a2a+p2p' (a2a 2,
  so a ring of 2 groups at cp 4 and one group at cp 2);
- S not divisible by cp (the pad path, masked through synthetic segment
  ids), packed segment ids, and d_v != d_qk on the rings;
- overlap on = off within 1e-5, every rank's output and grads the same;
- zigzag_indices and its inverse equal to JAX's;
- the collectives each mode counts, per kind and axis "cp".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_parallel_worker as W

from megatronapp_tpu.config.parallel_config import ParallelConfig as JPC
from megatronapp_tpu.ops import context_parallel as jcp
from megatronapp_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatronapp_tpu_torch.ops import context_parallel as tcp

B, S, H, HKV, D = 2, 32, 8, 4, 8
TOL = 1e-4
A2A = 2
# name: (mode, overlap)
MODES = {"p2p": ("p2p", True), "p2p-plain": ("p2p", False),
         "zigzag": ("p2p_zigzag", True), "a2a": ("a2a", True),
         "allgather": ("allgather", True), "a2a+p2p": ("a2a+p2p", True)}
# name: (mode, overlap, seq length, d_v, packed segments); causal.
EXTRA = {
    "pad-p2p": ("p2p", True, 30, D, False),
    "pad-p2p-plain": ("p2p", False, 30, D, False),
    "pad-a2a": ("a2a", True, 30, D, False),
    "pad-allgather": ("allgather", True, 30, D, False),
    "pad-a2a+p2p": ("a2a+p2p", True, 30, D, False),
    "dv-p2p": ("p2p", True, S, 12, False),
    "dv-p2p-plain": ("p2p", False, S, 12, False),
    "dv-zigzag": ("p2p_zigzag", True, S, 12, False),
    "seg-p2p": ("p2p", True, S, D, True),
    "seg-a2a": ("a2a", True, S, D, True),
    "seg-allgather": ("allgather", True, S, D, True),
    "seg-a2a+p2p": ("a2a+p2p", True, S, D, True),
}
CPS = (2, 4)


def _run_key(name, causal):
    return f"{name}-{'causal' if causal else 'bidir'}"


def _spec():
    """{key: (mode, causal, overlap, a2a, zigzag, segments, s, dv)}."""
    out = {}
    for name, (mode, overlap) in MODES.items():
        for causal in (True, False):
            out[_run_key(name, causal)] = (mode, causal, overlap, A2A,
                                           mode == "p2p_zigzag", False, S,
                                           D)
    for name, (mode, overlap, s, dv, segs) in EXTRA.items():
        out[name] = (mode, True, overlap, A2A, mode == "p2p_zigzag", segs,
                     s, dv)
    return out


SPEC = _spec()


def _inputs():
    """Each run's fp32 inputs, from a seed of its own (a plain-ring run
    takes its save-little twin's, so the two can be compared)."""
    arrays = {n: {} for n in ("q", "k", "v", "do", "seg")}
    keys = sorted({k.replace("p2p-plain", "p2p") for k in SPEC})
    for key, (*_, segs, s, dv) in SPEC.items():
        twin = key.replace("p2p-plain", "p2p")
        rng = np.random.default_rng(100 + keys.index(twin))
        arrays["q"][key] = rng.standard_normal((B, s, H, D), np.float32)
        arrays["k"][key] = rng.standard_normal((B, s, HKV, D), np.float32)
        arrays["v"][key] = rng.standard_normal((B, s, HKV, dv), np.float32)
        arrays["do"][key] = rng.standard_normal((B, s, H, dv), np.float32)
        cut = rng.integers(5, s - 5, size=B)
        arrays["seg"][key] = (np.arange(s)[None, :] >= cut[:, None]
                              ).astype(np.int32)
    return arrays


INPUTS = _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("cp_attention")
    runs = {k: v[:6] for k, v in SPEC.items()}
    cases = [dict(name=f"attn-cp{cp}", kind="cp_attn", world=cp, tp=1,
                  par={"context_parallel": cp},
                  cp_a2a=A2A if cp > A2A else None, runs=runs, **INPUTS)
             for cp in CPS]
    return W.spawn_ranks(4, str(d / "store"), cases)


_JAX = {}


def _jax(cp, key):
    """JAX context_attention's output and input grads for the run."""
    if (cp, key) in _JAX:
        return _JAX[cp, key]
    mode, causal, overlap, a2a, zz, segs, s, _ = SPEC[key]
    mesh = j_build_mesh(JPC(context_parallel=cp),
                        devices=jax.devices()[:cp]).mesh
    q, k, v, do = (jnp.asarray(INPUTS[n][key]) for n in ("q", "k", "v",
                                                          "do"))
    seg = jnp.asarray(INPUTS["seg"][key]) if segs else None
    idx = jnp.asarray(jcp.zigzag_indices(s, cp)) if zz else None
    inv = jnp.asarray(jcp.zigzag_inverse_indices(s, cp)) if zz else None

    def f(q, k, v):
        if zz:
            q, k, v = (jnp.take(x, idx, axis=1) for x in (q, k, v))
        with mesh:
            out = jcp.context_attention(q, k, v, mesh, mode, causal=causal,
                                        segment_ids=seg, a2a_size=a2a,
                                        overlap_ring=overlap)
        if zz:
            out = jnp.take(out, inv, axis=1)
        return jnp.sum(out * do), out

    grads, out = jax.jit(jax.grad(f, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    _JAX[cp, key] = {"out": np.asarray(out),
                     **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"),
                                                         grads)}}
    return _JAX[cp, key]


def _check(ranks, cp, key):
    want = _jax(cp, key)
    for r in range(cp):
        got = ranks[r][f"attn-cp{cp}"][key]
        for n in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=TOL,
                                       err_msg=f"{key} {n} rank {r}")


@pytest.mark.parametrize("cp", CPS)
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "bidir"])
@pytest.mark.parametrize("name", sorted(MODES))
def test_mode_matches_jax(ranks, name, causal, cp):
    _check(ranks, cp, _run_key(name, causal))


@pytest.mark.parametrize("cp", CPS)
@pytest.mark.parametrize("name", sorted(EXTRA))
def test_pad_segments_and_value_width_match_jax(ranks, name, cp):
    _check(ranks, cp, name)


@pytest.mark.parametrize("cp", CPS)
@pytest.mark.parametrize("key", ["p2p-causal", "p2p-bidir", "pad-p2p",
                                 "dv-p2p"])
def test_overlap_on_equals_off(ranks, key, cp):
    """The save-little ring (its fused reverse-ring backward) against
    autograd through the plain ring's rounds."""
    on = ranks[0][f"attn-cp{cp}"][key]
    off_key = key.replace("p2p", "p2p-plain", 1)
    off = ranks[0][f"attn-cp{cp}"][off_key]
    for n in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(on[n], off[n], rtol=0, atol=1e-5)


@pytest.mark.parametrize("s,cp", [(4, 2), (16, 2), (32, 4), (48, 3),
                                  (128, 8), (8192, 2)])
def test_zigzag_indices_equal_jax(s, cp):
    np.testing.assert_array_equal(tcp.zigzag_indices(s, cp),
                                  jcp.zigzag_indices(s, cp))
    np.testing.assert_array_equal(tcp.zigzag_inverse_indices(s, cp),
                                  jcp.zigzag_inverse_indices(s, cp))
    idx = tcp.zigzag_indices(s, cp)
    assert idx.dtype == np.int32
    assert np.array_equal(np.sort(idx), np.arange(s))
    with pytest.raises(ValueError, match="divisible by 2\\*cp"):
        tcp.zigzag_indices(s + 1, cp)


@pytest.mark.parametrize("cp", CPS)
def test_collectives_are_counted_per_kind_on_axis_cp(ranks, cp):
    """Each mode's calls a rank: the input's share backward and the
    output's gather (one all-gather each over cp for q, k, v and out),
    the ring's hops (cp - 1 a pass, and cp accumulator hops backward),
    Ulysses' all-to-alls (four forward, four backward)."""
    rep = ranks[0][f"attn-cp{cp}"]

    def calls(key, kind):
        return rep[key]["traffic"].get(kind, {}).get("calls", 0)

    shares = 4        # 3 input grads all-gathered, 1 output gathered
    assert calls("p2p-causal", "all_gather/cp") == shares
    # The save-little ring: cp - 1 K/V hops forward, cp - 1 backward and
    # cp accumulator hops.
    assert calls("p2p-causal", "send/cp") == 2 * (cp - 1) + cp
    assert calls("p2p-causal", "recv/cp") == 2 * (cp - 1) + cp
    assert calls("zigzag-causal", "send/cp") == 2 * (cp - 1) + cp
    # The plain ring: cp - 1 hops forward, as many back.
    assert calls("p2p-plain-causal", "send/cp") == 2 * (cp - 1)
    assert calls("a2a-causal", "all_to_all/cp") == 8
    assert calls("a2a-causal", "send/cp") == 0
    # allgather: K and V gathered, their grads reduce-scattered.
    assert calls("allgather-causal", "all_gather/cp") == shares + 2
    assert calls("allgather-causal", "reduce_scatter/cp") == 2
    inner = "all_to_all/cp_a2a" if cp > A2A else "all_to_all/cp"
    assert calls("a2a+p2p-causal", inner) == 8
    ring = cp // A2A
    assert calls("a2a+p2p-causal", "send/cp") == (
        2 * (ring - 1) + ring if ring > 1 else 0)
