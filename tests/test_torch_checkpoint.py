"""The port's checkpoints (training/checkpointing.py, train_state.py) on
the CPU.

- A durable round trip is bitwise for fp32 and bf16 leaves (bf16 stored
  as its uint16 bits, the dtype in meta.json), the step and the optimizer
  count included, read back by the writer or by a manager opened afresh;
  save() holds the host copy, so updates after it returns do not reach
  the file.
- A reader touches nothing on disk: a missing directory stays missing and
  a live run's write in flight survives it; the writer's first save drops
  a crashed write's leftover.
- max_to_keep holds, a step off save_interval is skipped unless forced, a
  damaged step is walked past (a truncated zip, a flipped byte caught by
  the CRC, a missing meta.json), an explicit step is not.
- The checkpoint-save chaos drill retries with backoff and succeeds; a
  fault outlasting the retries raises from wait(). A run directory holding
  one layout refuses another.
- LocalCheckpointManager: latest only, the side state inside, a corrupt
  or stale file reads as missing; the local-checkpoint-save site fires.
- The side state's sidecars are collected with their steps; the server's
  params-only restore reads only the params leaves.
- resolved_args.json: written with JAX's file name and a subset of JAX's
  parser keys, read by JAX's load_saved_args; --use-checkpoint-args takes
  the stored architecture flags, the run-control set being JAX's.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from megatronapp_tpu.config import arguments as jargs
from megatronapp_tpu_torch import pretrain_gpt as entry
from megatronapp_tpu_torch.training import checkpointing as ck
from megatronapp_tpu_torch.training.optimizer import Optimizer
from megatronapp_tpu_torch.training.train_state import (
    TrainState, load_state_dict, restore_params, state_dict,
)
from megatronapp_tpu_torch.training.train_step import named_trainable
from megatronapp_tpu_torch.config.training_config import OptimizerConfig
from megatronapp_tpu_torch.utils import chaos
from megatronapp_tpu_torch.utils.params import ParamTree


def _state(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    p = ParamTree({"w": torch.randn(5, 7, generator=g).to(dtype),
                   "b": torch.randn(7, generator=g).to(dtype)},
                  sub=ParamTree({"k": torch.randn(3, 3, 2,
                                                  generator=g).to(dtype)}))
    p.requires_grad_(True)
    opt = Optimizer(OptimizerConfig(), 10).init(named_trainable(p))
    for t in list(opt["mu"].values()) + list(opt["nu"].values()):
        t.normal_(generator=g)
    opt["count"] = seed
    return TrainState(p, opt, step=seed + 2)


def _bits(flat):
    return {k: (v.view(torch.int16) if isinstance(v, torch.Tensor)
                and v.dtype == torch.bfloat16 else v)
            for k, v in flat.items()}


def _assert_bitwise(a, b):
    a, b = _bits(a), _bits(b)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reader", ["writer", "fresh"])
def test_round_trip_is_bitwise(tmp_path, dtype, reader):
    src = _state(3, dtype)
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state_dict(src).items()}
    mngr = ck.CheckpointManager(str(tmp_path))
    assert mngr.save(5, state_dict(src))
    with torch.no_grad():            # the live state moves on at once
        for p in src.params.parameters():
            p.add_(1.0)
    mngr.wait()
    meta = json.loads((tmp_path / "5" / "meta.json").read_text())
    assert meta["step"] == 5 and meta["format_version"] == 1
    assert meta["leaves"]["params/w"]["dtype"] == str(dtype)[6:]
    if reader == "fresh":
        mngr = ck.CheckpointManager(str(tmp_path))
    dst = _state(9, dtype)
    load_state_dict(dst, mngr.restore(state_dict(dst)))
    _assert_bitwise(state_dict(dst), want)
    assert dst.step == 5 and dst.opt_state["count"] == 3
    with np.load(tmp_path / "5" / "state.npz") as z:
        if dtype == torch.bfloat16:
            assert z["params/w"].dtype == np.uint16
        assert z["step"] == 5


def test_max_to_keep_and_save_interval(tmp_path):
    mngr = ck.CheckpointManager(str(tmp_path), save_interval=2,
                                max_to_keep=3)
    flat = state_dict(_state(1))
    saved = [mngr.save(s, flat) for s in range(1, 11)]
    assert saved == [s % 2 == 0 for s in range(1, 11)]
    assert mngr.save(11, flat, force=True)
    mngr.wait()
    assert mngr.all_steps() == [8, 10, 11] and mngr.latest_step == 11


@pytest.mark.parametrize("damage", ["truncate", "flip", "meta"])
def test_a_damaged_step_is_walked_past(tmp_path, damage, caplog):
    mngr = ck.CheckpointManager(str(tmp_path))
    good, bad = _state(1), _state(2)
    mngr.save(1, state_dict(good))
    mngr.save(2, state_dict(bad))
    mngr.wait()
    npz = tmp_path / "2" / "state.npz"
    if damage == "truncate":
        npz.write_bytes(npz.read_bytes()[:200])
    elif damage == "flip":
        raw = bytearray(npz.read_bytes())
        with np.load(npz) as z:
            arr = z["params/w"]
        pos = bytes(raw).index(arr.tobytes()[:16])
        raw[pos + 3] ^= 0x40
        npz.write_bytes(bytes(raw))
    else:
        os.unlink(tmp_path / "2" / "meta.json")
    dst = _state(5)
    with caplog.at_level(logging.WARNING):
        out = mngr.restore(state_dict(dst))
    assert "checkpoint step 2 failed to restore" in caplog.text
    load_state_dict(dst, out)
    _assert_bitwise(state_dict(dst), state_dict(good))
    with pytest.raises(ck._CORRUPT_ERRS):
        mngr.restore(state_dict(dst), step=2)


def test_structure_mismatch_walks_back_then_raises(tmp_path):
    mngr = ck.CheckpointManager(str(tmp_path))
    mngr.save(1, state_dict(_state(1)))
    mngr.wait()
    other = _state(1)
    other.opt_state["mu"]["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="different state structure"):
        mngr.restore(state_dict(other))


def test_checkpoint_save_drill_retries(tmp_path, caplog):
    mngr = ck.CheckpointManager(str(tmp_path), retry_backoff_s=0.001)
    flat = state_dict(_state(1))
    try:
        chaos.arm("checkpoint-save", times=2)
        with caplog.at_level(logging.WARNING):
            mngr.save(1, flat)
            mngr.wait()
        assert mngr.all_steps() == [1]
        assert caplog.text.count("checkpoint save at step 1 failed") == 2
        chaos.arm("checkpoint-save", times=3)
        mngr.save(2, flat)
        with pytest.raises(chaos.ChaosFault):
            mngr.wait()
        assert mngr.all_steps() == [1]
        assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    finally:
        chaos.disarm()


def test_a_layout_mix_is_refused(tmp_path):
    mngr = ck.CheckpointManager(str(tmp_path))
    flat = state_dict(_state(1))
    lay = {"pp": 1, "vpp": 1, "num_layers": 2}
    mngr.save(1, flat, layout=lay)
    mngr.save(2, flat, layout=lay)
    with pytest.raises(ValueError, match="refusing to mix"):
        mngr.save(3, flat, layout=dict(lay, num_layers=4))
    mngr.wait()
    assert json.loads((tmp_path / "layout.json").read_text()) == lay


def test_local_checkpoint(tmp_path, caplog):
    local = ck.LocalCheckpointManager(str(tmp_path))
    src = _state(4, torch.bfloat16)
    local.save(7, state_dict(src), extra={"step": 7, "consumed": 28})
    local.save(8, state_dict(src), extra={"step": 8, "consumed": 32})
    assert os.listdir(tmp_path) == ["local_ckpt_p0.npz"]
    assert local.latest_step == 8
    dst = _state(5, torch.bfloat16)
    flat, extra = local.restore(state_dict(dst))
    assert extra == {"step": 8, "consumed": 32}
    load_state_dict(dst, flat)
    _assert_bitwise(state_dict(dst), state_dict(src))
    # Another layout (a leaf more): stale, read as missing.
    other = _state(5, torch.bfloat16)
    other.opt_state["mu"]["extra"] = torch.zeros(2)
    assert local.restore(state_dict(other)) is None
    path = tmp_path / "local_ckpt_p0.npz"
    path.write_bytes(path.read_bytes()[:100])
    with caplog.at_level(logging.WARNING):
        assert local.latest_step is None
        assert local.restore(state_dict(dst)) is None
    assert "corrupt" in caplog.text
    try:
        chaos.arm("local-checkpoint-save")
        with pytest.raises(chaos.ChaosFault):
            local.save(9, state_dict(src))
    finally:
        chaos.disarm()
    (tmp_path / "local_ckpt_p0.npz.tmp").write_bytes(b"partial")
    ck.LocalCheckpointManager(str(tmp_path))
    assert not (tmp_path / "local_ckpt_p0.npz.tmp").exists()


def test_side_state_sidecars_follow_their_steps(tmp_path):
    mngr = ck.CheckpointManager(str(tmp_path), max_to_keep=1)
    flat = state_dict(_state(1))
    for step in (2, 4):
        mngr.save(step, flat)
        mngr.wait()
        ck.write_side_state(str(tmp_path), step, {"consumed": step * 3})
    assert ck.read_side_state(str(tmp_path), 4) == {"step": 4,
                                                    "consumed": 12}
    assert ck.read_side_state(str(tmp_path), 2) is None
    (tmp_path / "side_state_4.json").write_text("{not json")
    assert ck.read_side_state(str(tmp_path), 4) is None


def test_params_only_restore(tmp_path):
    src = _state(6)
    mngr = ck.CheckpointManager(str(tmp_path))
    mngr.save(3, state_dict(src))
    src.step = 6
    mngr.save(6, state_dict(src))
    mngr.wait()
    params = _state(8, torch.bfloat16).params
    assert restore_params(str(tmp_path), params) == 6
    for (n, p), (_, q) in zip(params.named_parameters(),
                              src.params.named_parameters()):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p.detach(), q.detach().to(torch.bfloat16)), n
    assert restore_params(str(tmp_path / "empty"), params) is None


def test_a_reader_touches_nothing_on_disk(tmp_path):
    params = _state(8).params
    missing = tmp_path / "mistyped"
    assert restore_params(str(missing), params) is None
    assert ck.CheckpointManager(str(missing)).restore() is None
    assert not missing.exists()
    writer = ck.CheckpointManager(str(tmp_path / "run"))
    writer.save(2, state_dict(_state(0)))      # its step is 2
    writer.wait()
    # A write in flight (or a crashed one's leftover) looks alike on disk.
    in_flight = tmp_path / "run" / ".4.tmp-1-1"
    in_flight.mkdir()
    (in_flight / "state.npz").write_bytes(b"partial")
    assert restore_params(str(tmp_path / "run"), params) == 2
    assert ck.CheckpointManager(str(tmp_path / "run")).latest_step == 2
    assert in_flight.exists()
    # The writer of the run drops it at its first save.
    again = ck.CheckpointManager(str(tmp_path / "run"))
    again.save(3, state_dict(_state(1)))
    again.wait()
    assert not in_flight.exists() and again.all_steps() == [2, 3]


def test_resolved_args_with_jax_keys(tmp_path):
    args = entry.parse_args(["--num-layers", "3", "--hidden-size", "96",
                             "--save", str(tmp_path), "--train-iters", "7",
                             "--rampup-batch-size", "2", "2", "8"])
    entry.save_resolved_args(args, str(tmp_path))
    assert os.listdir(tmp_path) == ["resolved_args.json"]
    stored = jargs.load_saved_args(str(tmp_path))
    assert stored == entry.load_saved_args(str(tmp_path))
    jax_keys = {a.dest for a in jargs.build_parser("x")._actions}
    # The port's own flags: --device, --preset, and --data-parallel-size
    # (the dp of --use-dpp's one-process stage grid; JAX infers dp from
    # its mesh's devices).
    assert set(stored) - {"device", "preset", "data_parallel_size"} <= \
        jax_keys
    assert stored["num_layers"] == 3 and stored["rampup_batch_size"] == [
        2, 2, 8]
    # JAX's run-control set and the port's --device.
    assert entry._RUN_CONTROL_ARGS == jargs._RUN_CONTROL_ARGS | {"device"}
    again = entry.parse_args(["--load", str(tmp_path),
                              "--use-checkpoint-args", "--hidden-size",
                              "64"])
    assert (again.num_layers, again.hidden_size, again.train_iters) == (
        3, 64, 100)        # stored, explicit, run control not restored
    assert tuple(again.rampup_batch_size) == (2, 2, 8)
    with pytest.raises(ValueError, match="requires --load"):
        entry.parse_args(["--use-checkpoint-args"])


def test_use_checkpoint_args_keeps_this_runs_device(tmp_path):
    """A run made with --device cpu and resumed with --use-checkpoint-args
    runs where this invocation says (the card by default)."""
    args = entry.parse_args(["--num-layers", "3", "--device", "cpu",
                             "--save", str(tmp_path)])
    entry.save_resolved_args(args, str(tmp_path))
    again = entry.parse_args(["--load", str(tmp_path),
                              "--use-checkpoint-args"])
    assert again.num_layers == 3 and again.device is None
