"""The train state and its save / restore surface (the JAX package's
training/train_state.py, single-device part).

A ``TrainState`` holds the params (a ``ParamTree`` on the device), the
optimizer state ({"count", "mu", "nu"} keyed by parameter name;
training/optimizer.py) and the step. ``state_dict`` flattens it to leaf
paths, the keys of the port's checkpoints (training/checkpointing.py):

    step                    the optimizer steps taken (int)
    params/<name>           every parameter, by its state_dict name
    opt_state/count         the optimizer's applied-update count (int)
    opt_state/<mu|nu>/<name>  the moments of each trainable parameter
    fp8/block/<mod>/<site>/<hist|sat>  the fp8 state (training/fp8.py),
                            when the run trains in fp8

``load_state_dict`` copies such a dict back in place, so the tensors the
optimizer and the params' module hold stay the same objects. The server
restores params alone (``restore_params``): it reads only the
``params/`` leaves of the newest intact step; ``mtp_depths`` reads the
number of MTP depth modules the checkpoint's model has.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Union

import torch

Leaf = Union[torch.Tensor, int]


@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module
    opt_state: dict
    step: int = 0
    # The fp8 delayed-scaling state (training/fp8.py init_fp8_state).
    fp8: Optional[dict] = None


def state_dict(state: TrainState) -> Dict[str, Leaf]:
    """{leaf path: tensor (the live one, not a copy) or int}."""
    flat: Dict[str, Leaf] = {"step": int(state.step)}
    for name, p in state.params.named_parameters():
        flat[f"params/{name}"] = p.detach()
    for key, val in state.opt_state.items():
        if isinstance(val, dict):
            for name, t in val.items():
                flat[f"opt_state/{key}/{name}"] = t.detach()
        else:
            flat[f"opt_state/{key}"] = int(val)
    if state.fp8 is not None:
        from megatronapp_tpu_torch.training.fp8 import flat_fp8
        flat.update({k: t.detach() for k, t in flat_fp8(state.fp8).items()})
    return flat


@torch.no_grad()
def load_state_dict(state: TrainState, flat: Dict[str, Leaf]) -> None:
    """Copy every leaf of `flat` into `state` in place. The leaf paths
    must be exactly ``state_dict(state)``'s and each tensor's shape its
    target's (dtypes are cast to the target's)."""
    target = state_dict(state)
    missing = sorted(set(target) - set(flat))
    extra = sorted(set(flat) - set(target))
    if missing or extra:
        raise ValueError(f"train state structure differs: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    for key, dst in target.items():
        src = flat[key]
        if isinstance(dst, torch.Tensor):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: checkpoint shape "
                                 f"{tuple(src.shape)}, state "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
    state.step = int(flat["step"])
    for key in state.opt_state:
        if not isinstance(state.opt_state[key], dict):
            state.opt_state[key] = int(flat[f"opt_state/{key}"])


@torch.no_grad()
def restore_params(directory: str, params: torch.nn.Module,
                   step: Optional[int] = None) -> Optional[int]:
    """Copy the params of a checkpoint run directory's newest intact step
    (or `step`) into `params` in place, each cast to its target's dtype.
    Returns the step restored, or None when the directory holds none."""
    from megatronapp_tpu_torch.training.checkpointing import (
        CheckpointManager,
    )
    mngr = CheckpointManager(directory)
    target = {f"params/{n}": p for n, p in params.named_parameters()}
    out = mngr.restore(template=target, step=step, prefix="params/")
    if out is None:
        return None
    for key, dst in target.items():
        dst.copy_(out[key])
    return int(out["step"])


def mtp_depths(directory: str) -> Optional[int]:
    """The number of MTP depth modules (``params/mtp.<d>.*`` leaves) of a
    checkpoint run directory's newest step; None when it holds no step."""
    from megatronapp_tpu_torch.training.checkpointing import (
        CheckpointManager,
    )
    names = CheckpointManager(directory).leaf_names()
    if names is None:
        return None
    return len({m.group(1) for n in names
                if (m := re.match(r"params/mtp\.(\d+)\.", n))})
