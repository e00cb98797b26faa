"""Checkpoint save and restore (the JAX package's
training/checkpointing.py semantics in the port's own format).

Durable checkpoints (``CheckpointManager``): one directory per step under
the run directory,

    <dir>/<step>/state.npz   an uncompressed .npz keyed by leaf path
                             (training/train_state.py: step, params/<name>,
                             opt_state/count, opt_state/<mu|nu>/<name>)
    <dir>/<step>/meta.json   the step, the format version, each leaf's
                             shape and dtype, and the grid the step was
                             written under ("written_under": dp, tp and
                             ZeRO-1; absent on one device)
    <dir>/layout.json        the run's layout, written once
    <dir>/side_state_<step>.json  the loop's host bookkeeping

Every leaf is whole: a rank grid gathers its shards before rank 0 saves
(training/distributed_optimizer.py), so a step resumes on any grid. bf16
leaves are stored as their uint16 bits, the dtype named in meta.json
(numpy has no bfloat16). A step is written into a temporary directory and
renamed into place, so a step directory that exists is whole unless it
was damaged later; a damaged one fails its read (the zip's CRC, a missing
member or a shape that disagrees with meta.json) and ``restore`` walks
back to the previous step.

``save`` copies the whole state to the host before it returns: the
optimizer updates params and moments in place, so the write cannot read
the live tensors. Only the file write runs, on a background thread;
``wait`` finishes it and raises its error. The write retries with
backoff (the ``checkpoint-save`` chaos site fires at each attempt) and
keeps the newest ``max_to_keep`` steps. Opening a manager touches
nothing on disk; its first save creates the directory. As in JAX, a step
off ``save_interval`` is skipped unless forced, and a run directory holds
one layout: a save with another is refused.

``LocalCheckpointManager`` is the latest-only non-persistent checkpoint:
one .npz per process with the side state inside, written under a
temporary name and renamed; a corrupt or stale file reads as missing
(the ``local-checkpoint-save`` chaos site fires before each save).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import shutil
import threading
import time
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from megatronapp_tpu_torch.utils import chaos

logger = logging.getLogger("megatronapp_tpu_torch.checkpointing")

FORMAT_VERSION = 1
STATE_FILE = "state.npz"
META_FILE = "meta.json"
# Attempts after the first failed write of a step, with doubling backoff.
SAVE_RETRIES = 2
# Errors a damaged or partial file raises on read.
_CORRUPT_ERRS = (OSError, ValueError, KeyError, EOFError,
                 zipfile.BadZipFile)

HostState = Tuple[Dict[str, np.ndarray], Dict[str, str]]


def to_host(flat: Dict[str, object]) -> HostState:
    """(arrays, dtypes): each leaf copied to host memory (a copy even for
    CPU tensors: the caller keeps training them) as numpy, bf16 as its
    uint16 bits; ints as int64 scalars of dtype "int"."""
    arrays, dtypes = {}, {}
    for key, val in flat.items():
        if isinstance(val, torch.Tensor):
            t = val.detach().to("cpu", copy=True)
            dtypes[key] = str(t.dtype).replace("torch.", "")
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
                arrays[key] = t.numpy().view(np.uint16)
            else:
                arrays[key] = t.numpy()
        else:
            dtypes[key] = "int"
            arrays[key] = np.asarray(int(val), np.int64)
    return arrays, dtypes


def from_host(arr: np.ndarray, dtype: str):
    """A stored leaf back as a CPU tensor (or an int)."""
    if dtype == "int":
        return int(arr)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    want = getattr(torch, dtype)
    if t.dtype != want:
        raise ValueError(f"leaf stored as {t.dtype}, meta says {dtype}")
    return t


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Uncompressed .npz written leaf by leaf from the host arrays (no
    second full copy)."""
    with open(path, "wb") as f:
        np.savez(f, **arrays)


class CheckpointManager:
    """Durable checkpoints of one run directory."""

    def __init__(self, directory: str, save_interval: Optional[int] = None,
                 max_to_keep: int = 3, retry_backoff_s: float = 0.5):
        # Opening touches nothing on disk: a reader (the server, a --load
        # dir) must not create a mistyped directory nor remove a live
        # run's write in flight. The first save prepares the directory.
        self.directory = os.path.abspath(directory)
        self.save_interval = save_interval or 1
        self.max_to_keep = max_to_keep
        self.retry_backoff_s = retry_backoff_s
        self._layout_path = os.path.join(self.directory, "layout.json")
        self._prepared = False
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._in_flight: Optional[int] = None   # the step being written

    def _prepare(self) -> None:
        """Create the run directory and drop the temporary step
        directories a crash mid-write left (never a checkpoint); once,
        before this manager's first write: a later save would find its
        own write in flight."""
        if self._prepared:
            return
        os.makedirs(self.directory, exist_ok=True)
        for leftover in glob.glob(os.path.join(self.directory, ".*.tmp-*")):
            shutil.rmtree(leftover, ignore_errors=True)
        self._prepared = True

    # ---- steps -----------------------------------------------------------
    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isdir(
                    os.path.join(self.directory, name)):
                steps.append(int(name))
        return sorted(steps)

    @property
    def latest_step(self) -> Optional[int]:
        """The newest step on disk or being written."""
        steps = self.all_steps()
        if self._in_flight is not None:
            steps.append(self._in_flight)
        return max(steps) if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    # ---- save ------------------------------------------------------------
    def _read_layout(self) -> Optional[dict]:
        if not os.path.exists(self._layout_path):
            return None
        with open(self._layout_path) as f:
            return json.load(f)

    def save(self, step: int, flat: Dict[str, object], force: bool = False,
             layout: Optional[dict] = None,
             written_under: Optional[dict] = None) -> bool:
        """Save the flat state at `step` (skipped, returning False, off
        save_interval unless forced). The host copy is complete when this
        returns; the write may still run (``wait``). written_under: the
        grid of the run, recorded in meta.json."""
        if not force and step % self.save_interval:
            return False
        self._prepare()
        if layout is not None:
            existing = self._read_layout()
            if existing is not None and existing != dict(layout):
                raise ValueError(
                    f"checkpoint dir {self.directory} was saved with "
                    f"layout {existing}; refusing to mix in "
                    f"{dict(layout)} — use a fresh --save dir per layout")
            if existing is None:
                tmp = self._layout_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(dict(layout), f)
                os.replace(tmp, self._layout_path)
        host = to_host(flat)
        self.wait()                 # one write in flight at a time

        def run():
            try:
                self._write_with_retry(step, host, written_under)
            except BaseException as e:  # noqa: BLE001 — raised by wait()
                self._error = e

        self._in_flight = step
        self._thread = threading.Thread(target=run, name="ckpt-save",
                                        daemon=True)
        self._thread.start()
        return True

    def _write_with_retry(self, step: int, host: HostState,
                          written_under: Optional[dict] = None) -> None:
        """Bounded retry with backoff: a transient failure must not end a
        long run when the next attempt would succeed; a persistent one
        still raises after the last attempt."""
        last_err = None
        for attempt in range(SAVE_RETRIES + 1):
            try:
                chaos.fire("checkpoint-save")
                self._write(step, host, written_under)
                return
            except Exception as e:  # noqa: BLE001 — retried, then raised
                last_err = e
            if attempt >= SAVE_RETRIES:
                break
            delay = self.retry_backoff_s * (2 ** attempt)
            logger.warning("checkpoint save at step %d failed (%s: %s); "
                           "retry %d/%d in %.2fs", step,
                           type(last_err).__name__, last_err, attempt + 1,
                           SAVE_RETRIES, delay)
            time.sleep(delay)
        raise last_err

    def _write(self, step: int, host: HostState,
               written_under: Optional[dict] = None) -> None:
        arrays, dtypes = host
        tmp = os.path.join(
            self.directory,
            f".{step}.tmp-{os.getpid()}-{threading.get_ident()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            _write_npz(os.path.join(tmp, STATE_FILE), arrays)
            meta = {"step": int(step), "format_version": FORMAT_VERSION,
                    "leaves": {k: {"shape": list(a.shape),
                                   "dtype": dtypes[k]}
                               for k, a in arrays.items()}}
            if written_under is not None:
                meta["written_under"] = dict(written_under)
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f)
            final = self._step_dir(step)
            old = None
            if os.path.exists(final):
                old = final + f".old-{os.getpid()}"
                os.replace(final, old)
            os.replace(tmp, final)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def wait(self) -> None:
        """Finish the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._in_flight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    # ---- restore ---------------------------------------------------------
    def restore(self, template: Optional[Dict[str, object]] = None,
                step: Optional[int] = None,
                prefix: Optional[str] = None) -> Optional[Dict[str, object]]:
        """The flat state of `step`, or of the newest step that reads
        whole (walking back past damaged ones with a warning), as CPU
        tensors and ints; None when the directory holds no step.
        template: the flat state to restore into; its leaf paths and
        shapes must be the checkpoint's. prefix: read only leaves under
        it (and "step"), e.g. "params/" for the server."""
        if step is not None:
            return self._restore_at(step, template, prefix)
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None
        last_err = None
        for s in steps:
            try:
                return self._restore_at(s, template, prefix)
            except _CORRUPT_ERRS as e:
                last_err = e
                logger.warning("checkpoint step %d failed to restore (%s: "
                               "%s); falling back to the previous saved "
                               "step", s, type(e).__name__, e)
        raise last_err

    def leaf_names(self) -> Optional[list]:
        """The leaf paths of the newest step whose meta.json reads; None
        when the directory holds no such step."""
        for s in sorted(self.all_steps(), reverse=True):
            try:
                with open(os.path.join(self._step_dir(s), META_FILE)) as f:
                    return sorted(json.load(f)["leaves"])
            except _CORRUPT_ERRS:
                continue
        return None

    def _restore_at(self, step: int, template, prefix) -> Dict[str, object]:
        d = self._step_dir(step)
        with open(os.path.join(d, META_FILE)) as f:
            meta = json.load(f)
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"checkpoint step {step}: format version "
                             f"{meta.get('format_version')}, this code reads "
                             f"{FORMAT_VERSION}")
        leaves = meta["leaves"]
        keys = [k for k in leaves
                if prefix is None or k.startswith(prefix) or k == "step"]
        if template is not None:
            want = {k for k in template
                    if prefix is None or k.startswith(prefix)}
            have = {k for k in keys if k != "step" or prefix is None}
            if want != have:
                raise ValueError(
                    f"checkpoint step {step} holds a different state "
                    f"structure: missing {sorted(want - have)[:4]}, "
                    f"unexpected {sorted(have - want)[:4]}")
        out = {}
        with np.load(os.path.join(d, STATE_FILE)) as z:
            for k in keys:
                arr = z[k]
                if list(arr.shape) != leaves[k]["shape"]:
                    raise ValueError(f"checkpoint step {step}: leaf {k} "
                                     f"shape {arr.shape}, meta "
                                     f"{leaves[k]['shape']}")
                out[k] = from_host(arr, leaves[k]["dtype"])
        if template is not None:
            for k, t in template.items():
                if isinstance(t, torch.Tensor) and k in out and \
                        tuple(out[k].shape) != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint step {step}: leaf {k} has shape "
                        f"{tuple(out[k].shape)}, the state "
                        f"{tuple(t.shape)} (another model geometry?)")
        return out

    def nbytes(self, step: int) -> int:
        """Bytes on disk of step `step`."""
        d = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(d, f)) for f in
                   os.listdir(d))


class LocalCheckpointManager:
    """Latest-only non-persistent local checkpoint: one flat .npz,
    renamed into place, the side state inside."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # One process: the JAX trainer's file name of process 0.
        self._path = os.path.join(self.directory, "local_ckpt_p0.npz")
        # A crash between the write and the rename leaves the temporary
        # file: by definition incomplete.
        if os.path.exists(self._path + ".tmp"):
            logger.warning("local checkpoint: dropping leftover partial "
                           "file %s", self._path + ".tmp")
            os.unlink(self._path + ".tmp")

    def save(self, step: int, flat: Dict[str, object],
             extra: Optional[Dict] = None) -> None:
        chaos.fire("local-checkpoint-save")
        arrays, dtypes = to_host(flat)
        arrays["__step__"] = np.asarray(step)
        arrays["__dtypes__"] = np.frombuffer(json.dumps(dtypes).encode(),
                                             np.uint8)
        if extra is not None:
            arrays["__extra__"] = np.frombuffer(json.dumps(extra).encode(),
                                                np.uint8)
        tmp = self._path + ".tmp"
        _write_npz(tmp, arrays)
        os.replace(tmp, self._path)

    @property
    def latest_step(self) -> Optional[int]:
        if not os.path.exists(self._path):
            return None
        try:
            with np.load(self._path) as z:
                return int(z["__step__"])
        except _CORRUPT_ERRS as e:
            logger.warning("local checkpoint %s is corrupt/partial (%s: "
                           "%s); ignoring it", self._path,
                           type(e).__name__, e)
            return None

    def restore(self, template: Dict[str, object]
                ) -> Optional[Tuple[Dict[str, object], Optional[Dict]]]:
        """(flat state, side state) or None: a corrupt or partial file, or
        one whose leaves are not the template's (another layout), reads
        as missing and the caller takes the durable path."""
        if not os.path.exists(self._path):
            return None
        try:
            with np.load(self._path) as z:
                dtypes = json.loads(bytes(z["__dtypes__"]))
                extra = (json.loads(bytes(z["__extra__"]))
                         if "__extra__" in z else None)
                if set(dtypes) != set(template):
                    raise ValueError("leaf paths differ from the state's")
                out = {k: from_host(z[k], dtypes[k]) for k in dtypes}
            for k, t in template.items():
                if isinstance(t, torch.Tensor) and \
                        tuple(out[k].shape) != tuple(t.shape):
                    raise ValueError(f"{k}: shape {tuple(out[k].shape)}, "
                                     f"state {tuple(t.shape)}")
        except _CORRUPT_ERRS as e:
            logger.warning("local checkpoint %s failed to load (%s: %s); "
                           "ignoring it", self._path, type(e).__name__, e)
            return None
        return out, extra


# ---- resumable side state (consumed samples) -----------------------------

def write_side_state(directory: str, step: int, payload: Dict) -> None:
    """The loop's host bookkeeping beside a durable step (consumed
    samples: the data-stream position, _RowBuffer carry-over included),
    atomic rename; sidecars whose step directory is gone are removed
    (the just-written step's is kept: its async write may still run)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"side_state_{step}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, **payload}, f)
    os.replace(tmp, path)
    for old in glob.glob(os.path.join(directory, "side_state_*.json")):
        m = re.fullmatch(r"side_state_(\d+)\.json", os.path.basename(old))
        if m and int(m.group(1)) != step and \
                not os.path.isdir(os.path.join(directory, m.group(1))):
            try:
                os.unlink(old)
            except OSError:
                pass


def read_side_state(directory: str, step: int) -> Optional[Dict]:
    """The side state of a step; None when absent or unreadable (the
    loop then replays the rampup schedule)."""
    path = os.path.join(directory, f"side_state_{step}.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        logger.warning("side state %s unreadable (%s: %s); ignoring",
                       path, type(e).__name__, e)
        return None
