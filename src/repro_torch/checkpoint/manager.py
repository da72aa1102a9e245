"""Fault-tolerant checkpointing: async, atomic, the JAX package's layout.

Layout:  <dir>/step_<N>/ {manifest.json, arrays.npz}
  * atomic: written to a unique ``step_<N>.tmp-*`` directory, then renamed
    — a crash mid-save never corrupts the latest checkpoint;
  * async: a single background thread drains a depth-1 queue (a save that
    is still running skips the next request rather than stalling the step
    loop); a blocking save first waits for the queue, so two writers never
    race on one step;
  * ``keep``: only the newest ``keep`` checkpoints stay.

State is a nested dict of tensors, e.g. ``{"params": model.state_dict(),
"opt": opt_state}``; leaves are stored under their ``/``-joined key paths.
``save`` copies every leaf to the host before it returns, so the caller may
update its tensors in place at once.  bf16 (and fp8) leaves are stored as
unsigned-integer views with the true dtype in the manifest, and decoded
through torch alone (no ``ml_dtypes``).

Mesh-agnostic: a ``DTensor`` leaf (a training mesh's shard) is gathered
whole (``launch.sharding.full``) on the calling thread, on every rank,
since the gather is a collective; only then may the background writer run, and under
an initialised process group only rank 0 writes.  A checkpoint written on
a mesh is byte-identical to one written without one.  ``restore(...,
mesh=, specs=)`` distributes each leaf under its spec on ``mesh``
(``launch.sharding.shard_tensor``): a relaunch re-shards onto whatever mesh
it has.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import sharding as sh

# numpy's savez cannot store these dtypes: they are stored as raw unsigned
# ints of their width (the JAX package's encoding); torch views them through
# the int type of that width it has (torch.from_numpy takes no uint16)
_VIEW_AS = {"bfloat16": torch.int16, "float8_e4m3fn": torch.uint8,
            "float8_e5m2": torch.uint8}


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as a numpy array savez can store, and the name
    of its true dtype."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"checkpoint leaves must be tensors, got {type(t)}")
    t = t.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if name in _VIEW_AS:
        raw = t.view(_VIEW_AS[name]).numpy()
        return (raw.view(np.uint16) if raw.dtype == np.int16 else raw), name
    return t.numpy(), name


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEW_AS:
        if arr.dtype == np.uint16:
            arr = arr.view(np.int16)
        return torch.from_numpy(arr).view(getattr(torch, dtype_name))
    return torch.from_numpy(arr)


def _unflatten_into(like, flat: Dict[str, torch.Tensor], prefix: str = "",
                    mesh=None, specs=None):
    out = {}
    for key, leaf in like.items():
        path = f"{prefix}{key}"
        spec = None if specs is None else specs[key]
        if isinstance(leaf, dict):
            out[key] = _unflatten_into(leaf, flat, path + "/", mesh, spec)
            continue
        if path not in flat:
            raise KeyError(f"checkpoint missing leaf {path}")
        value = flat[path]
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {path}: ckpt "
                             f"{tuple(value.shape)} vs expected "
                             f"{tuple(leaf.shape)}")
        if value.dtype != leaf.dtype:
            raise ValueError(f"dtype mismatch for {path}: ckpt {value.dtype} "
                             f"vs expected {leaf.dtype}")
        value = value.to(leaf.device)
        out[key] = value if spec is None else sh.shard_tensor(mesh, value,
                                                              spec)
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._async = async_save
        self._err: Optional[BaseException] = None
        # under a process group every rank gathers, rank 0 alone writes
        self._writer = not (dist.is_available() and dist.is_initialized()) \
            or dist.get_rank() == 0
        if async_save and self._writer:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any], block: bool = False):
        """state: nested dict of tensors, e.g. {"params": ..., "opt": ...};
        ``DTensor`` leaves are gathered here, on every rank."""
        full = {k: sh.full(v) for k, v in _flatten(state).items()}
        if not self._writer:
            return
        host = {k: _to_host(v) for k, v in full.items()}
        del full          # the gathered tensors need not outlive the copies
        if not self._async or block:
            if self._async:
                self.wait()
            self._write(step, host)
            return
        try:
            self._q.put_nowait((step, host))
        except queue.Full:
            pass  # previous save still running — skip (depth-1 policy)

    def _worker(self):
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except BaseException as e:  # surfaced on next wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]]):
        # unique tmp dir: a crash leaves only debris that all_steps ignores
        tmp = os.path.join(self.dir,
                           f"step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: arr for k, (arr, _) in host.items()})
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(arr.shape), "dtype": name}
                       for k, (arr, name) in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        """Drain pending async saves (before shutdown, a blocking save, or
        an assert); re-raises a failure of the background writer."""
        if self._async and self._writer:
            self._q.join()
        if self._err:
            raise self._err

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: Optional[int] = None, mesh=None,
                specs=None) -> Tuple[Any, int]:
        """Restore into the structure of ``like`` (a nested dict of tensors,
        e.g. ``{"params": model.state_dict(), "opt": opt_state}``): new
        tensors of the same (global) shapes and dtypes on each leaf's
        device.  ``specs``, the same structure with a ``PartitionSpec`` (or
        None) a leaf, distributes each leaf under it on ``mesh``: a
        ``DTensor`` holding this rank's block.  Returns ``(state, step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _decode(z[k], manifest["leaves"][k]["dtype"])
                    for k in z.files}
        return _unflatten_into(like, flat, mesh=mesh, specs=specs), step
