"""Sharded checkpointing: atomic, async, elastic.  Ported from
``repro/checkpoint/manager.py``; trees go through ``repro_torch.tree``.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json
  manifest: step, config name/hash, mesh shape, data cursor, flat-param
            length (for elastic re-shard validation).

* Atomic: written to step_<N>.tmp then os.rename'd — a crash never leaves
  a half-checkpoint that restore() would pick up.  Stale ``step_<N>.tmp``
  directories (and final dirs missing their manifest) left by a crash
  are swept at startup so retention pruning never trips over them.
* Async: ``save_async`` snapshots to host memory synchronously (cheap) and
  writes on a background thread, double-buffered — the step loop never
  blocks on disk.  A background write failure is surfaced as a
  :class:`CheckpointError` on the NEXT ``save``/``save_async``/``wait``
  call (never swallowed).
* Elastic: optimizer m/v are stored as FULL flat vectors (gathered from
  shards); ``restore`` re-shards to ANY data-parallel world size — scaling
  from e.g. 4 hosts to 2 or 8 between runs changes nothing but slicing.
  ``restore(None, ...)`` falls back to the previous completed checkpoint
  when the newest one is truncated/corrupt (an explicit ``step`` never
  falls back — the caller asked for that exact checkpoint).
* Retention: keep_last completed checkpoints (older ones pruned).
* Stable bytes: ``arrays.npz`` is ``np.savez``'s layout with a fixed
  member timestamp, so one state always writes the same file.
* Fault injection: an optional ``io_hook(step)`` runs before every
  write/read — ``ft.FailurePlan.io_hook`` raises transient
  ``CheckpointIOError``\\ s through it, which the elastic controller's
  bounded retry/backoff must absorb.

The arrays are host (numpy) copies of the tensors, keyed as the
reference keys them: ``p_<i>`` for the i-th parameter leaf in JAX's
flatten order (dicts by sorted key, lists by index), ``opt_<key>`` for
each optimizer array.  numpy has no bfloat16: a bfloat16 leaf is stored
as the reference stores one, two raw bytes per element (dtype ``V2``),
and restored by reinterpreting those bytes.

On multi-host deployments each host would write its own process-local
shard files; the manifest/atomic-rename/cursor discipline is identical.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .. import tree as T


def _save_npz(path: str, arrays: dict) -> None:
    """``np.savez``'s file (one stored ``<key>.npy`` member per array, in
    order) with a fixed timestamp on every member, so the bytes depend
    on the arrays alone: the same state gives the same file, whichever
    world wrote it."""
    import zipfile
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            info = zipfile.ZipInfo(key + ".npy", date_time=(1980, 1, 1, 0, 0,
                                                            0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(val),
                                          allow_pickle=False)


class CheckpointError(RuntimeError):
    """A (possibly background) checkpoint write failed; carries the step
    whose save failed as ``.step``.  Chained from the original error."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(f"checkpoint save of step {step} failed: {cause!r}")
        self.step = step


def to_host(x) -> np.ndarray:
    """Host numpy copy of a tensor (or array): bfloat16 as raw ``V2``
    bytes, the layout the reference's checkpoints hold."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view("V2")
        return x.cpu().numpy()
    return np.asarray(x)


def from_host(arr: np.ndarray, like):
    """A stored array in the form of the template leaf ``like``: a tensor
    of its dtype on its device (``V2`` bytes read back as bfloat16), or a
    numpy array of its dtype."""
    if isinstance(like, torch.Tensor):
        if arr.dtype.kind == "V":
            if like.dtype != torch.bfloat16:
                raise ValueError(f"raw {arr.dtype} bytes for a {like.dtype} "
                                 f"leaf")
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)
        return t.to(like.device)
    return np.asarray(arr).astype(np.asarray(like).dtype)


def treedef_str(tree) -> str:
    """The tree's structure as the reference's manifest records it (JAX's
    ``str(treedef)`` of nested dicts and lists: sorted keys, list entries
    in order, ``*`` per leaf)."""
    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(x) for x in node) + "]"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _tree_to_flat_dict(tree, prefix="p"):
    return ({f"{prefix}_{i}": to_host(l)
             for i, l in enumerate(T.leaves(tree))}, treedef_str(tree))


def config_fingerprint(cfg) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


@dataclass
class Snapshot:
    step: int
    arrays: dict[str, np.ndarray]
    manifest: dict[str, Any]


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 io_hook: Callable[[int], None] | None = None):
        self.dir = directory
        self.keep_last = keep_last
        self.io_hook = io_hook
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        #: the last completed write: its step, seconds and bytes on disk
        self.last_write: dict | None = None
        self._sweep_stale()

    def _sweep_stale(self) -> list[str]:
        """Remove crash leftovers: ``step_<N>.tmp`` dirs (a write died
        before the atomic rename) and final dirs missing their manifest
        (should be impossible under the rename discipline, but a partial
        copy restored from external storage can produce one).  Returns
        the swept names (for logging/tests)."""
        swept = []
        for name in sorted(os.listdir(self.dir)):
            path = os.path.join(self.dir, name)
            if not (name.startswith("step_") and os.path.isdir(path)):
                continue
            stale = name.endswith(".tmp") or not os.path.exists(
                os.path.join(path, "manifest.json"))
            if stale:
                shutil.rmtree(path, ignore_errors=True)
                swept.append(name)
        return swept

    # -- save ---------------------------------------------------------------

    def _snapshot(self, step, params, opt_flat: dict, extra: dict) -> Snapshot:
        arrays, treedef = _tree_to_flat_dict(params)
        for k, v in opt_flat.items():
            arrays[f"opt_{k}"] = to_host(v)
        manifest = {
            "step": int(step),
            "treedef": treedef,
            "n_param_leaves": sum(1 for k in arrays if k.startswith("p_")),
            **extra,
        }
        return Snapshot(int(step), arrays, manifest)

    def _write(self, snap: Snapshot):
        if self.io_hook is not None:
            self.io_hook(snap.step)
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{snap.step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _save_npz(os.path.join(tmp, "arrays.npz"), snap.arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(snap.manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self.last_write = {"step": snap.step, "s": time.perf_counter() - t0,
                           "bytes": os.path.getsize(
                               os.path.join(final, "arrays.npz"))}
        self._prune()

    def _prune(self):
        steps = self.completed_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def save(self, step, params, opt_flat: dict, extra: dict | None = None):
        self.wait()  # surface a pending async failure before writing more
        try:
            self._write(self._snapshot(step, params, opt_flat, extra or {}))
        except CheckpointError:
            raise
        except BaseException as e:
            raise CheckpointError(int(step), e) from e

    def save_async(self, step, params, opt_flat: dict,
                   extra: dict | None = None):
        """Snapshot now (device->host copy), write in background.

        Surfaces the PREVIOUS background write's failure (if any) as a
        :class:`CheckpointError` before starting the new write."""
        self.wait()  # double-buffer: at most one outstanding write
        snap = self._snapshot(step, params, opt_flat, extra or {})

        def run():
            try:
                self._write(snap)
            except BaseException as e:  # surfaced on next save*/wait call
                self._error = CheckpointError(snap.step, e)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------

    def completed_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.completed_steps()
        return steps[-1] if steps else None

    def _read(self, step: int):
        """Raw (manifest, npz) of one checkpoint dir; raises on any
        corruption (truncated manifest, bad zip, missing keys)."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
        data.files  # force the zip directory read — surfaces truncation
        return manifest, data

    def restore(self, step: int | None, params_template, device=None):
        """Returns (step, params, opt_arrays dict, manifest): ``params``
        in the template's form (tensors of its leaves' dtypes on their
        devices, or all on ``device`` when it is given: a template of
        ``meta`` tensors then needs no memory), the optimizer arrays as
        host numpy arrays.

        ``step=None`` restores the newest checkpoint, falling back to
        the previous completed one if the newest is truncated/corrupt
        (each skip warns).  An explicit ``step`` never falls back.
        Template-shape mismatches are caller errors and always raise.
        """
        if step is None:
            candidates = list(reversed(self.completed_steps()))
            if not candidates:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        else:
            candidates = [step]
        manifest = data = None
        errors = []
        for i, s in enumerate(candidates):
            # The io_hook runs OUTSIDE the corruption fallback: a hook
            # failure models a TRANSIENT IO fault (retryable — the
            # elastic controller's backoff owns it), not a corrupt
            # checkpoint, so it must propagate instead of silently
            # falling back to an older step.
            if self.io_hook is not None:
                self.io_hook(s)
            try:
                manifest, data = self._read(s)
                step = s
                break
            except Exception as e:
                errors.append((s, e))
                if i + 1 < len(candidates):
                    warnings.warn(
                        f"checkpoint step_{s} is unreadable ({e!r}); "
                        f"falling back to step_{candidates[i + 1]}",
                        RuntimeWarning, stacklevel=2)
        if data is None:
            raise CheckpointError(candidates[-1], errors[-1][1]) \
                from errors[-1][1]
        items = T.flatten(params_template)
        if len(items) != manifest["n_param_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_param_leaves']} param leaves, "
                f"template has {len(items)} — config mismatch?")
        new_items = []
        for i, (path, tmpl) in enumerate(items):
            arr = data[f"p_{i}"]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != template "
                                 f"{tuple(tmpl.shape)}")
            leaf = from_host(arr, tmpl if device is None
                             else torch.empty((), dtype=tmpl.dtype,
                                              device=device))
            new_items.append((path, leaf))
            del arr
        params = T.unflatten(new_items)
        opt = {k[len("opt_"):]: data[k] for k in data.files
               if k.startswith("opt_")}
        return step, params, opt, manifest


def reshard_flat(full: np.ndarray, world: int, rank: int) -> np.ndarray:
    """Elastic slice of a stored full flat vector for a new DP world size."""
    n = full.shape[0]
    pad = (-n) % world
    if pad:
        full = np.concatenate([full, np.zeros(pad, full.dtype)])
    shard = full.shape[0] // world
    return full[rank * shard:(rank + 1) * shard]
