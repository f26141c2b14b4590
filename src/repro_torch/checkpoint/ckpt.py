"""Checkpointing: atomic and async, ported from ``repro.checkpoint.ckpt``
with the same on-disk layout, so either package restores what the other
wrote.

Layout:  <dir>/step_<N>/
            manifest.json       keys + dtypes + shapes + meta
            arrays.npz          flattened leaves keyed by path

Keys are the tree's paths joined by ``/`` (``params/embed/table``,
``opt/master/...``, ``opt/step``: the reference's state tree and the
port's, whose ``params`` is a ParamTree, flatten alike).  bf16 (and
fp8) leaves are stored as a same-width unsigned integer view, their
dtype in the manifest.  Writes go to ``<dir>/.tmp_<N>``
(``manifest.json`` written LAST, so its presence marks a complete
write) and are swapped into place with two renames: an existing
``step_<N>`` is first renamed aside to ``.old_<N>``, then the tmp dir is
renamed in, then the old copy is deleted, so at every instant one
COMPLETE copy of the step is on disk.  :func:`latest_step` and
:func:`restore` finish or discard what interrupted writers left: a
complete orphan whose final dir is missing is promoted, everything else
deleted.

``save_async`` copies the tree to host memory synchronously (a
consistent view) and writes on a daemon thread; its
:class:`CheckpointHandle`'s ``join()`` re-raises any write error.
``save(..., keep_last=N)`` prunes all but the newest N checkpoints.

:func:`restore` writes the stored values **into the example tree's
tensors in place** (cast to each leaf's dtype, on its device) and
returns that tree: the reference builds new arrays, but the trainer's
state is most of a card, and a second copy of it would not fit.
Restoring onto a resized mesh (the reference's ``shardings``) waits for
ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..models.params import flat_tree

# torch dtypes with no numpy twin: stored as an unsigned view of one width
_VIEWS = {torch.bfloat16: (torch.int16, np.uint16),
          torch.float8_e4m3fn: (torch.uint8, np.uint8),
          torch.float8_e5m2: (torch.uint8, np.uint8)}


def _to_host(t) -> tuple:
    """(numpy array as stored, dtype name for the manifest): a copy, so a
    later in-place update of ``t`` leaves it as it was."""
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    if t.dtype in _VIEWS:
        view, npv = _VIEWS[t.dtype]
        a = t.contiguous().view(view).numpy().view(npv)
        return a, str(t.dtype).removeprefix("torch.")
    a = t.numpy()
    return a, str(a.dtype)


def _from_stored(arr: np.ndarray, dtype: str) -> torch.Tensor:
    tdt = getattr(torch, dtype)
    if tdt in _VIEWS:
        view, _ = _VIEWS[tdt]
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16 if view == torch.int16 else np.uint8)).view(tdt)
    return torch.from_numpy(np.array(arr))


def _step_of(p: Path) -> Optional[int]:
    try:
        return int(p.name.split("_")[-1])
    except ValueError:
        return None


def _gc_stale(ckpt_dir: Path) -> None:
    """Finish or discard interrupted writers.  A ``.tmp_<N>``/``.old_<N>``
    dir with a ``manifest.json`` (written last => complete) whose
    ``step_<N>`` is missing is the survivor of a crash mid-swap: promote
    it.  Everything else is deleted.  ``.tmp`` is promoted before
    ``.old`` is examined, so when both are complete the newer content
    wins."""
    if not ckpt_dir.exists():
        return
    for prefix in (".tmp_", ".old_"):
        for p in sorted(ckpt_dir.glob(prefix + "*")):
            step = _step_of(p)
            if step is None:
                continue
            final = ckpt_dir / f"step_{step}"
            complete = (p / "manifest.json").exists()
            if final.exists() or not complete:
                shutil.rmtree(p, ignore_errors=True)
            else:
                os.rename(p, final)


def _apply_retention(ckpt_dir: Path, keep_last: int) -> None:
    steps = sorted((s for s in (_step_of(p)
                                for p in ckpt_dir.glob("step_*"))
                    if s is not None))
    for step in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(ckpt_dir / f"step_{step}", ignore_errors=True)


def _write(ckpt_dir, step: int, host: Dict[str, tuple], meta,
           keep_last: Optional[int]) -> str:
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {
        "step": step,
        "meta": meta or {},
        "treedef": sorted(host),
        "keys": {k: {"shape": list(a.shape), "dtype": dt}
                 for k, (a, dt) in host.items()},
        "time": time.time(),
    }
    np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in host.items()})
    # manifest last: its presence marks the tmp dir complete
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    # two-rename swap: an existing final is set aside, never destroyed
    # before the replacement is in place
    old = None
    if final.exists():
        old = ckpt_dir / f".old_{step}"
        if old.exists():
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    if keep_last is not None and keep_last > 0:
        _apply_retention(ckpt_dir, keep_last)
    return str(final)


def save(ckpt_dir, step: int, tree, meta: Optional[Dict] = None,
         keep_last: Optional[int] = None) -> str:
    """Write ``tree`` (dicts, lists, ParamTrees of tensors) as step
    ``step``; returns the checkpoint's path."""
    host = {k: _to_host(v) for k, v in flat_tree(tree).items()}
    return _write(ckpt_dir, step, host, meta, keep_last)


class CheckpointHandle:
    """A pending async checkpoint write.  ``join()`` blocks for the
    writer thread and RE-RAISES its exception, so a failed write (full
    disk, permissions) fails the caller loudly.  ``path()``/``join()``
    return the final checkpoint path on success."""

    def __init__(self, fn, args, kwargs):
        self.step = args[1]
        self._result: Optional[str] = None
        self._exc: Optional[BaseException] = None

        def _run():
            try:
                self._result = fn(*args, **kwargs)
            except BaseException as e:       # noqa: BLE001 — re-raised
                self._exc = e                # on join()

        self._thread = threading.Thread(
            target=_run, daemon=True, name=f"ckpt-save-{self.step}")
        self._thread.start()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> Optional[str]:
        """Wait for the write; re-raise its error.  Returns the final
        checkpoint path, or None if ``timeout`` expired first."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            return None
        if self._exc is not None:
            raise self._exc
        return self._result

    def path(self) -> Optional[str]:
        return self._result


def save_async(ckpt_dir, step: int, tree, meta: Optional[Dict] = None,
               keep_last: Optional[int] = None) -> CheckpointHandle:
    """Copy the tree to host memory now, write it on a daemon thread.
    Callers MUST ``join()`` the handle (the train driver does, before the
    next async save and at exit) or risk losing write failures."""
    host = {k: _to_host(v) for k, v in flat_tree(tree).items()}
    return CheckpointHandle(_write, (ckpt_dir, step, host, meta),
                            {"keep_last": keep_last})


def latest_step(ckpt_dir) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    _gc_stale(d)
    steps = [s for s in (_step_of(p) for p in d.glob("step_*"))
             if s is not None]
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir, step: Optional[int], example_tree) -> tuple:
    """Returns ``(example_tree, meta)`` with every tensor leaf of
    ``example_tree`` overwritten in place by the stored values (cast to
    the leaf's dtype); ``meta`` holds the saved meta and ``step``."""
    _gc_stale(Path(ckpt_dir))
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    arrays = np.load(d / "arrays.npz")
    flat = flat_tree(example_tree)
    missing = [k for k in flat if k not in arrays]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
    for key, leaf in flat.items():
        src = _from_stored(arrays[key], manifest["keys"][key]["dtype"])
        if tuple(src.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key} is {tuple(src.shape)}, "
                             f"the tree's {tuple(leaf.shape)}")
        leaf.copy_(src.to(device=leaf.device))
    return example_tree, manifest["meta"] | {"step": manifest["step"]}
