"""Fault-tolerant checkpointing, in the reference's on-disk format.

* Format: ``step_<10 digits>/<group>.npz`` keyed by the ``/``-joined key
  path of every leaf, plus ``meta.json`` — the reference's, so a
  checkpoint written by either package restores in the other.
* Atomic: write to ``<dir>/.tmp-<step>`` then ``rename`` — a crash mid-save
  never corrupts the latest checkpoint.
* keep_k: bounded disk usage.
* Async: saves can run on a background thread so the train loop only pays
  the device->host transfer.
* Retry: transient save I/O errors retry with exponential backoff
  (bounded, injectable sleep) before surfacing.
* Restore checks every leaf's shape against a template and returns host
  numpy arrays; the caller places them (``train/loop.py``).
* Observability: with an ``obs`` handle (:class:`~repro_torch.obs.Observer`)
  an async save's failure and the retry budget's exhaustion are recorded
  and dump the flight recorder, so the events before the failed save land
  on disk beside the error.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.common import tree_leaves


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten_with_names(tree) -> dict[str, np.ndarray]:
    return {"/".join(path): _to_numpy(leaf) for path, leaf in tree_leaves(tree)}


def _unflatten_like(template, flat: dict[str, np.ndarray], prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, prefix + (k,))
                for k, v in template.items()}
    name = "/".join(prefix)
    if name not in flat:
        raise KeyError(f"checkpoint missing leaf {name!r}")
    arr = flat[name]
    want = tuple(template.shape)
    if tuple(arr.shape) != want:
        raise ValueError(f"leaf {name!r}: checkpoint {arr.shape} != model {want}")
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep_k: int = 3, *,
                 save_retries: int = 3, retry_backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep, obs=None):
        if save_retries < 1:
            raise ValueError("save_retries must be >= 1")
        self.dir = directory
        self.keep_k = keep_k
        self.obs = obs
        # bounded retry around transient save I/O: attempt save_retries
        # times total, backing off retry_backoff_s * 2**attempt between
        # tries.  ``sleep`` is injectable so tests don't wait in real time.
        self.save_retries = save_retries
        self.retry_backoff_s = retry_backoff_s
        self._sleep = sleep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        # a failed async _write parks its exception here; wait() (and so
        # the next save()) re-raises it instead of letting the trainer
        # believe the checkpoint exists
        self._error: BaseException | None = None
        # a .tmp-<step> dir is a save that died before its atomic rename:
        # never restorable, only wasted disk — sweep on init
        for d in os.listdir(directory):
            if d.startswith(".tmp-"):
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: dict, *, blocking: bool = True,
             extra_meta: dict | None = None) -> None:
        """state: {"params": tree, "opt": tree, ...} of tensors or arrays;
        copied to host numpy here, before any background write."""
        self.wait()   # never two writers at once (same-step dir races)
        host = {k: _flatten_with_names(v) for k, v in state.items()}
        meta = {"step": step, "groups": {k: sorted(v) for k, v in host.items()}}
        if extra_meta:
            meta.update(extra_meta)
        if blocking:
            self._write(step, host, meta)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, meta), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join any in-flight async save; re-raise its failure if it had
        one (a daemon thread's exception is otherwise silently lost)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            if self.obs is not None:
                self.obs.record("ckpt_async_failure", error=repr(err))
                self.obs.dump("checkpoint_async_save_failed",
                              context={"dir": self.dir, "error": repr(err)})
            raise RuntimeError("async checkpoint save failed") from err

    def _write_guarded(self, step: int, host: dict, meta: dict) -> None:
        try:
            self._write(step, host, meta)
        except BaseException as e:  # noqa: BLE001 - surfaced at wait()
            self._error = e

    def _write(self, step: int, host: dict, meta: dict) -> None:
        """One save, retried through transient ``OSError``s.  Each attempt
        restarts from the tmp dir (``_write_once`` resets it); after the
        last attempt the error propagates (the orphaned tmp dir is left
        for the init-time sweep)."""
        for attempt in range(self.save_retries):
            try:
                return self._write_once(step, host, meta)
            except OSError as e:
                if attempt + 1 >= self.save_retries:
                    if self.obs is not None:
                        self.obs.record("ckpt_retry_exhausted", step=step,
                                        attempts=self.save_retries, error=repr(e))
                        self.obs.dump("checkpoint_save_retries_exhausted",
                                      context={"dir": self.dir, "step": step,
                                               "attempts": self.save_retries,
                                               "error": repr(e)})
                    raise
                self._sleep(self.retry_backoff_s * 2 ** attempt)

    def _write_once(self, step: int, host: dict, meta: dict) -> None:
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for group, flat in host.items():
            np.savez(os.path.join(tmp, f"{group}.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_k] if self.keep_k else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(d[len("step_"):]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int | None) -> tuple[int, str]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step, os.path.join(self.dir, f"step_{step:010d}")

    def load_meta(self, step: int | None = None) -> tuple[int, dict]:
        """Read a checkpoint's ``meta.json`` (latest when ``step`` is None)
        without touching its array groups.  Returns ``(step, meta)``."""
        _, path = self._path(step)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return meta["step"], meta

    def restore(self, template: dict, step: int | None = None,
                shard_fn: Callable[[Any], Any] | None = None) -> tuple[int, dict]:
        """Restore into the structure of ``template`` (leaves with
        ``.shape``: tensors, meta tensors or arrays).  Returns ``(step,
        state)`` with numpy leaves; ``shard_fn(tree) -> tree`` is applied
        to each group when given."""
        _, path = self._path(step)
        state = {}
        for group, tmpl in template.items():
            with np.load(os.path.join(path, f"{group}.npz")) as z:
                flat = {k: z[k] for k in z.files}
            tree = _unflatten_like(tmpl, flat)
            state[group] = shard_fn(tree) if shard_fn else tree
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return meta["step"], state
