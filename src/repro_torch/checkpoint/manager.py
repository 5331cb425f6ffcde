"""Fault-tolerant checkpoint manager.

Port of ``repro.checkpoint.manager``:

- atomic: write to a temporary directory, ``COMMIT`` marker, then
  ``os.replace`` — a crash mid-write never corrupts the latest checkpoint;
- keep-K garbage collection;
- optional async save (a background thread), so the training loop does
  not wait on the disk;
- ``restore_latest`` scans for the newest committed step — the restart
  path after a node failure.

The snapshot: the reference's state is immutable arrays, so it saves
``np.asarray`` views from its thread.  The port's optimizers update the
parameters and moments in place, and on the CPU ``Tensor.numpy()``
shares memory with the tensor, so ``save`` copies every leaf to host
memory before the thread starts: a later step cannot rewrite what is
being written.
"""
from __future__ import annotations

import os
import re
import shutil
import threading

from repro_torch.checkpoint.serial import load_tree, save_tree
from repro_torch.optim.sgd import tree_map

_STEP_RE = re.compile(r"^step_(\d+)$")


def snapshot(state):
    """A host copy of every tensor of ``state`` (numpy arrays that share
    nothing with the state)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), state)


class CheckpointManager:
    def __init__(self, directory, *, keep=3, async_save=False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread = None
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step):
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                out.append(int(m.group(1)))
        return sorted(out)

    # -- save ----------------------------------------------------------------
    def save(self, step, state, *, block=True):
        state_host = snapshot(state)          # before any thread starts
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, state_host), daemon=True)
            self._thread.start()
        else:
            self._save_sync(step, state_host)

    def _save_sync(self, step, state_host):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        save_tree(os.path.join(tmp, "state.npz"), state_host)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step, template):
        return load_tree(os.path.join(self._step_dir(step), "state.npz"),
                         template)

    def restore_latest(self, template):
        steps = self.steps()
        if not steps:
            return None, -1
        step = steps[-1]
        return self.restore(step, template), step
