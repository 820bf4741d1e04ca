"""Per-epoch checkpoints of the SGD solver, in the JAX package's layout.

- **atomic**: each file lands through ``ckpt.atomic.atomic_savez``;
- **versioned**: one file per epoch (``sgd_epoch_{e:05d}.npz``), the last
  ``keep`` (default 3) retained;
- **exact**: the optimizer velocity and the host PRNG bit-generator state
  (JSON in a 0-d string array) ride along, so an interrupted fit resumed
  from epoch *e* is bitwise equal to one that never stopped.

The npz keys (``coef``, ``intercept``, ``v_coef``, ``v_intercept``,
``epoch``, ``rng_state``, ``fingerprint``) are the JAX package's, so a
checkpoint written by either package resumes in the other. The
fingerprint's ``ndev`` is the fit's global data-shard count (the JAX
package's device count): a checkpoint resumes over as many shards as it
was written on, and is refused over any other count.

Usage::

    ck = SGDCheckpointer(dir)
    params = logistic_fit_sgd(x, y, epochs=8,
                              epoch_callback=ck.epoch_callback,
                              resume=ck.latest())   # None on first run
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from fraud_detection_tpu_torch.ckpt.atomic import atomic_savez

_FILE_RE = re.compile(r"^sgd_epoch_(\d{5})\.npz$")


def _np32(t) -> np.ndarray:
    if hasattr(t, "detach"):  # a torch tensor, possibly on the card
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


class SGDCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"sgd_epoch_{epoch:05d}.npz")

    # -- write -------------------------------------------------------------
    def epoch_callback(
        self, epoch: int, params, velocity, rng, fingerprint: dict | None = None
    ) -> str:
        """``logistic_fit_sgd(epoch_callback=...)`` adapter: persist one
        epoch's training state, then prune old epochs."""
        state = {
            "coef": _np32(params.coef),
            "intercept": _np32(params.intercept),
            "v_coef": _np32(velocity.coef),
            "v_intercept": _np32(velocity.intercept),
            "epoch": np.int64(epoch),
            "rng_state": np.array(json.dumps(rng.bit_generator.state)),
        }
        if fingerprint is not None:
            state["fingerprint"] = np.array(json.dumps(fingerprint))
        path = self._path(epoch)
        atomic_savez(path, **state)
        self._prune()
        return path

    def _prune(self) -> None:
        epochs = sorted(self._epochs())
        for e in epochs[: max(0, len(epochs) - self.keep)]:
            try:
                os.unlink(self._path(e))
            except FileNotFoundError:
                pass

    # -- read --------------------------------------------------------------
    def _epochs(self) -> list[int]:
        return [
            int(m.group(1))
            for m in map(_FILE_RE.match, os.listdir(self.directory)) if m
        ]

    def latest(self) -> dict | None:
        """Most recent saved state as ``logistic_fit_sgd(resume=...)``
        expects, or None when the directory holds no checkpoint."""
        epochs = self._epochs()
        return self.load(max(epochs)) if epochs else None

    def load(self, epoch: int) -> dict:
        with np.load(self._path(epoch)) as z:
            out = {
                "coef": np.asarray(z["coef"]),
                "intercept": np.asarray(z["intercept"]),
                "v_coef": np.asarray(z["v_coef"]),
                "v_intercept": np.asarray(z["v_intercept"]),
                "epoch": int(z["epoch"]),
                "rng_state": json.loads(str(z["rng_state"])),
            }
            if "fingerprint" in z:
                out["fingerprint"] = json.loads(str(z["fingerprint"]))
        return out

    def clear(self) -> None:
        """Remove every checkpoint — called after a fit completes so that a
        later run with the same directory starts fresh."""
        for e in self._epochs():
            try:
                os.unlink(self._path(e))
            except FileNotFoundError:
                pass
