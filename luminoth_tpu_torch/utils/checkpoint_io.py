"""Train-state checkpoints of the port (counterpart of the JAX package's
``utils/checkpoint_io.py::CheckpointManager``).

Same directory layout: ``<job_dir>/<run_name>/ckpt/ckpt_step_<N>.pt``,
``max_to_keep`` rotation, and resume from the newest readable file. A checkpoint is a
``torch.save`` dict of the step, the model's state dict and the optimizer
state (tensors, ints and strings only), loaded with ``weights_only=True``.
The JAX package's msgpack checkpoints are not read or written here.
"""

import logging
import os
import re

import torch

CHECKPOINT_PREFIX = "ckpt_step_"

logger = logging.getLogger(__name__)


class CheckpointManager:
    """Step-numbered ``torch.save`` checkpoints with rotation."""

    def __init__(self, directory, max_to_keep=1):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step):
        return os.path.join(self.directory, f"{CHECKPOINT_PREFIX}{step}.pt")

    def all_steps(self):
        pattern = re.compile(rf"{CHECKPOINT_PREFIX}(\d+)\.pt$")
        return sorted(
            int(m.group(1)) for m in map(pattern.match,
                                          os.listdir(self.directory)) if m
        )

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step):
        """Write ``state`` (a dict of tensors and numbers) as ``step``."""
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            os.remove(self._path(steps.pop(0)))

    def restore(self, step, map_location=None):
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)

    def restore_latest(self, map_location=None):
        """The newest readable checkpoint, or None when there is none.

        An unreadable newest file falls back to the next older one; raises
        only when every checkpoint is unreadable.
        """
        last_err = None
        for step in reversed(self.all_steps()):
            try:
                return self.restore(step, map_location=map_location)
            except Exception as e:  # truncated or corrupt: try older
                last_err = e
                logger.warning("Checkpoint %s unreadable (%s); falling back "
                               "to an older one", self._path(step), e)
        if last_err is not None:
            raise last_err
        return None
