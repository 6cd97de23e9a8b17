"""Train-state checkpoints of the port (counterpart of the JAX package's
``utils/checkpoint_io.py::CheckpointManager``).

Same directory layout: ``<job_dir>/<run_name>/ckpt/ckpt_step_<N>.pt``,
``max_to_keep`` rotation, and resume from the newest readable file. A checkpoint is a
``torch.save`` dict of the step, the model's state dict and the optimizer
state (tensors, ints and strings only), loaded with ``weights_only=True``.

For evaluation and serving, :meth:`CheckpointManager.latest_state_dict`
also reads the JAX package's ``ckpt_step_<N>.msgpack`` train states
(through the port's own msgpack reader, ``formats/msgpack.py``), and
:func:`load_model_weights` puts the weights of either format into a model.
The port writes only ``.pt`` files.
"""

import logging
import os
import re

import numpy as np
import torch

from luminoth_tpu_torch.formats import msgpack
from luminoth_tpu_torch.utils.weights import load_flax_variables

CHECKPOINT_PREFIX = "ckpt_step_"
_FILE = re.compile(rf"{CHECKPOINT_PREFIX}(\d+)\.(pt|msgpack)$")

logger = logging.getLogger(__name__)


class CheckpointManager:
    """Step-numbered ``torch.save`` checkpoints with rotation."""

    def __init__(self, directory, max_to_keep=1):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step, suffix="pt"):
        return os.path.join(self.directory,
                            f"{CHECKPOINT_PREFIX}{step}.{suffix}")

    def _files(self):
        """``(step, suffix)`` of every checkpoint file, oldest first; on
        equal steps the ``.pt`` file comes last (it is preferred)."""
        found = (m.groups() for m in map(_FILE.match,
                                         os.listdir(self.directory)) if m)
        return sorted((int(step), suffix) for step, suffix in found)

    def all_steps(self):
        return sorted(step for step, suffix in self._files() if suffix == "pt")

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

    def read(self, step, suffix):
        """The state of one checkpoint file of either format."""
        if suffix == "pt":
            return self.restore(step, map_location="cpu")
        return msgpack.load(self._path(step, suffix))

    def evaluable_steps(self):
        """``[(step, suffix)]``, oldest first, one file per step: the
        ``.pt`` where a step has both formats."""
        return list(dict(self._files()).items())

    def latest_state_dict(self):
        """``(state, step)`` of the newest readable checkpoint of either
        format (the port's ``.pt``, the JAX package's ``.msgpack``); on
        equal steps the ``.pt``. An unreadable file falls back to the next
        older one, as in the JAX package; ``(None, None)`` when nothing is
        readable."""
        for step, suffix in reversed(self._files()):
            try:
                return self.read(step, suffix), step
            except Exception as e:  # truncated or corrupt: try older
                logger.warning(
                    "Checkpoint %s unreadable (%s); falling back to an "
                    "older one", self._path(step, suffix), e)
        return None, None


def _as_float32(node):
    """Nested flax variables with numpy float32 leaves (a msgpack leaf may
    be a ``torch.bfloat16`` tensor)."""
    if isinstance(node, dict):
        return {key: _as_float32(value) for key, value in node.items()}
    if torch.is_tensor(node):
        return node.float().numpy()
    return np.asarray(node, np.float32)


def load_model_weights(model, state):
    """Load the weights of a checkpoint ``state`` into ``model``.

    A port checkpoint (``.pt``) holds the model's state dict under
    ``"model"``; a JAX train state (``.msgpack``) holds flax
    ``params`` and ``batch_stats``, which go through the weight bridge
    (``utils/weights.py``). Its optimizer state is not read.
    """
    if "model" in state:
        model.load_state_dict(state["model"], strict=True)
        return model
    variables = {"params": state["params"]}
    if state.get("batch_stats"):
        variables["batch_stats"] = state["batch_stats"]
    return load_flax_variables(model, _as_float32(variables))
