"""Periodic parameter-summary hook of the training loop.

Tags are the JAX package's: ``variables/<flax path>/mean`` (and, at the
``full`` level, a histogram and stddev/max/min/sparsity), with the path of
each parameter in the flax layout and its value in that layout, through
the weight bridge (``utils/weights.flax_variables_from_torch``).
"""

import logging

import numpy as np

from luminoth_tpu_torch.utils.hooks.timer import SecondOrStepTimer
from luminoth_tpu_torch.utils.weights import flax_variables_from_torch

logger = logging.getLogger(__name__)

_PARAMS = "params/"


def flax_params(model):
    """``{flax param path (no collection prefix): float32 array}``: the
    trees the JAX package's ``flatten_params(state.params)`` gives."""
    return {path[len(_PARAMS):]: value
            for path, value in flax_variables_from_torch(model).items()
            if path.startswith(_PARAMS)}


class VarVisHook:
    def __init__(self, writer, mode="reduced", every_secs=None,
                 every_steps=None):
        self._writer = writer
        self._mode = mode
        self._timer = SecondOrStepTimer(every_secs, every_steps)

    def after_step(self, step, model):
        if self._writer is None or not self._timer.should_trigger(step):
            return
        # Consume the trigger up front so a failing summary attempt is not
        # retried (with a host copy of every parameter) on every later step.
        self._timer.update(step)
        try:
            for name, value in flax_params(model).items():
                value = np.asarray(value)
                if self._mode == "full":
                    self._writer.add_histogram(
                        f"variables/{name}", value, step
                    )
                    self._writer.add_scalar(
                        f"variables/{name}/stddev", float(value.std()), step
                    )
                    self._writer.add_scalar(
                        f"variables/{name}/max", float(value.max()), step
                    )
                    self._writer.add_scalar(
                        f"variables/{name}/min", float(value.min()), step
                    )
                    self._writer.add_scalar(
                        f"variables/{name}/sparsity",
                        float((value == 0).mean()), step,
                    )
                self._writer.add_scalar(
                    f"variables/{name}/mean", float(value.mean()), step
                )
            self._writer.flush()
        except Exception as e:
            logger.warning("var vis failed: %s", e, exc_info=True)
