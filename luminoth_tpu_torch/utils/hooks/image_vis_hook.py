"""Periodic image-summary hook of the training loop.

The training loop asks :meth:`ImageVisHook.should_trigger` after a step;
when it is due, it runs a monitor forward (``model.eval()``, no gradients)
and hands its prediction dict to :meth:`ImageVisHook.after_step`, which
moves it to the host, keeps the first image of the batch and writes the
renderings of ``utils/image_vis.py`` as ``image_vis/<name>`` images.
"""

import logging

import numpy as np
import torch

from luminoth_tpu_torch.utils.hooks.timer import SecondOrStepTimer
from luminoth_tpu_torch.utils.image_vis import image_vis_summaries

logger = logging.getLogger(__name__)


class ImageVisHook:
    def __init__(self, writer, model_type, image_vis_mode="train",
                 every_secs=None, every_steps=None, variances=None):
        self._writer = writer
        self._model_type = model_type
        self._mode = image_vis_mode
        self._variances = variances
        self._timer = SecondOrStepTimer(every_secs, every_steps)

    def should_trigger(self, step):
        return self._writer is not None and self._timer.should_trigger(step)

    def after_step(self, step, batch, prediction_dict, all_anchors=None):
        if not self.should_trigger(step):
            return
        # Mark the trigger consumed up front: if the vis attempt fails,
        # retrying it (and the host copy of the whole prediction dict) on
        # every later step is far worse than skipping this tick.
        self._timer.update(step)
        try:
            summaries = image_vis_summaries(
                first_in_batch(to_host(prediction_dict)),
                config={"type": self._model_type},
                image_vis_mode=self._mode,
                image=batch["image"][0],
                gt_boxes=batch["gt_boxes"][0],
                all_anchors=all_anchors,
                variances=self._variances,
            )
            for name, img in summaries.items():
                self._writer.add_image(
                    f"image_vis/{name}", img, step, dataformats="HWC"
                )
            self._writer.flush()
        except Exception as e:
            logger.warning("image vis failed: %s", e, exc_info=True)


def to_host(tree):
    """Nested dicts of tensors → the same of numpy arrays (bfloat16 and
    other floating tensors as float32)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        tree = tree.detach()
        if tree.is_floating_point():
            tree = tree.float()
        return tree.cpu().numpy()
    return np.asarray(tree)


def first_in_batch(tree):
    """Slice the leading axis of every array leaf, as the JAX hook does
    (an unbatched leaf, such as SSD's ``(A, 4)`` anchors, loses its first
    axis too)."""
    if isinstance(tree, dict):
        return {k: first_in_batch(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.ndim >= 1 and arr.shape[0] >= 1:
        return arr[0]
    return arr
