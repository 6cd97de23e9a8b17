"""Faster R-CNN model family (inference)."""

from luminoth_tpu_torch.models.fasterrcnn.model import FasterRCNN  # noqa: F401
