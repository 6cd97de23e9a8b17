"""SSD model family (single-shot detector over a truncated VGG-16)."""

from luminoth_tpu_torch.models.ssd.model import SSD  # noqa: F401
