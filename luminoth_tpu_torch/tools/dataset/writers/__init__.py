"""TFRecord writers for converted datasets.

A copy of the JAX package's ``tools/dataset/writers/__init__.py``.
"""

from luminoth_tpu_torch.tools.dataset.writers.object_detection_writer import (  # noqa: F401
    ObjectDetectionWriter,
)
