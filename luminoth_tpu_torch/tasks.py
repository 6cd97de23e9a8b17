"""Python task API: the port's ``Detector`` class.

Counterpart of the JAX package's ``tasks.py``, with the same ``predict``
output format: a list of ``{"bbox": [x1, y1, x2, y2], "label": ...,
"prob": ...}``. A ``Detector`` is built from a config, with flax-layout
``variables`` or the newest training checkpoint under the config's
``train.job_dir``. Checkpoint-zoo loading (``checkpoint=``) is not ported
yet.
"""

import numpy as np

from luminoth_tpu_torch.utils.config import get_config
from luminoth_tpu_torch.utils.predicting import (
    ZOO_NOT_PORTED,
    PredictorNetwork,
)


class Detector:
    """High-level object-detection interface."""

    def __init__(self, checkpoint=None, config=None, prob=0.7, classes=None,
                 variables=None, device=None):
        """
        Args:
            checkpoint: zoo checkpoint id or alias (not ported yet: raises).
            config: path (or list of paths) to YAML config(s).
            prob: default probability threshold for predictions.
            classes: iterable of class labels to keep by default.
            variables: flax-layout weights (see ``utils/weights.py``);
                None loads the newest checkpoint under the config's
                ``train.job_dir``.
            device: torch device; None means the current CUDA device.
        """
        if checkpoint is not None and config is not None:
            raise ValueError(
                "Only one of `checkpoint` or `config` must be specified."
            )
        if config is None:
            raise NotImplementedError(ZOO_NOT_PORTED)
        self._config = get_config(config)
        self.prob = prob
        self.classes = set(classes) if classes else None
        self._network = PredictorNetwork(
            self._config, variables=variables, device=device
        )

    def predict(self, images, prob=None, classes=None):
        """Detect objects in one image or a list of images.

        Returns a list of objects for a single image, or a list of lists
        when given a list. Lists run in batches of at most 8, each padded
        to a power of two.
        """
        if prob is None:
            prob = self.prob
        classes = self.classes if classes is None else set(classes)

        single = not isinstance(images, (list, tuple))
        if single:
            images = [images]

        arrays = [np.asarray(image) for image in images]
        batched = []
        max_chunk = 8
        i = 0
        while i < len(arrays):
            chunk = arrays[i : i + max_chunk]
            pad_to = 1
            while pad_to < len(chunk):
                pad_to *= 2
            batched.extend(
                self._network.predict_batch(chunk, pad_to=pad_to)
            )
            i += len(chunk)

        all_results = []
        for objects in batched:
            objects = [o for o in objects if o["prob"] >= prob]
            if classes is not None:
                objects = [o for o in objects if o["label"] in classes]
            all_results.append(objects)

        return all_results[0] if single else all_results
