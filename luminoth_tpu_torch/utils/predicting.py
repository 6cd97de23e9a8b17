"""Inference harness: the port's ``PredictorNetwork``.

Counterpart of the JAX package's ``utils/predicting.py``. Images go through
the JAX package's host preprocessing (resize, pad to the canvas; it imports
neither jax nor flax), are stacked into one batch, cast to float32 on the
device when they travel as uint8, and run through one forward. The output
format is the JAX harness's: per image, a list of ``{bbox, label, prob}``
sorted by probability, boxes in the original image's coordinates.

Not ported (they work around XLA compilation or the TPU mesh): the AOT
executable cache, the persistent compile cache and the device mesh.
Checkpoint loading is not ported yet either: pass ``variables``.
"""

import numpy as np
import torch

from luminoth_tpu.datasets.object_detection_dataset import (
    canvas_shape,
    pad_to_canvas,
    preprocess_image,
)
from luminoth_tpu.utils.image import (
    compose_scale,
    fit_to_canvas,
    settle_transfer_dtype,
)
from luminoth_tpu_torch.models import get_model
from luminoth_tpu_torch.utils.weights import load_flax_variables

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(config):
    """The compute dtype named by ``model.compute_dtype``."""
    name = config.model.get("compute_dtype", "float32")
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"model.compute_dtype must be float32 or bfloat16, got {name!r}"
        ) from None


def resolve_device(device):
    """``device`` as a ``torch.device``; with None, the current CUDA device.

    There is no silent CPU fallback: with no device given and no CUDA
    device visible, this raises. Pass ``device="cpu"`` explicitly to run on
    the CPU (the plain versions of the kernels).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class PredictorNetwork:
    """Loads a model and its weights on a device and predicts objects."""

    def __init__(self, config, variables=None, class_labels=None,
                 device=None):
        """
        Args:
            config: resolved model config (``utils.config.get_config``).
            variables: flax-layout weights (nested ``{params,
                batch_stats}``, flat ``"params/<path>"`` keys, or an
                ``.npz`` path) carried over by ``utils.weights``.
            class_labels: optional label names, indexed by class id.
            device: torch device; None means the current CUDA device.
        """
        if variables is None:
            raise NotImplementedError(
                "checkpoint loading is not ported to PyTorch yet: pass "
                "variables= (flax-layout weights)"
            )
        self.device = resolve_device(device)
        self._config = config
        self._canvas = canvas_shape(config)
        model = get_model(config.model.type)(config, dtype=model_dtype(config))
        load_flax_variables(model, variables)
        self._model = model.to(self.device).eval()
        self.class_labels = class_labels
        transfer = str(config.dataset.get("transfer_dtype", "float32"))
        self._transfer_dtype = (
            np.uint8 if transfer == "uint8" else np.float32
        )

    @torch.inference_mode()
    def forward(self, images, im_shape):
        """Device forward of a (B, H, W, 3) batch → objects, labels, probs,
        valid tensors (B, T, ...)."""
        if images.dtype == torch.uint8:
            images = images.float()
        preds = self._model(images, im_shape=im_shape)
        cp = preds["classification_prediction"]
        return cp["objects"], cp["labels"], cp["probs"], cp["valid"]

    def predict_image(self, image):
        """Detect objects in one RGB ndarray image (list of dicts)."""
        return self.predict_batch([image])[0]

    def predict_batch(self, images, pad_to=None):
        """Detect objects in a list of images with ONE device forward.

        ``pad_to`` rounds the batch up (repeating the last image). Returns
        a list (per image) of lists of ``{bbox, label, prob}``.
        """
        n = len(images)
        if n == 0:
            return []

        padded_images = []
        shapes = []
        scales = []
        for image in images:
            arr = settle_transfer_dtype(np.asarray(image), self._transfer_dtype)
            result = preprocess_image(self._config, arr)
            im = result["image"]
            if im.shape[0] > self._canvas[0] or im.shape[1] > self._canvas[1]:
                # Downscale to fit the canvas rather than crop; fold the
                # factor into scale_factor.
                refit = fit_to_canvas(
                    im, self._canvas,
                    method=self._config.dataset.image_preprocessing.get(
                        "resize_method"
                    ),
                )
                im = refit["image"]
                result["scale_factor"] = compose_scale(
                    result["scale_factor"], refit["scale"]
                )
            padded, (h, w) = pad_to_canvas(im, self._canvas)
            padded_images.append(padded)
            shapes.append((float(h), float(w)))
            scales.append(result["scale_factor"])

        batch = n if pad_to is None else max(pad_to, n)
        while len(padded_images) < batch:
            padded_images.append(padded_images[-1])
            shapes.append(shapes[-1])
            scales.append(scales[-1])

        batch_image = torch.from_numpy(np.stack(padded_images)).to(
            self.device
        )
        im_shape = torch.tensor(shapes, dtype=torch.float32,
                                device=self.device)
        objects_b, labels_b, probs_b, valid_b = (
            t.cpu().numpy() for t in self.forward(batch_image, im_shape)
        )

        all_results = []
        for b in range(n):
            keep = valid_b[b].astype(bool)
            objects = objects_b[b][keep]
            labels = labels_b[b][keep]
            probs = probs_b[b][keep]

            scale = scales[b]
            if isinstance(scale, tuple):
                sy, sx = scale
                objects = objects / np.asarray([sx, sy, sx, sy])
            else:
                objects = objects / scale

            order = np.argsort(-probs)
            results = []
            for i in order:
                label = int(labels[i])
                if self.class_labels is not None and label < len(
                    self.class_labels
                ):
                    label = self.class_labels[label]
                results.append(
                    {
                        "bbox": [float(v) for v in objects[i]],
                        "label": label,
                        "prob": round(float(probs[i]), 4),
                    }
                )
            all_results.append(results)
        return all_results
