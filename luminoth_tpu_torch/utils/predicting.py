"""Inference harness: the port's ``PredictorNetwork``.

Counterpart of the JAX package's ``utils/predicting.py``. Images go through
the port's copy of the JAX package's host preprocessing (resize, pad to the
canvas), are stacked into one batch, cast to float32 on the
device when they travel as uint8, and run through one forward. The output
format is the JAX harness's: per image, a list of ``{bbox, label, prob}``
sorted by probability, boxes in the original image's coordinates.

Weights come from ``variables`` or, without them, from the newest
training checkpoint under ``train.job_dir`` (the port's ``.pt`` or the JAX
package's ``.msgpack``, see :func:`load_checkpoint_variables`); a zoo
bundle's config points ``train.job_dir`` at the bundle.

With ``model.base_network.int8_static`` (the ``fast`` profile) the int8
activation scales are calibrated once at load, as the JAX predictor does,
unless the variables carry the JAX package's ``int8_stats``.

Over several devices (the JAX package's ``mesh="auto"``), the model is
replicated in this process on each device and a batch, rounded up to a
multiple of the device count, is split over the replicas; their forwards
are all launched before any output is read.

Not ported (they work around XLA compilation): the AOT executable cache
and the persistent compile cache.
"""

import logging
import os
import time

import numpy as np
import torch

from luminoth_tpu_torch.datasets.object_detection_dataset import (
    canvas_shape,
    pad_to_canvas,
    preprocess_image,
)
from luminoth_tpu_torch.io import read_image
from luminoth_tpu_torch.models import get_model
from luminoth_tpu_torch.models.base.quantized_tail import (
    calibrating,
    int8_modules,
    needs_calibration,
)
from luminoth_tpu_torch.parallel.mesh import replicate, run_replicas
from luminoth_tpu_torch.utils.checkpoint_io import (
    CheckpointManager,
    load_model_weights,
)
from luminoth_tpu_torch.utils.image import (
    compose_scale,
    fit_to_canvas,
    settle_transfer_dtype,
)
from luminoth_tpu_torch.utils.weights import load_flax_variables

logger = logging.getLogger(__name__)

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


def load_checkpoint_variables(config):
    """The state of the newest readable training checkpoint, for
    :func:`~luminoth_tpu_torch.utils.checkpoint_io.load_model_weights`.

    Searches, in order, ``job_dir/run_name/ckpt``, ``job_dir/ckpt`` and
    ``job_dir`` itself, as the JAX package's predictor does; reads the
    port's ``.pt`` and the JAX package's ``.msgpack`` files.
    """
    job_dir = config.train.get("job_dir", "jobs/")
    run_name = config.train.get("run_name") or "default"
    for ckpt_dir in (os.path.join(job_dir, run_name, "ckpt"),
                     os.path.join(job_dir, "ckpt"), job_dir):
        if not os.path.isdir(ckpt_dir):
            continue
        # Falls back to an older checkpoint if the newest is unreadable.
        state, step = CheckpointManager(ckpt_dir).latest_state_dict()
        if state is not None:
            logger.info("Restored checkpoint at step %d from %s", step,
                        ckpt_dir)
            return state
    raise FileNotFoundError(f"no checkpoint found under {job_dir}")


class PredictorNetwork:
    """Loads a model and its weights on a device and predicts objects."""

    def __init__(self, config, variables=None, class_labels=None,
                 device=None, devices="auto"):
        """
        Args:
            config: resolved model config (``utils.config.get_config``).
            variables: flax-layout weights (nested ``{params,
                batch_stats}``, flat ``"params/<path>"`` keys, or an
                ``.npz`` path) carried over by ``utils.weights``; None
                loads the newest checkpoint under ``train.job_dir``.
            class_labels: optional label names, indexed by class id.
            device: torch device; None means the current CUDA device.
            devices: ``"auto"`` replicates the model on every visible
                CUDA device when there are several and ``device`` is None
                (one device: nothing changes); a list replicates it on
                those devices (one may repeat); None: ``device`` only.
        """
        if devices == "auto":
            devices = None
            if (device is None and torch.cuda.is_available()
                    and torch.cuda.device_count() > 1):
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
        if devices:
            device = devices[0]
        self.device = resolve_device(device)
        self._config = config
        self._canvas = canvas_shape(config)
        model = get_model(config.model.type)(config, dtype=model_dtype(config))
        if variables is None:
            load_model_weights(model, load_checkpoint_variables(config))
        else:
            load_flax_variables(model, variables)
        self._model = model.to(self.device).eval()
        self.class_labels = class_labels
        transfer = str(config.dataset.get("transfer_dtype", "float32"))
        self._transfer_dtype = (
            np.uint8 if transfer == "uint8" else np.float32
        )
        # Seconds the int8 calibration took at load (None: not run).
        self.int8_calibration_s = None
        if needs_calibration(self._model):
            t0 = time.perf_counter()
            self._calibrate_int8()
            self.int8_calibration_s = time.perf_counter() - t0
        # The model first, then a copy per other device (calibrated).
        self._replicas = ([self._model] if not devices or len(devices) < 2
                          else replicate(self._model, devices))

    @torch.inference_mode()
    def _calibrate_int8(self):
        """One activation-range calibration for ``int8_static`` serving
        (the JAX ``PredictorNetwork._calibrate_int8``).

        Runs the int8 forward with every static quant point recording its
        running ``max|x|`` (the forward itself quantizes dynamically); the
        served forwards then use those static scales. The inputs are the
        files of ``model.base_network.int8_calibration_images``, one at a
        time through the real preprocessing, or else one synthetic canvas
        (the JAX predictor's: ``RandomState(0).randint(0, 255, (1, h, w,
        3))``), fine for bring-up; calibrate on real data for
        accuracy-sensitive serving.
        """
        h, w = self._canvas
        batches = []
        for path in (self._config.model.base_network.get(
                "int8_calibration_images") or []):
            result = preprocess_image(
                self._config, read_image(path).astype(np.float32))
            padded, (ih, iw) = pad_to_canvas(result["image"], self._canvas)
            batches.append((padded[None], [[float(ih), float(iw)]]))
        if not batches:
            logger.info(
                "int8_static: calibrating on a synthetic canvas (set "
                "model.base_network.int8_calibration_images for real-"
                "data ranges).")
            rng = np.random.RandomState(0)
            batches = [(rng.randint(0, 255, (1, h, w, 3)).astype(np.float32),
                        [[float(h), float(w)]])]
        with calibrating(self._model):
            for image, im_shape in batches:
                self._model(torch.from_numpy(image).to(self.device),
                            im_shape=torch.tensor(im_shape,
                                                  device=self.device))
        logger.info(
            "int8_static: calibrated %d activation scale(s) over %d "
            "image(s)", sum(len(m.quant_points)
                            for m in int8_modules(self._model)),
            len(batches))

    @torch.inference_mode()
    def forward(self, images, im_shape):
        """Device forward of a (B, H, W, 3) batch → objects, labels, probs,
        valid tensors (B, T, ...)."""
        if images.dtype == torch.uint8:
            images = images.float()
        def detect(model, images, im_shape):
            cp = model(images, im_shape=im_shape)["classification_prediction"]
            return cp["objects"], cp["labels"], cp["probs"], cp["valid"]

        if len(self._replicas) == 1:
            return detect(self._model, images, im_shape)
        return run_replicas(self._replicas, detect, images, im_shape)

    def predict_image(self, image):
        """Detect objects in one RGB ndarray image (list of dicts)."""
        return self.predict_batch([image])[0]

    def predict_batch(self, images, pad_to=None):
        """Detect objects in a list of images with ONE device forward.

        ``pad_to`` rounds the batch up (repeating the last image), and so
        does a multiple of the replica count. Returns a list (per image)
        of lists of ``{bbox, label, prob}``.
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
        batch = -(-batch // len(self._replicas)) * len(self._replicas)
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
