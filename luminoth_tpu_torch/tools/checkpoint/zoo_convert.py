"""Reference detector-checkpoint conversion: a trained TF model → the port's
checkpoint.

The port's copy of the JAX package's ``tools/checkpoint/zoo_convert.py``,
over the port's own TF checkpoint reader (``formats/tf_checkpoint.py``),
so no TensorFlow is needed. It converts complete trained detector
checkpoints of the reference Luminoth (the zoo's ``accurate`` Faster
R-CNN/COCO and ``fast`` SSD/VOC bundles, or any reference ``lumi train``
output) into a step-0 checkpoint of the port (``ckpt/ckpt_step_0.pt``)
that ``predict``, ``eval`` and ``train`` (as a resume) load:

    python -m luminoth_tpu_torch checkpoint convert-detector \\
        model.ckpt-100000 converted/ -c config.yml

Name resolution is by **suffix matching**: sonnet/TF variable names carry
outer scopes that vary with how the graph was built
(``fasterrcnn/truncated_base_network/resnet_v1_101/...``), so every
wanted relative name (``rpn/cls_conv/w``, ``resnet_v1_101/conv1/weights``)
is located by its trailing path components instead of an absolute path.
Optimizer slots (``.../Momentum``) and ``global_step`` are not read.

Head layers need no value transforms: sonnet ``Conv2D`` kernels are HWIO
and ``snt.Linear`` weights are (in, out), both the flax layout, which the
port's weight bridge (``utils/weights.py``) takes.
"""

import logging

import numpy as np

from luminoth_tpu_torch.formats.tf_checkpoint import open_checkpoint
from luminoth_tpu_torch.models import get_model
from luminoth_tpu_torch.tools.checkpoint.slim_convert import (
    convert_slim_resnet,
    convert_slim_vgg16,
)
from luminoth_tpu_torch.utils.checkpoint_io import CheckpointManager
from luminoth_tpu_torch.utils.weights import (
    flax_variables_from_torch,
    load_flax_variables,
)

logger = logging.getLogger(__name__)


class SuffixResolver:
    """Resolve checkpoint variables by trailing path components."""

    def __init__(self, ckpt_path):
        self._reader = open_checkpoint(ckpt_path)
        self.names = sorted(self._reader.names())

    def find(self, suffix):
        """Full variable name ending in ``suffix`` (None if absent)."""
        matches = [
            n for n in self.names
            if n == suffix or n.endswith("/" + suffix)
        ]
        if not matches:
            return None
        if len(matches) > 1:
            raise ValueError(
                f"ambiguous suffix {suffix!r}: {matches}"
            )
        return matches[0]

    def read(self, suffix):
        name = self.find(suffix)
        if name is None:
            return None
        return np.asarray(self._reader.read(name), dtype=np.float32)


def _head_conv(flat, resolver, flax_prefix, slim_suffix):
    """Map a sonnet Conv2D/Linear ``{w,b}`` pair onto flax kernel/bias."""
    w = resolver.read(f"{slim_suffix}/w")
    if w is None:
        return False
    flat[f"params/{flax_prefix}/kernel"] = w
    b = resolver.read(f"{slim_suffix}/b")
    if b is not None:
        flat[f"params/{flax_prefix}/bias"] = b
    return True


def convert_reference_fasterrcnn(resolver, architecture="resnet_v1_101"):
    """Flat dict for a reference Faster R-CNN training checkpoint."""
    flat = convert_slim_resnet(resolver.read, architecture)
    for name in ("conv", "cls_conv", "bbox_conv"):
        if not _head_conv(flat, resolver, f"rpn/{name}", f"rpn/{name}"):
            raise KeyError(f"rpn/{name}/w not found in checkpoint")
    for name in ("fc_classifier", "fc_bbox"):
        if not _head_conv(flat, resolver, f"rcnn/{name}", f"rcnn/{name}"):
            raise KeyError(f"rcnn/{name}/w not found in checkpoint")
    i = 0
    while _head_conv(flat, resolver, f"rcnn/fc_{i}", f"rcnn/fc_{i}"):
        i += 1
    return flat


def convert_reference_ssd(resolver):
    """Flat dict for a reference SSD training checkpoint."""
    flat = convert_slim_vgg16(resolver.read, scopes=("feature_extractor",))
    extras = ("conv6", "conv7", "conv8_1", "conv8_2", "conv9_1", "conv9_2",
              "conv10_1", "conv10_2", "conv11_1", "conv11_2")
    for name in extras:
        if not _head_conv(
            flat, resolver, f"feature_extractor/{name}", name
        ):
            raise KeyError(f"{name}/w not found in checkpoint")
    scale = resolver.read("conv_4_3_norm/scale")
    if scale is None:
        scale = resolver.read("conv_4_3_norm/gamma")
    if scale is not None:
        flat["params/feature_extractor/conv4_3_norm/gamma"] = scale
    i = 0
    while _head_conv(
        flat, resolver,
        f"MultiBox_{i}_offsets_conv", f"MultiBox_{i}_offsets_conv",
    ):
        _head_conv(
            flat, resolver,
            f"MultiBox_{i}_classes_conv", f"MultiBox_{i}_classes_conv",
        )
        i += 1
    if i == 0:
        raise KeyError("no MultiBox_* heads found in checkpoint")
    return flat


def convert_zoo_checkpoint(ckpt_path, out_dir, config):
    """Convert a reference detector checkpoint into the port's.

    Args:
        ckpt_path: TF checkpoint prefix of the trained reference model.
        out_dir: directory to write the ``ckpt_step_0.pt`` into; point
            ``train.job_dir`` at its parent (or bundle it with
            ``checkpoint create``) to predict/evaluate.
        config: model config, used to build the variable tree.

    Returns (n_loaded, n_total) leaf counts. A variable the checkpoint
    does not give (or gives with another shape) is zero, as in the JAX
    converter, and is logged.
    """
    resolver = SuffixResolver(ckpt_path)
    if config.model.type == "fasterrcnn":
        flat = convert_reference_fasterrcnn(
            resolver, config.model.base_network.architecture
        )
    else:
        flat = convert_reference_ssd(resolver)

    model = get_model(config.model.type)(config)
    template = {
        path: np.zeros_like(value)
        for path, value in flax_variables_from_torch(model).items()
        if path.startswith(("params/", "batch_stats/"))
    }
    n_loaded = 0
    for path, value in template.items():
        if path in flat and flat[path].shape == value.shape:
            template[path] = flat[path].astype(value.dtype)
            n_loaded += 1
    n_total = len(template)
    logger.info("Converted %d/%d arrays", n_loaded, n_total)
    if n_loaded < n_total:
        # Surface exactly what didn't map — a partial detector is useless.
        missing = [k for k in template if k not in flat]
        logger.warning("Unmapped variables: %s", missing[:20])

    load_flax_variables(model, template)
    manager = CheckpointManager(out_dir)
    manager.save({"step": 0, "model": model.state_dict(),
                  "optimizer": {"count": 0, "slots": {}}}, 0)
    return n_loaded, n_total
