"""TF-slim checkpoint conversion: slim ImageNet ``.ckpt`` → ``.npz``.

The port's copy of the JAX package's ``tools/checkpoint/slim_convert.py``,
over the port's own TF checkpoint reader (``formats/tf_checkpoint.py``),
so no TensorFlow is needed. The reference initializes training from slim
ImageNet checkpoints and restores them into its scoped backbone by
remapping variable names; this emits a flat ``.npz`` keyed by flax
variable paths, exactly as the JAX converter writes it, which
``train.load_pretrained_backbone`` reads (``model.base_network.weights``):

    python -m luminoth_tpu_torch checkpoint convert-backbone \\
        resnet_v1_101.ckpt weights.npz --architecture resnet_v1_101

Slim checkpoints carry the layout the default ResNet computes (stride on
the LAST unit of each block, root max-pool VALID, conv2d_same padding), so
a ResNet file is stamped ``__meta__/layout = "slim"`` and loads with no
extra config. Conv kernels are already HWIO in TF; no transposes.

Downloading the tarballs needs the network: :func:`download_slim_backbone`
raises.
"""

import logging

import numpy as np

from luminoth_tpu_torch.formats.tf_checkpoint import checkpoint_reader
from luminoth_tpu_torch.models.base.resnet import RESNET_BLOCK_DEFS

logger = logging.getLogger(__name__)

# Slim ImageNet checkpoint tarballs — the reference's own pretrained
# sources (checkpoint_downloader.py:13-23).
SLIM_CHECKPOINT_URLS = {
    "resnet_v1_50":
        "http://download.tensorflow.org/models/resnet_v1_50_2016_08_28.tar.gz",
    "resnet_v1_101":
        "http://download.tensorflow.org/models/resnet_v1_101_2016_08_28.tar.gz",
    "resnet_v1_152":
        "http://download.tensorflow.org/models/resnet_v1_152_2016_08_28.tar.gz",
    "resnet_v2_50":
        "http://download.tensorflow.org/models/resnet_v2_50_2017_04_14.tar.gz",
    "resnet_v2_101":
        "http://download.tensorflow.org/models/resnet_v2_101_2017_04_14.tar.gz",
    "resnet_v2_152":
        "http://download.tensorflow.org/models/resnet_v2_152_2017_04_14.tar.gz",
    "vgg_16":
        "http://download.tensorflow.org/models/vgg_16_2016_08_28.tar.gz",
    "truncated_vgg_16":
        "http://download.tensorflow.org/models/vgg_16_2016_08_28.tar.gz",
}


def _get(read_tensor, name):
    value = read_tensor(name)
    if value is None:
        raise KeyError(f"variable {name!r} not found in checkpoint")
    return np.asarray(value, dtype=np.float32)


def _bn(flat, read_tensor, flax_prefix, slim_prefix):
    """gamma/beta → scale/bias; moving stats → batch_stats mean/var."""
    flat[f"params/{flax_prefix}/BatchNorm/scale"] = _get(
        read_tensor, f"{slim_prefix}/gamma"
    )
    flat[f"params/{flax_prefix}/BatchNorm/bias"] = _get(
        read_tensor, f"{slim_prefix}/beta"
    )
    flat[f"batch_stats/{flax_prefix}/BatchNorm/mean"] = _get(
        read_tensor, f"{slim_prefix}/moving_mean"
    )
    flat[f"batch_stats/{flax_prefix}/BatchNorm/var"] = _get(
        read_tensor, f"{slim_prefix}/moving_variance"
    )


def convert_slim_resnet(read_tensor, architecture, scope="base_network"):
    """Map slim ResNet v1/v2 variables onto the flax variable paths.

    Args:
        read_tensor: callable name -> ndarray (or None if absent), e.g.
            ``formats.tf_checkpoint.checkpoint_reader(path)``.
        architecture: e.g. ``"resnet_v1_101"``.
        scope: flax parent module name for the trunk.

    Returns a flat dict ``{"params/<path>"|"batch_stats/<path>": array}``,
    with ``block4`` mirrored under ``{scope}_tail`` for the ROI-head trunk.
    """
    version = 1 if "_v1_" in architecture else 2
    depth = int(architecture.rsplit("_", 1)[1])
    block_defs = RESNET_BLOCK_DEFS[depth]
    unit_scope = f"bottleneck_v{version}"
    flat = {}
    root = f"{scope}/{architecture}"

    flat[f"params/{root}/conv1/kernel"] = _get(
        read_tensor, f"{architecture}/conv1/weights"
    )
    if version == 1:
        _bn(flat, read_tensor, f"{root}/conv1_bn",
            f"{architecture}/conv1/BatchNorm")
    else:
        # v2's normalizer-free convs (root conv1, unit conv3, shortcut)
        # carry biases in slim checkpoints.
        flat[f"params/{root}/conv1/bias"] = _get(
            read_tensor, f"{architecture}/conv1/biases"
        )

    for b, (_, num_units, _) in enumerate(block_defs, start=1):
        for u in range(1, num_units + 1):
            slim_unit = f"{architecture}/block{b}/unit_{u}/{unit_scope}"
            scopes = [f"{root}/block{b}/unit_{u}"]
            if b == 4:
                # The detached ROI tail re-hosts block4 under its own
                # module (reference: truncated_base_network.py:56-95).
                scopes.append(
                    f"{scope}_tail/{architecture}/block4/unit_{u}"
                )
            for fprefix in scopes:
                for k in (1, 2, 3):
                    flat[f"params/{fprefix}/conv{k}/kernel"] = _get(
                        read_tensor, f"{slim_unit}/conv{k}/weights"
                    )
                    if version == 1 or k < 3:
                        # v2 conv3 has no normalizer (pre-activation)...
                        _bn(flat, read_tensor, f"{fprefix}/conv{k}_bn",
                            f"{slim_unit}/conv{k}/BatchNorm")
                    else:
                        # ...so it carries a bias instead.
                        flat[f"params/{fprefix}/conv3/bias"] = _get(
                            read_tensor, f"{slim_unit}/conv3/biases"
                        )
                if read_tensor(f"{slim_unit}/shortcut/weights") is not None:
                    flat[f"params/{fprefix}/shortcut/kernel"] = _get(
                        read_tensor, f"{slim_unit}/shortcut/weights"
                    )
                    if version == 1:
                        _bn(flat, read_tensor, f"{fprefix}/shortcut_bn",
                            f"{slim_unit}/shortcut/BatchNorm")
                    else:
                        flat[f"params/{fprefix}/shortcut/bias"] = _get(
                            read_tensor, f"{slim_unit}/shortcut/biases"
                        )
                if version == 2:
                    _bn(flat, read_tensor, f"{fprefix}/preact",
                        f"{architecture}/block{b}/unit_{u}/"
                        f"{unit_scope}/preact")
    if version == 2:
        _bn(flat, read_tensor, f"{root}/postnorm",
            f"{architecture}/postnorm")
    return flat


_VGG_CONVS = [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]


def convert_slim_vgg16(read_tensor,
                       scopes=("feature_extractor", "base_network")):
    """Map slim ``vgg_16`` conv variables onto the flax paths.

    Emits under both the SSD extractor scope and the Faster R-CNN backbone
    scope so one file serves either model; ``merge_flat_params`` ignores
    the scope the target tree doesn't have. FC layers (fc6-fc8) are not
    used by either detector and are skipped.
    """
    flat = {}
    for stage, reps, _ in _VGG_CONVS:
        for i in range(1, reps + 1):
            name = f"conv{stage}/conv{stage}_{i}"
            kernel = _get(read_tensor, f"vgg_16/{name}/weights")
            bias = _get(read_tensor, f"vgg_16/{name}/biases")
            for scope in scopes:
                flat[f"params/{scope}/vgg_16/{name}/kernel"] = kernel
                flat[f"params/{scope}/vgg_16/{name}/bias"] = bias
    return flat


def convert_slim_checkpoint_file(ckpt_path, out_path, architecture):
    """Convert a slim checkpoint (``.ckpt`` prefix) to a native ``.npz``."""
    read_tensor = checkpoint_reader(ckpt_path)
    if architecture.startswith("resnet"):
        flat = convert_slim_resnet(read_tensor, architecture)
        flat["__meta__/layout"] = np.asarray("slim")
    elif "vgg" in architecture:
        flat = convert_slim_vgg16(read_tensor)
    else:
        raise ValueError(f"unsupported architecture {architecture}")
    np.savez(out_path, **flat)
    logger.info("Wrote %d arrays to %s", len(flat), out_path)
    return len(flat)


def download_slim_backbone(architecture, dest_dir=None):
    """Not available: fetching a slim tarball needs the network. Download
    ``SLIM_CHECKPOINT_URLS[architecture]`` elsewhere, extract it, and
    convert the ``.ckpt`` with :func:`convert_slim_checkpoint_file`."""
    raise NotImplementedError(
        "downloading slim checkpoints needs the network; download "
        f"{SLIM_CHECKPOINT_URLS.get(architecture, architecture)} elsewhere "
        "and run `checkpoint convert-backbone --source slim`")
