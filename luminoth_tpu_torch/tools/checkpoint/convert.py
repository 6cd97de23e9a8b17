"""Pretrained-backbone weight conversion: torchvision ``.pth`` → ``.npz``.

A copy of the JAX package's ``tools/checkpoint/convert.py``: the ``.npz``
holds flat arrays keyed ``params/<path>`` and ``batch_stats/<path>`` of the
flax variable tree, which both packages load through
``model.base_network.weights``. A ResNet file is stamped
``__meta__/layout = "torchvision"`` (the stride on the first unit of each
stage), which the trainer accepts only with
``model.base_network.torchvision_compat: True``:

    python -m luminoth_tpu_torch checkpoint convert-backbone \\
        resnet101.pth weights.npz --architecture resnet_v1_101

Downloading the torchvision weights needs the network, which the port's
machines do not have: :func:`download_backbone` raises.
"""

import logging

import numpy as np

from luminoth_tpu_torch.models.base.resnet import RESNET_BLOCK_DEFS

logger = logging.getLogger(__name__)


def _conv_kernel(tensor):
    """torch OIHW → flax HWIO."""
    return np.transpose(np.asarray(tensor, dtype=np.float32), (2, 3, 1, 0))


def _bn(flat, prefix, state, torch_prefix):
    flat[f"params/{prefix}/BatchNorm/scale"] = np.asarray(
        state[f"{torch_prefix}.weight"], np.float32
    )
    flat[f"params/{prefix}/BatchNorm/bias"] = np.asarray(
        state[f"{torch_prefix}.bias"], np.float32
    )
    flat[f"batch_stats/{prefix}/BatchNorm/mean"] = np.asarray(
        state[f"{torch_prefix}.running_mean"], np.float32
    )
    flat[f"batch_stats/{prefix}/BatchNorm/var"] = np.asarray(
        state[f"{torch_prefix}.running_var"], np.float32
    )


def convert_torchvision_resnet(state_dict, architecture="resnet_v1_101",
                               scope="base_network"):
    """Map a torchvision ResNet state dict onto the flax variable paths.

    Also emits the detached ``block4`` tail under ``base_network_tail`` so
    both the trunk and the RCNN head trunk are initialized.
    """
    depth = int(architecture.rsplit("_", 1)[1])
    block_defs = RESNET_BLOCK_DEFS[depth]
    flat = {}
    root = f"{scope}/{architecture}"

    flat[f"params/{root}/conv1/kernel"] = _conv_kernel(
        state_dict["conv1.weight"]
    )
    _bn(flat, f"{root}/conv1_bn", state_dict, "bn1")

    for layer_idx, (_, num_units, _) in enumerate(block_defs, start=1):
        for unit in range(num_units):
            tprefix = f"layer{layer_idx}.{unit}"
            scopes = [f"{root}/block{layer_idx}/unit_{unit + 1}"]
            if layer_idx == 4:
                # The tail module re-hosts block4 under its own scope.
                scopes.append(
                    f"base_network_tail/{architecture}/block4/unit_{unit + 1}"
                )
            for fprefix in scopes:
                for k in (1, 2, 3):
                    flat[f"params/{fprefix}/conv{k}/kernel"] = _conv_kernel(
                        state_dict[f"{tprefix}.conv{k}.weight"]
                    )
                    _bn(
                        flat, f"{fprefix}/conv{k}_bn", state_dict,
                        f"{tprefix}.bn{k}",
                    )
                if f"{tprefix}.downsample.0.weight" in state_dict:
                    flat[f"params/{fprefix}/shortcut/kernel"] = _conv_kernel(
                        state_dict[f"{tprefix}.downsample.0.weight"]
                    )
                    _bn(
                        flat, f"{fprefix}/shortcut_bn", state_dict,
                        f"{tprefix}.downsample.1",
                    )
    return flat


_VGG_FEATURE_LAYOUT = [
    ("conv1/conv1_1", 0), ("conv1/conv1_2", 2),
    ("conv2/conv2_1", 5), ("conv2/conv2_2", 7),
    ("conv3/conv3_1", 10), ("conv3/conv3_2", 12), ("conv3/conv3_3", 14),
    ("conv4/conv4_1", 17), ("conv4/conv4_2", 19), ("conv4/conv4_3", 21),
    ("conv5/conv5_1", 24), ("conv5/conv5_2", 26), ("conv5/conv5_3", 28),
]


def convert_torchvision_vgg16(state_dict,
                              scopes=("feature_extractor", "base_network")):
    """Map torchvision VGG-16 features onto the flax VGG trunk paths.

    Emits under both the SSD extractor scope and the Faster R-CNN backbone
    scope so one file serves either model; unknown scopes are skipped at
    merge time.
    """
    flat = {}
    for name, idx in _VGG_FEATURE_LAYOUT:
        kernel = _conv_kernel(state_dict[f"features.{idx}.weight"])
        bias = np.asarray(state_dict[f"features.{idx}.bias"], np.float32)
        for scope in scopes:
            flat[f"params/{scope}/vgg_16/{name}/kernel"] = kernel
            flat[f"params/{scope}/vgg_16/{name}/bias"] = bias
    return flat


def download_backbone(architecture, dest_dir=None):
    """Not available in the port: the torchvision weights are fetched over
    the network. Download the ``.pth`` elsewhere and convert it with
    :func:`convert_backbone_file`."""
    raise NotImplementedError(
        f"downloading the {architecture} backbone needs the network, which "
        "the port does not use: fetch the torchvision .pth elsewhere and run "
        "`checkpoint convert-backbone` on it"
    )


def convert_backbone_file(pth_path, out_path, architecture):
    """Convert a torchvision checkpoint file to a native flat ``.npz``."""
    import torch

    state_dict = torch.load(pth_path, map_location="cpu", weights_only=True)
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    state_dict = {
        k: v.numpy() if hasattr(v, "numpy") else v
        for k, v in state_dict.items()
    }

    if architecture.startswith("resnet"):
        flat = convert_torchvision_resnet(state_dict, architecture)
        # Stamp the stride layout so the loader can refuse a config that
        # would run slim-style strides over torchvision-trained weights.
        flat["__meta__/layout"] = np.asarray("torchvision")
    elif "vgg" in architecture:
        flat = convert_torchvision_vgg16(state_dict)
    else:
        raise ValueError(f"unsupported architecture {architecture}")

    np.savez(out_path, **flat)
    logger.info("Wrote %d arrays to %s", len(flat), out_path)
    return len(flat)
