"""Weight bridge from the flax variable layout to the port's modules.

The JAX package keeps a model's weights as ``{"params": ..., "batch_stats":
...}`` pytrees of arrays, or flattened as ``"params/<path>"`` keys (the
``.npz`` layout of ``luminoth_tpu/utils/checkpoint_io.py``). The port's
module and parameter names follow those paths, so the bridge is a rename
plus two layout changes:

* conv kernels HWIO → OIHW, dense kernels (in, out) → (out, in);
* batch norm ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var`` (eps 1e-5 lives in the module).

:func:`init_variables` draws random variables in the flax layout with the
JAX model's initializers, for runs that have no JAX (the weights then go
through the same bridge). The torch → flax direction comes with training.
"""

import os
from collections.abc import Mapping

import numpy as np
import torch

from luminoth_tpu_torch.models.base.resnet import BatchNorm

_COLLECTIONS = ("params", "batch_stats")
_FLAX_TO_TORCH_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}
_BN_TO_FLAX = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def flatten_variables(variables):
    """Flat ``{"params/<path>": array}`` from any of the flax layouts.

    ``variables`` is a nested ``{params, batch_stats}`` mapping, an already
    flat mapping, or the path of an ``.npz`` file in the flat layout.
    """
    if isinstance(variables, (str, os.PathLike)):
        with np.load(variables, allow_pickle=False) as data:
            return {key: data[key] for key in data.files}
    flat = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(value, path)
            else:
                flat[path] = np.asarray(value)

    walk(variables, "")
    return flat


def torch_key(flax_path):
    """``params/rpn/conv/kernel`` → ``rpn.conv.weight`` (and so on)."""
    collection, *parts = flax_path.split("/")
    if collection not in _COLLECTIONS or len(parts) < 2:
        raise KeyError(f"not a flax variable path: {flax_path!r}")
    *modules, leaf = parts
    if leaf not in _FLAX_TO_TORCH_LEAF:
        raise KeyError(f"unknown flax leaf {leaf!r} in {flax_path!r}")
    modules = [m for m in modules if m != "BatchNorm"]
    return ".".join(modules + [_FLAX_TO_TORCH_LEAF[leaf]])


def torch_state_from_flax(variables):
    """The port's state dict (float32 tensors) from flax-layout variables."""
    state = {}
    for path, value in flatten_variables(variables).items():
        key = torch_key(path)
        if key in state:
            raise KeyError(f"two flax variables map to {key!r}")
        value = np.array(value, dtype=np.float32)  # a writable copy
        if path.endswith("/kernel"):
            if value.ndim == 4:  # conv HWIO → OIHW
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2:  # dense (in, out) → (out, in)
                value = value.T
            else:
                raise ValueError(f"{path}: kernel of rank {value.ndim}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value))
    return state


def load_flax_variables(model, variables):
    """Load flax-layout variables into ``model``; every key must match.

    Raises on a missing or left-over key and on a shape mismatch.
    """
    state = torch_state_from_flax(variables)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise KeyError(
            f"flax variables do not fit the model: missing {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''} ({len(missing)}), "
            f"left over {extra[:5]}{'...' if len(extra) > 5 else ''} "
            f"({len(extra)})"
        )
    model.load_state_dict(state, strict=True)
    return model


# ------------------------------------------------------------ random init


def _truncated_normal(rng, shape, stddev):
    """Normal samples truncated to ±2 standard deviations, times stddev."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return out * stddev


def _fans(shape):
    """(fan_in, fan_out) of a flax kernel: dense (in, out) or conv HWIO."""
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _variance_scaling(rng, shape, scale, mode, distribution):
    fan_in, fan_out = _fans(shape)
    denominator = {
        "fan_in": fan_in, "fan_out": fan_out,
        "fan_avg": (fan_in + fan_out) / 2.0,
    }[mode]
    variance = scale / denominator
    if distribution == "uniform":
        limit = np.sqrt(3.0 * variance)
        return rng.uniform(-limit, limit, shape)
    # jax's truncated_normal variance scaling corrects for the truncation.
    return _truncated_normal(rng, shape, np.sqrt(variance) / 0.87962566103423978)


def _draw(rng, shape, config):
    """A kernel drawn like ``luminoth_tpu.utils.vars.get_initializer``."""
    if config is None:  # flax's default: lecun_normal
        return _variance_scaling(rng, shape, 1.0, "fan_in", "truncated")
    itype = config.get("type", "variance_scaling_initializer")
    if itype == "truncated_normal_initializer":
        return _truncated_normal(rng, shape, config.get("stddev", 1.0))
    if itype == "random_normal_initializer":
        return rng.standard_normal(shape) * config.get("stddev", 1.0)
    if itype == "variance_scaling_initializer":
        mode = {"FAN_IN": "fan_in", "FAN_OUT": "fan_out"}.get(
            config.get("mode", "FAN_AVG"), "fan_avg"
        )
        distribution = (
            "uniform" if config.get("uniform", True) else "truncated"
        )
        return _variance_scaling(
            rng, shape, config.get("factor", 1.0), mode, distribution
        )
    if itype == "xavier_initializer":
        return _variance_scaling(rng, shape, 1.0, "fan_avg", "uniform")
    raise ValueError("Initializer {} not supported".format(itype))


def _kernel_initializers(model_config):
    """Initializer config per head module path (the rest: lecun_normal)."""
    rpn, rcnn = model_config.rpn, model_config.rcnn
    inits = {
        "rpn/conv": rpn.get("rpn_initializer"),
        "rpn/cls_conv": rpn.get("cls_initializer"),
        "rpn/bbox_conv": rpn.get("bbox_initializer"),
        "rcnn/fc_classifier": rcnn.get("cls_initializer"),
        "rcnn/fc_bbox": rcnn.get("bbox_initializer"),
    }
    for i, _ in enumerate(rcnn.get("layer_sizes") or []):
        inits[f"rcnn/fc_{i}"] = rcnn.get("rcnn_initializer")
    return inits


def init_variables(config, seed=0):
    """Random flax-layout variables for the port's Faster R-CNN.

    Convs draw flax's default lecun-normal, the RPN and RCNN heads the
    config's initializers, biases start at 0 and batch norm as the
    identity. Returns ``{"params": {...}, "batch_stats": {...}}`` of
    float32 numpy arrays (nested by path), for :func:`load_flax_variables`.
    """
    from luminoth_tpu_torch.models import get_model

    with torch.device("meta"):
        model = get_model(config.model.type)(config)
    inits = _kernel_initializers(config.model)
    rng = np.random.default_rng(seed)
    variables = {collection: {} for collection in _COLLECTIONS}

    def put(collection, path, value):
        node = variables[collection]
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value.astype(np.float32)

    for name, module in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, BatchNorm):
            for attr, (collection, leaf) in _BN_TO_FLAX.items():
                tensor = getattr(module, attr)
                fill = 1.0 if attr in ("weight", "running_var") else 0.0
                put(collection, f"{path}/BatchNorm/{leaf}",
                    np.full(tuple(tensor.shape), fill))
        elif isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
            shape = tuple(module.weight.shape)
            if module.weight.dim() == 4:  # OIHW → HWIO
                shape = (shape[2], shape[3], shape[1], shape[0])
            else:  # (out, in) → (in, out)
                shape = shape[::-1]
            put("params", f"{path}/kernel",
                _draw(rng, shape, inits.get(path)))
            if module.bias is not None:
                put("params", f"{path}/bias",
                    np.zeros(tuple(module.bias.shape)))
    return variables
