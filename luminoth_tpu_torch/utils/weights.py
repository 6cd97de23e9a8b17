"""Weight bridge from the flax variable layout to the port's modules.

The JAX package keeps a model's weights as ``{"params": ..., "batch_stats":
...}`` pytrees of arrays, or flattened as ``"params/<path>"`` keys (the
``.npz`` layout of ``luminoth_tpu/utils/checkpoint_io.py``). The port's
module and parameter names follow those paths, so the bridge is a rename
plus two layout changes:

* conv kernels HWIO → OIHW, dense kernels (in, out) → (out, in);
* batch norm ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var`` (eps 1e-5 lives in the module);
  SSD's L2-normalisation ``gamma`` keeps its name and (1, 1, 1, C) shape.

A flax module name may hold a ``/`` (VGG's ``conv1/conv1_1``): the port
nests it (``conv1.conv1_1``), so the flat paths of both sides agree.

The JAX package's ``int8_stats`` collection (the calibrated ``max|x|`` of
each int8 quant point, ``int8_stats/<path>/<point>_amax`` scalars) maps to
the non-persistent buffers of the port's int8 twins
(``models/base/quantized_tail.py``), which the state dict does not hold:
:func:`load_flax_variables` puts them in, and
:func:`flax_variables_from_torch` gives them back once calibrated.

:func:`init_variables` draws random variables in the flax layout with the
JAX model's initializers, for runs that have no JAX (the weights then go
through the same bridge). :func:`flax_variables_from_torch` is the way
back: a model trained by the port leaves it in the flat flax layout, which
``flatten_variables`` and the JAX package's ``load_params_npz`` both read.
"""

import os
import re
from collections.abc import Mapping

import numpy as np
import torch

from luminoth_tpu_torch.models.base.quantized_tail import (
    Int8Points,
    int8_modules,
    load_int8_stats,
)
from luminoth_tpu_torch.models.base.resnet import BatchNorm

_COLLECTIONS = ("params", "batch_stats", "int8_stats")
_INT8_STATS = "int8_stats/"
_FLAX_TO_TORCH_LEAF = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
    "gamma": "gamma",
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


# Flax module names holding a "/": ResNet units and VGG convs.
_SLASHED_NAME = re.compile(r"(block\d+/unit_\d+|conv\d+/conv\d+_\d+)(/|$)")


def nest_variables(flat):
    """Nested flax variables (``{"params": {...}, ...}``) from the flat
    ``"<collection>/<path>"`` layout: the inverse of
    :func:`flatten_variables`. A flax module whose name holds a ``/``
    (``block1/unit_1``, ``conv1/conv1_1``) stays one level, as in the
    JAX package's trees."""
    tree = {}
    for path, value in flat.items():
        parts, rest = [], path
        while rest:
            match = _SLASHED_NAME.match(rest)
            if match:
                parts.append(match.group(1))
                rest = rest[match.end():]
            else:
                part, _, rest = rest.partition("/")
                parts.append(part)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def torch_key(flax_path):
    """``params/rpn/conv/kernel`` → ``rpn.conv.weight`` (and so on)."""
    collection, *parts = flax_path.split("/")
    if collection not in _COLLECTIONS or len(parts) < 2:
        raise KeyError(f"not a flax variable path: {flax_path!r}")
    if collection == "int8_stats":  # a quant point keeps its name
        return ".".join(parts)
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

    Raises on a missing or left-over key and on a shape mismatch. An
    ``int8_stats`` collection must name every static quant point of the
    model; a model without static quant points ignores it, as flax does.
    """
    flat = flatten_variables(variables)
    stats = {path: flat.pop(path) for path in list(flat)
             if path.startswith(_INT8_STATS)}
    state = torch_state_from_flax(flat)
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
    if stats and any(m.static_scales for m in int8_modules(model)):
        load_int8_stats(model, {torch_key(path): np.float32(value)
                                for path, value in stats.items()})
    return model


def flax_paths(model):
    """``{state-dict key: flax path}`` for every variable of ``model``.

    Batch norm modules map ``weight``/``bias``/``running_mean``/
    ``running_var`` to ``params/<path>/BatchNorm/{scale,bias}`` and
    ``batch_stats/<path>/BatchNorm/{mean,var}``; convs and dense layers
    map ``weight``/``bias`` to ``params/<path>/{kernel,bias}``; a
    module's own parameter named ``gamma`` (SSD's L2 normalisation) maps to
    ``params/<path>/gamma``. The quant points of a static int8 twin map
    ``<point>`` to ``int8_stats/<path>/<point>`` (buffers outside the
    state dict).
    """
    paths = {}
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        path = name.replace(".", "/")
        if isinstance(module, Int8Points) and module.static_scales:
            for point in module.quant_points:
                paths[prefix + point] = "/".join(
                    part for part in ("int8_stats", path, point) if part)
        if isinstance(module, BatchNorm):
            for attr, (collection, leaf) in _BN_TO_FLAX.items():
                paths[prefix + attr] = f"{collection}/{path}/BatchNorm/{leaf}"
        elif isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
            paths[prefix + "weight"] = f"params/{path}/kernel"
            if module.bias is not None:
                paths[prefix + "bias"] = f"params/{path}/bias"
        elif "gamma" in dict(module.named_parameters(recurse=False)):
            paths[prefix + "gamma"] = f"params/{path}/gamma"
    return paths


def flax_variables_from_torch(model):
    """Flat ``{"params/<path>" or "batch_stats/<path>": float32 array}``
    variables of ``model``.

    The inverse of :func:`torch_state_from_flax`: conv kernels OIHW → HWIO,
    dense kernels (out, in) → (in, out). ``np.savez(path, **result)``
    writes the ``.npz`` layout both packages load. Calibrated quant points
    come as ``int8_stats/...`` scalars.
    """
    state = model.state_dict()
    paths = flax_paths(model)
    missing = sorted(set(state) - set(paths))
    if missing:
        raise KeyError(f"no flax path for {missing[:5]} ({len(missing)})")
    for prefix, module in model.named_modules():
        if isinstance(module, Int8Points) and module.calibrated:
            state.update((f"{prefix}.{point}" if prefix else point,
                          getattr(module, point))
                         for point in module.quant_points)
    flat = {}
    for key, path in paths.items():
        if key not in state:  # a quant point not calibrated yet
            continue
        value = state[key].detach().float().cpu().numpy()
        if path.endswith("/kernel"):
            value = (value.transpose(2, 3, 1, 0) if value.ndim == 4
                     else value.T)
        # (np.ascontiguousarray makes a quant point's scalar 1-d.)
        flat[path] = np.array(value, order="C")
    return flat


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
    """Initializer config per head module path (the rest: lecun_normal).
    A model without ``rpn`` and ``rcnn`` sections (SSD) has none."""
    rpn, rcnn = model_config.get("rpn"), model_config.get("rcnn")
    if rpn is None or rcnn is None:
        return {}
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
    """Random flax-layout variables for the port's Faster R-CNN or SSD.

    Convs draw flax's default lecun-normal, the RPN and RCNN heads the
    config's initializers, biases start at 0, batch norm as the identity
    and SSD's L2-normalisation scale at 20. Returns ``{"params": {...},
    "batch_stats": {...}}`` of float32 numpy arrays (nested by path), for
    :func:`load_flax_variables`.
    """
    from luminoth_tpu_torch.models import get_model

    with torch.device("meta"):
        model = get_model(config.model.type)(config)
    inits = _kernel_initializers(config.model)
    rng = np.random.default_rng(seed)
    variables = {"params": {}, "batch_stats": {}}

    def put(collection, path, value):
        node = variables[collection]
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value.astype(np.float32)

    state = model.state_dict()
    for key, path in flax_paths(model).items():
        if path.startswith(_INT8_STATS):  # calibrated at load, not drawn
            continue
        collection, rest = path.split("/", 1)
        module_path, leaf = rest.rsplit("/", 1)
        shape = tuple(state[key].shape)
        if leaf == "kernel":
            # OIHW → HWIO, (out, in) → (in, out)
            shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape[::-1]
            value = _draw(rng, shape, inits.get(module_path))
        else:  # batch norm as the identity, zero biases, gamma 20
            value = np.full(shape, {"scale": 1.0, "var": 1.0,
                                    "gamma": 20.0}.get(leaf, 0.0))
        put(collection, rest, value)
    return variables
