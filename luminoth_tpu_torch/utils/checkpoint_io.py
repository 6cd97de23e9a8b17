"""Train-state checkpoints of the port (counterpart of the JAX package's
``utils/checkpoint_io.py::CheckpointManager``).

Same directory layout: ``<job_dir>/<run_name>/ckpt/ckpt_step_<N>.pt``,
``max_to_keep`` rotation, and resume from the newest readable file. A checkpoint is a
``torch.save`` dict of the step, the model's state dict and the optimizer
state (tensors, ints and strings only), loaded with ``weights_only=True``.

For evaluation and serving, :meth:`CheckpointManager.latest_state_dict`
also reads the JAX package's ``ckpt_step_<N>.msgpack`` train states
(through the port's own msgpack reader, ``formats/msgpack.py``), and
:func:`load_model_weights` puts the weights of either format into a model.
The port writes only ``.pt`` files.

To resume training, :meth:`CheckpointManager.restore_latest` takes the
fresh run's state as a ``template`` and reads the newest checkpoint of
either format into it (:func:`merge_train_state`): with ``ignore_scope``
it skips every tensor whose flax path holds that string, as the JAX
package's ``restore_latest(ignore_scope=)`` does.
"""

import logging
import os
import re

import numpy as np
import torch

from luminoth_tpu_torch.formats import msgpack
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    load_flax_variables,
    torch_state_from_flax,
)

CHECKPOINT_PREFIX = "ckpt_step_"
_FILE = re.compile(rf"{CHECKPOINT_PREFIX}(\d+)\.(pt|msgpack)$")

logger = logging.getLogger(__name__)


class CheckpointManager:
    """Step-numbered ``torch.save`` checkpoints with rotation."""

    def __init__(self, directory, max_to_keep=1):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step, suffix="pt"):
        return os.path.join(self.directory,
                            f"{CHECKPOINT_PREFIX}{step}.{suffix}")

    def _files(self):
        """``(step, suffix)`` of every checkpoint file, oldest first; on
        equal steps the ``.pt`` file comes last (it is preferred)."""
        found = (m.groups() for m in map(_FILE.match,
                                         os.listdir(self.directory)) if m)
        return sorted((int(step), suffix) for step, suffix in found)

    def all_steps(self):
        return sorted(step for step, suffix in self._files() if suffix == "pt")

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step):
        """Write ``state`` (a dict of tensors and numbers) as ``step``."""
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            os.remove(self._path(steps.pop(0)))

    def restore(self, step, map_location=None):
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)

    def restore_latest(self, map_location=None, template=None, paths=None,
                       ignore_scope=None):
        """The newest readable checkpoint, or None when there is none.

        Without ``template``: the newest ``.pt`` state as saved. With
        ``template`` (the fresh run's ``{"step", "model", "optimizer"}``)
        and ``paths`` (``utils/weights.flax_paths(model)``): the newest
        checkpoint of either format merged into it by
        :func:`merge_train_state` (``ignore_scope`` skips a scope).

        An unreadable newest file falls back to the next older one; raises
        only when every checkpoint is unreadable.
        """
        if template is None:
            if ignore_scope:
                raise ValueError("ignore_scope needs a template")
            files = [(step, "pt") for step in self.all_steps()]
        else:
            files = self._files()
        last_err = None
        for step, suffix in reversed(files):
            try:
                if suffix == "pt":
                    state = self.restore(step, map_location=map_location)
                else:
                    state = msgpack.load(self._path(step, suffix))
            except Exception as e:  # truncated or corrupt: try older
                last_err = e
                logger.warning("Checkpoint %s unreadable (%s); falling back "
                               "to an older one", self._path(step, suffix), e)
                continue
            if template is None:
                return state
            return merge_train_state(template, state, paths, ignore_scope)
        if last_err is not None:
            raise last_err
        return None

    def read(self, step, suffix):
        """The state of one checkpoint file of either format."""
        if suffix == "pt":
            return self.restore(step, map_location="cpu")
        return msgpack.load(self._path(step, suffix))

    def evaluable_steps(self):
        """``[(step, suffix)]``, oldest first, one file per step: the
        ``.pt`` where a step has both formats."""
        return list(dict(self._files()).items())

    def latest_state_dict(self):
        """``(state, step)`` of the newest readable checkpoint of either
        format (the port's ``.pt``, the JAX package's ``.msgpack``); on
        equal steps the ``.pt``. An unreadable file falls back to the next
        older one, as in the JAX package; ``(None, None)`` when nothing is
        readable."""
        for step, suffix in reversed(self._files()):
            try:
                return self.read(step, suffix), step
            except Exception as e:  # truncated or corrupt: try older
                logger.warning(
                    "Checkpoint %s unreadable (%s); falling back to an "
                    "older one", self._path(step, suffix), e)
        return None, None


def _as_float32(node):
    """Nested flax variables with numpy float32 leaves (a msgpack leaf may
    be a ``torch.bfloat16`` tensor)."""
    if isinstance(node, dict):
        return {key: _as_float32(value) for key, value in node.items()}
    if torch.is_tensor(node):
        return node.float().numpy()
    return np.asarray(node, np.float32)


_SLOTS = ("trace", "mu", "nu")
_PARAMS = "params/"


def _train_state_leaves(state, paths):
    """``(leaves, values)`` of a train state of either format, keyed
    ``("model", key)``, ``("slot", name, slot)``, ``("count",)`` and
    ``("step",)``: ``leaves`` maps each to the path that the JAX package's
    ``_merge_state`` tests (``/params/rcnn/...``, ``/opt_state/.../trace/
    rcnn/...``, ``/step``), ``values`` to the tensor or number in the
    ``.pt`` layout.

    A ``.pt`` state's optimizer paths are ``/opt_state/<slot>/<path>``
    and ``/opt_state/count``; a JAX state's are its own, and its ``count``
    is adam's (beside ``mu``/``nu``), else the step.
    """
    names = {path: key for key, path in paths.items()}
    leaves, values = {}, {}

    def put(key, path, value):
        leaves[key], values[key] = path, value

    put(("step",), "/step", int(np.asarray(state["step"])))
    if "model" in state:  # the port's .pt
        for key, value in state["model"].items():
            put(("model", key), "/" + paths.get(key, key), value)
        opt = state["optimizer"]
        put(("count",), "/opt_state/count", int(opt["count"]))
        for name, slots in opt["slots"].items():
            path = paths.get(name, name)
            if path.startswith(_PARAMS):
                path = path[len(_PARAMS):]
            for slot, value in slots.items():
                put(("slot", name, slot), f"/opt_state/{slot}/{path}", value)
        return leaves, values
    # a JAX train state (.msgpack): params, batch_stats, opt_state, step
    collections = {c: state[c] for c in ("params", "batch_stats")
                   if state.get(c)}
    flat = flatten_variables(_as_float32(collections))
    converted = torch_state_from_flax(
        {path: value for path, value in flat.items() if path in names})
    for path in flat:
        if path in names:
            put(("model", names[path]), "/" + path,
                converted[names[path]])

    def walk(node, path):
        if not isinstance(node, dict):
            return
        if "count" in node and any(s in node for s in _SLOTS):
            put(("count",), f"{path}/count", int(np.asarray(node["count"])))
        for key, value in node.items():
            if key in _SLOTS and isinstance(value, dict):
                slot = flatten_variables(_as_float32(value))
                converted = torch_state_from_flax(
                    {_PARAMS + p: v for p, v in slot.items()
                     if _PARAMS + p in names})
                for name, tensor in converted.items():
                    put(("slot", name, key),
                        f"{path}/{key}/{paths[name][len(_PARAMS):]}", tensor)
            else:
                walk(value, f"{path}/{key}")

    walk(state.get("opt_state") or {}, "/opt_state")
    if ("count",) not in leaves:  # no adam state: the port counts steps
        put(("count",), "/step", values[("step",)])
    return leaves, values


def merge_train_state(template, state, paths, ignore_scope=None):
    """A checkpoint's train state merged into ``template``, as the JAX
    package's ``_merge_state``: a tensor keeps the template's value when
    its path holds ``ignore_scope`` (a substring test on the flax path,
    ``/params/rcnn/...``, and on the optimizer state's own path, so an
    ignored tensor's optimizer slots are reset too), when the checkpoint
    lacks it, or when the shapes differ.

    ``template`` and the result are in the ``.pt`` layout (``{"step",
    "model", "optimizer": {"count", "slots"}}``); ``state`` is a ``.pt``
    state or a JAX ``.msgpack`` one (its ``params``, ``batch_stats`` and
    optax ``opt_state`` go through the weight bridge). ``paths`` is
    ``utils/weights.flax_paths(model)``.
    """
    leaves, values = _train_state_leaves(state, paths)

    def pick(key, current):
        if key not in values:
            return current
        if ignore_scope and ignore_scope in leaves[key]:
            return current
        value = values[key]
        if np.shape(value) != np.shape(current):
            return current
        if torch.is_tensor(current):
            return torch.as_tensor(value).to(current.device, current.dtype)
        return value

    opt = template["optimizer"]
    return {
        "step": pick(("step",), template["step"]),
        "model": {key: pick(("model", key), value)
                  for key, value in template["model"].items()},
        "optimizer": {
            "count": pick(("count",), opt["count"]),
            "slots": {name: {slot: pick(("slot", name, slot), value)
                             for slot, value in slots.items()}
                      for name, slots in opt["slots"].items()},
        },
    }


def load_model_weights(model, state):
    """Load the weights of a checkpoint ``state`` into ``model``.

    A port checkpoint (``.pt``) holds the model's state dict under
    ``"model"``; a JAX train state (``.msgpack``) holds flax
    ``params`` and ``batch_stats``, which go through the weight bridge
    (``utils/weights.py``). Its optimizer state is not read.
    """
    if "model" in state:
        model.load_state_dict(state["model"], strict=True)
        return model
    variables = {"params": state["params"]}
    if state.get("batch_stats"):
        variables["batch_stats"] = state["batch_stats"]
    return load_flax_variables(model, _as_float32(variables))
