"""Learning-rate schedules, optimizers and trainable/decay masks.

Counterpart of the JAX package's ``utils/training.py``, which builds them
on optax. The port writes the same update rules by hand, with optax's
semantics (PyTorch's built-in optimizers differ in places):

* the chain is clip → add ``c·p`` per parameter → optimizer, and frozen
  parameters get no update and no decay;
* ``clip_by_norm`` scales by ``max_norm / norm`` when the global norm is
  not below 10, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds
  1e-6);
* rmsprop divides by ``sqrt(nu + eps)``, eps inside the square root
  (``torch.optim.RMSprop`` puts it outside), momentum is applied after the
  learning rate;
* the learning rate is the schedule at the number of updates already made,
  read every step.

Masks and coefficients are keyed by the model's parameter names and are
computed on the flax paths of those parameters (``utils.weights.
flax_paths``), so they are the JAX package's masks exactly.
"""

import re

import numpy as np
import torch

from luminoth_tpu_torch.utils.weights import flax_paths

# Optimizer names and the state slots each keeps per parameter.
OPTIMIZER_SLOTS = {
    "momentum": ("trace",),
    "gradient_descent": (),
    "sgd": (),
    "adam": ("mu", "nu"),
    "rmsprop": ("nu", "trace"),
}
CLIP_NORM = 10.0


def get_learning_rate(train_config):
    """The schedule of ``train.learning_rate``: ``step -> learning rate``.

    ``decay_method``: none/(empty), ``piecewise_constant``,
    ``exponential_decay`` (with ``staircase``) or ``polynomial_decay``, with
    optax's step semantics, computed in float32 as optax does.
    """
    lr_config = dict(train_config.get("learning_rate") or {})
    method = lr_config.pop("decay_method", None)
    f32 = np.float32

    def initial(default_key="initial_learning_rate"):
        # float() everywhere a rate enters: YAML 1.1 parses `1e-4` as a
        # string.
        return f32(float(lr_config.get(
            "learning_rate", lr_config.get(default_key, 0.0003))))

    if not method or method == "none":
        value = float(f32(float(
            lr_config.get("learning_rate", lr_config.get("value", 0.0003))
        )))
        return lambda step: value

    if method == "piecewise_constant":
        boundaries = [int(b) for b in lr_config["boundaries"]]
        values = [float(f32(float(v))) for v in lr_config["values"]]

        def piecewise(step):
            return values[sum(step >= b for b in boundaries)]

        return piecewise

    if method == "exponential_decay":
        init = initial()
        steps = int(lr_config.get("decay_steps", 100000))
        rate = f32(float(lr_config.get("decay_rate", 0.96)))
        staircase = bool(lr_config.get("staircase", False))
        if steps <= 0 or rate == 0:
            return lambda step: float(init)

        def exponential(step):
            if step <= 0:
                return float(init)
            p = f32(step) / f32(steps)
            if staircase:
                p = np.floor(p)
            return float(init * np.power(rate, p, dtype=f32))

        return exponential

    if method == "polynomial_decay":
        init = float(initial())
        end = float(lr_config.get("end_learning_rate", 0.0001))
        power = f32(float(lr_config.get("power", 1.0)))
        steps = int(lr_config.get("decay_steps", 100000))
        if steps <= 0:
            return lambda step: init
        span = f32(init - end)  # a Python-float difference, as in optax

        def polynomial(step):
            frac = f32(1) - f32(min(max(step, 0), steps)) / f32(steps)
            return float(span * np.power(frac, power, dtype=f32) + f32(end))

        return polynomial

    raise ValueError('Invalid learning_rate method "{}"'.format(method))


class Optimizer:
    """optax's chain on a dict of parameters, updated in place.

    Holds the trainable parameters only. :meth:`step` takes their
    gradients and the number of updates made so far.
    """

    def __init__(self, params, opt_type, schedule, opt_config=None,
                 clip_norm=None, decay=None):
        if opt_type not in OPTIMIZER_SLOTS:
            raise ValueError('Invalid optimizer type "{}"'.format(opt_type))
        opt_config = dict(opt_config or {})
        self.params = dict(params)
        self.opt_type = opt_type
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.decay = {k: float(v) for k, v in (decay or {}).items() if v}
        # float() every rate-like value: YAML 1.1 parses `1e-8` as a string.
        self.momentum = float(opt_config.get(
            "momentum", 0.9 if opt_type == "momentum" else 0.0))
        self.beta1 = float(opt_config.get("beta1", 0.9))
        self.beta2 = float(opt_config.get("beta2", 0.999))
        self.rms_decay = float(opt_config.get("decay", 0.9))
        self.eps = float(opt_config.get(
            "epsilon", 1e-10 if opt_type == "rmsprop" else 1e-8))
        self.count = 0  # adam's bias-correction count
        self.slots = {
            name: {slot: torch.zeros_like(p)
                   for slot in OPTIMIZER_SLOTS[opt_type]}
            for name, p in self.params.items()
        }

    @torch.no_grad()
    def step(self, grads, step):
        """Apply one update from ``{name: gradient}`` at schedule ``step``.

        Returns the global gradient norm before the clip (a device scalar).
        """
        grads = {name: grads[name].float() for name in self.params}
        norm = global_norm(grads.values())
        if self.clip_norm is not None:
            # torch.where, not a branch: no device-to-host sync.
            below = norm < self.clip_norm
            grads = {name: torch.where(below, g, g / norm * self.clip_norm)
                     for name, g in grads.items()}
        neg_lr = -self.schedule(step)
        self.count += 1
        for name, p in self.params.items():
            g = grads[name]
            if name in self.decay:
                g = g + self.decay[name] * p
            slots = self.slots[name]
            if self.opt_type == "momentum":
                slots["trace"].copy_(g + self.momentum * slots["trace"])
                update = neg_lr * slots["trace"]
            elif self.opt_type == "adam":
                slots["mu"].copy_((1 - self.beta1) * g
                                  + self.beta1 * slots["mu"])
                slots["nu"].copy_((1 - self.beta2) * torch.square(g)
                                  + self.beta2 * slots["nu"])
                mu_hat = slots["mu"] / (1 - self.beta1 ** self.count)
                nu_hat = slots["nu"] / (1 - self.beta2 ** self.count)
                update = neg_lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
            elif self.opt_type == "rmsprop":
                slots["nu"].copy_((1 - self.rms_decay) * torch.square(g)
                                  + self.rms_decay * slots["nu"])
                update = neg_lr * (g * torch.rsqrt(slots["nu"] + self.eps))
                slots["trace"].copy_(update + self.momentum * slots["trace"])
                update = slots["trace"]
            else:  # gradient_descent / sgd
                update = neg_lr * g
            p.add_(update)
        return norm

    def state_dict(self):
        return {"count": self.count, "slots": self.slots}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        for name, slots in state["slots"].items():
            for slot, value in slots.items():
                self.slots[name][slot].copy_(value)


def global_norm(tensors):
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def get_optimizer(train_config, params, trainable_mask=None,
                  weight_decay=None):
    """The optimizer of ``train.optimizer`` over ``params``.

    Args:
        train_config: the ``train`` section of the config.
        params: ``{name: parameter}`` (``dict(model.named_parameters())``).
        trainable_mask: optional ``{name: bool}``; False freezes.
        weight_decay: optional ``{name: coefficient}`` (decayed only where
            trainable).

    Returns:
        ``(Optimizer, schedule)``.
    """
    opt_config = dict(train_config.get("optimizer") or {})
    opt_type = opt_config.pop("type", "momentum")
    schedule = get_learning_rate(train_config)
    trainable = {
        name: p for name, p in params.items()
        if trainable_mask is None or trainable_mask[name]
    }
    decay = {name: (weight_decay or {}).get(name, 0.0) for name in trainable}
    optimizer = Optimizer(
        trainable, opt_type, schedule, opt_config,
        clip_norm=CLIP_NORM if train_config.get("clip_by_norm") else None,
        decay=decay,
    )
    return optimizer, schedule


# Depth order of backbone stage scopes (the reference's creation order).
_FINETUNE_STAGE_ORDER = [
    "conv1", "conv2", "conv3", "conv4", "conv5",
    "fc6", "conv6", "fc7", "conv7", "fc8",
    "conv8", "conv9", "conv10", "conv11",
    "block1", "block2", "block3", "block4",
]
_ARCH_RE = re.compile(
    r"vgg_16|truncated_vgg_16|resnet_v[12]_\d+"
    r"|truncated_base_network|fasterrcnn|ssd"
)


def _natural(s):
    """Natural-sort key: digit runs compare numerically (unit_10 > unit_9)."""
    return tuple(
        ("d", int(t)) if t.isdigit() else ("s", t)
        for t in re.split(r"(\d+)", s) if t
    )


def _depth_key(path):
    """(stage index, natural order from the stage scope on), or None."""
    segments = path.split("/")
    for i, seg in enumerate(segments):
        stage = seg if seg in _FINETUNE_STAGE_ORDER else seg.split("_")[0]
        if stage in _FINETUNE_STAGE_ORDER:
            return (_FINETUNE_STAGE_ORDER.index(stage),
                    _natural("/".join(segments[i:])))
    return None


def _param_paths(model):
    """``{parameter name: flax param path without the "params/" prefix}``."""
    paths = flax_paths(model)
    return {
        name: paths[name][len("params/"):]
        for name, _ in model.named_parameters()
    }


def build_trainable_mask(model, model_config):
    """``{parameter name: trainable}`` from the reference's flags.

    ``base_network.trainable: False`` freezes the backbone;
    ``fine_tune_from: <scope>`` orders the backbone parameters by depth and
    trains from the first whose path contains the scope (a scope matching
    nothing raises ``ValueError``); ``freeze_tail: True`` freezes the block4
    tail. The JAX package's ``build_trainable_mask`` rule for rule.
    """
    cfg = model_config.get("base_network", {})
    trainable = cfg.get("trainable", True)
    fine_tune_from = cfg.get("fine_tune_from")
    freeze_tail = cfg.get("freeze_tail", False)
    paths = _param_paths(model)

    def is_backbone(path):
        root = path.split("/")[0]
        return (("base_network" in root or "feature_extractor" in root)
                and "tail" not in root)

    trainable_paths = None
    if fine_tune_from:
        stripped = "/".join(
            c for c in str(fine_tune_from).split("/")
            if c and not _ARCH_RE.fullmatch(c)
        )
        queries = [q for q in {str(fine_tune_from), stripped} if q]
        ordered = sorted(
            (_depth_key(path), path) for path in paths.values()
            if is_backbone(path) and _depth_key(path) is not None
        )
        ordered = [path for _, path in ordered]
        boundary = next(
            (i for i, path in enumerate(ordered)
             if any(q in path for q in queries)),
            None,
        )
        if boundary is None:
            raise ValueError(
                '"{}" is an invalid value of fine_tune_from for this '
                "architecture.".format(fine_tune_from)
            )
        trainable_paths = set(ordered[boundary:])

    def path_trainable(path):
        if "tail" in path.split("/")[0]:
            return not freeze_tail
        if not is_backbone(path):
            return True
        if not trainable:
            return False
        if trainable_paths is not None and _depth_key(path) is not None:
            return path in trainable_paths
        return True

    return {name: path_trainable(path) for name, path in paths.items()}


def build_weight_decay_coefficients(model, model_config):
    """``{parameter name: L2 coefficient}``, 0.0 for non-kernels.

    The backbone's ``arg_scope.weight_decay``, ``rpn.
    l2_regularization_scale`` and ``rcnn.l2_regularization_scale``.
    """
    base_wd = float(
        (model_config.get("base_network") or {})
        .get("arg_scope", {}).get("weight_decay", 0.0) or 0.0
    )
    rpn_wd = float((model_config.get("rpn") or {}).get(
        "l2_regularization_scale", base_wd) or 0.0)
    rcnn_wd = float((model_config.get("rcnn") or {}).get(
        "l2_regularization_scale", base_wd) or 0.0)

    def coefficient(path):
        parts = path.split("/")
        if parts[-1] not in ("kernel", "w"):
            return 0.0
        return {"rpn": rpn_wd, "rcnn": rcnn_wd}.get(parts[0], base_wd)

    return {name: coefficient(path)
            for name, path in _param_paths(model).items()}


def l2_regularization_loss(params, coefficients):
    """``Σ 0.5·c·‖w‖²``: the reported regularization term (the decay itself
    is applied by the optimizer)."""
    terms = [
        0.5 * coefficients[name] * torch.sum(torch.square(p.detach().float()))
        for name, p in params.items() if coefficients.get(name)
    ]
    if not terms:
        return torch.zeros(())
    return sum(terms)
