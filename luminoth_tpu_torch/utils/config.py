"""Layered YAML configuration system of the port.

A copy of the JAX package's ``utils/config.py``, with the same semantics:

* Each model ships a ``base_config.yml``; the port keeps its own copies,
  ``models/fasterrcnn/base_config.yml`` and ``models/ssd/base_config.yml``.
* User YAML files are deep-merged on top of the base config.
* Dotted-path CLI overrides (``-o train.learning_rate.value=1e-4``) are merged
  last, with scalar values parsed as none/bool/int/float/str.
* A ``_replace: True`` meta-key replaces a whole subtree instead of merging
  (used for kwargs-style dicts like optimizer / learning-rate schedules).
* Merges enforce type compatibility between the new and existing values.

Only the lookup of a model's base config differs: the JAX helper finds it
next to the flax model class, the port by model type.
"""

import copy
import os
from collections.abc import Mapping

import yaml

from luminoth_tpu_torch.utils import fileio

REPLACE_KEY = "_replace"


class Config(dict):
    """A dict with attribute access, recursively applied."""

    def __init__(self, data=None):
        super().__init__()
        if data:
            for key, value in dict(data).items():
                self[key] = value

    @staticmethod
    def _wrap(value):
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def copy(self):
        return Config(self)

    def __deepcopy__(self, memo):
        import copy

        out = Config()
        for key, value in self.items():
            out[key] = copy.deepcopy(value, memo)
        return out


def to_plain(config):
    """Recursively convert a Config tree back to plain dicts/lists."""
    if isinstance(config, dict):
        return {k: to_plain(v) for k, v in config.items()}
    if isinstance(config, (list, tuple)):
        return [to_plain(v) for v in config]
    return config


def dump_config(config):
    """Serialize a config tree to a YAML string."""
    return yaml.safe_dump(to_plain(config), default_flow_style=False)


def load_config_files(filename_or_filenames):
    """Load one or more YAML files, later ones overriding earlier ones."""
    filenames = filename_or_filenames
    if not isinstance(filenames, (list, tuple)):
        filenames = [filenames]

    config = Config()
    for filename in filenames:
        with fileio.open_file(filename) as f:
            new_config = Config(yaml.safe_load(f) or {})
        config = merge_into(new_config, config, overwrite=True)
    return config


_MODELS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models"
)


def get_base_config(model_type):
    """The merged ``base_config.yml`` of a model type, ``fasterrcnn`` or
    ``ssd``."""
    if model_type not in ("fasterrcnn", "ssd"):
        raise ValueError('Invalid model type "{}"'.format(model_type))
    return load_config_files(
        [os.path.join(_MODELS_DIR, model_type, "base_config.yml")]
    )


def proposals_config(config):
    """The final detection stage's ``proposals`` section of a model config:
    ``model.rcnn.proposals`` for Faster R-CNN, ``model.proposals`` for
    SSD."""
    if config.model.type == "fasterrcnn":
        return config.model.rcnn.proposals
    return config.model.proposals


def _is_string(value):
    return isinstance(value, str)


def types_compatible(new_value, base_value):
    """Whether ``new_value`` may overwrite ``base_value`` during a merge."""
    if base_value is None:
        return True
    # None / False always allowed to overwrite (matches reference behavior).
    if new_value is None or new_value is False:
        return True
    if _is_string(new_value) and _is_string(base_value):
        return True
    if isinstance(new_value, bool) != isinstance(base_value, bool):
        # bool is an int subclass; don't let ints silently replace flags.
        return False
    if isinstance(new_value, (int, float)) and isinstance(base_value, (int, float)):
        return True
    return isinstance(new_value, type(base_value))


def _should_replace(new_config, base_config, key):
    base_replace = None
    new_replace = None
    base_sub = base_config.get(key)
    if isinstance(base_sub, dict):
        base_replace = base_sub.get(REPLACE_KEY)
    new_sub = new_config.get(key)
    if isinstance(new_sub, dict):
        new_replace = new_sub.get(REPLACE_KEY)

    if new_replace:
        return True
    if new_replace is None and base_replace:
        return True
    return False


def merge_into(new_config, base_config, overwrite=False):
    """Deep-merge ``new_config`` into ``base_config``.

    When ``overwrite`` is true, conflicting scalar keys take the new value.
    """
    if not isinstance(new_config, dict):
        return base_config

    for key, value in new_config.items():
        if not types_compatible(value, base_config.get(key)):
            raise ValueError(
                'Incorrect type "{}" for key "{}". Must be "{}"'.format(
                    type(value).__name__, key, type(base_config.get(key)).__name__
                )
            )

        if isinstance(value, dict):
            if _should_replace(new_config, base_config, key):
                # Deep-copy, don't alias: cleanup_config later strips
                # _replace markers in place, and an aliased subtree would
                # mutate the caller's input — a second resolve of the
                # same parsed config would then deep-MERGE a subtree the
                # user marked for wholesale replacement.
                base_config[key] = copy.deepcopy(value)
            else:
                base = base_config.get(key)
                if not isinstance(base, dict):
                    # A dict may merge over None (an empty YAML section
                    # parses to None) or a missing key.
                    base = Config()
                base_config[key] = merge_into(
                    value, base, overwrite=overwrite
                )
        else:
            if base_config.get(key) is None or overwrite:
                base_config[key] = value

    return base_config


def parse_config_value(value):
    """Parse a string override value into none/bool/int/float/str."""
    lowered = value.lower()
    if lowered == "none":
        return None
    if lowered == "true":
        return True
    if lowered == "false":
        return False
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def parse_override(override_options):
    """Parse ``key.path=value`` strings into a nested dict."""
    if not override_options:
        return {}

    override_dict = {}
    for option in override_options:
        key_value = option.split("=", 1)
        if len(key_value) != 2:
            raise ValueError('Invalid override option "{}"'.format(option))
        key, value = key_value
        nested_keys = key.split(".")

        local = override_dict
        for nested_key in nested_keys[:-1]:
            local = local.setdefault(nested_key, {})
        local[nested_keys[-1]] = parse_config_value(value)

    return override_dict


def cleanup_config(config):
    """Remove meta-keys (``_replace``) from a config tree, in place."""
    config.pop(REPLACE_KEY, None)
    for key in config:
        if isinstance(config[key], dict):
            cleanup_config(config[key])
    return config


def get_model_config(base_config, custom_config, override_params=None):
    """base ← custom yaml ← CLI overrides, then strip meta-keys."""
    config = copy.deepcopy(Config(base_config))
    if custom_config:
        config = merge_into(Config(custom_config), config, overwrite=True)
    if override_params:
        config = merge_into(
            Config(parse_override(override_params)), config, overwrite=True
        )
    return cleanup_config(config)


def get_config(config_files, override_params=None):
    """base config ← user YAML file(s) ← ``key.path=value`` overrides."""
    custom_config = load_config_files(config_files)
    base_config = get_base_config(custom_config["model"]["type"])
    return get_model_config(base_config, custom_config, override_params)


def override_config_params(config, params):
    """Apply ``key.path=value`` overrides onto an existing config."""
    config = merge_into(Config(parse_override(params)), config, overwrite=True)
    return config
