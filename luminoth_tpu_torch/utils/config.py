"""Config resolution for the port.

The layered YAML system is the JAX package's own
(``luminoth_tpu/utils/config.py``, which imports neither jax nor flax).
Only the lookup of a model's ``base_config.yml`` differs: the JAX helper
finds it next to the flax model class, so the port reads it by path.
"""

import os

import luminoth_tpu
from luminoth_tpu.utils.config import (
    get_model_config,
    load_config_files,
)

_MODELS_DIR = os.path.join(os.path.dirname(luminoth_tpu.__file__), "models")


def get_base_config(model_type):
    """The merged ``base_config.yml`` of a model type, e.g. ``fasterrcnn``."""
    if model_type != "fasterrcnn":
        raise NotImplementedError(
            f"model type {model_type!r} is not ported to PyTorch yet"
        )
    return load_config_files(
        [os.path.join(_MODELS_DIR, model_type, "base_config.yml")]
    )


def get_config(config_files, override_params=None):
    """base config ← user YAML file(s) ← ``key.path=value`` overrides."""
    custom_config = load_config_files(config_files)
    base_config = get_base_config(custom_config["model"]["type"])
    return get_model_config(base_config, custom_config, override_params)
