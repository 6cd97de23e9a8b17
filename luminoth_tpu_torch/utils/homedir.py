"""Toolkit home directory (``~/.luminoth_tpu``) management.

A copy of the JAX package's ``utils/homedir.py``: a per-user directory
holding the checkpoint zoo's index and bundles, overridable through the
``LUMI_HOME`` environment variable. The port shares the JAX package's
home on purpose, so that one zoo serves both packages.
"""

import os

DEFAULT_HOME = os.path.expanduser("~/.luminoth_tpu")
HOME_ENV_VAR = "LUMI_HOME"


def get_home(create_if_missing=True):
    """Return the toolkit's home directory, creating it if needed."""
    path = os.path.abspath(os.environ.get(HOME_ENV_VAR, DEFAULT_HOME))
    if create_if_missing and not os.path.exists(path):
        os.makedirs(path, exist_ok=True)
    return path
