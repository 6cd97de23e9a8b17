"""Run journal: append per-run metadata for forensics.

A copy of the JAX package's ``utils/experiments.py`` (reference:
luminoth/utils/experiments.py:48-73): ``save_run`` appends a JSON line
with the config and the environment to ``runs.json`` in the toolkit's
home, the one the JAX package writes too (``utils/homedir.py``), so both
packages keep one journal. ``versions`` names torch and this package.
"""

import getpass
import json
import os
import subprocess
import time

from luminoth_tpu_torch.utils.config import to_plain
from luminoth_tpu_torch.utils.homedir import get_home
from luminoth_tpu_torch.version import __version__


def get_diff():
    try:
        return subprocess.check_output(
            ["git", "diff"], stderr=subprocess.DEVNULL
        ).decode("utf-8", "replace")
    except Exception:
        return None


def save_run(config, environment=None, comment=None, extra_config=None,
             filename="runs.json"):
    """Append a JSON line describing this run to the journal."""
    import torch

    diff = get_diff() if environment != "cloud" else None
    run = {
        "timestamp": time.time(),
        "user": getpass.getuser(),
        "environment": environment,
        "comment": comment,
        "config": to_plain(config),
        "extra_config": extra_config,
        "diff": diff,
        "versions": {
            "torch": torch.__version__,
            "luminoth_tpu_torch": __version__,
        },
    }
    path = os.path.join(get_home(), filename)
    with open(path, "a") as f:
        f.write(json.dumps(run) + "\n")
