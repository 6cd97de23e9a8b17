"""``lumi dataset`` command group (reference: tools/dataset/cli.py:7-13).

A copy of the JAX package's ``tools/dataset/__init__.py``.
"""

import click

from luminoth_tpu_torch.tools.dataset.transform import transform
from luminoth_tpu_torch.tools.dataset.merge import merge


@click.group(help="Groups of commands to manage datasets")
def dataset():
    pass


dataset.add_command(transform)
dataset.add_command(merge)
