"""The port's ``lumi server`` command group."""

import click

from luminoth_tpu_torch.tools.server import web


@click.group(help="Groups of commands to serve models")
def server():
    pass


server.add_command(web.web)
