"""The port's ``lumi`` command group: ``python -m luminoth_tpu_torch <cmd>``.

Commands: ``train``, ``eval``, ``predict``, ``server`` (``server web``),
``checkpoint`` (the zoo) and ``dataset`` (``dataset transform`` and
``dataset merge``: annotations to TFRecords). The model commands take
``--device`` (default: the current CUDA device; without one they raise,
there is no CPU fallback). ``cloud`` (Cloud TPU jobs) is not ported.
Command modules are imported only when their command runs, so ``--help``
stays fast.
"""

import importlib

import click

CONTEXT_SETTINGS = {"help_option_names": ["-h", "--help"]}

# command name → (module, attribute)
_COMMANDS = {
    "train": ("luminoth_tpu_torch.train", "train"),
    "eval": ("luminoth_tpu_torch.eval", "eval"),
    "predict": ("luminoth_tpu_torch.predict", "predict"),
    "server": ("luminoth_tpu_torch.tools.server", "server"),
    "checkpoint": ("luminoth_tpu_torch.tools.checkpoint", "checkpoint"),
    "dataset": ("luminoth_tpu_torch.tools.dataset", "dataset"),
}

_HELP = {
    "train": "Train a detection model.",
    "eval": "Evaluate checkpoints on a dataset split.",
    "predict": "Run a detector on images or video.",
    "server": "Serve a model over HTTP.",
    "checkpoint": "Manage the checkpoint zoo.",
    "dataset": "Convert annotations to TFRecords and merge them.",
}


class LazyGroup(click.Group):
    def list_commands(self, ctx):
        return sorted(_COMMANDS)

    def get_command(self, ctx, name):
        target = _COMMANDS.get(name)
        if target is None:
            return None
        module, attr = target
        return getattr(importlib.import_module(module), attr)

    def format_commands(self, ctx, formatter):
        # Help listing without importing any command module.
        rows = [(name, _HELP[name]) for name in sorted(_COMMANDS)]
        with formatter.section("Commands"):
            formatter.write_dl(rows)


@click.group(
    cls=LazyGroup,
    context_settings=CONTEXT_SETTINGS,
    help="Luminoth-TPU on PyTorch: object detection on NVIDIA GPUs",
)
def cli():
    pass
