"""Periodic observability hooks of the training loop (the JAX package's
``utils/hooks/``)."""

from luminoth_tpu_torch.utils.hooks.image_vis_hook import ImageVisHook  # noqa: F401
from luminoth_tpu_torch.utils.hooks.timer import SecondOrStepTimer  # noqa: F401
from luminoth_tpu_torch.utils.hooks.var_vis_hook import VarVisHook  # noqa: F401
