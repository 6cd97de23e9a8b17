"""Activation lookup (counterpart of ``luminoth_tpu/utils/vars.py``).

The initializers of the JAX module live in ``utils/weights.py``
(:func:`init_variables`), which draws the flax-layout variables the port
loads through the weight bridge.
"""

import torch

_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(torch.relu(x), max=6.0),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "": lambda x: x,
    None: lambda x: x,
}


def get_activation(name):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            "Activation function {} not supported".format(name)
        ) from None
