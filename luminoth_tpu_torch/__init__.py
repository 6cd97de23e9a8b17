"""luminoth_tpu_torch — the PyTorch/CUDA port of luminoth_tpu.

Faster R-CNN (ResNet v1 trunk) and SSD (truncated VGG-16) serving,
training, evaluation and the predict/serve tools (``python -m luminoth_tpu_torch``) on an NVIDIA GPU,
held against the JAX package ``luminoth_tpu`` (the reference, which it
never imports: the host code it needs, from config resolution to the
dataset readers, is copied here). The TPU Pallas kernels are hand-written CUDA C++
here (``csrc/``), built by ``nvcc`` at first use.
Imports are lazy so ``import luminoth_tpu_torch`` stays cheap.
"""

from luminoth_tpu_torch.version import __version__  # noqa: F401

_LAZY = {
    "Detector": ("luminoth_tpu_torch.tasks", "Detector"),
}

__all__ = ["__version__"] + list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'luminoth_tpu_torch' has no attribute '{name}'"
    )
