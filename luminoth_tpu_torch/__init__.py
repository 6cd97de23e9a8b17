"""luminoth_tpu_torch — the PyTorch/CUDA port of luminoth_tpu.

Faster R-CNN (ResNet v1 trunk) inference on an NVIDIA GPU, held against the
JAX package ``luminoth_tpu`` (the reference, which it never imports beyond
its jax-free host modules). The two TPU Pallas kernels of the serving path
are hand-written CUDA C++ here (``csrc/``), built by ``nvcc`` at first use.
Imports are lazy so ``import luminoth_tpu_torch`` stays cheap.
"""

from luminoth_tpu.version import __version__  # noqa: F401

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
