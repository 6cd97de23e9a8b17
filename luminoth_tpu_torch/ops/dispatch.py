"""Kernel dispatch shared by the ops that carry a hand-written CUDA kernel.

A tensor on a CUDA device goes to the kernel; a tensor on the CPU goes to
the kernel's plain PyTorch version. There is no switch that sends CUDA
tensors to the plain version, and no fallback when a kernel fails.
"""


def use_kernel(tensor):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor."""
    if tensor.is_cuda:
        return True
    if tensor.device.type == "cpu":
        return False
    raise NotImplementedError(
        f"no kernel or plain version for device {tensor.device}"
    )
