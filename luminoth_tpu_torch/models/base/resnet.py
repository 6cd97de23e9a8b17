"""ResNet v1 backbone with slim's structure, in PyTorch.

Counterpart of ``luminoth_tpu/models/base/resnet.py`` (v1 only): stride is
applied on the **last** unit of each block, ``output_stride`` switches to
atrous (dilated) convolution once the target stride is reached, strided
convs pad explicitly ("conv2d_same") and the root max-pool is VALID.

Modules are NCHW and run on ``torch.channels_last`` tensors, so the NHWC
views at the public functions cost no copy. Parameters stay float32 and
are cast to the compute dtype of the input (bfloat16 on the serving path),
as flax's ``dtype`` does; batch-norm statistics stay float32. Module and
parameter names follow the flax variable paths (see ``utils/weights.py``).
"""

import torch
import torch.nn.functional as F
from torch import nn

# (base_depth, num_units, stride) per block; stride applies to the LAST unit.
RESNET_BLOCK_DEFS = {
    50: ((64, 3, 2), (128, 4, 2), (256, 6, 2), (512, 3, 1)),
    101: ((64, 3, 2), (128, 4, 2), (256, 23, 2), (512, 3, 1)),
    152: ((64, 3, 2), (128, 8, 2), (256, 36, 2), (512, 3, 1)),
}

BN_EPSILON = 1e-5


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the input's dtype from float32 params."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.Module):
    """Inference batch norm (eps 1e-5): float32 statistics and affine,
    output in the input's dtype."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=False, eps=BN_EPSILON,
        )


def conv2d_same(in_channels, features, kernel_size, stride, rate,
                use_bias=False):
    """The conv of TF-slim ``conv2d_same`` and the explicit pad it needs.

    Returns ``(conv, pad)``: for stride 1, ``pad`` is None and the conv pads
    SAME itself; for a strided conv, ``pad`` is the ``F.pad`` tuple to apply
    before the VALID conv.
    """
    kernel_eff = kernel_size + (kernel_size - 1) * (rate - 1)
    pad_total = kernel_eff - 1
    pad_beg = pad_total // 2
    pad_end = pad_total - pad_beg
    if stride == 1:
        # SAME at stride 1 pads pad_beg/pad_end; both are equal for odd
        # kernels, the only ones the backbone has.
        conv = Conv2d(in_channels, features, kernel_size, stride=1,
                      padding=pad_beg, dilation=rate, bias=use_bias)
        return conv, None
    conv = Conv2d(in_channels, features, kernel_size, stride=stride,
                  padding=0, dilation=rate, bias=use_bias)
    return conv, (pad_beg, pad_end, pad_beg, pad_end)


class BottleneckV1(nn.Module):
    """ResNet v1 bottleneck: 1x1 / 3x3(stride, rate) / 1x1, post-add relu."""

    def __init__(self, depth_in, depth, depth_bottleneck, stride, rate=1):
        super().__init__()
        self.stride = stride
        self.project = depth_in != depth
        if self.project:
            self.shortcut = Conv2d(depth_in, depth, 1, stride=stride,
                                   bias=False)
            self.shortcut_bn = BatchNorm(depth)
        self.conv1 = Conv2d(depth_in, depth_bottleneck, 1, bias=False)
        self.conv1_bn = BatchNorm(depth_bottleneck)
        self.conv2, self.conv2_pad = conv2d_same(
            depth_bottleneck, depth_bottleneck, 3, stride, rate
        )
        self.conv2_bn = BatchNorm(depth_bottleneck)
        self.conv3 = Conv2d(depth_bottleneck, depth, 1, bias=False)
        self.conv3_bn = BatchNorm(depth)

    def forward(self, x):
        if self.project:
            shortcut = self.shortcut_bn(self.shortcut(x))
        else:
            # slim's 1x1 VALID max-pool subsample.
            shortcut = x[:, :, ::self.stride, ::self.stride]

        residual = torch.relu(self.conv1_bn(self.conv1(x)))
        if self.conv2_pad is not None:
            residual = F.pad(residual, self.conv2_pad)
        residual = torch.relu(self.conv2_bn(self.conv2(residual)))
        residual = self.conv3_bn(self.conv3(residual))
        return torch.relu(shortcut + residual)


def _plan_units(block_defs, output_stride):
    """Expand block defs into per-unit (base_depth, stride, rate) schedules.

    slim's ``stack_blocks_dense`` atrous bookkeeping: once the accumulated
    stride reaches ``output_stride``, further strides become dilation
    rates. The root conv+pool contribute stride 4.
    """
    plan = []
    current_stride = 4
    rate = 1
    for b, (base_depth, num_units, block_stride) in enumerate(block_defs,
                                                              start=1):
        units = []
        for u in range(num_units):
            unit_stride = block_stride if u == num_units - 1 else 1
            if output_stride is not None and current_stride == output_stride:
                units.append((base_depth, 1, rate))
                rate *= unit_stride
            else:
                units.append((base_depth, unit_stride, 1))
                current_stride *= unit_stride
        plan.append((f"block{b}", units))
        if output_stride is not None and current_stride > output_stride:
            raise ValueError("output_stride not reachable with these blocks")
    return plan


def _make_block(depth_in, units, unit=BottleneckV1):
    """A ``ModuleDict`` of ``unit_<u>`` bottlenecks built by ``unit``;
    returns it and depth."""
    block = nn.ModuleDict()
    for u, (base_depth, stride, rate) in enumerate(units, start=1):
        block[f"unit_{u}"] = unit(
            depth_in, base_depth * 4, base_depth, stride, rate
        )
        depth_in = base_depth * 4
    return block, depth_in


class ResNet(nn.Module):
    """ResNet v1 trunk up to ``endpoint`` (``"block1"`` .. ``"block4"``).

    Takes and returns NCHW tensors (channels_last on the serving path).
    """

    def __init__(self, depth=101, output_stride=None, endpoint="block3",
                 unit=BottleneckV1):
        super().__init__()
        self.conv1, self.conv1_pad = conv2d_same(3, 64, 7, 2, 1)
        self.conv1_bn = BatchNorm(64)
        plan = _plan_units(RESNET_BLOCK_DEFS[depth], output_stride)
        names = [name for name, _ in plan]
        if endpoint not in names:
            raise ValueError(
                f"Unknown endpoint {endpoint!r}; expected one of {names}"
            )
        self.block_names = names[:names.index(endpoint) + 1]
        depth_in = 64
        for name, units in plan[:len(self.block_names)]:
            block, depth_in = _make_block(depth_in, units, unit)
            self.add_module(name, block)
        self.out_channels = depth_in

    def forward(self, x):
        x = F.pad(x, self.conv1_pad)
        x = torch.relu(self.conv1_bn(self.conv1(x)))
        # slim's max_pool2d(3, stride=2) is VALID: no padding.
        x = F.max_pool2d(x, 3, stride=2)
        for name in self.block_names:
            for unit in getattr(self, name).values():
                x = unit(x)
        return x


class ResNetTail(nn.Module):
    """``block4`` run over pooled ROI crops: three stride-1 bottlenecks."""

    def __init__(self, depth=101, depth_in=1024, unit=BottleneckV1):
        super().__init__()
        base_depth, num_units, _ = RESNET_BLOCK_DEFS[depth][-1]
        self.block4, self.out_channels = _make_block(
            depth_in, [(base_depth, 1, 1)] * num_units, unit
        )

    def forward(self, x):
        for unit in self.block4.values():
            x = unit(x)
        return x
