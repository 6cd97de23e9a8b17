"""Int8 twins of the ResNet v1 tail and trunk for serving.

Counterpart of the JAX package's ``models/base/quantized_tail.py``. The
twins compute the float networks of ``resnet.py`` again with

* batch norm folded into the conv weights (inference batch norm is an
  affine map per output channel);
* symmetric int8 weights with one scale per output channel;
* symmetric int8 activations with one scale per tensor: dynamic
  (``max|x| / 127`` of each tensor) or, with ``static_scales``, from the
  calibrated running maximum of each quant point;
* int8 x int8 -> int32 products through ``torch._int_mm`` (on the card,
  cuBLASLt on the int8 tensor cores) and a float32 epilogue
  ``acc * (x_scale * w_scales) + bias`` in JAX's order, one fused
  multiply-add per element as XLA computes it; residual adds in float32.

The twins subclass the float modules: they have the same parameters under
the same names, so the flax weight mapping, ``.pt`` and ``.msgpack``
checkpoints load unchanged, and in training (``module.train()``) they run
the float path, as the JAX flags are inert with ``train=True``. The int8
weights are folded and quantized once per set of weights (cached, and made
again only when a source tensor changes) rather than in every forward.

Each quant point is a non-persistent float32 buffer ``<point>_amax`` on
the module that owns it, at the flax path of the JAX package's
``int8_stats`` collection (``utils/weights.py`` carries that collection
both ways). :func:`calibrating` collects the running ``max|x|`` of every
point while the forwards still use dynamic scales, as the JAX package's
``mutable=["int8_stats"]`` forward does.

A 3x3 conv is one product over an explicit im2col (the nine shifted
views of the padded int8 input, concatenated on channels): nine per-tap
products would leave nine int32 partial sums in memory.

The quantizers return ranges ``r = max(max|x|, 1e-8)`` where the JAX
package returns scales ``r / 127``: XLA folds the two ``1/127`` of its
``x_scale * w_scales`` into one constant and computes ``w_r * (x_r *
127**-2)``; the port forms that product in the same order, and the codes
``round(x / (r * (1/127)))`` as XLA does, so given the same inputs and
weights it computes the JAX package's bits.
"""

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from luminoth_tpu_torch.models.base.resnet import (
    BN_EPSILON,
    BottleneckV1,
    ResNet,
    ResNetTail,
    root_pool,
)

# XLA turns the JAX package's division by the constant 127 into a product
# with the float32 reciprocal, and folds the two of an epilogue into one.
INV_127 = float(np.float32(1.0) / np.float32(127.0))
INV_127_SQ = float(np.float32(INV_127) * np.float32(INV_127))
# torch._int_mm on CUDA takes more than 16 rows: fewer are padded with zeros.
MIN_ROWS = 17


def quantize_per_tensor(x):
    """Symmetric dynamic per-tensor int8: ``(x_q, r)`` with x ≈ x_q·r/127;
    the range ``r`` is a float32 0-d tensor on ``x``'s device."""
    return quantize_with_range(x, max_abs(x))


def max_abs(x):
    """``max|x|`` as a float32 0-d tensor (exact in any dtype)."""
    lo, hi = torch.aminmax(x)
    return torch.maximum(-lo, hi).float()


def quantize_with_range(x, amax):
    """``(clip(round(x / (r / 127)), -127, 127) as int8, r)`` with ``r =
    max(amax, 1e-8)``; the division is by a device tensor, the rounding
    half to even."""
    r = torch.clamp(amax, min=1e-8)
    q = x.float() / (r * INV_127)
    return q.round_().clamp_(-127, 127).to(torch.int8), r


def quantize_weight_per_channel(w):
    """Symmetric int8 with one scale per output channel.

    ``w`` is (out, ...), the port's layout; returns ``(w_q, ranges
    (out,))``, w ≈ w_q·r/127 per channel.
    """
    w = w.float()
    amax = w.abs().reshape(w.shape[0], -1).amax(dim=1)
    ranges = torch.clamp(amax, min=1e-8)
    q = w / (ranges * INV_127).reshape((-1,) + (1,) * (w.dim() - 1))
    return q.round_().clamp_(-127, 127).to(torch.int8), ranges


def fold_bn(kernel, gamma, beta, mean, var, eps=BN_EPSILON):
    """Fold an inference batch norm into the conv before it.

    conv(x, W) then BN = conv(x, W·γ/σ) + (β − μ·γ/σ); ``kernel`` is
    (out, ...). Returns float32 ``(kernel, bias)``. The bias is one fused
    multiply-add, as XLA computes it; XLA's ``γ·rsqrt(σ²+ε)`` for ``γ/σ``
    may differ from this correctly rounded quotient by one unit in the
    last place.
    """
    inv_sigma = gamma.float() / torch.sqrt(var.float() + eps)
    folded_kernel = kernel.float() * inv_sigma.reshape(
        (-1,) + (1,) * (kernel.dim() - 1))
    folded_bias = torch.addcmul(beta.float(), -mean.float(), inv_sigma)
    return folded_kernel, folded_bias


def weight_matrix(kernel):
    """An (out, in, kh, kw) kernel as the (out, kh·kw·in) matrix the im2col
    rows meet: taps in (ky, kx) order, channels within a tap."""
    return kernel.permute(0, 2, 3, 1).reshape(kernel.shape[0], -1).contiguous()


def int8_weights(kernel, bias):
    """``(w_mat, w_ranges, bias)`` of a float (out, in, kh, kw) kernel and
    its float32 bias: the per-channel int8 matrix of :func:`weight_matrix`."""
    w_q, w_ranges = quantize_weight_per_channel(kernel)
    return weight_matrix(w_q), w_ranges, bias.float()


def int8_mm(rows, w_mat):
    """(M, K) int8 rows times the (N, K) int8 matrix's transpose → (M, N)
    int32, by ``torch._int_mm``; fewer than ``MIN_ROWS`` rows are padded
    with zero rows, which are sliced off."""
    m = rows.shape[0]
    if m < MIN_ROWS:
        rows = F.pad(rows, (0, 0, 0, MIN_ROWS - m))
    acc = torch._int_mm(rows, w_mat.t())
    return acc[:m] if m < MIN_ROWS else acc


def _epilogue(acc, x_range, w_ranges, bias, shape):
    """``acc * (x_scale * w_scales) + bias`` in float32, as ``shape``.

    The scale product is ``w_r * (x_r * 127**-2)`` and the rest one fused
    multiply-add per element (``addcmul``), as XLA computes the JAX
    package's epilogue.
    """
    out = acc.float()
    scale = w_ranges * (x_range * INV_127_SQ)
    return torch.addcmul(bias, out, scale, out=out).view(shape)


def _int8_matmul_1x1(x_q, x_range, w_mat, w_ranges, bias):
    """(N, H, W, Cin) int8 × a folded 1x1 kernel → float32 (N, H, W, Cout)."""
    n, h, w, cin = x_q.shape
    acc = int8_mm(x_q.reshape(n * h * w, cin), w_mat)
    return _epilogue(acc, x_range, w_ranges, bias, (n, h, w, -1))


def _conv_pads(size, kernel_eff, stride, padding):
    """(pad_beg, pad_end, out_size) for one spatial dim.

    ``conv2d_same``: slim's explicit symmetric pad + VALID (a total of
    ``kernel_eff - 1`` at any stride), used by the ResNet trunk.
    ``same``: TF SAME (``out = ceil(size/stride)``, the odd pixel at the
    end), the VGG/SSD float path. The two agree at stride 1.
    ``valid``: no padding.
    """
    if padding == "conv2d_same":
        pad_total = kernel_eff - 1
    elif padding == "same":
        out = -(-size // stride)
        pad_total = max((out - 1) * stride + kernel_eff - size, 0)
    elif padding == "valid":
        pad_total = 0
    else:
        raise ValueError(f"Unknown padding {padding!r}")
    pad_beg = pad_total // 2
    pad_end = pad_total - pad_beg
    out = (size + pad_total - kernel_eff) // stride + 1
    return pad_beg, pad_end, out


def im2col3x3(x_q, stride=1, rate=1, padding="conv2d_same"):
    """The (N·OH·OW, 9·C) int8 rows of a 3x3 conv over NHWC ``x_q``: the
    explicit pad of ``padding``, then the nine (dilated, strided) taps
    side by side."""
    n, h, w, cin = x_q.shape
    kernel_eff = 3 + 2 * (rate - 1)
    ph0, ph1, oh = _conv_pads(h, kernel_eff, stride, padding)
    pw0, pw1, ow = _conv_pads(w, kernel_eff, stride, padding)
    xp = F.pad(x_q, (0, 0, pw0, pw1, ph0, ph1))
    # One strided copy of (n, oh, ow, ky, kx, channel) windows, moved as
    # 4-byte words when the channels allow.
    if cin % 4 == 0:
        xp = xp.view(torch.int32)
    sn, sh, sw, sc = xp.stride()
    windows = xp.as_strided(
        (n, oh, ow, 3, 3, xp.shape[-1]),
        (sn, sh * stride, sw * stride, sh * rate, sw * rate, sc))
    rows = windows.reshape(n * oh * ow, -1)
    return rows.view(torch.int8), (n, oh, ow)


def _int8_conv3x3(x_q, x_range, w_mat, w_ranges, bias, stride=1, rate=1,
                  padding="conv2d_same"):
    """3x3 conv (stride, dilation rate, ``_conv_pads`` padding) of NHWC int8
    ``x_q`` → float32 NHWC, as one int8 product over the im2col rows."""
    rows, (n, oh, ow) = im2col3x3(x_q, stride, rate, padding)
    acc = int8_mm(rows, w_mat)
    del rows
    return _epilogue(acc, x_range, w_ranges, bias, (n, oh, ow, -1))


def _fingerprint(tensors):
    """Identity and version of each tensor: changes when one is loaded,
    moved or updated in place."""
    return tuple((t.device, t.data_ptr(),
                  0 if t.is_inference() else t._version) for t in tensors)


class Int8Points:
    """Mixin of a twin module: its quant points and its int8 weight cache.

    Each point ``name`` is a non-persistent float32 0-d buffer holding the
    calibrated ``max|x|``. ``static_scales`` reads the buffers; while
    ``calibrating`` each forward raises them to the running maximum and
    still quantizes dynamically. ``calibrated`` says the buffers hold
    calibrated values (set by :func:`calibrating` and :func:`load_int8_stats`).
    """

    def _setup_int8(self, points, static_scales):
        self.quant_points = tuple(points)
        self.static_scales = bool(static_scales)
        self.calibrating = False
        self.calibrated = False
        for name in self.quant_points:
            self.register_buffer(name, torch.zeros(()), persistent=False)
        self._int8_cache = {}

    def activation_quant(self, x, name):
        """``(x_q, range)`` of the activation ``x`` at quant point ``name``:
        dynamic, calibrating, or static (the JAX ``activation_quant``)."""
        if not self.static_scales:
            return quantize_per_tensor(x)
        amax = getattr(self, name)
        if self.calibrating:
            current = max_abs(x)
            amax.copy_(torch.maximum(amax, current))
            return quantize_with_range(x, current)
        if not self.calibrated:
            raise RuntimeError(
                "int8_static needs calibrated activation scales: run the "
                "forward under quantized_tail.calibrating(model) first, or "
                "load the JAX package's int8_stats")
        return quantize_with_range(x, amax)

    def cached_weights(self, name, make, sources):
        """``make(*sources)``'s tensors for ``name`` on the sources' device,
        made again only when one of the ``sources`` tensors has changed.

        ``make`` runs on host copies of the sources: the folded and
        quantized weights are the same bits on every device.
        """
        key = _fingerprint(sources)
        hit = self._int8_cache.get(name)
        if hit is None or hit[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                made = make(*(t.detach().cpu() for t in sources))
                hit = (key, tuple(t.to(sources[0].device) for t in made))
            self._int8_cache[name] = hit
        return hit[1]


def int8_modules(model):
    """The twin modules of ``model`` that have quant points."""
    return [m for m in model.modules()
            if isinstance(m, Int8Points) and m.quant_points]


def needs_calibration(model):
    """True when a module of ``model`` uses static scales not yet
    calibrated."""
    return any(m.static_scales and not m.calibrated
               for m in int8_modules(model))


@contextlib.contextmanager
def calibrating(model):
    """Collect each static quant point's running ``max|x|`` over the
    forwards run in the block (from 0); the forwards quantize dynamically,
    so their outputs are the dynamic path's. Afterwards the points are
    calibrated."""
    modules = [m for m in int8_modules(model) if m.static_scales]
    for m in modules:
        for name in m.quant_points:
            getattr(m, name).zero_()
        m.calibrating = True
    try:
        yield
    finally:
        for m in modules:
            m.calibrating = False
    for m in modules:
        m.calibrated = True


def int8_stat_keys(model):
    """State-dict-style keys (``<module>.<point>``) of every static quant
    point of ``model``."""
    return [f"{prefix}.{name}" if prefix else name
            for prefix, m in model.named_modules()
            if isinstance(m, Int8Points) and m.static_scales
            for name in m.quant_points]


def load_int8_stats(model, stats):
    """Put calibrated ``{key: scalar}`` values (keys of
    :func:`int8_stat_keys`) into the buffers; every static point must be
    given, and nothing else. Marks the points calibrated."""
    keys = set(int8_stat_keys(model))
    missing, extra = sorted(keys - set(stats)), sorted(set(stats) - keys)
    if missing or extra:
        raise KeyError(f"int8_stats do not fit the model: missing "
                       f"{missing[:5]} ({len(missing)}), left over "
                       f"{extra[:5]} ({len(extra)})")
    with torch.no_grad():
        for key, value in stats.items():
            model.get_buffer(key).copy_(torch.as_tensor(value))
    for m in int8_modules(model):
        if m.static_scales:
            m.calibrated = True


def _bn_sources(conv, bn):
    return (conv.weight, bn.weight, bn.bias, bn.running_mean,
            bn.running_var)


def _folded_int8(*sources):
    return int8_weights(*fold_bn(*sources))


class Int8BottleneckV1(Int8Points, BottleneckV1):
    """Int8 inference twin of ``resnet.BottleneckV1``: the same parameters;
    stride on the 3x3 conv and the shortcut, ``conv2d_same`` padding.

    Quant points: ``in_amax`` (the unit's input), ``conv1_amax`` and
    ``conv2_amax`` (the relu'd residual before conv2 and conv3).
    """

    def __init__(self, depth_in, depth, depth_bottleneck, stride, rate=1,
                 static_scales=False):
        super().__init__(depth_in, depth, depth_bottleneck, stride, rate)
        self.rate = rate
        self._setup_int8(("in_amax", "conv1_amax", "conv2_amax"),
                         static_scales)

    def forward(self, x, height=None):
        if self.training:  # the float unit (on a band under a grid)
            return super().forward(x, height)
        return self.int8_forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def _weights(self, name):
        conv, bn = getattr(self, name), getattr(self, f"{name}_bn")
        return self.cached_weights(name, _folded_int8,
                                   _bn_sources(conv, bn))

    def int8_forward(self, x):
        """NHWC ``x`` (any float dtype) → float32 NHWC."""
        s = self.stride
        x_q, x_range = self.activation_quant(x, "in_amax")
        if self.project:
            shortcut = _int8_matmul_1x1(
                x_q[:, ::s, ::s] if s > 1 else x_q, x_range,
                *self._weights("shortcut"))
        else:
            # the float path's 1x1 max-pool subsample, kept in x's dtype
            # until the float32 add below.
            shortcut = x[:, ::s, ::s] if s > 1 else x

        residual = _int8_matmul_1x1(x_q, x_range,
                                    *self._weights("conv1")).relu_()
        del x_q
        r_q, r_range = self.activation_quant(residual, "conv1_amax")
        del residual
        residual = _int8_conv3x3(r_q, r_range, *self._weights("conv2"),
                                 stride=s, rate=self.rate).relu_()
        del r_q
        r_q, r_range = self.activation_quant(residual, "conv2_amax")
        del residual
        residual = _int8_matmul_1x1(r_q, r_range, *self._weights("conv3"))
        del r_q
        # relu(shortcut + residual): the add is in float32 either way round.
        return residual.add_(shortcut).relu_()


def _check_version(version, flag):
    if version != 1:
        raise ValueError(f"{flag} supports resnet v1 only")


class Int8ResNetTail(ResNetTail):
    """Int8 inference twin of ``resnet.ResNetTail`` (v1): the same
    ``block4/unit_N`` modules and parameters; the output is in the input's
    dtype (the model's), as the float tail's."""

    def __init__(self, depth=101, depth_in=1024, version=1,
                 static_scales=False):
        _check_version(version, "int8_tail")
        super().__init__(depth, depth_in, unit=functools.partial(
            Int8BottleneckV1, static_scales=static_scales))

    def forward(self, x):
        """NCHW (channels_last) ROI features → NCHW, like the float tail."""
        if self.training:
            return super().forward(x)
        y = x.permute(0, 2, 3, 1)
        for unit in self.block4.values():
            y = unit.int8_forward(y)
        return y.to(x.dtype).permute(0, 3, 1, 2)


class Int8ResNetTrunk(Int8Points, ResNet):
    """Int8 inference twin of ``resnet.ResNet`` (v1) up to ``endpoint``.

    The root 7x7 conv stays float32 with batch norm folded (3 input
    channels), then relu and the 3x3/2 max-pool (VALID, or padded with
    ``stride_first``); every bottleneck runs int8. The input is the
    float32 mean-subtracted batch; the output is in ``dtype``, the
    model's.
    """

    def __init__(self, depth=101, output_stride=None, endpoint="block3",
                 version=1, stride_first=False, static_scales=False,
                 dtype=torch.float32):
        _check_version(version, "int8_trunk")
        super().__init__(depth, output_stride, endpoint,
                         unit=functools.partial(Int8BottleneckV1,
                                                static_scales=static_scales),
                         stride_first=stride_first)
        self.dtype = dtype
        self._setup_int8((), False)  # the cache of the folded root conv

    def forward(self, x):
        """NCHW ``x`` → NCHW map: the float trunk in training (``x`` in the
        model's dtype), else the int8 trunk (``x`` float32)."""
        if self.training:
            return super().forward(x)
        kernel, bias = self.cached_weights(
            "conv1", fold_bn, _bn_sources(self.conv1, self.conv1_bn))
        x = F.conv2d(F.pad(x.float(), self.conv1_pad), kernel, stride=2)
        x = root_pool(torch.relu_(x + bias.reshape(1, -1, 1, 1)),
                      self.stride_first)
        y = x.permute(0, 2, 3, 1).contiguous()
        for name in self.block_names:
            for unit in getattr(self, name).values():
                y = unit.int8_forward(y)
        return y.to(self.dtype).permute(0, 3, 1, 2)


def int8_conv(module, name, conv, x, padding, qname):
    """Float-in, float32-out int8 conv with bias (1x1 or 3x3, the JAX
    ``int8_conv``) of NHWC ``x`` by the biased conv ``conv`` of the
    :class:`Int8Points` ``module``, the activation quantized at its point
    ``qname``; ``padding`` is ``"same"`` or ``"valid"``."""
    x_q, x_range = module.activation_quant(x, qname)
    weights = module.cached_weights(name, int8_weights,
                                    (conv.weight, conv.bias))
    if conv.kernel_size[0] == 1:
        return _int8_matmul_1x1(x_q, x_range, *weights)
    return _int8_conv3x3(x_q, x_range, *weights, stride=conv.stride[0],
                         rate=conv.dilation[0], padding=padding)
