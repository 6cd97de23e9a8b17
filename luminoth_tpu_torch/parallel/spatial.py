"""Spatial sharding: each image's height split in bands over a group of
ranks, the JAX package's ``space`` mesh axis (``train.spatial_shards``).

The JAX package lays a 2-D ``(data, space)`` mesh over its devices and
lets XLA shard the images' height over ``space``, inserting the halo
exchanges. Here the ranks form the same grid (:class:`Grid`: rank ``r`` is
band ``r % space`` of image row block ``r // space``) and the trunk's
layers with a spatial extent are band-aware explicitly:

* **Bands.** A map of global height ``H`` is split in ``space`` contiguous
  bands, band ``i`` holding rows ``[H·i // space, H·(i+1) // space)``
  (:func:`bands`). The split follows the global geometry at every layer:
  deeper maps, which floors and ``VALID`` pools leave uneven, are split
  anew, and a band may be thinner than a halo, or empty.
* **Halo exchange.** An op with kernel ``k``, stride ``s`` and global
  padding ``(top, bottom)`` along the height (:func:`rows_op`) computes
  this band's output rows from a window of input rows; the rows of the
  window that other bands hold come through one ``all_gather`` of the
  space group (:class:`_Halo`, any band may serve any other), the rows
  outside the map are the op's pad value (0 for convolutions, −inf for
  max-pools). Its backward sends each received row's gradient back to
  the band that holds it, through a second ``all_gather``.
* **The head on the leader.** At the trunk's endpoint the bands are
  gathered on the space group's first rank, the *leader* (:func:`gather`):
  only it runs the detection head and the loss, on the whole map; the
  backward broadcasts the leader's gradient of the map and each band
  takes its rows. The other ranks ("followers") report zero losses
  (:func:`follower_losses`) and give their trunk's gradients.

Both collectives carry the tensors' bytes (``uint8`` views), which NCCL
and gloo take for CUDA tensors alike (gloo lets two ranks share one GPU,
NCCL refuses). Without an active :func:`space_shard` every function here
computes what the plain layer computes.
"""

import contextlib
import dataclasses
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from luminoth_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class Grid:
    """A rank's place in the ``(data, space)`` grid of ``data · space``
    ranks, laid out as the JAX ``make_mesh``'s ``reshape(data, space)``."""

    rank: int
    data: int
    space: int

    @property
    def data_index(self):
        return self.rank // self.space

    @property
    def space_index(self):
        return self.rank % self.space

    @property
    def leader(self):
        """The first rank of this rank's space group (it runs the head)."""
        return self.rank - self.space_index

    @property
    def is_leader(self):
        return self.space_index == 0


def make_grid(rank, world_size, space):
    """The grid of ``world_size`` ranks with ``space`` bands per image.

    Raises ``ValueError`` when ``space`` does not divide the rank count,
    as the JAX package does for its device count.
    """
    space = int(space or 1)
    if space < 1 or world_size % space:
        raise ValueError(
            f"train.spatial_shards={space} requires a device count "
            f"divisible by it; have {world_size} device(s)")
    return Grid(int(rank), world_size // space, space)


def grid_groups(grid, group=None):
    """``(space group, leaders' group, leader)`` of ``grid``'s rank in
    the grid laid over ``group`` (None: the default group): the ranks of
    its image's bands, the leaders of every space group (the data axis of
    the head), and its leader's global rank. Every rank of the default
    group must call this, in the same order (``new_group`` is
    collective)."""
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    space_groups = [dist.new_group(ranks[d * grid.space:(d + 1) * grid.space])
                    for d in range(grid.data)]
    leaders = dist.new_group(ranks[::grid.space])
    return space_groups[grid.data_index], leaders, ranks[grid.leader]


@dataclasses.dataclass(frozen=True)
class SpaceShard:
    """This rank's band: ``index`` of ``size`` bands, the ``group`` of
    the image's ranks, the global rank of its leader (band 0) and the
    group whose bands sum the batch statistics (every rank of the grid;
    None: ``group``)."""

    index: int
    size: int
    group: object
    leader: int
    statistics: object = None

    @property
    def is_leader(self):
        return self.index == 0

    def image_height(self, rows):
        """The global height of an image whose band has ``rows`` rows (the
        input split is even)."""
        return rows * self.size


_SPACE = None


@contextlib.contextmanager
def space_shard(index, size, group, leader, statistics=None):
    """Run the body as band ``index`` of ``size``: the trunks compute
    their band and gather the map on the leader; their batch statistics
    sum over ``statistics`` (None: ``group``). Yields the
    :class:`SpaceShard`."""
    global _SPACE
    previous = _SPACE
    _SPACE = SpaceShard(int(index), int(size), group, int(leader),
                        group if statistics is None else statistics)
    try:
        yield _SPACE
    finally:
        _SPACE = previous


def current():
    """The active :class:`SpaceShard`, or None."""
    return _SPACE


def band_statistics():
    """A context in which batch statistics sum over every band of the
    active shard's ``statistics`` group (the ranks hold unequal shares:
    ``parallel/mesh.batch_moments`` all-reduces the counts too)."""
    group = _SPACE.statistics
    return mesh.batch_shard(0, dist.get_world_size(group), group)


def is_follower():
    """Whether this rank computes a band and no head."""
    return _SPACE is not None and not _SPACE.is_leader


@contextlib.contextmanager
def restored(shard):
    """Re-enter a captured :class:`SpaceShard` (None: none), e.g. for a
    recompute in the backward pass."""
    global _SPACE
    previous, _SPACE = _SPACE, shard
    try:
        yield
    finally:
        _SPACE = previous


def bands(height, size):
    """``[(start, stop)]`` global rows of each of ``size`` bands."""
    return tuple((height * i // size, height * (i + 1) // size)
                 for i in range(size))


def split_height(height, size):
    """Raise ``ValueError`` unless ``size`` bands split ``height`` rows
    evenly (the JAX package's ``device_put`` refuses an uneven split)."""
    if height % size:
        raise ValueError(f"a canvas height of {height} does not split in "
                         f"{size} spatial shards")


def image_band(image, index, size):
    """Band ``index`` of ``size`` of a batch-leading (B, H, ...) image
    array (an even split, else ``ValueError``)."""
    height = image.shape[1]
    split_height(height, size)
    start, stop = bands(height, size)[index]
    return image[:, start:stop]


def out_height(height, kernel, stride=1, pad=(0, 0)):
    """Output rows of a (kernel, stride, (top, bottom) pad) op on
    ``height`` rows (None stays None: no band)."""
    if height is None:
        return None
    return (height + pad[0] + pad[1] - kernel) // stride + 1


@dataclasses.dataclass(frozen=True)
class _Plan:
    """Who holds, needs and sends which rows for one op."""

    height: int
    kernel: int
    ins: tuple  # (start, stop) input rows per band
    windows: tuple  # (lo, hi) input rows each band's outputs read, or None
    sends: tuple  # per band: ((dst, lo, hi), ...) rows it sends

    def received(self, dst):
        """``((src, lo, hi, offset), ...)``: the rows ``dst`` receives and
        where they start in the source's message."""
        out = []
        for src, pieces in enumerate(self.sends):
            offset = 0
            for to, lo, hi in pieces:
                if to == dst:
                    out.append((src, lo, hi, offset))
                offset += hi - lo
        return tuple(out)


@functools.lru_cache(maxsize=None)
def _plan(height, size, kernel, stride, top, bottom):
    ins = bands(height, size)
    outs = bands(out_height(height, kernel, stride, (top, bottom)), size)
    windows = tuple(
        None if o0 == o1 else (o0 * stride - top, (o1 - 1) * stride - top
                               + kernel)
        for o0, o1 in outs)
    sends = []
    for src, (a, b) in enumerate(ins):
        pieces = []
        for dst, window in enumerate(windows):
            if dst != src and window is not None:
                lo, hi = max(window[0], a), min(window[1], b)
                if lo < hi:
                    pieces.append((dst, lo, hi))
        sends.append(tuple(pieces))
    return _Plan(height, kernel, ins, windows, tuple(sends))


def _all_gather(tensor, length, group, size):
    """Every rank's ``tensor`` (rows along dim 2, zero-padded to
    ``length``), gathered as bytes over ``group``."""
    if tensor.shape[2] < length:
        n, c, rows, w = tensor.shape
        tensor = torch.cat([tensor, tensor.new_zeros((n, c, length - rows,
                                                      w))], dim=2)
    tensor = tensor.contiguous()
    flat = tensor.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    return [p.view(tensor.dtype).view(tensor.shape) for p in parts]


def _rows(x, start, lo, hi):
    return x[:, :, lo - start:hi - start]


class _Halo(torch.autograd.Function):
    """This band's input window of a ``_Plan`` op (rows of other bands
    exchanged, the map's outside filled with ``fill``); its backward
    returns each received row's gradient to its band."""

    @staticmethod
    def forward(ctx, x, plan, shard, fill):
        ctx.plan, ctx.shard = plan, shard
        me = shard.index
        start = plan.ins[me][0]
        length = max(sum(hi - lo for _, lo, hi in s) for s in plan.sends)
        received = []
        if length:
            pieces = [_rows(x, start, lo, hi) for _, lo, hi in plan.sends[me]]
            mine = (torch.cat(pieces, dim=2) if pieces
                    else x[:, :, :0])
            received = _all_gather(mine, length, shard.group, shard.size)
        window = plan.windows[me]
        n, c, _, w = x.shape
        if window is None:  # no output rows: a window of one output's rows
            return x.new_full((n, c, plan.kernel, w), fill).contiguous(
                memory_format=torch.channels_last)
        lo, hi = window
        parts = []
        if lo < 0:
            parts.append(x.new_full((n, c, -lo, w), fill))
        incoming = {src: (a, b, offset)
                    for src, a, b, offset in plan.received(me)}
        for src, (a, b) in enumerate(plan.ins):
            a, b = max(a, lo), min(b, hi)
            if a >= b:
                continue
            if src == me:
                parts.append(_rows(x, start, a, b))
            else:
                _, _, offset = incoming[src]
                parts.append(received[src][:, :, offset:offset + b - a])
        if hi > plan.height:
            parts.append(x.new_full((n, c, hi - plan.height, w), fill))
        out = torch.cat(parts, dim=2)
        return out.contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, grad):
        plan, shard = ctx.plan, ctx.shard
        me = shard.index
        start, stop = plan.ins[me]
        n, c, _, w = grad.shape
        dx = grad.new_zeros((n, c, stop - start, w))
        window = plan.windows[me]
        back = []
        if window is not None:
            lo, hi = window
            for src, (a, b) in enumerate(plan.ins):
                a, b = max(a, lo), min(b, hi)
                if a >= b:
                    continue
                rows = grad[:, :, a - lo:b - lo]
                if src == me:
                    dx[:, :, a - start:b - start] += rows
                else:
                    back.append(rows)
        length = max(sum(hi - lo for _, lo, hi, _ in plan.received(dst))
                     for dst in range(shard.size))
        if length:
            mine = torch.cat(back, dim=2) if back else grad[:, :, :0]
            returned = _all_gather(mine, length, shard.group, shard.size)
            for dst, lo, hi in plan.sends[me]:
                offset = 0
                for src, a, b, _ in plan.received(dst):
                    if src == me:
                        break
                    offset += b - a
                dx[:, :, lo - start:hi - start] += (
                    returned[dst][:, :, offset:offset + hi - lo])
        return dx, None, None, None


def rows_op(op, x, height, kernel, stride=1, pad=(0, 0), fill=0.0):
    """``op`` on this band's rows of a map of global ``height`` rows, for
    an op of ``kernel`` rows (dilation included), ``stride`` and
    ``(top, bottom)`` padding along the height.

    ``op`` takes a window that already holds the height padding (rows of
    other bands, ``fill`` outside the map) and pads the width itself.
    """
    shard = current()
    plan = _plan(height, shard.size, kernel, stride, pad[0], pad[1])
    if not any(plan.sends) and plan.windows[shard.index] == plan.ins[
            shard.index]:
        return op(x)  # this band's own rows, and no band sends any
    out = op(_Halo.apply(x, plan, shard, fill))
    if plan.windows[shard.index] is None:
        out = out[:, :, :0]
    return out


def conv2d(x, height, weight, bias, stride, dilation, pad):
    """``F.conv2d`` of this band of a map of global ``height`` rows,
    padded by ``pad`` = (left, right, top, bottom) (an ``F.pad`` tuple)
    around the whole map."""
    left, right, top, bottom = pad

    def op(window):
        if left == right:
            return F.conv2d(window, weight, bias, stride, (0, left),
                            dilation)
        return F.conv2d(F.pad(window, (left, right, 0, 0)), weight, bias,
                        stride, 0, dilation)

    kernel = (weight.shape[2] - 1) * dilation + 1
    return rows_op(op, x, height, kernel, stride, (top, bottom))


def max_pool2d(x, height, kernel, stride, padding=0):
    """``F.max_pool2d`` (``padding`` counts as −inf); ``height``: of
    this band of a map that high."""
    if height is None:
        return F.max_pool2d(x, kernel, stride=stride, padding=padding)
    return rows_op(
        lambda window: F.max_pool2d(window, kernel, stride=stride,
                                    padding=(0, padding)),
        x, height, kernel, stride, (padding, padding), fill=float("-inf"))


def subsample(x, height, stride):
    """``x[:, :, ::stride, ::stride]`` (slim's 1x1 ``VALID`` max-pool
    shortcut); ``height``: of this band of a map that high."""
    if height is None:
        return x[:, :, ::stride, ::stride]
    if stride == 1:
        return x
    return rows_op(lambda window: window[:, :, ::stride, ::stride], x,
                   height, 1, stride)


class _Gather(torch.autograd.Function):
    """The bands joined on the leader (an empty tensor elsewhere); the
    backward broadcasts the leader's gradient and each band takes its
    rows."""

    @staticmethod
    def forward(ctx, x, height, shard):
        ctx.height, ctx.shard = height, shard
        spans = bands(height, shard.size)
        ctx.shape = x.shape
        length = max(b - a for a, b in spans)
        parts = _all_gather(x, length, shard.group, shard.size)
        if not shard.is_leader:
            return x.new_empty(x.shape[:2] + (0, x.shape[3]))
        full = torch.cat([p[:, :, :b - a] for p, (a, b) in zip(parts, spans)],
                         dim=2)
        return full.contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        n, c, _, w = ctx.shape
        if shard.is_leader:
            full = grad.contiguous()
        else:
            full = grad.new_empty((n, c, ctx.height, w))
        flat = full.reshape(-1).view(torch.uint8)
        dist.broadcast(flat, src=shard.leader, group=shard.group)
        a, b = bands(ctx.height, shard.size)[shard.index]
        return full[:, :, a:b], None, None


def gather(x, height):
    """The whole map (NCHW) on the leader from every band of a map of
    global ``height``; an empty (0-row) tensor on the other ranks.
    Without a band, ``x`` itself."""
    if height is None:
        return x
    return _Gather.apply(x, height, current())


def follower_losses(names, band, return_all):
    """A follower's losses: zeros under the leader's ``names`` (in its
    order), tied to this rank's gathered ``band`` so that the backward
    reaches the trunk (and the gather's broadcast)."""
    zero = band.float().sum() * 0.0
    if not return_all:
        return zero
    return {name: zero for name in names}
