"""Synchronous data parallelism over a 1-D group of ranks.

Counterpart of the JAX package's ``parallel/mesh.py``: one global batch per
step, split along the batch axis over the ranks, weights replicated, and a
step whose numbers equal the single-device step on that global batch. The
JAX package gets that from XLA over a mesh; here each rank is one process
of a ``torch.distributed`` group (NCCL on CUDA, gloo on the CPU) and the
places where a rank's rows alone would give another step are made global
explicitly, inside :func:`batch_shard`:

* **random draws** (target priorities, dropout; :func:`rand_rows`): each
  rank draws the global batch's shape from the step's generator and keeps
  its rows, so it draws what the one-process step draws;
* **loss denominators** (:func:`masked_mean`, :func:`batch_mean`): each
  rank divides its local sum by the count over the global batch (an
  all-reduce, no gradient), so the ranks' losses sum to the global loss
  and their gradients are summed, not averaged;
* **batch-statistics batch norm** (:func:`batch_moments`): the sums of x
  and x² and the counts are all-reduced (the ranks may hold unequal
  shares: the bands of ``parallel/spatial.py``), with a backward that
  all-reduces the sums' gradients.

Outside :func:`batch_shard` (one process) every function computes what the
model computed before, operation for operation. Eval and serving replicate
the model over devices in one process instead (:func:`replicate`,
:func:`run_replicas`); there only the draws take the shard, and losses
are computed on the gathered predictions. The JAX package's 2-D ``(data,
space)`` mesh is ``parallel/spatial.py``: the head runs on one rank per
image, under a :func:`batch_shard` of those ranks.
"""

import contextlib
import copy
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass
class BatchShard:
    """This rank's place in the global batch, and the group whose counts
    and statistics are global (None: draws only)."""

    rank: int = 0
    world: int = 1
    group: object = None


_SHARD = BatchShard()


@contextlib.contextmanager
def batch_shard(rank, world, group=None):
    """Run the body as row block ``rank`` of ``world`` of the global batch;
    with ``group``, loss counts and batch statistics are all-reduced over
    it. Yields the :class:`BatchShard`."""
    with use_shard(BatchShard(int(rank), int(world), group)):
        yield _SHARD


def current_shard():
    """The active :class:`BatchShard` (to re-enter it in a recompute)."""
    return _SHARD


@contextlib.contextmanager
def use_shard(shard):
    """Run the body under ``shard`` (a :class:`BatchShard`)."""
    global _SHARD
    previous, _SHARD = _SHARD, shard
    try:
        yield
    finally:
        _SHARD = previous


def _reduced():
    return _SHARD.group is not None and _SHARD.world > 1


def world():
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_chief():
    """Single-writer semantics: rank 0 is the chief."""
    return world()[0] == 0


def data_parallel_count(batch_size, devices):
    """The largest device count, at most ``devices``, dividing the batch."""
    count = max(int(devices), 1)
    while batch_size % count:
        count -= 1
    return count


def shard_rows(value, rank, world_size):
    """Row block ``rank`` of ``world_size`` of a batch-leading array (or
    list)."""
    rows = len(value)
    if rows % world_size:
        raise ValueError(f"a batch of {rows} does not split over "
                         f"{world_size} ranks")
    size = rows // world_size
    return value[rank * size:(rank + 1) * size]


def shard_batch(batch, rank, world_size):
    """This rank's rows of every batch-leading array of a host batch
    (``image``, ``gt_boxes``, ``im_shape``, ``filename``...); scalars and
    other entries are kept whole."""
    rows = batch["image"].shape[0]
    out = {}
    for key, value in batch.items():
        if getattr(value, "shape", None) and value.shape[0] == rows or (
                isinstance(value, list) and len(value) == rows):
            out[key] = shard_rows(value, rank, world_size)
        else:
            out[key] = value
    return out


def rand_rows(shape, generator, device):
    """``torch.rand(shape)`` for this rank's rows: the global batch's shape
    (``shape[0] · world`` rows) is drawn and the rank's block kept."""
    if _SHARD.world == 1:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((shape[0] * _SHARD.world,) + tuple(shape[1:]),
                      generator=generator, device=device)
    return shard_rows(full, _SHARD.rank, _SHARD.world)


def _all_reduce(value):
    value = value.clone()
    dist.all_reduce(value, group=_SHARD.group)
    return value


def global_count(count):
    """A count over the global batch (summed over the group, no gradient)."""
    if not _reduced():
        return count
    return _all_reduce(count.detach())


def masked_mean(values, mask):
    """``Σ values·mask / max(Σ mask, 1)`` with the count over the global
    batch."""
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp(
        global_count(torch.sum(mask)), min=1.0)


def batch_mean(values):
    """The mean of per-image values over the global batch."""
    if not _reduced():
        return torch.mean(values)
    return torch.sum(values) / (values.shape[0] * _SHARD.world)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient of each rank's input is the sum of
    the ranks' output gradients."""

    @staticmethod
    def forward(ctx, value, group):
        ctx.group = group
        value = value.clone()
        dist.all_reduce(value, group=group)
        return value

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_moments(x, dim):
    """``(E[x], E[x²])`` over ``dim`` of float32 ``x``, over the global
    batch: the sums of the ranks and their counts (exact in float32 below
    2^24 elements a channel) are all-reduced, the sums differentiably, so
    the ranks normalise alike and move their running statistics alike.
    A recompute (``remat``) all-reduces the same sums again."""
    if not _reduced():
        return x.mean(dim=dim), x.square().mean(dim=dim)
    count = x.new_full((1,), x.numel() // x.shape[1])
    sums = _AllReduceSum.apply(
        torch.cat([x.sum(dim=dim), x.square().sum(dim=dim), count]),
        _SHARD.group)
    mean, mean_sq = (sums[:-1] / sums[-1]).chunk(2)
    return mean, mean_sq


def all_reduce_tensors(tensors, group=None):
    """Sum a list of tensors over the group in one collective (flattened
    into one buffer). Returns new tensors of the same shapes and dtypes."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return out


def replicate(model, devices):
    """``model`` on ``devices[0]`` and a copy of it on each other device
    (a device may repeat), for data-parallel inference in one process."""
    devices = [torch.device(d) for d in devices]
    first = model.to(devices[0])
    return [first] + [copy.deepcopy(first).to(d) for d in devices[1:]]


def run_replicas(replicas, fn, *tensors):
    """``fn(replica, *rows)`` for each replica on its row block of the
    batch-leading ``tensors`` (moved to the replica's device, inside
    :func:`batch_shard`, so its draws are its rows of the global batch's),
    every call launched before any output is read; the outputs joined in
    batch order on the first tensor's device."""
    parts = len(replicas)
    outs = []
    for i, replica in enumerate(replicas):
        device = next(replica.parameters()).device
        rows = [shard_rows(t, i, parts).to(device, non_blocking=True)
                for t in tensors]
        with batch_shard(i, parts):
            outs.append(fn(replica, *rows))
    return concat_rows(outs, tensors[0].device)


def concat_rows(trees, device):
    """The per-replica outputs (nested dicts of batch-leading tensors)
    joined along the batch axis on ``device``, in replica order."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: concat_rows([t[key] for t in trees], device)
                for key in first}
    if isinstance(first, (tuple, list)):
        return type(first)(concat_rows([t[i] for t in trees], device)
                           for i in range(len(first)))
    return torch.cat([t.to(device) for t in trees])
