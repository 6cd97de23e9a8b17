"""Rank functions of the port's data-parallel tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_parallel_mesh.py``
run these in processes spawned by ``parallel.distributed.spawn_ranks``
(gloo on the CPU). This module imports the port only: a spawned rank
imports it by name, and JAX would cost each rank seconds and memory.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.datasets import get_dataset
from luminoth_tpu_torch.models import get_model
from luminoth_tpu_torch.models.base import resnet
from luminoth_tpu_torch.models.base.resnet import set_train_batch_norm
from luminoth_tpu_torch.parallel import mesh, spatial
from luminoth_tpu_torch.utils import config as torch_config
from luminoth_tpu_torch.utils import training
from luminoth_tpu_torch.utils.config import Config
from luminoth_tpu_torch.utils.weights import load_flax_variables

SEED = 3
RANK_TIMEOUT_S = 600  # the join's deadline in the tests' spawns
# tests/test_torch_train.py's setting: Faster R-CNN ResNet-50 v1, 3
# classes, small proposal budgets, momentum 0.9, the clip at 10.
OVERRIDES = {
    "train": {"clip_by_norm": True, "learning_rate": {"learning_rate": 1e-3},
              "optimizer": {"type": "momentum", "momentum": 0.9}},
    "model": {
        "network": {"num_classes": 3},
        "base_network": {"architecture": "resnet_v1_50"},
        "rpn": {"proposals": {"pre_nms_top_n": 128, "post_nms_top_n": 32},
                "target": {"minibatch_size": 64}},
        "rcnn": {"target": {"minibatch_size": 16}},
    },
}


def step_config(train_batch_norm=False):
    config = torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config(OVERRIDES))
    config.model.base_network.train_batch_norm = bool(train_batch_norm)
    return config


def ssd_config():
    """SSD's base config (truncated VGG-16, 300 x 300) with 3 classes."""
    return torch_config.get_model_config(
        torch_config.get_base_config("ssd"), Config({
            "train": OVERRIDES["train"],
            "model": {"network": {"num_classes": 3}}}))


def ssd_batch():
    """Two 300 x 300 images with 3 and 1 ground-truth boxes."""
    rng = np.random.RandomState(1)
    images = (rng.rand(2, 300, 300, 3) * 255).astype(np.float32)
    gt = np.full((2, 3, 5), -1.0, np.float32)
    gt[0] = [[20, 30, 150, 160, 0], [100, 90, 280, 250, 2],
             [200, 10, 290, 80, 1]]
    gt[1, :1] = [[40, 40, 260, 220, 1]]
    return {"image": images, "gt_boxes": gt}


def train_batch():
    """Two 96 x 128 images with 3 and 2 ground-truth boxes (so the two
    ranks' loss counts differ)."""
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 96, 128, 3) * 255).astype(np.float32)
    gt = np.zeros((2, 4, 5), np.float32)
    gt[..., 4] = -1
    gt[0, :3] = [[10, 12, 60, 50, 0], [40, 30, 120, 90, 2],
                 [70, 5, 110, 40, 1]]
    gt[1, :2] = [[5, 5, 90, 80, 1], [60, 40, 125, 95, 0]]
    return {"image": images, "gt_boxes": gt}


def port_steps(config, variables, batch, steps=2, priorities=None,
               device="cpu", space=1):
    """``steps`` train steps of the port on ``batch`` from ``variables``,
    as this process's rank of the default group when there is one.

    ``batch`` and ``priorities`` are the global batch's; a rank takes its
    rows (with ``space`` > 1: the rows of its data index, and its band of
    their height). Without ``priorities`` the draws come from
    ``train.step_generator``. Returns the metrics of each step, the model
    state after them, and per step the masked means' ``(local, global)``
    denominators.
    """
    rank, world = mesh.world()
    group = dist.group.WORLD if world > 1 else None
    grid = spatial.make_grid(rank, world, space) if space > 1 else None
    rows = (grid.data_index, grid.data) if grid else (rank, world)
    model = load_flax_variables(get_model(config.model.type)(config),
                                variables).to(device)
    set_train_batch_norm(model, (config.model.get("base_network") or {}).get(
        "train_batch_norm"))
    mask = training.build_trainable_mask(model, config.model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    params = dict(model.named_parameters())
    decay = training.build_weight_decay_coefficients(model, config.model)
    optimizer, _ = training.get_optimizer(config.train, params, mask, decay)
    counts = []
    global_count = mesh.global_count

    def recording(count):
        total = global_count(count)
        counts[-1].append((float(count), float(total)))
        return total

    mesh.global_count = recording
    try:
        step = trainer.make_train_step(
            model, optimizer, group=group, grid=grid,
            reg_fn=lambda: training.l2_regularization_loss(params, decay))
        local = mesh.shard_batch(batch, *rows)
        if grid is not None:
            local["image"] = spatial.image_band(local["image"],
                                                grid.space_index, space)
        device_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            device) for k, v in local.items()}
        if priorities is not None:
            priorities = {stage: tuple(mesh.shard_rows(p, *rows)
                                       for p in pair)
                          for stage, pair in priorities.items()}
        metrics = []
        for i in range(steps):
            generator = (None if priorities is not None
                         else trainer.step_generator(SEED, i, device))
            counts.append([])
            out = step(device_batch, i, generator, priorities)
            metrics.append({k: float(v) for k, v in out.items()})
    finally:
        mesh.global_count = global_count
    return {"metrics": metrics, "counts": counts,
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}


def rank_steps(device, jobs, priorities=None, space=1):
    """:func:`port_steps` of each ``(config, variables, batch)`` job as a
    spawned rank, TF32 off (a spawned process starts with PyTorch's
    defaults)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return [port_steps(config, variables, batch, priorities=priorities,
                       device=device, space=space)
            for config, variables, batch in jobs]


def checksum(state):
    """A float64 sum per tensor of a state dict (numpy's, so that it does
    not depend on the thread count)."""
    return {k: float(np.sum(v.detach().cpu().double().numpy()))
            for k, v in state.items()}


def rank_run(device, config, max_steps):
    """``train.run`` as one rank of the spawned group: its step, history
    and state checksums."""
    state = trainer.run(config, max_steps=max_steps, device=device)
    return {"step": state.step, "history": state.history,
            "checksum": checksum(state.model.state_dict())}


def rank_read(device, config, max_steps):
    """``train.run`` as one rank of the spawned group, with a dataset
    that keeps the filenames of each global batch it yields; returns
    those of the first ``max_steps`` batches."""
    read = []

    def recorded_dataset(kind):
        def make(config):
            def batches():
                for batch in get_dataset(kind)(config):
                    read.append(list(batch["filename"]))
                    yield batch
            return batches()
        return make

    trainer.run(config, get_dataset_fn=recorded_dataset,
                max_steps=max_steps, device=device)
    return read[:max_steps]


# ----------------------------------------------------- spatial (bands)

def jax_mesh_config():
    """The JAX package's 2-D mesh test's setting (``tests/test_parallel.py``
    ``test_fasterrcnn_spatial_train_step_matches_single_device``): Faster
    R-CNN ResNet-50 v1, 3 classes, pre/post NMS 64/16, minibatches 16/8,
    plain SGD at 1e-3 on every parameter, no L2 term, no clip."""
    config = torch_config.get_model_config(
        torch_config.get_base_config("fasterrcnn"), Config({
            "train": {"learning_rate": {"learning_rate": 1e-3},
                      "optimizer": {"type": "gradient_descent"}},
            "model": {
                "network": {"num_classes": 3},
                "base_network": {"architecture": "resnet_v1_50",
                                 "fine_tune_from": None,
                                 "arg_scope": {"weight_decay": 0.0}},
                "rpn": {"proposals": {"pre_nms_top_n": 64,
                                      "post_nms_top_n": 16},
                        "target": {"minibatch_size": 16},
                        "l2_regularization_scale": 0.0},
                "rcnn": {"target": {"minibatch_size": 8},
                         "l2_regularization_scale": 0.0},
            }}))
    return config


def jax_mesh_batch():
    """Two 64 x 64 images with the JAX test's two boxes each."""
    rng = np.random.RandomState(2)
    images = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    gt = np.tile(np.asarray([[[5.0, 5, 40, 40, 0], [20, 20, 60, 60, 2]]],
                            np.float32), (2, 1, 1))
    return {"image": images, "gt_boxes": gt}


def band_module(case):
    """The module of a band case, from seed 0: ``TruncatedBaseNetwork`` of
    ``case["config"]`` (batch norms with random running statistics), or
    SSD's feature extractor (``case["ssd"]``), in ``case["dtype"]``."""
    from luminoth_tpu_torch.models.base.base_network import (
        TruncatedBaseNetwork,
    )
    from luminoth_tpu_torch.models.ssd.feature_extractor import (
        SSDFeatureExtractor,
    )

    dtype = getattr(torch, case["dtype"])
    torch.manual_seed(0)
    if case.get("ssd"):
        module = SSDFeatureExtractor(Config({}))
    else:
        module = TruncatedBaseNetwork(Config(case["config"]), dtype=dtype)
    for m in module.modules():
        if hasattr(m, "running_var"):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.5, 1.5)
    return module.to(dtype).train()


def _band_forward(module, case, images):
    dtype = getattr(torch, case["dtype"])
    x = torch.from_numpy(images)
    if case.get("ssd"):  # the extractor takes mean-subtracted NCHW images
        x = (x - torch.tensor([123.68, 116.78, 103.94])).permute(0, 3, 1, 2)
        return list(module(x.to(dtype).contiguous(
            memory_format=torch.channels_last)))
    return [module(x).permute(0, 3, 1, 2)]


def band_case(case, space_index, space):
    """One band case on this rank: the banded forward and backward of
    ``case``'s module on ``case["images"]`` (the leader applies one random
    cotangent per output map, drawn from ``case["seed"]``), then, on the
    leader, the whole image's in this process. Returns (on the leader)
    both outputs and, per parameter, the gradients' largest excess over
    ``case["rtol"]`` times the whole image's gradient, and that gradient's
    largest magnitude; None elsewhere."""
    module = band_module(case)
    params = list(module.parameters())
    names = [n for n, _ in module.named_parameters()]
    band = spatial.image_band(case["images"], space_index, space)
    with spatial.space_shard(space_index, space, dist.group.WORLD, 0):
        outs = _band_forward(module, case, band)
        if spatial.is_follower():
            loss = outs[0].sum() * 0.0
        else:
            rng = np.random.RandomState(case["seed"])
            cots = [torch.from_numpy(rng.randn(*o.shape)).to(o.dtype)
                    for o in outs]
            loss = sum((o * c).sum() for o, c in zip(outs, cots))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    summed = []
    for g, p in zip(grads, params):  # in the parameters' dtype
        g = torch.zeros_like(p) if g is None else g.contiguous()
        dist.all_reduce(g)
        summed.append(g)
    if space_index:
        return None
    whole = _band_forward(module, case, case["images"])
    want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(whole, cots)),
                               params, allow_unused=True)
    excess, scale = {}, {}
    for name, g, w in zip(names, summed, want):
        w = torch.zeros_like(g) if w is None else w
        excess[name] = float(((g - w).abs() - case["rtol"] * w.abs()).max())
        scale[name] = float(w.abs().max())
    return {"out": [o.detach() for o in outs],
            "want": [o.detach() for o in whole],
            "grad_excess": excess, "grad_scale": scale}


@contextlib.contextmanager
def planted_fault(fault):
    """A fault planted in the banded step for the block:
    ``"local_band_statistics"`` normalises each band by its own batch
    moments; None plants nothing."""
    saved = resnet.batch_moments
    if fault == "local_band_statistics":
        resnet.batch_moments = lambda x, dim: (x.mean(dim=dim),
                                               x.square().mean(dim=dim))
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        resnet.batch_moments = saved


def rank_spatial(device, tasks):
    """Each task in a spawned rank of a ``data x space`` grid: ``("band",
    case)`` runs :func:`band_case` (space = the world), ``("steps", config,
    variables, batch, priorities, space, steps[, fault])`` runs
    :func:`port_steps` on that grid, with the :func:`planted_fault`.
    Returns the results in order."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = mesh.world()
    out = []
    for task in tasks:
        if task[0] == "band":
            out.append(band_case(task[1], rank, world))
        else:
            config, variables, batch, priorities, space, steps = task[1:7]
            with planted_fault(task[7] if len(task) > 7 else None):
                out.append(port_steps(config, variables, batch, steps=steps,
                                      priorities=priorities, device=device,
                                      space=space))
    return out
