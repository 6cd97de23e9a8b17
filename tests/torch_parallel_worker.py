"""Rank functions of the port's data-parallel tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_parallel_mesh.py``
run these in processes spawned by ``parallel.distributed.spawn_ranks``
(gloo on the CPU). This module imports the port only: a spawned rank
imports it by name, and JAX would cost each rank seconds and memory.
"""

import numpy as np
import torch
import torch.distributed as dist

from luminoth_tpu_torch import train as trainer
from luminoth_tpu_torch.datasets import get_dataset
from luminoth_tpu_torch.models import get_model
from luminoth_tpu_torch.models.base.resnet import set_train_batch_norm
from luminoth_tpu_torch.parallel import mesh
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
               device="cpu"):
    """``steps`` train steps of the port on ``batch`` from ``variables``,
    as this process's rank of the default group when there is one.

    ``batch`` and ``priorities`` are the global batch's; a rank takes its
    rows. Without ``priorities`` the draws come from
    ``train.step_generator``. Returns the metrics of each step, the model
    state after them, and per step the masked means' ``(local, global)``
    denominators.
    """
    rank, world = mesh.world()
    group = dist.group.WORLD if world > 1 else None
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
            model, optimizer, group=group,
            reg_fn=lambda: training.l2_regularization_loss(params, decay))
        rows = mesh.shard_batch(batch, rank, world)
        device_batch = {k: torch.from_numpy(v).to(device)
                        for k, v in rows.items()}
        if priorities is not None:
            priorities = {stage: tuple(mesh.shard_rows(p, rank, world)
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


def rank_steps(device, jobs, priorities=None):
    """:func:`port_steps` of each ``(config, variables, batch)`` job as a
    spawned rank, TF32 off (a spawned process starts with PyTorch's
    defaults)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return [port_steps(config, variables, batch, priorities=priorities,
                       device=device) for config, variables, batch in jobs]


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
