"""Training loop of the port: train step, device prefetch, checkpoints,
summaries, and the ``train`` command.

Counterpart of the JAX package's ``train.py`` on one CUDA device (or the
CPU, for tests), or data-parallel over several. The step is the JAX ``make_train_step``'s: uint8 images
cast to float on the device, the forward with ground truth, the model's
loss (Faster R-CNN's 4 parts, or SSD's multibox loss: SSD makes no
detections in training and launches no kernel), gradients of the
trainable partition only (frozen parameters have ``requires_grad`` False,
so autograd never enters the frozen early blocks), the pre-clip global gradient norm, and the reported ``total_loss`` with the
L2 term (``no_reg_loss`` without it). Target subsampling and dropout draw
from a ``torch.Generator`` seeded by (``train.seed``, step), so a resumed
run draws what an uninterrupted one would.

    python -m luminoth_tpu_torch.train -c config.yml --max-steps N

The JAX package's training knobs: ``model.base_network.train_batch_norm``
(batch-statistics batch norm with running-statistics updates) and
``train.remat`` (per-unit recompute of the trunk, ``models/base/
resnet.py``); ``ignore_scope`` (resume while skipping a scope,
``utils/checkpoint_io.merge_train_state``); ``tf_debug`` (raise at the
first step whose module outputs, losses or gradients hold a non-finite
value, naming it by its flax path); ``full_trace``/``save_timeline`` (a ``torch.profiler``
trace of the first 5 steps in ``run_dir/profile``); and the summaries:
``image_vis`` (a monitor forward in eval mode, rendered by
``utils/image_vis.py``) and ``var_vis`` (parameter statistics under their
flax paths), on ``display_every_steps``/``display_every_secs``. Summaries
are TensorBoard event files written by ``formats/tfevents.py``. A logged
run appends its line to the run journal (``utils/experiments.py``,
``runs.json`` in the toolkit's home).

Data parallelism (``parallel/``): one process per device in a
``torch.distributed`` group, the JAX package's 1-D data mesh. Every rank
reads the same global batch in the same order and trains on its rows; the
step's numbers are the one-process step's on the global batch (global
loss counts, draws and batch statistics, see ``parallel/mesh.py``; summed
gradients, so the clip sees the global norm; the L2 term added once).
Only the chief (rank 0) writes checkpoints, summaries, the monitor
forwards' images, the run journal and the trace; on resume the chief
restores and broadcasts its state. Groups form from ``run(device=[d0,
d1, ...])`` (one spawned rank per device, as many as divide the batch; by
default every visible CUDA device), or from the ``LUMI_COORDINATOR``/
``LUMI_DISTRIBUTED_AUTO`` environment of a launcher that starts the ranks
itself (``parallel/distributed.py``).

``train.spatial_shards: N`` (``parallel/spatial.py``) is the JAX
package's 2-D ``(data, space)`` mesh: the ranks form a grid of ``data x
N``, rank ``r`` training band ``r % N`` of the height of row block ``r //
N`` of the global batch. Each band runs the trunk with halo exchanges; the
band's first rank (the leader) gathers the map and runs the head and the
loss; the gradients are summed over every rank. ``data`` is the largest
count, at most ``ranks / N``, that divides the batch (a device list that
``N`` does not divide, or a canvas height that ``N`` does not divide,
raises ``ValueError``, as in the JAX package).
"""

import collections
import contextlib
import copy
import dataclasses
import logging
import math
import os
import time
from typing import Any

import click
import numpy as np
import torch
import torch.distributed as dist

from luminoth_tpu_torch.datasets import get_dataset
from luminoth_tpu_torch.models import get_model
from luminoth_tpu_torch.formats.tfevents import SummaryWriter
from luminoth_tpu_torch.parallel import spatial
from luminoth_tpu_torch.parallel.distributed import (
    initialize_from_env,
    local_device,
    requested,
    shared_seed,
    spawn_ranks,
    sync_state_from_chief,
)
from luminoth_tpu_torch.parallel.mesh import (
    all_reduce_tensors,
    batch_shard,
    data_parallel_count,
    shard_batch,
    world,
)
from luminoth_tpu_torch.utils.checkpoint_io import CheckpointManager
from luminoth_tpu_torch.utils.config import get_config
from luminoth_tpu_torch.utils.experiments import save_run
from luminoth_tpu_torch.utils.hooks import ImageVisHook, VarVisHook
from luminoth_tpu_torch.utils.predicting import model_dtype, resolve_device
from luminoth_tpu_torch.utils.training import (
    build_trainable_mask,
    build_weight_decay_coefficients,
    get_optimizer,
    l2_regularization_loss,
)
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    flax_paths,
    init_variables,
    load_flax_variables,
)

logger = logging.getLogger("luminoth_tpu_torch.train")

TRACE_STEPS = 5  # full_trace/save_timeline: the steps traced


@dataclasses.dataclass
class TrainState:
    """What :func:`run` leaves: the step count, the trained model, the
    optimizer, and the metrics of every logged step."""

    step: int
    model: Any
    optimizer: Any
    history: list


def spatial_shards(config):
    """``train.spatial_shards`` (1 when unset); ``ValueError`` below 1."""
    space = int(config.train.get("spatial_shards") or 1)
    if space < 1:
        raise ValueError(f"train.spatial_shards must be at least 1, got "
                         f"{space}")
    return space


def check_canvas(config, space):
    """``ValueError`` unless every canvas height of the dataset splits in
    ``space`` bands."""
    from luminoth_tpu_torch.datasets.object_detection_dataset import (
        canvas_buckets,
    )

    for height, _ in canvas_buckets(config):
        spatial.split_height(height, space)


def step_generator(seed, step, device):
    """The generator of one step's random draws, from (seed, step)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(
        int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])
    )
    return generator


def _first_non_finite(named, paths):
    return next((paths.get(name, name) for name, t in named
                 if not bool(torch.isfinite(t).all())), None)


def check_finite(step, losses, grads, model):
    """``tf_debug``: raise ``FloatingPointError`` when a loss or a gradient
    of ``step`` holds a non-finite value, naming the non-finite losses and
    the first non-finite gradient by its flax path. One device-to-host
    read per step."""
    tensors = list(losses.values()) + list(grads.values())
    if bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all()):
        return
    bad_losses = [name for name, t in losses.items()
                  if not bool(torch.isfinite(t).all())]
    raise FloatingPointError(
        f"tf_debug: non-finite value at step {step}: losses {bad_losses}, "
        f"first non-finite gradient "
        f"{_first_non_finite(grads.items(), flax_paths(model))}")


def watch_outputs(model, step_of):
    """``tf_debug`` in the forward: a hook on every module that holds
    parameters raises ``FloatingPointError`` at the first module whose
    output is non-finite (the JAX ``jax_debug_nans`` stops at the first
    operation that makes a NaN), naming the module by its flax path, the
    step (``step_of()``) and the first non-finite parameter. Reads one flag
    per module from the device. Returns the hook handles."""
    paths = flax_paths(model)
    module_names = {module: name for name, module in model.named_modules()
                    if any(True for _ in module.parameters(recurse=False))}

    def hook(module, inputs, output):
        if not torch.is_tensor(output) or bool(torch.isfinite(output).all()):
            return
        name = module_names[module]
        scope = next((paths[k].rsplit("/", 1)[0] for k in paths
                      if k.startswith(name + ".")), name)
        raise FloatingPointError(
            f"tf_debug: non-finite output of {scope} at step {step_of()}; "
            f"first non-finite parameter "
            f"{_first_non_finite(model.named_parameters(), paths)}")

    return [module.register_forward_hook(hook) for module in module_names]


def make_train_step(model, optimizer, reg_fn=None, debug_nans=False,
                    group=None, grid=None):
    """The train step over the parameters of ``model`` that require grad.

    Returns ``train_step(batch, step, generator, priorities=None) ->
    metrics``: one forward/backward and one optimizer update (in place).
    ``reg_fn()`` gives the L2 term reported in ``total_loss``. With a
    process ``group`` of more than one rank, ``batch`` is this rank's rows
    of the global batch: the forward, loss and backward run inside
    :func:`~luminoth_tpu_torch.parallel.mesh.batch_shard`, then the
    gradients and the losses are summed over the group in one all-reduce
    (only the parameters that require grad take part), so the update, the
    clip's norm and the metrics are the global batch's. With
    ``debug_nans`` (``tf_debug``) a step raises ``FloatingPointError``
    before its update at the first non-finite module output
    (:func:`watch_outputs`, whose hooks ``train_step.debug_hooks`` holds),
    loss or gradient (:func:`check_finite`).

    With a spatial ``grid`` (a ``parallel/spatial.Grid`` laid over
    ``group``; its space and leaders' groups are made here, by every
    rank), ``batch["image"]`` is this rank's band of its rows: the forward
    runs under the band, the batch statistics sum over every rank, the
    leaders' loss counts and draws are those of the data axis, and the
    gradients and losses are summed over ``group`` (every rank).
    """
    params = {name: p for name, p in model.named_parameters()
              if p.requires_grad}
    current = [0]
    rank, world_size = ((dist.get_rank(group), dist.get_world_size(group))
                        if group is not None else (0, 1))
    group = group if world_size > 1 else None
    band = contextlib.nullcontext
    if grid is not None and grid.space > 1:
        space_group, leaders, leader = spatial.grid_groups(grid, group)
        rank, world_size = grid.data_index, grid.data
        shard_group = leaders if grid.is_leader and grid.data > 1 else None

        def band():
            return spatial.space_shard(grid.space_index, grid.space,
                                       space_group, leader,
                                       statistics=group)
    else:
        shard_group = group

    def train_step(batch, step, generator, priorities=None):
        current[0] = step + 1
        images = batch["image"]
        if images.dtype == torch.uint8:
            images = images.float()  # the uint8 transfer path
        model.train()
        with batch_shard(rank, world_size, shard_group), band():
            preds = model(images, gt_boxes=batch["gt_boxes"],
                          im_shape=batch.get("im_shape"),
                          generator=generator, priorities=priorities)
            losses = model.loss(preds, return_all=True)
            grads = (None,) * len(params)
            if losses["total_loss"].requires_grad:
                grads = torch.autograd.grad(losses["total_loss"],
                                            list(params.values()),
                                            allow_unused=True)
        grads = {
            name: torch.zeros_like(p) if g is None else g
            for (name, p), g in zip(params.items(), grads)
        }
        metrics = {name: value.detach() for name, value in losses.items()}
        if group is not None:
            # Each rank's loss is its share of the global loss: sum.
            summed = all_reduce_tensors(
                list(grads.values()) + list(metrics.values()), group)
            grads = dict(zip(grads, summed[:len(grads)]))
            metrics = dict(zip(metrics, summed[len(grads):]))
        if debug_nans:
            check_finite(step + 1, metrics, grads, model)
        if reg_fn is not None:
            reg = reg_fn()  # on the parameters before the update
            metrics["reg_loss"] = reg
            metrics["no_reg_loss"] = metrics["total_loss"]
            metrics["total_loss"] = metrics["total_loss"] + reg
        metrics["grad_norm"] = optimizer.step(grads, step)
        return metrics

    # The forward hooks of tf_debug; remove them to stop the checks.
    train_step.debug_hooks = (watch_outputs(model, lambda: current[0])
                              if debug_nans else [])
    return train_step


def _device_batch(batch, device):
    out = {}
    for key in ("image", "gt_boxes", "im_shape"):
        if key in batch:
            tensor = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if device.type == "cuda":
                tensor = tensor.pin_memory()
            out[key] = tensor.to(device, non_blocking=True)
    return out


def prefetch_to_device(batch_iter, device, depth=2):
    """Yield ``(host_batch, device_batch)`` with ``depth`` uploads in flight.

    Host arrays go through pinned memory and ``non_blocking`` copies, so
    batch k+1's upload overlaps step k on the card.
    """
    buf = collections.deque()
    it = iter(batch_iter)
    exhausted = False
    while True:
        while not exhausted and len(buf) < depth:
            try:
                batch = next(it)
            except StopIteration:
                exhausted = True
                break
            buf.append((batch, _device_batch(batch, device)))
        if not buf:
            return
        yield buf.popleft()


def load_pretrained_backbone(variables, config):
    """Merge ``base_network.weights`` (flat flax ``.npz``) into flat
    ``variables``: paths present with the same shape are replaced, others
    skipped, as the JAX package's ``merge_flat_params`` does.

    A file stamped with a stride layout (``__meta__/layout``) must match
    the config: torchvision-layout ResNet weights need
    ``torchvision_compat: True`` and slim-layout ones must not have it;
    a mismatch raises ``ValueError``, as in the JAX package.
    """
    weights_file = config.model.base_network.get("weights")
    if not weights_file:
        return variables
    flat = flatten_variables(weights_file)
    layout = str(flat.pop("__meta__/layout", ""))
    compat = config.model.base_network.get("torchvision_compat")
    if layout == "torchvision" and not compat:
        raise ValueError(
            f"{weights_file} holds torchvision-layout ResNet weights "
            "(stride on the first unit of each stage); set "
            "model.base_network.torchvision_compat: True so the network "
            "computes the features these weights were trained for."
        )
    if layout == "slim" and compat:
        raise ValueError(
            f"{weights_file} holds slim-layout ResNet weights (stride on "
            "the last unit of each block); remove "
            "model.base_network.torchvision_compat from the config."
        )
    if not any(k.startswith(("params/", "batch_stats/")) for k in flat):
        flat = {f"params/{k}": v for k, v in flat.items()}  # un-prefixed
    merged = dict(variables)
    loaded = 0
    for key, value in flat.items():
        if key in merged and merged[key].shape == value.shape:
            merged[key] = np.asarray(value, np.float32)
            loaded += 1
    logger.info("Loaded %d arrays from %s", loaded, weights_file)
    return merged


def monitor_forward(model, device_batch):
    """The image-vis hook's forward: the model in eval mode (the JAX
    ``train=False``: running statistics, detections made), with the ground
    truth and no gradients; the model goes back to training after."""
    images = device_batch["image"]
    if images.dtype == torch.uint8:
        images = images.float()
    model.eval()
    try:
        with torch.no_grad():
            return model(images, gt_boxes=device_batch["gt_boxes"],
                         im_shape=device_batch.get("im_shape"))
    finally:
        model.train()


def _start_trace(trace_dir, device):
    """A ``torch.profiler`` trace (CPU, and CUDA on the card) written to
    ``trace_dir`` as a Chrome trace when it stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir))
    trace.start()
    logger.info("Profiler trace started → %s", trace_dir)
    return trace


def build_model_and_optimizer(config, get_model_fn, device):
    """The model with its initial weights (``train.seed``, then
    ``base_network.weights``) on ``device``, frozen per ``fine_tune_from``,
    and its optimizer. Returns ``(model, optimizer, lr_schedule,
    params, decay)``."""
    train_cfg = config.train
    model = get_model_fn(config.model.type)(config, dtype=model_dtype(config))
    seed = int(train_cfg.get("seed") or 0)
    variables = load_pretrained_backbone(
        flatten_variables(init_variables(config, seed)), config)
    model = load_flax_variables(model, variables).to(device)
    trainable_mask = build_trainable_mask(model, config.model)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable_mask[name])
    decay = build_weight_decay_coefficients(model, config.model)
    params = dict(model.named_parameters())
    optimizer, lr_schedule = get_optimizer(
        train_cfg, params, trainable_mask=trainable_mask, weight_decay=decay)
    return model, optimizer, lr_schedule, params, decay


def run(config, get_model_fn=get_model, get_dataset_fn=get_dataset,
        environment=None, max_steps=None, device=None, backend=None):
    """Train a model per config. Returns a :class:`TrainState`.

    ``device``: a torch device (None: the current CUDA device, or every
    visible one when there are several; there is no silent CPU fallback,
    pass ``"cpu"`` explicitly), or a list of devices: one spawned rank
    per device, as many as divide ``train.batch_size``, and the chief's
    state is returned. Under the ``LUMI_COORDINATOR`` or
    ``LUMI_DISTRIBUTED_AUTO`` environment this process joins that group as
    one rank. ``backend`` names the ``torch.distributed`` backend (default
    NCCL on CUDA, gloo on the CPU). With ``train.spatial_shards: N`` the
    ranks form a ``data x N`` grid (``N`` must divide the device count and
    every canvas height, else ``ValueError``).
    """
    space = spatial_shards(config)
    if (device is None and not requested()
            and torch.cuda.is_available() and torch.cuda.device_count() > 1):
        device = [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())]
    if space > 1 and not requested() and not dist.is_initialized():
        devices = list(device) if isinstance(device, (list, tuple)) else [
            device]
        grid = spatial.make_grid(0, len(devices), space)
        check_canvas(config, space)
        data = data_parallel_count(int(config.train.get("batch_size") or 1),
                                   grid.data)
        return _run_spawned(config, devices[:data * space], get_model_fn,
                            get_dataset_fn, environment, max_steps, backend)
    if isinstance(device, (list, tuple)):
        count = data_parallel_count(
            int(config.train.get("batch_size") or 1), len(device))
        if count > 1:
            return _run_spawned(config, list(device)[:count], get_model_fn,
                                get_dataset_fn, environment, max_steps,
                                backend)
        device = device[0]
    if device is None:
        device = local_device()
    device = resolve_device(device)
    formed = initialize_from_env(device=device, backend=backend)
    try:
        return _train(config, get_model_fn, get_dataset_fn, environment,
                      max_steps, device)
    finally:
        if formed:
            dist.destroy_process_group()


def _rank_train(device, config, get_model_fn, get_dataset_fn, environment,
                max_steps):
    """One spawned rank of :func:`run`: train; the chief hands back its
    state (the other ranks hold the same)."""
    state = _train(config, get_model_fn, get_dataset_fn, environment,
                   max_steps, device)
    if dist.get_rank() != 0:
        return None
    optimizer = state.optimizer.state_dict()
    return {
        "step": state.step, "history": state.history,
        "model": {k: v.cpu() for k, v in state.model.state_dict().items()},
        "optimizer": {"count": optimizer["count"], "slots": {
            name: {slot: v.cpu() for slot, v in slots.items()}
            for name, slots in optimizer["slots"].items()}},
    }


def _run_spawned(config, devices, get_model_fn, get_dataset_fn, environment,
                 max_steps, backend):
    """:func:`run` over ``devices``, one spawned rank each; the chief's
    model and optimizer are loaded on ``devices[0]`` here."""
    devices = [torch.device(d) for d in devices]
    logger.info("Training data-parallel over %d ranks: %s", len(devices),
                ", ".join(map(str, devices)))
    threads = None
    if devices[0].type == "cpu":  # the ranks share the host's cores
        threads = min(2, max(1, torch.get_num_threads() // len(devices)))
    result = spawn_ranks(
        _rank_train, devices, backend=backend, threads=threads,
        args=(config, get_model_fn, get_dataset_fn, environment,
              max_steps))[0]
    model, optimizer, _, _, _ = build_model_and_optimizer(
        config, get_model_fn, devices[0])
    model.load_state_dict(result["model"])
    optimizer.load_state_dict(result["optimizer"])
    return TrainState(step=result["step"], model=model, optimizer=optimizer,
                      history=result["history"])


def _train(config, get_model_fn, get_dataset_fn, environment, max_steps,
           device):
    """The training loop on ``device``, as one rank of the process group
    when there is one."""
    train_cfg = config.train
    if train_cfg.get("remat"):
        # The per-unit recompute of the trunk. The JAX package also wraps
        # the whole loss in jax.checkpoint, which changes no number; the
        # port does not copy it.
        config.model.base_network.remat = True
    rank, world_size = world()
    chief = rank == 0
    dataset_config = config
    if world_size > 1 and train_cfg.get("seed") is None:
        # Unseeded, each rank would shuffle from its own entropy and read
        # other batches: the ranks share the chief's draw instead.
        dataset_config = copy.deepcopy(config)
        dataset_config.train.seed = shared_seed(device)
    dataset = get_dataset_fn(config.dataset.type)(dataset_config)
    group = dist.group.WORLD if world_size > 1 else None
    space = spatial_shards(config)
    grid = spatial.make_grid(rank, world_size, space) if space > 1 else None
    rows = (grid.data_index, grid.data) if grid else (rank, world_size)

    run_dir = os.path.join(train_cfg.get("job_dir", "jobs/"),
                           train_cfg.get("run_name") or "default")
    no_log = bool(train_cfg.get("no_log"))
    batch_iter = iter(dataset)
    first_batch = next(batch_iter)
    batch_size = first_batch["image"].shape[0]
    if batch_size % rows[1]:
        raise ValueError(f"a global batch of {batch_size} does not split "
                         f"over {rows[1]} ranks")
    if grid is not None:
        spatial.split_height(first_batch["image"].shape[1], space)
        logger.info("Training on %s, batch %d (rank %d of %d: %d data x %d "
                    "space)", device, batch_size, rank, world_size,
                    grid.data, space)
    else:
        logger.info("Training on %s, batch %d (rank %d of %d)", device,
                    batch_size, rank, world_size)

    seed = int(train_cfg.get("seed") or 0)
    model, optimizer, lr_schedule, params, decay = (
        build_model_and_optimizer(config, get_model_fn, device))

    step = 0

    def checkpoint():
        return {"step": step, "model": model.state_dict(),
                "optimizer": optimizer.state_dict()}

    manager = None
    if not no_log and chief:
        manager = CheckpointManager(
            os.path.join(run_dir, "ckpt"),
            max_to_keep=int(train_cfg.get("checkpoints_max_keep", 1)),
        )
        restored = manager.restore_latest(
            map_location=device, template=checkpoint(),
            paths=flax_paths(model),
            ignore_scope=train_cfg.get("ignore_scope"))
        if restored is not None:
            model.load_state_dict(restored["model"])
            optimizer.load_state_dict(restored["optimizer"])
            step = int(restored["step"])
            logger.info("Resumed from step %d", step)
    if world_size > 1:
        step = sync_state_from_chief(model, optimizer, step)

    writer = None
    if not no_log and chief:
        os.makedirs(run_dir, exist_ok=True)
        writer = SummaryWriter(run_dir)

    train_step = make_train_step(
        model, optimizer,
        reg_fn=lambda: l2_regularization_loss(params, decay).to(device),
        debug_nans=bool(train_cfg.get("tf_debug")),
        group=group, grid=grid,
    )

    vis_hook = var_hook = None
    if writer is not None and train_cfg.get("image_vis"):
        variances = config.model.get("variances") or (
            config.model.get("rcnn") or {}).get(
                "target_normalization_variances")
        vis_hook = ImageVisHook(
            writer, config.model.type,
            image_vis_mode=train_cfg.get("image_vis"),
            every_secs=train_cfg.get("display_every_secs"),
            every_steps=train_cfg.get("display_every_steps"),
            variances=tuple(variances) if variances else None,
        )
    if writer is not None and train_cfg.get("var_vis"):
        var_hook = VarVisHook(
            writer, mode=train_cfg.get("var_vis"),
            every_secs=train_cfg.get("display_every_secs") or 300,
            every_steps=train_cfg.get("display_every_steps"),
        )

    if not no_log and chief:
        try:
            save_run(config, environment=environment)
        except Exception:
            pass

    save_secs = train_cfg.get("save_checkpoint_secs") or 600
    summary_secs = train_cfg.get("save_summaries_secs") or 30
    summary_steps = train_cfg.get("save_summaries_steps")
    log_every = int(train_cfg.get("log_every_steps") or 1)
    last_save = last_summary = time.time()
    timed = device.type == "cuda"
    history = []

    def batches():
        yield first_batch
        yield from batch_iter

    trace = None
    if chief and (train_cfg.get("full_trace")
                  or train_cfg.get("save_timeline")):
        trace = _start_trace(os.path.join(run_dir, "profile"), device)
        trace_stop_step = step + TRACE_STEPS

    def local(batch):
        """This rank's rows (and band) of a global batch; a band keeps its
        rows' whole images for the monitor forward."""
        if rows[1] > 1:
            batch = shard_batch(batch, *rows)
        if grid is not None:
            batch = dict(batch, whole_image=batch["image"],
                         image=spatial.image_band(batch["image"],
                                                  grid.space_index, space))
        return batch

    try:
        staged = prefetch_to_device(
            (local(b) for b in batches()
             if b["image"].shape[0] == batch_size),
            device,
        )
        for batch, device_batch in staged:
            t0 = time.time()
            if timed:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record()
            metrics = train_step(device_batch, step,
                                 step_generator(seed, step, device))
            if timed:
                events[1].record()
            step += 1

            # Reading the loss waits for the device: only on the cadence.
            if step % log_every == 0:
                values = {k: float(v) for k, v in metrics.items()}
                if not math.isfinite(values["total_loss"]):
                    raise FloatingPointError(
                        f"non-finite loss at step {step}: "
                        f"{values['total_loss']}")
                if timed:
                    values["device_ms"] = events[0].elapsed_time(events[1])
                values["step"] = step
                history.append(values)
                logger.info(
                    "step: %d, file: %s, train_loss: %.4f, in %.2fs",
                    step, batch.get("filename", [""])[0],
                    values["total_loss"], time.time() - t0,
                )

            if writer is not None and (
                (summary_steps and step % summary_steps == 0)
                or (not summary_steps
                    and time.time() - last_summary > summary_secs)
            ):
                for name, value in metrics.items():
                    writer.add_scalar(f"losses/{name}", float(value), step)
                writer.add_scalar("training/learning_rate",
                                  lr_schedule(step), step)
                writer.flush()
                last_summary = time.time()

            if manager is not None and time.time() - last_save > save_secs:
                manager.save(checkpoint(), step)
                last_save = time.time()

            if vis_hook is not None and vis_hook.should_trigger(step):
                if grid is not None:  # the chief's rows, whole
                    batch = dict(batch, image=batch.pop("whole_image"))
                    device_batch = _device_batch(batch, device)
                vis_hook.after_step(step, batch,
                                    monitor_forward(model, device_batch))
            if var_hook is not None:
                var_hook.after_step(step, model)

            if trace is not None and step >= trace_stop_step:
                trace.stop()
                logger.info("Profiler trace saved to %s",
                            os.path.join(run_dir, "profile"))
                trace = None

            if max_steps is not None and step >= max_steps:
                break
    except KeyboardInterrupt:
        logger.info("Interrupted at step %d", step)
    finally:
        for hook in train_step.debug_hooks:
            hook.remove()
        if trace is not None:
            trace.stop()
        if manager is not None and step > 0:
            manager.save(checkpoint(), step)
        if writer is not None:
            writer.close()

    return TrainState(step=step, model=model, optimizer=optimizer,
                      history=history)


@click.command(help="Train models")
@click.option(
    "config_files", "--config", "-c", required=True, multiple=True,
    help="Config to use.")
@click.option("--job-dir", help="Job directory.")
@click.option(
    "override_params", "--override", "-o", multiple=True,
    help="Override model config params.")
@click.option(
    "--max-steps", type=int, default=None,
    help="Stop after this many steps (default: run all epochs).")
@click.option(
    "--device", default=None,
    help="Torch device (default: the current CUDA device).")
def train(config_files, job_dir, override_params, max_steps, device):
    """The port's ``lumi train``."""
    logging.basicConfig(level=logging.INFO)
    config = get_config(list(config_files), override_params=override_params)
    if job_dir:
        config.train.job_dir = job_dir
    run(config, max_steps=max_steps, device=device)


if __name__ == "__main__":
    train()
