"""Training loop of the port: train step, device prefetch, checkpoints,
summaries, and the ``train`` command.

Counterpart of the JAX package's ``train.py`` on one CUDA device (or the
CPU, for tests). The step is the JAX ``make_train_step``'s: uint8 images
cast to float on the device, the forward with ground truth, the model's
loss (Faster R-CNN's 4 parts, or SSD's multibox loss: SSD makes no
detections in training and launches no kernel), gradients of the
trainable partition only (frozen parameters have ``requires_grad`` False,
so autograd never enters the frozen early blocks), the pre-clip global gradient norm, and the reported ``total_loss`` with the
L2 term (``no_reg_loss`` without it). Target subsampling and dropout draw
from a ``torch.Generator`` seeded by (``train.seed``, step), so a resumed
run draws what an uninterrupted one would.

    python -m luminoth_tpu_torch.train -c config.yml --max-steps N

Not ported (each raises ``NotImplementedError`` when set): more than one
device (``train.spatial_shards > 1``, a device list, or the
``LUMI_COORDINATOR``/``LUMI_DISTRIBUTED_AUTO`` multi-process environment),
``full_trace``/``save_timeline``, ``tf_debug``, ``remat``,
``base_network.train_batch_norm`` and ``ignore_scope``. The image and
variable summaries (``image_vis``, ``var_vis``) are skipped with a log
line. A logged run appends its line to the run journal
(``utils/experiments.py``, ``runs.json`` in the toolkit's home).
"""

import collections
import dataclasses
import logging
import math
import os
import time
from typing import Any

import click
import numpy as np
import torch

from luminoth_tpu_torch.datasets import get_dataset
from luminoth_tpu_torch.models import get_model
from luminoth_tpu_torch.models.base.base_network import check_trainable_config
from luminoth_tpu_torch.utils.checkpoint_io import CheckpointManager
from luminoth_tpu_torch.utils.config import get_config
from luminoth_tpu_torch.utils.experiments import save_run
from luminoth_tpu_torch.utils.predicting import model_dtype, resolve_device
from luminoth_tpu_torch.utils.training import (
    build_trainable_mask,
    build_weight_decay_coefficients,
    get_optimizer,
    l2_regularization_loss,
)
from luminoth_tpu_torch.utils.weights import (
    flatten_variables,
    init_variables,
    load_flax_variables,
)

logger = logging.getLogger("luminoth_tpu_torch.train")

_DISTRIBUTED_ENV = ("LUMI_COORDINATOR", "LUMI_DISTRIBUTED_AUTO")


@dataclasses.dataclass
class TrainState:
    """What :func:`run` leaves: the step count, the trained model, the
    optimizer, and the metrics of every logged step."""

    step: int
    model: Any
    optimizer: Any
    history: list


def check_config(config):
    """Raise ``NotImplementedError`` for training knobs not ported."""
    train_cfg = config.train
    if int(train_cfg.get("spatial_shards") or 1) > 1:
        raise NotImplementedError(
            "train.spatial_shards > 1 (more than one device) is not ported")
    for knob in ("full_trace", "save_timeline", "tf_debug", "remat",
                 "ignore_scope"):
        if train_cfg.get(knob):
            raise NotImplementedError(f"train.{knob} is not ported")
    check_trainable_config(config.model.get("base_network") or {})
    for name in _DISTRIBUTED_ENV:
        if os.environ.get(name):
            raise NotImplementedError(
                f"multi-process training ({name} is set) is not ported")


def step_generator(seed, step, device):
    """The generator of one step's random draws, from (seed, step)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(
        int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])
    )
    return generator


def make_train_step(model, optimizer, reg_fn=None):
    """The train step over the parameters of ``model`` that require grad.

    Returns ``train_step(batch, step, generator, priorities=None) ->
    metrics``: one forward/backward and one optimizer update (in place).
    ``reg_fn()`` gives the L2 term reported in ``total_loss``.
    """
    params = {name: p for name, p in model.named_parameters()
              if p.requires_grad}

    def train_step(batch, step, generator, priorities=None):
        images = batch["image"]
        if images.dtype == torch.uint8:
            images = images.float()  # the uint8 transfer path
        model.train()
        preds = model(images, gt_boxes=batch["gt_boxes"],
                      im_shape=batch.get("im_shape"), generator=generator,
                      priorities=priorities)
        losses = model.loss(preds, return_all=True)
        grads = torch.autograd.grad(losses["total_loss"],
                                    list(params.values()), allow_unused=True)
        grads = {
            name: torch.zeros_like(p) if g is None else g
            for (name, p), g in zip(params.items(), grads)
        }
        metrics = {name: value.detach() for name, value in losses.items()}
        if reg_fn is not None:
            reg = reg_fn()  # on the parameters before the update
            metrics["reg_loss"] = reg
            metrics["no_reg_loss"] = metrics["total_loss"]
            metrics["total_loss"] = metrics["total_loss"] + reg
        metrics["grad_norm"] = optimizer.step(grads, step)
        return metrics

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


def _summary_writer(run_dir):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logger.info("tensorboardX is not installed: no summaries")
        return None
    return SummaryWriter(run_dir)


def run(config, get_model_fn=get_model, get_dataset_fn=get_dataset,
        environment=None, max_steps=None, device=None):
    """Train a model per config on one device. Returns a :class:`TrainState`.

    ``device``: a torch device (None: the current CUDA device; there is no
    silent CPU fallback, pass ``"cpu"`` explicitly).
    """
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(
                "training on more than one device is not ported")
        device = device[0]
    device = resolve_device(device)
    check_config(config)
    train_cfg = config.train
    model = get_model_fn(config.model.type)(config, dtype=model_dtype(config))
    dataset = get_dataset_fn(config.dataset.type)(config)

    run_dir = os.path.join(train_cfg.get("job_dir", "jobs/"),
                           train_cfg.get("run_name") or "default")
    no_log = bool(train_cfg.get("no_log"))
    batch_iter = iter(dataset)
    first_batch = next(batch_iter)
    batch_size = first_batch["image"].shape[0]
    logger.info("Training on %s, batch %d", device, batch_size)

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

    step = 0
    manager = None
    if not no_log:
        manager = CheckpointManager(
            os.path.join(run_dir, "ckpt"),
            max_to_keep=int(train_cfg.get("checkpoints_max_keep", 1)),
        )
        restored = manager.restore_latest(map_location=device)
        if restored is not None:
            model.load_state_dict(restored["model"])
            optimizer.load_state_dict(restored["optimizer"])
            step = int(restored["step"])
            logger.info("Resumed from step %d", step)

    writer = None
    if not no_log:
        os.makedirs(run_dir, exist_ok=True)
        writer = _summary_writer(run_dir)
    for knob in ("image_vis", "var_vis"):
        if writer is not None and train_cfg.get(knob):
            logger.info("train.%s summaries are not ported: skipped", knob)

    train_step = make_train_step(
        model, optimizer,
        reg_fn=lambda: l2_regularization_loss(params, decay).to(device),
    )

    if not no_log:
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

    def checkpoint():
        return {"step": step, "model": model.state_dict(),
                "optimizer": optimizer.state_dict()}

    try:
        staged = prefetch_to_device(
            (b for b in batches() if b["image"].shape[0] == batch_size),
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

            if max_steps is not None and step >= max_steps:
                break
    except KeyboardInterrupt:
        logger.info("Interrupted at step %d", step)
    finally:
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
