"""Multi-process runtime of the port: the ``LUMI_*`` environment protocol,
process groups, per-device rank spawning and the chief's state broadcast.

Counterpart of the JAX package's ``parallel/distributed.py``. JAX joins
one coordination service and sees every host's devices; the PyTorch idiom
is one process per GPU in a ``torch.distributed`` group. Two ways in:

* ``LUMI_COORDINATOR=host:port`` with ``LUMI_NUM_PROCESSES`` and
  ``LUMI_PROCESS_ID``: explicit wiring, ``init_method="tcp://host:port"``;
* ``LUMI_DISTRIBUTED_AUTO=1``: the wiring a GPU cluster's launcher
  (``torchrun``, a scheduler) puts in ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK`` (``env://``), as the
  TPU metadata server gives it to JAX.

The backend is NCCL for CUDA devices and gloo for the CPU, unless the
caller names it (gloo also reduces CUDA tensors, which lets two ranks
share one GPU, which NCCL refuses).

Either way the group holds every rank; with ``train.spatial_shards: N``
``train.run`` lays the JAX package's ``(data, space)`` grid over it
(``parallel/spatial.make_grid``: rank ``r`` is band ``r % N`` of row block
``r // N``), so a launcher starts ``data x N`` processes.
"""

import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist

ENV_COORDINATOR = "LUMI_COORDINATOR"
ENV_NUM_PROCESSES = "LUMI_NUM_PROCESSES"
ENV_PROCESS_ID = "LUMI_PROCESS_ID"
ENV_AUTO = "LUMI_DISTRIBUTED_AUTO"


def default_backend(device):
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def requested(environ=None):
    """Whether the environment asks for a multi-process run."""
    environ = os.environ if environ is None else environ
    return bool(environ.get(ENV_COORDINATOR)) or environ.get(
        ENV_AUTO, "").lower() in ("1", "true", "yes")


def local_device(environ=None):
    """The CUDA device of this process under ``LUMI_DISTRIBUTED_AUTO``
    (``LOCAL_RANK``), or None."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_AUTO, "").lower() in ("1", "true", "yes") and (
            "LOCAL_RANK" in environ and torch.cuda.is_available()):
        return torch.device("cuda", int(environ["LOCAL_RANK"]))
    return None


def initialize_from_env(environ=None, device="cpu", backend=None):
    """Join the process group when the environment asks for it.

    Returns True if ``init_process_group`` ran here, False when the
    environment selects a single process or a group already exists. A
    group that fails to form raises; there is no single-process fallback.
    """
    environ = os.environ if environ is None else environ
    if not requested(environ) or dist.is_initialized():
        return False
    backend = backend or default_backend(device)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    coordinator = environ.get(ENV_COORDINATOR)
    if coordinator:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=int(environ.get(ENV_NUM_PROCESSES, "1")),
            rank=int(environ.get(ENV_PROCESS_ID, "0")),
        )
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in environ]
        if missing:
            raise RuntimeError(f"{ENV_AUTO} is set but the launcher gave "
                               f"no {', '.join(missing)}")
        for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.setdefault(key, environ[key])
        dist.init_process_group(
            backend, init_method="env://",
            world_size=int(environ["WORLD_SIZE"]),
            rank=int(environ["RANK"]),
        )
    return True


def sync_state_from_chief(model, optimizer=None, step=0):
    """Broadcast rank 0's parameters, buffers (running statistics),
    optimizer slots and update count, and step; returns the step.

    Only the chief restores a checkpoint (no shared filesystem is
    assumed), so after a restart the other ranks still hold the fresh
    init; replicated weights must be equal everywhere, and so must the
    step, or the ranks' epochs end apart and the next collective hangs.
    No-op without a group.
    """
    if not (dist.is_available() and dist.is_initialized()):
        return step
    with torch.no_grad():
        for tensor in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(tensor.data, src=0)
        if optimizer is not None:
            for slots in optimizer.slots.values():
                for tensor in slots.values():
                    dist.broadcast(tensor, src=0)
        device = next(model.parameters()).device
        counters = torch.tensor(
            [int(step), int(getattr(optimizer, "count", 0))],
            dtype=torch.int64, device=device)
        dist.broadcast(counters, src=0)
    if optimizer is not None:
        optimizer.count = int(counters[1])
    return int(counters[0])


def shared_seed(device):
    """A seed drawn on the chief from the OS's entropy and broadcast, so
    that every rank seeds alike what a config leaves unseeded (the
    dataset's shuffle: each rank must read the same global batches)."""
    value = torch.tensor([int.from_bytes(os.urandom(4), "little") % 2**31],
                         dtype=torch.int64, device=device)
    dist.broadcast(value, src=0)
    return int(value)


def worker_env(coordinator_host, coordinator_port, num_processes, process_id):
    """The env assignments a launcher must set on worker `process_id`."""
    return {
        ENV_COORDINATOR: f"{coordinator_host}:{coordinator_port}",
        ENV_NUM_PROCESSES: str(num_processes),
        ENV_PROCESS_ID: str(process_id),
    }


def worker_env_auto():
    """The env of a worker whose launcher sets ``RANK``/``WORLD_SIZE``/
    ``MASTER_ADDR``/``MASTER_PORT``/``LOCAL_RANK`` itself."""
    return {ENV_AUTO: "1"}


def free_port():
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, devices, backend, port, threads, out_dir, args):
    if threads:
        torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or default_backend(device),
        init_method=f"tcp://127.0.0.1:{port}",
        world_size=len(devices), rank=rank)
    try:
        torch.save(fn(device, *args),
                   os.path.join(out_dir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, devices, args=(), backend=None, threads=None,
                timeout=None):
    """Run ``fn(device, *args)`` in one spawned process per entry of
    ``devices``, as the ranks of a fresh process group on a free local
    port; returns the ranks' results (``torch.save``-able), by rank.

    ``fn`` must be importable by the spawned processes (a module-level
    function). ``threads`` caps each rank's torch threads. The join waits
    for as long as the ranks run, or at most ``timeout`` seconds when one
    is given. A rank that raises, or a join past its timeout, raises here
    (the ranks are killed); nothing falls back to one process.
    """
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        context = mp.start_processes(
            _rank_main,
            args=(fn, [str(d) for d in devices], backend, free_port(),
                  threads, out_dir, tuple(args)),
            nprocs=len(devices), join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not context.join(timeout=None if deadline is None else
                                   max(deadline - time.monotonic(), 0.0)):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{len(devices)} ranks did not "
                                       f"finish in {timeout} s")
        finally:
            for process in context.processes:
                if process.is_alive():
                    process.kill()
                    process.join()
        return [torch.load(os.path.join(out_dir, f"result_{rank}.pt"),
                           weights_only=False)
                for rank in range(len(devices))]
