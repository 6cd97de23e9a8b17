"""Static-shape greedy non-maximum suppression, grouped.

Counterpart of ``luminoth_tpu/ops/nms.py``. Candidates are sorted by score
(descending, stable), the greedy alive mask is computed over the sorted
order, and the survivors come out as fixed-size padded ``(indices,
keep_mask)`` pairs. The alive mask is the work of kernel K1
(``csrc/nms.cu``) for CUDA tensors and of :func:`nms_alive_reference`, the
tiled fixpoint of the JAX package's ``_alive_sorted_xla``, for CPU tensors.

Every descending selection here goes through :func:`top_k`, which keeps
ties in ascending index order as ``jax.lax.top_k`` does: the RPN scores of
a bf16 model tie often, and the order of ties decides which proposals
survive.
"""

import ctypes

import torch

from luminoth_tpu_torch import _build
from luminoth_tpu_torch.ops.boxes import iou_matrix
from luminoth_tpu_torch.ops.dispatch import use_kernel

NEG_INF = -1e37


def top_k(values, k):
    """``(values, indices)`` of the k largest along the last axis.

    Ties keep ascending index order (the order of ``jax.lax.top_k`` and of
    a stable descending argsort); ``torch.topk`` promises no tie order on
    CUDA.
    """
    sorted_values, order = torch.sort(values, dim=-1, descending=True,
                                      stable=True)
    return sorted_values[..., :k], order[..., :k]


def _self_suppression(iou_mask, alive0):
    """Greedy survivors within one tile, for a batch of groups.

    ``iou_mask``: (G, T, T) bool, strictly upper-triangular ``iou >
    threshold`` (row suppresses column). ``alive0``: (G, T) bool.
    """
    alive = alive0
    while True:
        killed = torch.any(iou_mask & alive[:, :, None], dim=1)
        new_alive = alive0 & ~killed
        if torch.equal(new_alive, alive):
            return alive
        alive = new_alive


def _default_block(n):
    if n >= 4096:
        return 512
    if n >= 1024:
        return 256
    return min(128, n)


def nms_alive_reference(boxes, valid, iou_threshold, max_survivors=0,
                        block_size=None):
    """Plain PyTorch greedy alive mask over score-sorted groups.

    The partitioned sweep of the JAX package's ``_alive_sorted_xla``: each
    tile of ``block_size`` candidates resolves its own greedy recursion by
    fixpoint, then its survivors suppress every later candidate. Exact at
    every position (``max_survivors`` is accepted for the kernel's
    signature and not used).

    Args:
        boxes: (G, N, 4) float32 boxes, score-sorted per group.
        valid: (G, N) bool.
    Returns:
        (G, N) bool alive mask.
    """
    del max_survivors
    g, n = valid.shape
    block = min(block_size or _default_block(n), n)
    num_blocks = -(-n // block)
    pad = num_blocks * block - n
    boxes = boxes.float()
    if pad:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    alive = valid.clone()
    tri = torch.triu(
        torch.ones(block, block, dtype=torch.bool, device=boxes.device), 1
    )
    for i in range(num_blocks):
        start, stop = i * block, (i + 1) * block
        tile_boxes = boxes[:, start:stop]
        tile_iou = iou_matrix(tile_boxes, tile_boxes, offset=0.0)
        tile_alive = _self_suppression(
            (tile_iou > iou_threshold) & tri, alive[:, start:stop]
        )
        alive[:, start:stop] = tile_alive
        if stop < alive.shape[1]:
            cross_iou = iou_matrix(tile_boxes, boxes[:, stop:], offset=0.0)
            suppress = torch.any(
                (cross_iou > iou_threshold) & tile_alive[:, :, None], dim=1
            )
            alive[:, stop:] &= ~suppress
    return alive[:, :n]


def _configure_nms(lib):
    lib.lumi_nms_alive.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.lumi_nms_alive.restype = ctypes.c_int
    lib.lumi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lumi_cuda_error_string.restype = ctypes.c_char_p


def nms_alive_cuda(boxes, valid, iou_threshold, max_survivors=0):
    """Kernel K1: greedy alive mask over score-sorted groups, on the GPU.

    Same arguments and result as :func:`nms_alive_reference`; with
    ``max_survivors > 0`` only the ``max_survivors`` first alive entries of
    each group are guaranteed (the exact prefix early exit).
    """
    if not (boxes.is_cuda and valid.is_cuda):
        raise ValueError("nms_alive_cuda takes CUDA tensors")
    if boxes.device != valid.device:
        raise ValueError("boxes and valid lie on different devices")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"nms_alive_cuda takes float32 boxes and bool valid, got "
            f"{boxes.dtype} and {valid.dtype}"
        )
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or (
        tuple(valid.shape) != tuple(boxes.shape[:2])
    ):
        raise ValueError(
            f"expected boxes (G, N, 4) and valid (G, N), got "
            f"{tuple(boxes.shape)} and {tuple(valid.shape)}"
        )
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_alive_cuda takes contiguous tensors")
    g, n = valid.shape
    alive = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    lib = _build.load("nms", _configure_nms)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.lumi_nms_alive(
            boxes.data_ptr(), valid.data_ptr(), alive.data_ptr(), g, n,
            float(iou_threshold), int(max_survivors), stream,
        )
    _build.check_status(lib, status, "nms_alive_cuda")
    nms_alive_cuda.launches += 1
    return alive


nms_alive_cuda.launches = 0


def nms_alive(boxes, valid, iou_threshold, max_survivors=0):
    """Greedy alive mask: kernel K1 on CUDA, the plain version on the CPU."""
    if use_kernel(boxes):
        return nms_alive_cuda(
            boxes.float().contiguous(), valid.contiguous(), iou_threshold,
            max_survivors,
        )
    return nms_alive_reference(boxes, valid, iou_threshold, max_survivors)


def nms_padded_batch(boxes, scores, iou_threshold, max_outputs, valid=None,
                     presorted=False):
    """Grouped greedy NMS over (G, N) candidate groups.

    Args:
        boxes: (G, N, 4); scores: (G, N); valid: optional (G, N) bool.
        presorted: the caller guarantees per-group scores (with invalid
            entries masked low) are already non-increasing, as after a
            :func:`top_k` candidate cap; skips the stable argsort.

    Returns:
        ``(indices, keep_mask)`` of shape (G, max_outputs): per group,
        indices into the group's inputs in descending-score order, and
        which of them are real survivors. Masked slots point at arbitrary
        rows.
    """
    g, n = scores.shape
    device = scores.device
    if n == 0:
        return (
            torch.zeros((g, max_outputs), dtype=torch.int64, device=device),
            torch.zeros((g, max_outputs), dtype=torch.bool, device=device),
        )
    scores = scores.float()
    if valid is None:
        valid = torch.ones((g, n), dtype=torch.bool, device=device)

    masked_scores = torch.where(
        valid, scores, torch.full_like(scores, NEG_INF)
    )
    if presorted:
        order = None
        boxes_s, valid_s, sorted_scores = boxes, valid, masked_scores
    else:
        sorted_scores, order = top_k(masked_scores, n)
        boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        valid_s = torch.gather(valid, 1, order)

    alive = nms_alive(boxes_s, valid_s, float(iou_threshold),
                      max_survivors=int(max_outputs))

    alive_scores = torch.where(
        alive, sorted_scores, torch.full_like(sorted_scores, NEG_INF)
    )
    k = min(max_outputs, n)
    top_scores, top_pos = top_k(alive_scores, k)
    keep_mask = top_scores > NEG_INF
    indices = top_pos if presorted else torch.gather(order, 1, top_pos)

    if max_outputs > n:
        extra = max_outputs - n
        indices = torch.nn.functional.pad(indices, (0, extra))
        keep_mask = torch.nn.functional.pad(keep_mask, (0, extra))
    return indices, keep_mask


def nms_padded(boxes, scores, iou_threshold, max_outputs, valid=None):
    """Single-group :func:`nms_padded_batch`: (N, 4) boxes, (N,) scores."""
    indices, keep_mask = nms_padded_batch(
        boxes[None], scores[None], iou_threshold, max_outputs,
        valid=None if valid is None else valid[None],
    )
    return indices[0], keep_mask[0]


def nms_per_class(boxes, scores, iou_threshold, max_per_class, valid=None):
    """Per-class NMS: (C, N, 4) boxes and (C, N) scores, classes as groups."""
    return nms_padded_batch(
        boxes, scores, iou_threshold, max_per_class, valid=valid
    )
