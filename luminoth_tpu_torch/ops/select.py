"""Exact dynamic-k top-k selection masks (counterpart of the JAX package's
``ops/select.py``).

Only :func:`top_k_mask` is ported. ``gather_rows`` exists in the JAX
package because a TPU lowers a gather from a tiny table slowly; the port
indexes the table directly.
"""

import torch


def top_k_mask(scores, k):
    """Boolean mask of the ``k`` largest entries along the last axis.

    Args:
        scores: (..., n) NaN-free scores.
        k: an int, or an integer tensor broadcastable to ``scores.shape[:-1]``
            (one quota per row). Clamped to [0, n].

    Ties at the selection boundary fill the quota in ascending index order
    (the order of a stable descending argsort), and -0.0 counts as +0.0:
    the semantics of ``luminoth_tpu.ops.select.top_k_mask``.
    """
    n = scores.shape[-1]
    k = torch.as_tensor(k, device=scores.device).long()
    k = torch.clamp(k.expand(scores.shape[:-1]), 0, n)
    scores = torch.where(scores == 0.0, torch.zeros_like(scores), scores)
    sorted_vals = torch.sort(scores, dim=-1).values  # ascending
    kth = torch.gather(
        sorted_vals, -1, torch.clamp(n - k, 0, max(n - 1, 0))[..., None]
    )  # the k-th largest, (..., 1)
    greater = scores > kth
    need = k[..., None] - greater.sum(dim=-1, keepdim=True)
    tie = scores == kth
    tie_order = torch.cumsum(tie.long(), dim=-1)  # 1-based among ties
    return greater | (tie & (tie_order <= need))
