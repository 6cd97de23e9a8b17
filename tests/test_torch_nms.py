"""Port's grouped NMS (plain version of kernel K1) against the JAX package.

The same numpy inputs go through ``luminoth_tpu.ops.nms`` (the XLA sweep
on CPU), the Pallas kernel in interpret mode, the numpy golden and the
port on CPU tensors. Indices and keep masks must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminoth_tpu.ops import nms as jax_nms
from luminoth_tpu.ops.np_boxes import nms as np_nms
from luminoth_tpu.ops.pallas.nms_kernel import nms_alive_pallas
from luminoth_tpu_torch.ops import nms as torch_nms


def random_groups(rng, g, n, spread=80.0, tie_levels=None):
    xy = rng.uniform(0, spread, (g, n, 2))
    wh = rng.uniform(5, 40, (g, n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    if tie_levels:  # few distinct scores: many ties
        scores = rng.randint(0, tie_levels, (g, n)) / float(tie_levels)
    else:
        scores = rng.uniform(0, 1, (g, n))
    valid = rng.rand(g, n) > 0.2
    return boxes, scores.astype(np.float32), valid


def torch_batch(boxes, scores, valid, thr, k, presorted=False):
    idx, keep = torch_nms.nms_padded_batch(
        torch.from_numpy(boxes), torch.from_numpy(scores), thr, k,
        valid=torch.from_numpy(valid), presorted=presorted,
    )
    return idx.numpy(), keep.numpy()


def jax_batch(boxes, scores, valid, thr, k, presorted=False):
    idx, keep = jax_nms.nms_padded_batch(
        jnp.asarray(boxes), jnp.asarray(scores), thr, k,
        valid=jnp.asarray(valid), presorted=presorted,
    )
    return np.asarray(idx), np.asarray(keep)


class TestPaddedBatch:
    @pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
    @pytest.mark.parametrize("tie_levels", [None, 5])
    def test_unsorted_matches_jax(self, rng, thr, tie_levels):
        boxes, scores, valid = random_groups(rng, 3, 300, tie_levels=tie_levels)
        got = torch_batch(boxes, scores, valid, thr, 40)
        want = jax_batch(boxes, scores, valid, thr, 40)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])

    @pytest.mark.parametrize("thr", [0.5, 0.7])
    def test_presorted_matches_jax(self, rng, thr):
        boxes, scores, valid = random_groups(rng, 2, 700, tie_levels=7)
        # The proposal stages' candidate cap: top-k by masked score.
        masked = np.where(valid, scores, -1.0).astype(np.float32)
        top_scores, top_idx = jax.lax.top_k(jnp.asarray(masked), 700)
        top_idx = np.asarray(top_idx)
        boxes_s = np.take_along_axis(boxes, top_idx[..., None], 1)
        scores_s = np.take_along_axis(scores, top_idx, 1)
        valid_s = np.asarray(top_scores) > -1.0
        got = torch_batch(boxes_s, scores_s, valid_s, thr, 64, presorted=True)
        want = jax_batch(boxes_s, scores_s, valid_s, thr, 64, presorted=True)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])

    def test_more_outputs_than_candidates(self, rng):
        boxes, scores, valid = random_groups(rng, 2, 10)
        got = torch_batch(boxes, scores, valid, 0.5, 16)
        want = jax_batch(boxes, scores, valid, 0.5, 16)
        assert got[0].shape == (2, 16)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])

    def test_empty_candidates(self):
        idx, keep = torch_nms.nms_padded_batch(
            torch.zeros(2, 0, 4), torch.zeros(2, 0), 0.5, 4
        )
        assert idx.shape == (2, 4) and not keep.any()

    def test_matches_numpy_golden(self, rng):
        boxes, scores, _ = random_groups(rng, 1, 200, spread=50.0)
        for thr in (0.3, 0.6):
            idx, keep = torch_nms.nms_padded(
                torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                thr, 200,
            )
            ref = np_nms(boxes[0], scores[0], thr)
            np.testing.assert_array_equal(idx.numpy()[keep.numpy()], ref)

    def test_per_class(self, rng):
        boxes, scores, valid = random_groups(rng, 4, 100)
        idx, keep = torch_nms.nms_per_class(
            torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 20,
            valid=torch.from_numpy(valid),
        )
        want = jax_nms.nms_per_class(
            jnp.asarray(boxes), jnp.asarray(scores), 0.5, 20,
            valid=jnp.asarray(valid),
        )
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))


class TestAliveReference:
    @pytest.mark.parametrize("n,tile,block", [(256, 64, 64), (300, 128, 100)])
    def test_matches_pallas_interpret(self, rng, n, tile, block):
        boxes, scores, valid = random_groups(rng, 2, n, spread=60.0)
        order = np.argsort(-scores, axis=1, kind="stable")
        boxes_s = np.take_along_axis(boxes, order[..., None], 1)
        valid_s = np.take_along_axis(valid, order, 1)
        pad = -n % tile
        boxes_p = np.pad(boxes_s, ((0, 0), (0, pad), (0, 0)))
        valid_p = np.pad(valid_s, ((0, 0), (0, pad)))
        for thr in (0.3, 0.7):
            want = np.asarray(nms_alive_pallas(
                jnp.asarray(boxes_p).transpose(0, 2, 1),
                jnp.asarray(valid_p, jnp.float32), thr, tile=tile,
                interpret=True,
            ))[:, :n] > 0.5
            got = torch_nms.nms_alive_reference(
                torch.from_numpy(boxes_s), torch.from_numpy(valid_s), thr,
                block_size=block,
            )
            np.testing.assert_array_equal(got.numpy(), want)

    def test_cpu_dispatch_uses_plain_version(self, rng):
        boxes, _, valid = random_groups(rng, 2, 64)
        before = torch_nms.nms_alive_cuda.launches
        alive = torch_nms.nms_alive(
            torch.from_numpy(boxes), torch.from_numpy(valid), 0.5
        )
        assert torch_nms.nms_alive_cuda.launches == before
        assert alive.dtype == torch.bool and alive.shape == (2, 64)

    def test_kernel_wrapper_rejects_cpu_tensors(self):
        with pytest.raises(ValueError):
            torch_nms.nms_alive_cuda(
                torch.zeros(1, 8, 4), torch.ones(1, 8, dtype=torch.bool), 0.5
            )


class TestTopK:
    def test_tie_order_matches_lax_top_k(self, rng):
        values = (rng.randint(0, 4, (3, 50)) / 4.0).astype(np.float32)
        got_v, got_i = torch_nms.top_k(torch.from_numpy(values), 20)
        want_v, want_i = jax.lax.top_k(jnp.asarray(values), 20)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
