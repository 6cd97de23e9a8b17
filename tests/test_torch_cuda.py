"""Kernels K1, K2 and K3 against their plain versions on the GPU.

These need a CUDA device and ``nvcc`` (the kernels are built at first use);
without a CUDA device they skip. Run them on a GPU machine with::

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from luminoth_tpu_torch.ops import nms, roi_align

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def sorted_groups(rng, g, n, spread, device, ties=False):
    xy = rng.uniform(0, spread, (g, n, 2))
    wh = rng.uniform(4, spread / 3, (g, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if ties:  # exact duplicates: IoU 1 with the earlier copy
        boxes[:, 1::7] = boxes[:, 0:-1:7][:, : boxes[:, 1::7].shape[1]]
    valid = rng.rand(g, n) > 0.1
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device))


def first_alive(alive, k):
    n = alive.shape[1]
    pos = torch.arange(n, device=alive.device).expand_as(alive)
    first = torch.sort(torch.where(alive, pos, n), dim=1).values[:, :k]
    return torch.where(first < n, first, -1)


def footprint_boxes(rng, kind, b, r, h, w):
    """(b, r, 4) normalized boxes whose S = 14 footprints are of ``kind``:
    1 x 1 slots (every sample on the map's last cell), 2 x 2 (every sample
    on one point inside a cell), 2S x 2S (samples over 2 cells apart) or
    random.

    The 2 x 2 boxes are points a quarter cell into a cell of a map whose
    sides less one are powers of two, so the sample coordinates, the tap
    weights (3/4, 1/4) and the samples are exact: a window's four samples
    tie exactly, in the kernel and the plain version alike. (Distinct
    samples a fraction of a cell apart tie within float32 rounding, and
    the two versions may then route them differently.)"""
    if kind == "corner":
        return np.ones((b, r, 4), np.float32)
    if kind == "tiny":
        y = (rng.randint(0, h - 2, (b, r)) + 0.25) / (h - 1)
        x = (rng.randint(0, w - 2, (b, r)) + 0.25) / (w - 1)
        return np.stack([y, x, y, x], -1).astype(np.float32)
    if kind == "wide":
        lo = rng.uniform(0.0, 0.02, (b, r, 2))
        hi = rng.uniform(0.97, 0.99, (b, r, 2))
        return np.concatenate([lo, hi], -1).astype(np.float32)
    y1 = rng.uniform(-0.2, 0.8, (b, r))
    x1 = rng.uniform(-0.2, 0.8, (b, r))
    return np.stack([y1, x1, y1 + rng.uniform(0.01, 0.6, (b, r)),
                     x1 + rng.uniform(0.01, 0.6, (b, r))],
                    -1).astype(np.float32)


class TestNMSKernel:
    @pytest.mark.parametrize("g,n", [(3, 100), (5, 700), (2, 5000)])
    @pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
    def test_full_mask_matches_plain(self, rng, device, g, n, thr):
        boxes, valid = sorted_groups(rng, g, n, 200.0, device, ties=True)
        got = nms.nms_alive_cuda(boxes, valid, thr)
        want = nms.nms_alive_reference(boxes, valid, thr)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("keep", [1, 10, 100])
    def test_prefix_exit_is_exact(self, rng, device, keep):
        boxes, valid = sorted_groups(rng, 4, 1500, 600.0, device)
        got = nms.nms_alive_cuda(boxes, valid, 0.5, keep)
        want = nms.nms_alive_reference(boxes, valid, 0.5)
        assert torch.equal(first_alive(got, keep), first_alive(want, keep))

    def test_groups_beyond_shared_memory(self, rng, device):
        boxes, valid = sorted_groups(rng, 2, 15000, 800.0, device)
        got = nms.nms_alive_cuda(boxes, valid, 0.7, 2000)
        want = nms.nms_alive_reference(boxes, valid, 0.7)
        assert torch.equal(first_alive(got, 2000), first_alive(want, 2000))

    # Fewer groups than SMs take the banded bitmask (1024 candidates a
    # band), more take the one-block-per-group sweep.
    @pytest.mark.parametrize("g,n,keep", [
        (3, 1, 0), (3, 1, 5), (4, 65, 0), (2, 1000, 0), (2, 1000, 37),
        (5, 2500, 0), (3, 2500, 700), (200, 300, 0), (200, 300, 20),
    ])
    def test_edge_shapes(self, rng, device, g, n, keep):
        boxes, valid = sorted_groups(rng, g, n, 300.0, device, ties=True)
        got = nms.nms_alive_cuda(boxes, valid, 0.5, keep)
        want = nms.nms_alive_reference(boxes, valid, 0.5)
        k = keep or n
        assert torch.equal(first_alive(got, k), first_alive(want, k))
        if keep == 0:
            assert torch.equal(got, want)

    @pytest.mark.parametrize("g", [2, 200])
    def test_all_invalid(self, rng, device, g):
        boxes, _ = sorted_groups(rng, g, 1500, 300.0, device)
        valid = torch.zeros(g, 1500, dtype=torch.bool, device=device)
        for keep in (0, 10):
            got = nms.nms_alive_cuda(boxes, valid, 0.5, keep)
            assert not bool(got.any())

    @pytest.mark.parametrize("g", [2, 200])
    def test_iou_exactly_at_threshold_survives(self, device, g):
        # IoU([0,0,4,1], [0,0,2,1]) = 2 / 4 = 0.5 exactly: kept at 0.5
        # (strictly greater suppresses), struck at 0.4999.
        triple = np.array([[0, 0, 4, 1], [0, 0, 2, 1], [10, 10, 12, 11]],
                          np.float32)
        # 30 triples 20 apart (90 candidates: past one 64-wide chunk).
        shift = 20 * np.arange(30, dtype=np.float32)[:, None, None]
        boxes = (triple[None] + shift * np.float32([1, 0, 1, 0])).reshape(
            1, 90, 4)
        boxes = torch.from_numpy(np.repeat(boxes, g, 0)).to(device)
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=device)
        for thr in (0.5, 0.4999):
            got = nms.nms_alive_cuda(boxes, valid, thr)
            want = nms.nms_alive_reference(boxes, valid, thr)
            assert torch.equal(got, want)
            assert bool(got[:, 1::3].all()) == (thr == 0.5)

    @pytest.mark.parametrize("g", [3, 200])
    def test_survivors_stop_before_keep(self, rng, device, g):
        # Heavy overlap: far fewer survivors than max_survivors, so the
        # scan runs to the end of every group without its early exit.
        boxes, valid = sorted_groups(rng, g, 1200, 40.0, device)
        want = nms.nms_alive_reference(boxes, valid, 0.3)
        keep = 1100
        assert int(want.sum(1).max()) < keep
        got = nms.nms_alive_cuda(boxes, valid, 0.3, keep)
        assert torch.equal(got, want)

    def test_counts_launches(self, rng, device):
        boxes, valid = sorted_groups(rng, 2, 64, 100.0, device)
        before = nms.nms_alive_cuda.launches
        nms.nms_padded_batch(boxes, torch.rand(2, 64, device=device), 0.5, 8,
                             valid=valid)
        assert nms.nms_alive_cuda.launches == before + 1

    def test_rejects_bad_inputs(self, device):
        boxes = torch.zeros(1, 8, 4, device=device)
        valid = torch.ones(1, 8, dtype=torch.bool, device=device)
        with pytest.raises(TypeError):
            nms.nms_alive_cuda(boxes.double(), valid, 0.5)
        with pytest.raises(ValueError):
            nms.nms_alive_cuda(boxes[:, ::2], valid[:, :4], 0.5)


class TestROIKernel:
    def _inputs(self, rng, device, b=2, r=37, h=13, w=17, c=96):
        fm = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
        y1 = rng.uniform(-0.1, 0.8, (b, r))
        x1 = rng.uniform(-0.1, 0.8, (b, r))
        boxes = np.stack(
            [y1, x1, y1 + rng.uniform(0.01, 0.6, (b, r)),
             x1 + rng.uniform(0.01, 0.6, (b, r))], -1
        ).astype(np.float32)
        boxes[0, 0] = [0, 0, 1, 1]  # samples exactly on dim - 1
        return fm.to(device), torch.from_numpy(boxes).to(device)

    @pytest.mark.parametrize("s", [2, 8, 14])
    def test_f32_matches_plain(self, rng, device, s):
        fm, boxes = self._inputs(rng, device)
        got = roi_align.roi_crop_pool_cuda(fm, boxes, s)
        want = roi_align.roi_crop_pool_reference(fm, boxes, s)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)

    # Large maps with S = 28 stage 2S x 2S taps one vector at a time (many
    # double-buffered slices); C = 1024 bf16 is the served width.
    @pytest.mark.parametrize("h,w,c,s,dtype", [
        (64, 64, 64, 28, torch.float32), (64, 64, 64, 28, torch.bfloat16),
        (38, 50, 1024, 14, torch.bfloat16), (5, 7, 8, 14, torch.bfloat16),
    ])
    def test_footprints_and_slices(self, rng, device, h, w, c, s, dtype):
        fm, boxes = self._inputs(rng, device, b=2, r=23, h=h, w=w, c=c)
        fm = fm.to(dtype)
        got = roi_align.roi_crop_pool_cuda(fm, boxes, s).float()
        want = roi_align.roi_crop_pool_reference(fm.float(), boxes, s)
        err = (got - want).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-5
        else:
            assert bool((err <= (2.0 ** -8 + 1e-6) * want.abs() + 1e-5).all())

    def test_bf16_within_one_rounding(self, rng, device):
        fm, boxes = self._inputs(rng, device)
        fm16 = fm.bfloat16()
        got = roi_align.roi_crop_pool_cuda(fm16, boxes, 14)
        assert got.dtype == torch.bfloat16
        want = roi_align.roi_crop_pool_reference(fm16.float(), boxes, 14)
        err = (got.float() - want).abs()
        assert bool((err <= (2.0 ** -8 + 1e-6) * want.abs() + 1e-5).all())

    def test_batch_path_counts_launches(self, rng, device):
        fm, _ = self._inputs(rng, device)
        rois = torch.tensor([[[0.0, 0.0, 50.0, 40.0]] * 3] * 2, device=device)
        before = roi_align.roi_crop_pool_cuda.launches
        out = roi_align.roi_crop_pool_batch(fm, rois, (104.0, 136.0))
        assert roi_align.roi_crop_pool_cuda.launches == before + 1
        assert out.shape == (2, 3, 7, 7, 96)

    def test_rejects_bad_inputs(self, rng, device):
        fm, boxes = self._inputs(rng, device)
        with pytest.raises(TypeError):
            roi_align.roi_crop_pool_cuda(fm.half(), boxes, 14)
        with pytest.raises(ValueError):
            roi_align.roi_crop_pool_cuda(fm, boxes, 7)
        with pytest.raises(ValueError):
            roi_align.roi_crop_pool_cuda(fm.transpose(1, 2), boxes, 14)
        with pytest.raises(ValueError):  # more than 2S x 2S staged taps
            roi_align.roi_crop_pool_cuda(fm, boxes, 30)

    @pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 100),
                                         (torch.float32, 98)])
    def test_rejects_channels_off_the_vector_width(self, rng, device, dtype,
                                                   c):
        # The kernel moves 16 bytes of channels at a time: 8 bf16 or 4
        # float32. Other channel counts raise rather than run.
        fm, boxes = self._inputs(rng, device, c=c)
        with pytest.raises(ValueError, match="multiple of"):
            roi_align.roi_crop_pool_cuda(fm.to(dtype), boxes, 14)


class TestROIBackwardKernel:
    _inputs = TestROIKernel._inputs

    def _grad(self, rng, device, boxes, s=14, c=96):
        b, r = boxes.shape[:2]
        return torch.from_numpy(
            rng.randn(b, r, s // 2, s // 2, c).astype(np.float32)
        ).to(device)

    @pytest.mark.parametrize("s", [2, 8, 14])
    def test_f32_matches_plain(self, rng, device, s):
        fm, boxes = self._inputs(rng, device)
        g = self._grad(rng, device, boxes, s)
        got = roi_align.roi_crop_pool_backward_cuda(fm, boxes, g, s)
        want = roi_align.roi_crop_pool_backward_reference(fm, boxes, g, s)
        assert got.dtype == torch.float32
        # Random N(0, 1) maps: no window's top two samples lie within the
        # float32 difference of the two crop computations.
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

    def test_bf16_matches_plain(self, rng, device):
        fm, boxes = self._inputs(rng, device)
        fm16 = fm.bfloat16()
        g = self._grad(rng, device, boxes).bfloat16()
        got = roi_align.roi_crop_pool_backward_cuda(fm16, boxes, g, 14)
        want = roi_align.roi_crop_pool_backward_reference(fm16, boxes, g, 14)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

    def test_ties_split_evenly(self, device):
        # Samples exactly on the cells of a constant map: all four samples
        # of every window tie.
        fm = torch.ones(1, 4, 4, 32, device=device)
        boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0]]], device=device)
        g = torch.ones(1, 1, 2, 2, 32, device=device)
        got = roi_align.roi_crop_pool_backward_cuda(fm, boxes, g, 4)
        want = roi_align.roi_crop_pool_backward_reference(fm, boxes, g, 4)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        torch.testing.assert_close(got.sum(), g.sum())

    def test_autograd_grad_equals_plain_backward(self, rng, device):
        """The CUDA path carries a gradient to the map (K3), equal to the
        plain backward's; the boxes get none."""
        fm, _ = self._inputs(rng, device)
        rois = torch.from_numpy(
            rng.uniform(0, 60, (2, 5, 4)).astype(np.float32)
        ).to(device)
        rois[..., 2:] += rois[..., :2]
        rois.requires_grad_(True)
        fm.requires_grad_(True)
        before = roi_align.roi_crop_pool_backward_cuda.launches
        pooled = roi_align.roi_crop_pool_batch(fm, rois, (104.0, 136.0))
        g = torch.from_numpy(
            rng.randn(*pooled.shape).astype(np.float32)).to(device)
        (pooled * g).sum().backward()
        assert roi_align.roi_crop_pool_backward_cuda.launches == before + 1
        assert rois.grad is None
        frame = torch.tensor([136.0, 104.0] * 2, device=device)
        x1, y1, x2, y2 = (rois.detach() / frame).unbind(-1)
        boxes = torch.stack([y1, x1, y2, x2], -1)
        want = roi_align.roi_crop_pool_backward_reference(
            fm.detach(), boxes, g, 14)
        torch.testing.assert_close(fm.grad, want, rtol=1e-4, atol=1e-4)

    def test_autograd_bf16_grad_dtype(self, rng, device):
        fm, boxes = self._inputs(rng, device)
        fm16 = fm.bfloat16().requires_grad_(True)
        pooled = roi_align.RoiCropPool.apply(fm16, boxes, 14)
        pooled.float().sum().backward()
        assert fm16.grad.dtype == torch.bfloat16

    def test_rejects_bad_inputs(self, rng, device):
        fm, boxes = self._inputs(rng, device)
        g = self._grad(rng, device, boxes)
        with pytest.raises(ValueError):
            roi_align.roi_crop_pool_backward_cuda(fm, boxes, g[:, :3], 14)
        with pytest.raises(ValueError):
            roi_align.roi_crop_pool_backward_cuda(
                fm, boxes, g.bfloat16(), 14)
        with pytest.raises(ValueError):
            roi_align.roi_crop_pool_backward_cuda(fm, boxes, g.cpu(), 14)

    # Footprints of 1 x 1 to 28 x 28 slots (and one ROI wholly outside the
    # map) at channel counts of one slice (one vector) and of many.
    @pytest.mark.parametrize("kind", ["corner", "tiny", "wide", "random"])
    @pytest.mark.parametrize("dtype,c", [
        (torch.float32, 4), (torch.float32, 96), (torch.bfloat16, 8),
        (torch.bfloat16, 1024),
    ])
    def test_footprints_and_slices(self, rng, device, kind, dtype, c):
        h, w = 33, 33
        boxes = footprint_boxes(rng, kind, 2, 9, h, w)
        boxes[0, 0] = [-2.0, -2.0, -1.0, -1.0]
        fm = torch.from_numpy(rng.randn(2, h, w, c).astype(np.float32))
        g = torch.from_numpy(rng.randn(2, 9, 7, 7, c).astype(np.float32))
        fm, g = fm.to(device, dtype), g.to(device, dtype)
        boxes = torch.from_numpy(boxes).to(device)
        got = roi_align.roi_crop_pool_backward_cuda(fm, boxes, g, 14)
        want = roi_align.roi_crop_pool_backward_reference(fm, boxes, g, 14)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

    # S = 28: footprints up to 56 x 56 slots, the launch's widest stage.
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_widest_crop(self, rng, device, dtype):
        fm = torch.from_numpy(rng.randn(2, 64, 64, 16).astype(np.float32))
        boxes = footprint_boxes(rng, "wide", 2, 3, 64, 64)
        g = torch.from_numpy(rng.randn(2, 3, 14, 14, 16).astype(np.float32))
        fm, g = fm.to(device, dtype), g.to(device, dtype)
        boxes = torch.from_numpy(boxes).to(device)
        got = roi_align.roi_crop_pool_backward_cuda(fm, boxes, g, 28)
        want = roi_align.roi_crop_pool_backward_reference(fm, boxes, g, 28)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_stacked_rois_contend(self, rng, device, dtype):
        # Every ROI of both images on one box: all blocks of an image add
        # into the same slots of d_fm at once.
        fm, _ = self._inputs(rng, device, c=256)
        boxes = torch.tensor([[[0.2, 0.3, 0.45, 0.5]] * 300] * 2,
                             device=device)
        g = self._grad(rng, device, boxes, c=256)
        fm, g = fm.to(dtype), g.to(dtype)
        got = roi_align.roi_crop_pool_backward_cuda(fm, boxes, g, 14)
        want = roi_align.roi_crop_pool_backward_reference(fm, boxes, g, 14)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 100),
                                         (torch.float32, 98)])
    def test_rejects_channels_off_the_vector_width(self, rng, device, dtype,
                                                   c):
        fm, boxes = self._inputs(rng, device, c=c)
        g = self._grad(rng, device, boxes, c=c)
        with pytest.raises(ValueError, match="multiple of"):
            roi_align.roi_crop_pool_backward_cuda(fm.to(dtype), boxes,
                                                  g.to(dtype), 14)

    def test_rejects_crops_over_28(self, rng, device):
        fm, boxes = self._inputs(rng, device)
        g = self._grad(rng, device, boxes, s=30)
        with pytest.raises(ValueError, match="crop_size"):
            roi_align.roi_crop_pool_backward_cuda(fm, boxes, g, 30)

    def test_rejects_unaligned_cotangents(self, rng, device):
        fm, boxes = self._inputs(rng, device)
        g = self._grad(rng, device, boxes)
        flat = torch.zeros(g.numel() + 1, device=device)
        shifted = flat[1:].view(g.shape)  # contiguous, 4 bytes off 16
        shifted.copy_(g)
        with pytest.raises(ValueError, match="aligned"):
            roi_align.roi_crop_pool_backward_cuda(fm, boxes, shifted, 14)


# ------------------------------------------------- eval and serving paths

SMALL = {  # the small configuration of tests/test_torch_eval.py
    "train": {"batch_size": 2, "run_name": "small"},
    "dataset": {"image_preprocessing": {
        "min_size": 96, "max_size": 128,
        "canvas_height": 96, "canvas_width": 128,
    }},
    "model": {
        "type": "fasterrcnn",
        "network": {"num_classes": 3},
        "base_network": {"architecture": "resnet_v1_50"},
        "rpn": {"proposals": {"pre_nms_top_n": 128, "post_nms_top_n": 32}},
        "rcnn": {"proposals": {"total_max_detections": 10,
                               "class_max_detections": 8,
                               "min_prob_threshold": 0.0}},
    },
}


def write_small_config(tmp_path, config=SMALL, images=5, height=72,
                       width=96):
    """A config file over ``images`` synthetic val records, its job_dir
    under ``tmp_path``; returns its path."""
    import yaml

    from luminoth_tpu_torch.utils.synthetic import write_synthetic_records

    classes = config["model"]["network"]["num_classes"]
    data, _ = write_synthetic_records(str(tmp_path / "data"), images,
                                      classes, 7, height=height,
                                      width=width, split="val")
    body = {**config,
            "train": {**config["train"], "job_dir": str(tmp_path / "jobs")},
            "dataset": {**config["dataset"], "dir": data}}
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(body))
    return str(path)


def rescaled_model(config):
    """The port's model with random weights, its classifiers rescaled to
    unsaturated logits (as in tests/test_torch_slice.py), on the CPU."""
    from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
    from luminoth_tpu_torch.utils.weights import (
        init_variables,
        load_flax_variables,
    )

    canvas = (config.dataset.image_preprocessing.canvas_height,
              config.dataset.image_preprocessing.canvas_width)
    variables = init_variables(config, seed=0)
    images = torch.rand((2,) + canvas + (3,),
                        generator=torch.Generator().manual_seed(0)) * 255

    def forward():
        model = load_flax_variables(FasterRCNN(config), variables).eval()
        with torch.inference_mode():
            return model(images)

    params = variables["params"]
    params["rpn"]["cls_conv"]["kernel"] *= 3.0 / float(
        forward()["rpn_prediction"]["rpn_cls_score"].std())
    rcnn = forward()["classification_prediction"]["rcnn"]
    params["rcnn"]["fc_classifier"]["kernel"] *= 3.0 / float(
        rcnn["cls_score"].std())
    params["rcnn"]["fc_bbox"]["kernel"] *= 0.5 / float(
        rcnn["bbox_offsets"].std())
    return load_flax_variables(FasterRCNN(config), variables)


class TestEvalAndServing:
    def test_eval_on_the_card_equals_the_cpu(self, tmp_path, device):
        import copy

        from luminoth_tpu_torch import eval as evaluator
        from luminoth_tpu_torch.utils.config import get_config

        config = evaluator.apply_eval_config_mutations(
            get_config(write_small_config(tmp_path)), "val")
        model = rescaled_model(config)
        want = evaluator.evaluate_once(config, model)
        # Full float32 on the card: TF32 convs and matmuls would round
        # the inputs to 10 mantissa bits.
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            got = evaluator.evaluate_once(config,
                                          copy.deepcopy(model).to(device))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        assert got["images"] == want["images"] == 5
        assert got["forward_device_ms"] > 0
        for key in ("AP@0.5", "AP@0.75", "AP@[0.5:0.95]", "AR@[0.5:0.95]"):
            assert abs(got[key] - want[key]) <= 1e-6, key
        losses = [k for k in want if k.startswith("losses/")]
        assert losses
        for key in losses:
            assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), (
                key, got[key], want[key])

    def test_k1_on_an_eval_forwards_per_class_tensors(self, tmp_path,
                                                      device):
        """The uncapped per-class NMS of eval: K1 at G = 8 x 80 = 640
        groups of N = 2000 candidates, against its plain version."""
        from luminoth_tpu_torch import eval as evaluator
        from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN
        from luminoth_tpu_torch.utils.config import get_config
        from luminoth_tpu_torch.utils.weights import (
            init_variables,
            load_flax_variables,
        )

        full = {**SMALL,
                "train": {**SMALL["train"], "batch_size": 8},
                "dataset": {"image_preprocessing": {
                    "min_size": 600, "max_size": 800,
                    "canvas_height": 608, "canvas_width": 800}},
                "model": {"type": "fasterrcnn",
                          "network": {"num_classes": 80},
                          "base_network": {"architecture": "resnet_v1_50"}}}
        config = evaluator.apply_eval_config_mutations(get_config(
            write_small_config(tmp_path, full, images=8, height=480,
                               width=640)), "val")
        model = load_flax_variables(FasterRCNN(config),
                                    init_variables(config, 0)).to(device)
        kernel, captured = nms.nms_alive_cuda, []

        def capture(boxes, valid, thr, keep=0):
            captured.append((boxes.clone(), valid.clone(), thr, keep))
            return kernel(boxes, valid, thr, keep)

        capture.launches = 0
        nms.nms_alive_cuda = capture
        try:
            metrics = evaluator.evaluate_once(config, model)
        finally:
            nms.nms_alive_cuda = kernel
        assert metrics["images"] == 8 and capture.launches == 2
        boxes, valid, thr, keep = captured[1]
        assert (tuple(boxes.shape), thr, keep) == ((640, 2000, 4), 0.5, 100)
        assert int(valid.sum()) > 0
        got = first_alive(kernel(boxes, valid, thr, keep), keep)
        want = first_alive(nms.nms_alive_reference(boxes, valid, thr), keep)
        assert torch.equal(got, want)

    def test_a_web_request_served_from_the_card(self, tmp_path, device):
        import io
        import json
        import urllib.request

        from PIL import Image

        from luminoth_tpu_torch.tasks import Detector
        from luminoth_tpu_torch.tools.server import web
        from luminoth_tpu_torch.utils.checkpoint_io import CheckpointManager
        from luminoth_tpu_torch.utils.config import get_config

        path = write_small_config(tmp_path, images=1)
        config = get_config(path)
        CheckpointManager(str(tmp_path / "jobs" / "small" / "ckpt")).save(
            {"step": 1, "model": rescaled_model(config).state_dict()}, 1)
        buf = io.BytesIO()
        Image.fromarray(np.random.RandomState(0).randint(
            0, 256, (90, 120, 3)).astype(np.uint8)).save(buf, "JPEG")
        httpd = web.run_server(config, port=0, block=False, device=device)
        try:
            assert httpd.state.ready.wait(300) and httpd.state.network
            request = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}"
                f"/api/fasterrcnn/predict/", data=buf.getvalue())
            with urllib.request.urlopen(request, timeout=300) as response:
                objects = json.load(response)["objects"]
        finally:
            web.stop_server(httpd)
        image = np.asarray(Image.open(io.BytesIO(buf.getvalue()))
                           .convert("RGB"))
        want = Detector(config=path, device=device, prob=0.0).predict(image)
        assert objects == want and len(want) > 0

    def test_fallback_draw_is_the_cpus(self, device):
        from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN

        model = FasterRCNN.__new__(FasterRCNN)
        for stage in ("rpn", "rcnn"):
            got = FasterRCNN._priorities(model, stage, (2, 50), None, None,
                                         device)
            want = FasterRCNN._priorities(model, stage, (2, 50), None, None,
                                          torch.device("cpu"))
            for g, w in zip(got, want):
                assert g.is_cuda and torch.equal(g.cpu(), w)


# ------------------------------------------------------------------- SSD


def class_shifted_groups(rng, g, n, classes, device, shift=1e4):
    """SSD's fused-path groups: score-sorted boxes in a 300x300 image, each
    shifted by its class x 1e4 (coordinates up to ~1.9e5 at 20 classes,
    where a float32 ulp is 1/64), exact duplicates, a valid prefix."""
    boxes, _ = sorted_groups(rng, g, n, 300.0, device, ties=True)
    cls = torch.from_numpy(rng.randint(0, classes, (g, n))).to(device)
    boxes = boxes + cls[..., None].float() * shift
    valid = torch.arange(n, device=device)[None] < torch.from_numpy(
        rng.randint(n // 3, n + 1, (g, 1))).to(device)
    return boxes.contiguous(), valid


class TestSSDShapes:
    @pytest.mark.parametrize("g", [32, 128])
    @pytest.mark.parametrize("keep", [0, 100])
    def test_fused_class_shifted_groups(self, rng, device, g, keep):
        """G = B (32, 128 < the SM count: the bitmask path), N = 1000,
        threshold 0.45, on class-shifted boxes."""
        boxes, valid = class_shifted_groups(rng, g, 1000, 20, device)
        got = first_alive(nms.nms_alive_cuda(boxes, valid, 0.45, keep),
                          keep or 1000)
        want = first_alive(nms.nms_alive_reference(boxes, valid, 0.45),
                           keep or 1000)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("g", [160, 640])
    def test_per_class_groups(self, rng, device, g):
        """G = B x 20 (the sweep path), N = 1000, keep 100."""
        boxes, valid = sorted_groups(rng, g, 1000, 300.0, device, ties=True)
        got = first_alive(nms.nms_alive_cuda(boxes, valid, 0.45, 100), 100)
        want = first_alive(nms.nms_alive_reference(boxes, valid, 0.45), 100)
        assert torch.equal(got, want)

    def test_card_equals_the_cpu(self, device):
        """SSD at 3 classes, float32 with TF32 off: every anchor's class
        logits and box offsets within 1e-4; the loss within 1e-5 relative;
        both detection paths, fed the same head outputs, equal in valid,
        labels and probabilities, boxes within 1e-4 px."""
        import copy

        from luminoth_tpu_torch.models.ssd import SSD
        from luminoth_tpu_torch.models.ssd.proposal import ssd_proposal
        from luminoth_tpu_torch.utils.config import (
            Config,
            get_base_config,
            get_model_config,
        )
        from luminoth_tpu_torch.utils.weights import (
            init_variables,
            load_flax_variables,
        )

        config = get_model_config(get_base_config("ssd"), Config(
            {"model": {"network": {"num_classes": 3}}}))
        model = load_flax_variables(SSD(config), init_variables(config, 0))
        model.eval()
        images = torch.rand((2, 300, 300, 3),
                            generator=torch.Generator().manual_seed(0)) * 255
        gt = torch.tensor([[[20, 30, 140, 160, 0], [150, 100, 290, 280, 2]],
                           [[100, 100, 220, 200, 1], [0, 0, 0, 0, -1]]],
                          dtype=torch.float32)
        card = copy.deepcopy(model).to(device)
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                want = model(images, gt_boxes=gt)
                got = card(images.to(device), gt_boxes=gt.to(device))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        for key in ("cls_pred", "loc_pred"):
            assert float((got[key].cpu() - want[key]).abs().max()) <= 1e-4, key
        for key, value in model.loss(want, return_all=True).items():
            card_value = float(card.loss(got, return_all=True)[key])
            assert abs(card_value - float(value)) <= 1e-5 * abs(
                float(value)), key
        probs = torch.softmax(got["cls_pred"], -1)
        p_cfg = config.model.proposals
        for min_prob in (0.5, 0.0):  # fused, per class
            args = (3, 0.45, int(p_cfg.class_max_detections),
                    int(p_cfg.total_max_detections), min_prob, (0.1, 0.2))
            det_card = ssd_proposal(probs, got["loc_pred"], got["anchors"],
                                    (300, 300), *args)
            det_cpu = ssd_proposal(probs.cpu(), got["loc_pred"].cpu(),
                                   got["anchors"].cpu(), (300, 300), *args)
            valid = det_cpu["valid"]
            assert valid.sum() > 0
            assert torch.equal(det_card["valid"].cpu(), valid)
            for key in ("labels", "probs"):
                assert torch.equal(det_card[key].cpu()[valid],
                                   det_cpu[key][valid]), key
            assert float((det_card["objects"].cpu() - det_cpu["objects"])
                         [valid].abs().max()) <= 1e-4


class TestInt8:
    """The int8 serving path's products and layers on the card against the
    CPU: ``torch._int_mm``'s shape rules, the padded rows, and bitwise
    equality of codes, accumulators and epilogues."""

    @pytest.mark.parametrize("m,k,n", [
        (392, 1024, 512), (392, 4608, 512), (392, 512, 2048),  # the tail
        (2592, 1152, 256), (41, 4608, 1024),  # SSD conv3_1, conv6 at b1
    ])
    def test_int_mm_equals_the_cpu(self, device, m, k, n):
        from luminoth_tpu_torch.models.base import quantized_tail as pq

        g = torch.Generator().manual_seed(m + k + n)
        rows = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g)
        got = pq.int8_mm(rows.to(device), w.to(device))
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got.cpu(), pq.int8_mm(rows, w))

    @pytest.mark.parametrize("m", [1, 9, 16, 17])
    def test_few_rows_are_padded(self, device, m):
        """``torch._int_mm`` on CUDA takes more than 16 rows; ``int8_mm``
        pads to ``MIN_ROWS`` and slices the padding off."""
        from luminoth_tpu_torch.models.base import quantized_tail as pq

        g = torch.Generator().manual_seed(m)
        rows = torch.randint(-127, 128, (m, 128), dtype=torch.int8,
                             generator=g).to(device)
        w = torch.randint(-127, 128, (256, 128), dtype=torch.int8,
                          generator=g).to(device)
        if m <= 16:
            with pytest.raises(RuntimeError, match="greater than 16"):
                torch._int_mm(rows, w.t())
        got = pq.int8_mm(rows, w)
        assert got.shape == (m, 256)
        assert torch.equal(got.cpu(), pq.int8_mm(rows.cpu(), w.cpu()))

    def test_quantizers_and_epilogue_equal_the_cpu(self, device):
        """Codes (a device-tensor division, half to even), folded and
        quantized weights (made on the host) and the fused epilogue: the
        same bits on the card."""
        from luminoth_tpu_torch.models.base import quantized_tail as pq

        g = torch.Generator().manual_seed(0)
        x = torch.randn(4, 9, 11, 64, generator=g) * 30
        for got, want in zip(pq.quantize_per_tensor(x.to(device)),
                             pq.quantize_per_tensor(x)):
            assert torch.equal(got.cpu(), want)
        acc = torch.randint(-2 ** 26, 2 ** 26, (5000, 64), generator=g)
        w_r = torch.rand(64, generator=g) + 0.1
        bias = torch.randn(64, generator=g)
        want = pq._epilogue(acc, torch.tensor(3.7), w_r, bias, (5000, 64))
        got = pq._epilogue(acc.to(device), torch.tensor(3.7, device=device),
                           w_r.to(device), bias.to(device), (5000, 64))
        assert torch.equal(got.cpu(), want)
        # One rounding: the float64 multiply-add rounded once to float32.
        scale = w_r * (torch.tensor(3.7) * pq.INV_127_SQ)
        fma = (acc.float().double() * scale.double() + bias.double()).float()
        assert torch.equal(want, fma)

    def test_int8_tail_equals_the_cpu(self, device):
        """An R50 int8 tail with random batch norms, calibrated, then
        static: outputs and maxima bitwise."""
        import copy

        from luminoth_tpu_torch.models.base import quantized_tail as pq

        g = torch.Generator().manual_seed(1)
        tail = pq.Int8ResNetTail(50, 256, static_scales=True).eval()
        with torch.no_grad():
            for m in tail.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.normal_(0, 0.05, generator=g)
                elif hasattr(m, "running_var"):
                    m.running_var.uniform_(0.5, 1.5, generator=g)
                    m.running_mean.normal_(0, 0.2, generator=g)
        card = copy.deepcopy(tail).to(device)
        x = torch.relu(torch.randn(6, 256, 7, 7, generator=g)).contiguous(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            with pq.calibrating(tail):
                want = tail(x)
            with pq.calibrating(card):
                got = card(x.to(device))
            assert torch.equal(got.cpu(), want)
            for a, b in zip(card.buffers(), tail.buffers()):
                assert torch.equal(a.cpu(), b)
            assert torch.equal(card(x.to(device) * 0.7).cpu(), tail(x * 0.7))

    def test_one_image_ssd_fast_forward(self, device):
        """SSD under the ``fast`` profile on one image: conv10_2 and
        conv11_2 have 9 and 1 rows, padded for the product; calibrated at
        load on the card; K1 once, K2 never."""
        from luminoth_tpu_torch.utils.config import (
            Config,
            get_base_config,
            get_model_config,
        )
        from luminoth_tpu_torch.utils.predicting import PredictorNetwork
        from luminoth_tpu_torch.utils.serving import apply_serving_profile
        from luminoth_tpu_torch.utils.weights import init_variables

        config = apply_serving_profile(get_model_config(
            get_base_config("ssd"), Config(
                {"model": {"network": {"num_classes": 3}}})), "fast")
        network = PredictorNetwork(config, variables=init_variables(
            config, 0), device=device)
        assert network.int8_calibration_s is not None
        image = np.random.RandomState(0).randint(
            0, 256, (240, 320, 3)).astype(np.uint8)
        nms.nms_alive_cuda.launches = roi_align.roi_crop_pool_cuda.launches = 0
        objects = network.predict_image(image)
        assert nms.nms_alive_cuda.launches == 1
        assert roi_align.roi_crop_pool_cuda.launches == 0
        assert 0 < len(objects) <= 100
        for o in objects:
            assert np.isfinite(o["bbox"]).all() and 0 <= o["label"] < 3


class TestDataParallel:
    """Two gloo ranks sharing ``cuda:0`` (NCCL refuses two ranks on one
    GPU) against one process on the global batch, f32, TF32 off: the
    setting and the tolerances of ``tests/test_torch_parallel.py``."""

    def test_two_rank_step_on_the_card_equals_one_process(self, device):
        from luminoth_tpu_torch.parallel.distributed import spawn_ranks
        from luminoth_tpu_torch.utils.weights import init_variables
        from torch_parallel_worker import (
            RANK_TIMEOUT_S,
            port_steps,
            rank_steps,
            step_config,
            train_batch,
        )

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        config = step_config()
        variables = init_variables(config, seed=0)
        one = port_steps(config, variables, train_batch(), device=device)
        ranks = spawn_ranks(rank_steps, [device, device], backend="gloo",
                            args=([(config, variables, train_batch())],),
                            timeout=RANK_TIMEOUT_S)
        got = [rank[0] for rank in ranks]
        assert got[0]["metrics"] == got[1]["metrics"]
        assert got[0]["counts"][0] != got[1]["counts"][0]
        for metrics, want in zip(got[0]["metrics"], one["metrics"]):
            for key, value in want.items():
                np.testing.assert_allclose(metrics[key], value, rtol=1e-5,
                                           err_msg=key)
        for key, value in one["state"].items():
            np.testing.assert_allclose(got[0]["state"][key].numpy(),
                                       value.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
