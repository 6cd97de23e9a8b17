"""Serving profiles and dynamic request batching (counterpart of the JAX
package's ``utils/serving.py``).

The web server (``tools/server/web.py``) handles each request on its own
thread. The :class:`MicroBatcher` coalesces requests that arrive within a
short window into ONE ``predict_batch`` device forward. Batches pad to
power-of-two buckets up to ``max_batch``, so sparse traffic keeps the
single-image forward while bursts ride the batched one.
"""

import logging
import threading
import time

logger = logging.getLogger(__name__)

SERVING_PROFILES = ("accurate", "fast")


def apply_serving_profile(config, profile):
    """Apply a named serving profile's knobs to a resolved config.

    ``accurate`` (default): the reference's inference settings, unchanged.
    ``fast``: the JAX package's fast profile, the same knobs:
      * ``dataset.transfer_dtype=uint8`` (pixels cast back on the device);
      * Faster R-CNN proposal budget 6000/1000 instead of 12000/2000;
      * int8 with static calibrated activation scales (``int8_tail`` for
        Faster R-CNN, ``int8_trunk`` otherwise, and ``int8_static``; see
        ``models/base/quantized_tail.py``). ``PredictorNetwork``
        calibrates at load; set ``model.base_network.
        int8_calibration_images`` for real-data activation ranges.
    """
    if profile in (None, "", "accurate"):
        return config
    if profile != "fast":
        raise ValueError(
            f"unknown serving profile {profile!r}; "
            f"choose from {SERVING_PROFILES}"
        )
    config.dataset.transfer_dtype = "uint8"
    config.model.base_network.int8_static = True
    if config.model.type == "fasterrcnn":
        config.model.rpn.proposals.pre_nms_top_n = 6000
        config.model.rpn.proposals.post_nms_top_n = 1000
        config.model.base_network.int8_tail = True
    else:
        config.model.base_network.int8_trunk = True
    return config


class _Ticket:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Coalesce concurrent ``predict_image`` calls into batched forwards.

    Args:
        network: object with ``predict_batch(images, pad_to=None)``.
        max_batch: largest device batch (and padding bucket ceiling).
        max_wait_ms: how long the worker waits for more requests after
            the first one arrives. Keep small: it bounds the added latency
            on sparse traffic.
    """

    def __init__(self, network, max_batch=8, max_wait_ms=2.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._network = network
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1000.0
        self._lock = threading.Lock()
        self._pending = []
        self._wakeup = threading.Event()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _bucket(self, n):
        size = 1
        while size < n:
            size *= 2
        return min(size, self._max_batch)

    def predict_image(self, image):
        """Submit one image; blocks until its detections are ready."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        ticket = _Ticket(image)
        with self._lock:
            self._pending.append(ticket)
        self._wakeup.set()
        ticket.event.wait()
        if ticket.error is not None:
            raise ticket.error
        return ticket.result

    def _run(self):
        while True:
            self._wakeup.wait()
            if self._closed:
                return
            # First request seen: give followers a short window to join.
            if self._max_wait_s > 0:
                time.sleep(self._max_wait_s)
            with self._lock:
                group = self._pending[: self._max_batch]
                del self._pending[: len(group)]
                if not self._pending:
                    self._wakeup.clear()
            if not group:
                continue
            try:
                results = self._network.predict_batch(
                    [t.image for t in group],
                    pad_to=self._bucket(len(group)),
                )
                for ticket, result in zip(group, results):
                    ticket.result = result
            except Exception as e:  # propagate to every waiter
                logger.exception("Batched predict failed: %s", e)
                for ticket in group:
                    ticket.error = e
            for ticket in group:
                ticket.event.set()

    def close(self):
        self._closed = True
        with self._lock:
            pending, self._pending = self._pending, []
        for ticket in pending:  # don't strand un-popped waiters
            ticket.error = RuntimeError("MicroBatcher closed")
            ticket.event.set()
        self._wakeup.set()
