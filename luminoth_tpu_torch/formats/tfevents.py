"""TensorBoard event files, written without TensorFlow or tensorboardX.

An event file is a TFRecord file (``formats/tfrecord.py``, masked CRC32C
framing) of serialized ``tensorflow.Event`` protos: a first record with
``file_version: "brain.Event:2"``, then one event per summary call with its
wall time, step and a ``Summary`` of one value. The protos are encoded by
hand with the varint helpers of ``formats/example_pb.py``.

:class:`SummaryWriter` has the surface the training loop and the evaluator
call: ``add_scalar``, ``add_image`` (an HWC ``uint8`` array, stored as PNG
through PIL), ``add_histogram`` (tensorboardX's default buckets and bin
trimming), ``flush`` and ``close``. Tags are cleaned as tensorboardX cleans
them, so TensorBoard shows the same names for either writer's files.
:func:`read_events` reads such a file back without TensorFlow.
"""

import io
import itertools
import os
import re
import socket
import struct
import time

import numpy as np

from luminoth_tpu_torch.formats.example_pb import (
    _iter_fields,
    _write_len_delimited,
    _write_tag,
    _write_varint,
)
from luminoth_tpu_torch.formats.tfrecord import TFRecordWriter, read_tfrecords

_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")
_FILE_COUNTER = itertools.count()

# Wire types of the protobuf encoding.
_VARINT, _FIXED64, _FIXED32 = 0, 1, 5
_KINDS = {2: "simple_value", 4: "image", 5: "histo"}


def _default_bins():
    """tensorboardX's histogram bucket limits: ±1e-12·1.1^k up to 1e20."""
    v, buckets = 1e-12, []
    while v < 1e20:
        buckets.append(v)
        v *= 1.1
    return [-b for b in reversed(buckets)] + [0] + buckets


DEFAULT_BINS = _default_bins()


def clean_tag(name):
    """The tag as tensorboardX stores it: characters outside ``[-/\\w.]``
    become ``_`` and leading slashes go."""
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


def _double(out, field, value):
    _write_tag(out, field, _FIXED64)
    out.extend(struct.pack("<d", float(value)))


def _packed_doubles(out, field, values):
    _write_len_delimited(out, field,
                         struct.pack(f"<{len(values)}d", *map(float, values)))


def _uint(out, field, value):
    _write_tag(out, field, _VARINT)
    _write_varint(out, int(value))


def _value(tag, field, payload):
    """A ``Summary.Value``: the tag, then a float (field 2) or a message."""
    out = bytearray()
    _write_len_delimited(out, 1, clean_tag(tag).encode("utf-8"))
    if field == 2:
        _write_tag(out, 2, _FIXED32)
        out.extend(struct.pack("<f", payload))
    else:
        _write_len_delimited(out, field, payload)
    return bytes(out)


def encode_event(wall_time, step=None, summary_value=None,
                 file_version=None):
    """A serialized ``Event``; ``summary_value`` is one encoded value."""
    out = bytearray()
    _double(out, 1, wall_time)
    if step is not None:
        _uint(out, 2, step)
    if file_version is not None:
        _write_len_delimited(out, 3, file_version.encode("utf-8"))
    if summary_value is not None:
        summary = bytearray()
        _write_len_delimited(summary, 1, summary_value)
        _write_len_delimited(out, 5, summary)
    return bytes(out)


def encode_image(array):
    """A ``Summary.Image`` of an (H, W, C) uint8 array, PNG-encoded."""
    from PIL import Image

    array = np.asarray(array)
    if array.dtype != np.uint8:
        array = (array * 255.0).astype(np.uint8)
    height, width, channels = array.shape
    png = io.BytesIO()
    Image.fromarray(array.squeeze(-1) if channels == 1 else array).save(
        png, format="PNG")
    out = bytearray()
    _uint(out, 1, height)
    _uint(out, 2, width)
    _uint(out, 3, channels)
    _write_len_delimited(out, 4, png.getvalue())
    return bytes(out)


def encode_histogram(values, bins=None):
    """A ``HistogramProto`` of ``values``, binned as tensorboardX bins: the
    empty buckets outside the data's support are dropped, keeping one empty
    bucket on the left."""
    values = np.asarray(values, dtype=float).reshape(-1)
    if values.size == 0:
        raise ValueError("a histogram needs at least one value")
    counts, limits = np.histogram(values,
                                  bins=DEFAULT_BINS if bins is None else bins)
    cum_counts = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum_counts, [0, cum_counts[-1] - 1],
                                 side="right")
    start, end = int(start), int(end) + 1
    counts = (counts[start - 1:end] if start > 0
              else np.concatenate([[0], counts[:end]]))
    limits = limits[start:end + 1]
    out = bytearray()
    _double(out, 1, values.min())
    _double(out, 2, values.max())
    _double(out, 3, len(values))
    _double(out, 4, values.sum())
    _double(out, 5, values.dot(values))
    _packed_doubles(out, 6, limits.tolist())
    _packed_doubles(out, 7, counts.tolist())
    return bytes(out)


class SummaryWriter:
    """Writes one event file under ``logdir``; every call writes its event
    at once (``flush`` pushes the file's buffer to the disk)."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "events.out.tfevents.{:010d}.{}.{}.{}"
                                 .format(int(time.time()),
                                         socket.gethostname(), os.getpid(),
                                         next(_FILE_COUNTER)))
        self._records = TFRecordWriter(self.path)
        self._records.write(encode_event(time.time(),
                                         file_version="brain.Event:2"))
        self._records.flush()

    def _add(self, step, value, walltime=None):
        self._records.write(encode_event(
            time.time() if walltime is None else walltime,
            step=step, summary_value=value))

    def add_scalar(self, tag, value, global_step=None, walltime=None):
        self._add(global_step, _value(tag, 2, float(value)), walltime)

    def add_image(self, tag, img, global_step=None, walltime=None,
                  dataformats="CHW"):
        img = np.asarray(img)
        if dataformats == "CHW":
            img = img.transpose(1, 2, 0)
        elif dataformats != "HWC":
            raise ValueError(f"unsupported dataformats {dataformats!r}")
        self._add(global_step, _value(tag, 4, encode_image(img)), walltime)

    def add_histogram(self, tag, values, global_step=None, bins=None,
                      walltime=None):
        self._add(global_step,
                  _value(tag, 5, encode_histogram(values, bins)), walltime)

    def flush(self):
        self._records.flush()

    def close(self):
        self._records.close()


def read_events(path):
    """``[(step, tag, kind, value)]`` of the summary values of an event
    file, in order: ``kind`` is ``"simple_value"`` (a float),
    ``"image"`` (the encoded PNG bytes) or ``"histo"`` (the serialized
    ``HistogramProto``)."""
    out = []
    for record in read_tfrecords(path):
        step, summary = 0, None
        for field, _, value in _iter_fields(record):
            if field == 2:
                step = value
            elif field == 5:
                summary = value
        for _, _, value in _iter_fields(summary or b""):
            tag, kind, payload = None, None, None
            for field, _, part in _iter_fields(value):
                if field == 1:
                    tag = bytes(part).decode("utf-8")
                elif field in _KINDS:
                    kind = _KINDS[field]
                    payload = struct.unpack("<f", part)[0] if field == 2 \
                        else bytes(part)
            if kind == "image":
                payload = next(bytes(p) for f, _, p in _iter_fields(payload)
                               if f == 4)
            out.append((step, tag, kind, payload))
    return out
