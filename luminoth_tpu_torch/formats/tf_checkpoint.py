"""TensorFlow checkpoint reader in pure Python: V1 files and V2 bundles.

The slim ImageNet tarballs (2016/2017) hold V1 checkpoints, and the
reference Luminoth's trained detectors (TF >= 1.5) are V2 tensor bundles.
Both are leveldb tables (SSTables), read here without TensorFlow and
without the ``protobuf`` package; the protocol buffers inside are decoded
from the wire format by hand.

SSTable: data blocks, a metaindex block, an index block, and a 48-byte
footer (the two block handles as varints, zero padding, then the magic
``57fb808b247547db``). A block is prefix-compressed entries, a restart
array and its count; a 5-byte trailer follows it (the compression type
byte, 0 none or 1 snappy, then the masked crc32c of the block and the
type byte).

* **V2** (``prefix.index`` + ``prefix.data-XXXXX-of-YYYYY``): the index
  maps ``""`` to a ``BundleHeaderProto`` and each tensor name to a
  ``BundleEntryProto`` (dtype, shape, shard, offset, size, masked crc32c
  of the bytes). The bytes are the tensor in C order, little-endian.
* **V1** (one file, or ``prefix-XXXXX-of-YYYYY`` shards): ``""`` maps to a
  ``SavedTensorSlices`` whose ``meta`` lists each tensor's name, shape,
  dtype and slices; every other key holds one ``SavedSlice`` whose
  ``TensorProto`` carries the values (packed ``float_val`` and friends, or
  ``tensor_content``). A tensor saved in several slices is assembled.

    reader = open_checkpoint("model.ckpt-1000")
    for name in reader.names():
        value = reader.read(name)  # ndarray
"""

import glob
import os
import re
import struct

import numpy as np

from luminoth_tpu_torch.formats.crc32c import crc32c

MAGIC = bytes.fromhex("57fb808b247547db")
FOOTER_SIZE = 48

# TF DataType enum -> numpy dtype (reference types are the value + 100).
DTYPES = {
    1: np.dtype("<f4"),   # DT_FLOAT
    2: np.dtype("<f8"),   # DT_DOUBLE
    3: np.dtype("<i4"),   # DT_INT32
    4: np.dtype("u1"),    # DT_UINT8
    5: np.dtype("<i2"),   # DT_INT16
    6: np.dtype("i1"),    # DT_INT8
    9: np.dtype("<i8"),   # DT_INT64
    10: np.dtype("?"),    # DT_BOOL
    14: np.dtype("<u2"),  # DT_BFLOAT16, as its bit pattern
    17: np.dtype("<u2"),  # DT_UINT16
    19: np.dtype("<f2"),  # DT_HALF
    22: np.dtype("<u4"),  # DT_UINT32
    23: np.dtype("<u8"),  # DT_UINT64
}
DT_BFLOAT16 = 14
DT_NAMES = {7: "string", 8: "complex64", 18: "complex128", 20: "resource",
            21: "variant"}


def _mask(crc):
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf wire format


def _varint(buf, pos):
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _signed64(value):
    return value - (1 << 64) if value >= 1 << 63 else value


def fields(buf):
    """Yield ``(field number, wire type, value)`` of a serialized message:
    an int for varints, ``bytes`` for length-delimited, fixed32 and
    fixed64 fields."""
    buf = memoryview(buf)
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = bytes(buf[pos:pos + 8]), pos + 8
        elif wire == 2:
            length, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + length], pos + length
        elif wire == 5:
            value, pos = bytes(buf[pos:pos + 4]), pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, value


def _packed_varints(value, wire):
    if wire == 0:
        return [value]
    out, pos, buf = [], 0, memoryview(value)
    while pos < len(buf):
        item, pos = _varint(buf, pos)
        out.append(item)
    return out


def _shape(buf):
    """``TensorShapeProto`` -> tuple of dims."""
    dims = []
    for number, _, value in fields(buf):
        if number == 2:  # dim
            size = 0
            for n, _, v in fields(value):
                if n == 1:
                    size = _signed64(v)
            dims.append(size)
        elif number == 3 and value:
            raise ValueError("checkpoint tensor of unknown rank")
    return tuple(dims)


def _extents(buf):
    """``TensorSliceProto`` -> ``[(start, length or None)]`` per dim (an
    extent without a length covers the whole dim)."""
    extents = []
    for number, _, value in fields(buf):
        if number == 1:
            start, length = 0, None
            for n, _, v in fields(value):
                if n == 1:
                    start = _signed64(v)
                elif n == 2:
                    length = _signed64(v)
            extents.append((start, length))
    return extents


def _slice(buf, shape):
    """``TensorSliceProto`` -> tuple of python slices over ``shape``."""
    extents = _extents(buf)
    if not extents:  # the full tensor
        return tuple(slice(0, d) for d in shape)
    return tuple(
        slice(0, dim) if length is None else slice(start, start + length)
        for (start, length), dim in zip(extents, shape))


def _ordered_signed(value):
    """TF's ``OrderedCode::WriteSignedNumIncreasing``: big-endian two's
    complement in the fewest bytes, the byte count as leading 1-bits."""
    x = ~value if value < 0 else value
    length = x.bit_length() // 7 + 1
    raw = bytearray((value & ((1 << (8 * length)) - 1)).to_bytes(length,
                                                                  "big"))
    header = (0xFFFF << (16 - length)) & 0xFFFF
    raw[0] ^= header >> 8
    if length > 1:
        raw[1] ^= header & 0xFF
    return bytes(raw)


def _slice_key(name, extents):
    """TF's ``EncodeTensorNameSlice``: the table key of one saved slice."""
    escaped = b"".join(
        {0: b"\x00\xff", 0xFF: b"\xff\x00"}.get(c, bytes([c]))
        for c in name.encode("utf-8"))
    key = b"\x00" + escaped + b"\x00\x01"
    key += bytes([1, len(extents)]) if extents else b"\x00"
    for start, length in extents:
        key += _ordered_signed(start) + _ordered_signed(
            -1 if length is None else length)
    return key


def _dtype(enum, name):
    enum = enum - 100 if enum > 100 else enum
    if enum not in DTYPES:
        raise ValueError(
            f"variable {name!r} has an unsupported dtype "
            f"({DT_NAMES.get(enum, f'DataType {enum}')})")
    return enum, DTYPES[enum]


def _as_array(raw, enum, shape):
    """Tensor bytes -> ndarray; bfloat16 widens to float32."""
    array = np.frombuffer(raw, dtype=DTYPES[enum]).reshape(shape)
    if enum == DT_BFLOAT16:
        array = (array.astype(np.uint32) << 16).view(np.float32)
    return array


# ----------------------------------------------------------- snappy, SSTable


def snappy_decompress(data):
    """Decompress one raw snappy block (leveldb's compression type 1)."""
    data = memoryview(data)
    length, pos = _varint(data, 0)
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            size = tag >> 2
            if size >= 60:
                extra = size - 59
                size = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            size += 1
            out += data[pos:pos + size]
            pos += size
            continue
        if kind == 1:
            size = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            size = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:
            size = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if not 0 < offset <= len(out):
            raise ValueError("corrupt snappy block: bad copy offset")
        start = len(out) - offset
        for i in range(size):  # copies may overlap their own output
            out.append(out[start + i])
    if len(out) != length:
        raise ValueError("corrupt snappy block: wrong length")
    return bytes(out)


def _block_entries(block):
    """Yield the ``(key, value)`` entries of one decoded table block."""
    block = memoryview(block)
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * num_restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_length, pos = _varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + non_shared])
        pos += non_shared
        yield key, block[pos:pos + value_length]
        pos += value_length


class SSTable:
    """The entries of a leveldb table file, in key order."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            self._data = f.read()
        if (len(self._data) < FOOTER_SIZE
                or self._data[-8:] != MAGIC):
            raise ValueError(f"{path} is not a TF checkpoint table "
                             "(no SSTable magic)")
        footer = memoryview(self._data)[-FOOTER_SIZE:]
        _, pos = _varint(footer, 0)
        _, pos = _varint(footer, pos)  # metaindex handle: not needed
        offset, pos = _varint(footer, pos)
        size, _ = _varint(footer, pos)
        self._index = self._block(offset, size)

    def _block(self, offset, size):
        contents = self._data[offset:offset + size]
        kind = self._data[offset + size]
        stored = struct.unpack_from("<I", self._data, offset + size + 1)[0]
        if _mask(crc32c(contents + bytes([kind]))) != stored:
            raise ValueError(f"{self.path}: block at {offset} fails its crc")
        if kind == 0:
            return contents
        if kind == 1:
            return snappy_decompress(contents)
        raise ValueError(f"{self.path}: block at {offset} has unsupported "
                         f"compression type {kind}")

    def items(self):
        for _, handle in _block_entries(self._index):
            offset, pos = _varint(handle, 0)
            size, _ = _varint(handle, pos)
            yield from _block_entries(self._block(offset, size))


# ------------------------------------------------------------------ readers


class BundleReader:
    """A V2 tensor bundle: ``prefix.index`` and its data shards."""

    version = 2

    def __init__(self, prefix):
        self.prefix = prefix
        self._entries = {}
        self._slice_entries = {}  # by their encoded keys
        num_shards = 1
        for key, value in SSTable(prefix + ".index").items():
            if key == b"":
                for number, _, v in fields(value):
                    if number == 1:
                        num_shards = v
            elif key[0] == 0:
                self._slice_entries[key] = self._entry(bytes(value))
            else:
                self._entries[key.decode("utf-8")] = self._entry(
                    bytes(value))
        self._num_shards = num_shards
        self._shards = {}

    @staticmethod
    def _entry(buf):
        entry = {"dtype": 0, "shape": (), "shard": 0, "offset": 0,
                 "size": 0, "crc": None, "slices": []}
        for number, _, value in fields(buf):
            if number == 1:
                entry["dtype"] = value
            elif number == 2:
                entry["shape"] = _shape(value)
            elif number == 3:
                entry["shard"] = value
            elif number == 4:
                entry["offset"] = _signed64(value)
            elif number == 5:
                entry["size"] = _signed64(value)
            elif number == 6:
                entry["crc"] = struct.unpack("<I", value)[0]
            elif number == 7:
                entry["slices"].append(_extents(value))
        return entry

    def names(self):
        return sorted(self._entries)

    def shape(self, name):
        return self._entries[name]["shape"]

    def _shard(self, shard):
        if shard not in self._shards:
            path = (f"{self.prefix}.data-{shard:05d}-of-"
                    f"{self._num_shards:05d}")
            with open(path, "rb") as f:
                self._shards[shard] = f.read()
        return self._shards[shard]

    def _bytes(self, entry, name):
        data = self._shard(entry["shard"])
        raw = data[entry["offset"]:entry["offset"] + entry["size"]]
        if len(raw) != entry["size"]:
            raise ValueError(f"variable {name!r}: its data shard is short")
        if entry["crc"] is not None and _mask(crc32c(raw)) != entry["crc"]:
            raise ValueError(f"variable {name!r} fails its crc32c")
        return raw

    def read(self, name):
        entry = self._entries[name]
        enum, _ = _dtype(entry["dtype"], name)
        if not entry["slices"]:
            return _as_array(self._bytes(entry, name), enum,
                             entry["shape"]).copy()
        # A partitioned variable: one entry per saved slice.
        shape = entry["shape"]
        full = np.zeros(shape, _as_array(b"", enum, (0,)).dtype)
        for extents in entry["slices"]:
            part = self._slice_entries.get(_slice_key(name, extents))
            if part is None:
                raise ValueError(f"variable {name!r}: a saved slice is "
                                 "missing from the index")
            index = tuple(
                slice(0, dim) if length is None
                else slice(start, start + length)
                for (start, length), dim in zip(extents, shape))
            full[index] = _as_array(
                self._bytes(part, name), enum,
                tuple(s.stop - s.start for s in index))
        return full


# TensorProto fields holding values, by (dtype enum) -> field number.
_VALUE_FIELDS = {1: 5, 2: 6, 3: 7, 4: 7, 5: 7, 6: 7, 9: 10, 10: 11,
                 14: 13, 17: 7, 19: 13, 22: 16, 23: 17}


def _tensor_proto_values(buf, enum, count, name):
    """The values of a ``TensorProto`` as a flat array of ``count``."""
    dtype = DTYPES[enum]
    field = _VALUE_FIELDS[enum]
    content = None
    values = []
    for number, wire, value in fields(buf):
        if number == 4:
            content = bytes(value)
        elif number == field:
            if field in (5, 6):  # float_val / double_val: fixed width
                values.append(np.frombuffer(
                    bytes(value), "<f4" if field == 5 else "<f8"))
            else:
                values.append(np.asarray(
                    [_signed64(v) if field in (7, 10) else v
                     for v in _packed_varints(value, wire)]))
    if content is not None:
        flat = _as_array(content, enum, (-1,))
    else:
        flat = (np.concatenate(values) if values
                else np.zeros(0, dtype))
        if enum == DT_BFLOAT16:
            flat = _as_array(flat.astype("<u2").tobytes(), enum, (-1,))
        elif enum == 19:  # half_val holds the bit patterns
            flat = flat.astype("<u2").view("<f2")
        else:
            flat = flat.astype(dtype)
    if flat.size == 1 and count > 1:  # a splat of one value
        flat = np.full(count, flat[0], flat.dtype)
    if flat.size != count:
        raise ValueError(f"variable {name!r}: a slice holds {flat.size} "
                         f"values, expected {count}")
    return flat


class SlicedReader:
    """A V1 checkpoint: one table file, or ``prefix-XXXXX-of-YYYYY``
    shards; tensors assembled from their saved slices."""

    version = 1

    def __init__(self, paths):
        self._meta = {}
        self._slices = {}
        for path in paths:
            for key, value in SSTable(path).items():
                if key == b"":
                    self._read_meta(value)
                else:
                    self._read_slice(value)

    def _read_meta(self, buf):
        for number, _, value in fields(buf):
            if number != 1:  # meta
                continue
            for n, _, tensor in fields(value):
                if n != 1:
                    continue
                name, shape, enum = "", (), 0
                for m, _, v in fields(tensor):
                    if m == 1:
                        name = bytes(v).decode("utf-8")
                    elif m == 2:
                        shape = _shape(v)
                    elif m == 3:
                        enum = v
                self._meta[name] = (shape, enum)

    def _read_slice(self, buf):
        for number, _, value in fields(buf):
            if number != 2:  # data
                continue
            name, extent, data = "", None, None
            for n, _, v in fields(value):
                if n == 1:
                    name = bytes(v).decode("utf-8")
                elif n == 2:
                    extent = bytes(v)
                elif n == 3:
                    data = bytes(v)
            self._slices.setdefault(name, []).append((extent, data))

    def names(self):
        return sorted(self._meta)

    def shape(self, name):
        return self._meta[name][0]

    def read(self, name):
        shape, enum = self._meta[name]
        enum, dtype = _dtype(enum, name)
        out_dtype = np.float32 if enum == DT_BFLOAT16 else dtype
        full = np.zeros(shape, out_dtype)
        covered = 0
        for extent, data in self._slices.get(name, []):
            index = _slice(extent or b"", shape)
            sub = tuple(s.stop - s.start for s in index)
            count = int(np.prod(sub, dtype=np.int64))
            full[index] = _tensor_proto_values(
                data or b"", enum, count, name).reshape(sub)
            covered += count
        if covered != full.size:
            raise ValueError(f"variable {name!r}: its slices cover "
                             f"{covered} of {full.size} values")
        return full


def _state_file_prefix(directory):
    """The ``model_checkpoint_path`` of a directory's ``checkpoint`` file."""
    path = os.path.join(directory, "checkpoint")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint state file in {directory}")
    with open(path) as f:
        match = re.search(r'^model_checkpoint_path:\s*"(.*)"', f.read(),
                          re.MULTILINE)
    if match is None:
        raise ValueError(f"{path} names no model_checkpoint_path")
    prefix = match.group(1).encode().decode("unicode_escape")
    return prefix if os.path.isabs(prefix) else os.path.join(directory,
                                                             prefix)


def open_checkpoint(path):
    """A reader of the checkpoint at ``path``, with ``names()``,
    ``shape(name)`` and ``read(name)`` (an ndarray; bfloat16 as float32).

    ``path`` is what ``tf.train.load_checkpoint`` takes: a V2 prefix (with
    ``path.index`` beside it), a V1 file (or the prefix of V1 shards), or
    a directory whose ``checkpoint`` state file names the prefix.
    """
    path = os.fspath(path)
    if os.path.isdir(path):
        path = _state_file_prefix(path)
    if os.path.exists(path + ".index"):
        return BundleReader(path)
    if os.path.isfile(path):
        return SlicedReader([path])
    shards = sorted(glob.glob(glob.escape(path) + "-?????-of-?????"))
    if shards:
        return SlicedReader(shards)
    raise FileNotFoundError(f"no TF checkpoint at {path}")


def checkpoint_reader(path):
    """``name -> ndarray | None`` over the checkpoint at ``path`` (None for
    a name it does not hold), the converters' ``read_tensor``."""
    reader = open_checkpoint(path)
    names = set(reader.names())

    def read_tensor(name):
        return reader.read(name) if name in names else None

    return read_tensor
