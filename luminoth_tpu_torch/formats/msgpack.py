"""Reader and writer for the msgpack checkpoints of the JAX package.

``luminoth_tpu/utils/checkpoint_io.py`` writes its train state with
``flax.serialization.to_bytes``: msgpack maps (dict keys as strings, tuples
as ``{"0": ..., "1": ...}`` maps), with three extension types of flax's:

* code 1, an ndarray: the msgpack triple ``(shape, dtype name, raw C-order
  bytes)``;
* code 2, a Python complex: the pair ``(real, imag)``;
* code 3, a numpy scalar, packed as a 0-d ndarray.

Arrays over 2**30 bytes arrive split into ``__msgpack_chunked_array__``
maps, which are joined back here. :func:`restore` decodes what
``flax.serialization.msgpack_restore`` decodes, in pure Python and numpy:
the port does not depend on ``msgpack`` or flax. ``bfloat16`` has no numpy
dtype here, so its arrays (and scalars) come back as ``torch.bfloat16``
tensors, viewed from their 16-bit patterns; every other array is a numpy
array.

:func:`serialize` writes what ``flax.serialization.msgpack_serialize``
writes, byte for byte: dicts (in key order, as ``jax.tree_util`` rebuilds
them), lists, strings, bytes, Python and numpy
scalars and arrays (a ``torch.bfloat16`` tensor as flax's ``bfloat16``
array), the same smallest encodings as ``msgpack.packb`` with
``strict_types`` (so a numpy float64 scalar is an extension, not a
float), and arrays over :data:`MAX_CHUNK_SIZE` bytes split into chunked
maps. It lets the port write checkpoint-zoo bundles in the JAX layout.
"""

import os
import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# flax splits arrays larger than this many bytes (msgpack's limit is 2**31
# - 1 per object, less a margin).
MAX_CHUNK_SIZE = 2**30

# Fixed-width scalars: lead byte -> (struct format, size).
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# Lead byte -> size of the length field that follows it.
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class MsgpackError(ValueError):
    """The bytes are not a msgpack document this reader decodes."""


class _Decoder:
    def __init__(self, data, raw):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str payloads stay bytes (flax's inner triples)

    def take(self, n):
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError("truncated msgpack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def uint(self, size):
        return int.from_bytes(self.take(size), "big")

    def str_(self, n):
        payload = bytes(self.take(n))
        return payload if self.raw else payload.decode("utf-8")

    def decode(self):
        lead = self.take(1)[0]
        if lead <= 0x7F:
            return lead
        if lead >= 0xE0:
            return lead - 0x100
        if 0x80 <= lead <= 0x8F:
            return self.map_(lead & 0x0F)
        if 0x90 <= lead <= 0x9F:
            return [self.decode() for _ in range(lead & 0x0F)]
        if 0xA0 <= lead <= 0xBF:
            return self.str_(lead & 0x1F)
        if lead == 0xC0:
            return None
        if lead in (0xC2, 0xC3):
            return lead == 0xC3
        if lead in _SCALARS:
            fmt, size = _SCALARS[lead]
            return struct.unpack(fmt, self.take(size))[0]
        if lead in _STR:
            return self.str_(self.uint(_STR[lead]))
        if lead in _BIN:
            return bytes(self.take(self.uint(_BIN[lead])))
        if lead in _ARRAY:
            return [self.decode() for _ in range(self.uint(_ARRAY[lead]))]
        if lead in _MAP:
            return self.map_(self.uint(_MAP[lead]))
        if lead in _EXT or lead in _FIXEXT:
            size = (self.uint(_EXT[lead]) if lead in _EXT
                    else _FIXEXT[lead])
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, self.take(size))
        raise MsgpackError(f"unknown msgpack type byte 0x{lead:02x}")

    def map_(self, n):
        out = {}
        for _ in range(n):
            key = self.decode()
            if isinstance(key, (dict, list)):
                raise MsgpackError("unhashable msgpack map key")
            out[key] = self.decode()
        return out


def _decode(data, raw=False):
    decoder = _Decoder(data, raw)
    value = decoder.decode()
    if decoder.pos != len(decoder.data):
        raise MsgpackError(
            f"{len(decoder.data) - decoder.pos} bytes after the document")
    return value


def _ndarray(payload):
    """flax's ndarray triple → numpy array (bfloat16: torch tensor)."""
    shape, name, buffer = _decode(payload, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape)


def _ext(code, payload):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        value = _ndarray(payload)
        return value.reshape(()) if torch.is_tensor(value) else value[()]
    if code == _EXT_COMPLEX:
        real, imag = _decode(payload)
        return complex(real, imag)
    raise MsgpackError(f"unknown msgpack extension type {code}")


def _unchunk(node):
    """Join ``__msgpack_chunked_array__`` maps back into arrays."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in node.items()}


def restore(data):
    """The tree of a flax msgpack document (``bytes``): nested dicts and
    lists of Python scalars, strings, bytes, numpy arrays and scalars, and
    ``torch.bfloat16`` tensors."""
    return _unchunk(_decode(data))


def load(path):
    """:func:`restore` of the file at ``path``."""
    with open(path, "rb") as f:
        return restore(f.read())


# ------------------------------------------------------------------ writer


def _header(out, size, fix_base, fix_max, wide):
    """A length header: ``fix_base | size`` up to ``fix_max``, else the
    first ``(lead byte, width)`` of ``wide`` that holds ``size``."""
    if fix_base is not None and size <= fix_max:
        out.append(struct.pack(">B", fix_base | size))
        return
    for lead, width in wide:
        if size < 1 << (8 * width):
            out.append(struct.pack(">B", lead) + size.to_bytes(width, "big"))
            return
    raise ValueError(f"msgpack object of {size} items or bytes is too large")


def _int(out, value):
    if 0 <= value < 0x80 or -32 <= value < 0:
        out.append(struct.pack(">b" if value < 0 else ">B", value))
    elif value >= 0:
        for lead, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if value <= limit:
                out.append(struct.pack(">B", lead) + struct.pack(fmt, value))
                return
        raise OverflowError(f"integer {value} is too large for msgpack")
    else:
        for lead, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if value >= limit:
                out.append(struct.pack(">B", lead) + struct.pack(fmt, value))
                return
        raise OverflowError(f"integer {value} is too small for msgpack")


def _ext_bytes(out, code, payload):
    size = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(size)
    if fixed is not None:
        out.append(struct.pack(">B", fixed))
    else:
        _header(out, size, None, 0, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
    out.append(struct.pack(">b", code))
    out.append(payload)


def _as_numpy(value):
    """``(array, dtype name)`` of an array leaf; a bfloat16 tensor as its
    16-bit patterns."""
    if torch.is_tensor(value):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return value.contiguous().view(torch.int16).numpy(), "bfloat16"
        value = value.numpy()
    return value, value.dtype.name


def _array_payload(array, name):
    """flax's ``(shape, dtype name, C-order bytes)`` triple."""
    out = []
    _pack([list(array.shape), name, array.tobytes("C")], out)
    return b"".join(out)


class _Chunk:
    """One chunk of a chunked array, with the array's dtype name."""

    def __init__(self, array, name):
        self.array, self.name = array, name


def _chunk(array, name):
    """flax's chunked form of an array over ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / array.dtype.itemsize))
    flat = array.reshape(-1)
    chunks = [_Chunk(flat[i:i + size], name)
              for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(array.shape)},
            "chunks": {str(i): chunk for i, chunk in enumerate(chunks)}}


def _is_array(value):
    return isinstance(value, np.ndarray) or torch.is_tensor(value)


def _pack(value, out):
    kind = type(value)
    if value is None:
        out.append(b"\xc0")
    elif kind is bool:
        out.append(b"\xc3" if value else b"\xc2")
    elif kind is int:
        _int(out, value)
    elif kind is float:
        out.append(b"\xcb" + struct.pack(">d", value))
    elif kind is str:
        data = value.encode("utf-8")
        _header(out, len(data), 0xA0, 31, ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
        out.append(data)
    elif kind is bytes:
        _header(out, len(value), None, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
        out.append(value)
    elif kind is list:
        _header(out, len(value), 0x90, 15, ((0xDC, 2), (0xDD, 4)))
        for item in value:
            _pack(item, out)
    elif kind is dict:
        _header(out, len(value), 0x80, 15, ((0xDE, 2), (0xDF, 4)))
        for key, item in value.items():
            _pack(key, out)
            _pack(item, out)
    elif kind is _Chunk:
        _ext_bytes(out, _EXT_NDARRAY, _array_payload(value.array, value.name))
    elif _is_array(value):
        _ext_bytes(out, _EXT_NDARRAY, _array_payload(*_as_numpy(value)))
    elif isinstance(value, np.generic):
        array = np.asarray(value)
        _ext_bytes(out, _EXT_NPSCALAR, _array_payload(array, array.dtype.name))
    elif kind is complex:
        inner = []
        _pack([value.real, value.imag], inner)
        _ext_bytes(out, _EXT_COMPLEX, b"".join(inner))
    else:
        raise TypeError(f"can not serialize {kind.__name__!r} object")


def _prepare(node, chunkable=True):
    """The tree as flax packs it: dict keys sorted (``jax.tree_util``
    rebuilds every dict in key order), and arrays over ``MAX_CHUNK_SIZE``
    bytes that are dict values or the root (flax's
    ``_chunk_array_leaves_in_place``) turned into chunked maps."""
    if type(node) is dict:
        return {key: _prepare(node[key]) for key in sorted(node)}
    if type(node) is list:
        return [_prepare(item, chunkable=False) for item in node]
    if chunkable and _is_array(node):
        array, name = _as_numpy(node)
        if array.size * array.dtype.itemsize > MAX_CHUNK_SIZE:
            return _chunk(array, name)
    return node


def serialize(tree):
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` gives."""
    out = []
    _pack(_prepare(tree), out)
    return b"".join(out)


def dump(tree, path):
    """Write :func:`serialize` of ``tree`` to ``path`` (through a temporary
    file, so that a reader never sees half of it)."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(serialize(tree))
    os.replace(tmp, path)
