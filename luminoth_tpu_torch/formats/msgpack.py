"""Reader for the msgpack checkpoints of the JAX package.

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
"""

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

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
