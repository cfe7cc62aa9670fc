"""A reader of the msgpack that flax writes (``flax.serialization.
msgpack_serialize``), in pure Python: the JAX package's checkpoints are
such files (JAX training/checkpoint.py), and the card's machine has no
``msgpack`` package.

It covers what flax writes: maps, arrays, str and bin, integers, floats,
nil and bool, and flax's extension types: 1, an ndarray (a nested msgpack
array of (shape, dtype name, C-order bytes)); 2, a Python complex (a nested
(real, imag)); 3, a numpy scalar (an ndarray of shape ()).  Arrays above
flax's ``MAX_CHUNK_SIZE`` come as ``{"__msgpack_chunked_array__": True,
"shape": {...}, "chunks": {...}}`` maps and are joined back, as flax's
``_unchunk`` does.  numpy has no bfloat16: a bfloat16 ndarray is read as
uint16 and comes back as a ``torch.bfloat16`` tensor; every other ndarray is
a read-only numpy array over the file's bytes.

``restore(data)`` returns what ``flax.serialization.msgpack_restore`` does
(msgpack arrays as lists, map keys as str), with the bfloat16 difference
above.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        # flax's inner ndarrays: str as bytes, bin as a view of the data
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:                       # bin 8 / 16 / 32
            v = self._take(self._uint(1 << (b - 0xC4)))
            return v if self.raw else bytes(v)
        if 0xC7 <= b <= 0xC9:                       # ext 8 / 16 / 32
            n = self._uint(1 << (b - 0xC7))
            return self._ext(self._take(1)[0], self._take(n))
        if b == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= b <= 0xCF:                       # uint 8 .. 64
            return self._uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:                       # int 8 .. 64
            n = 1 << (b - 0xD0)
            return int.from_bytes(self._take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:                       # fixext 1 .. 16
            code = self._take(1)[0]
            return self._ext(code, self._take(1 << (b - 0xD4)))
        if 0xD9 <= b <= 0xDB:                       # str 8 / 16 / 32
            return self._str(self._uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):                       # array 16 / 32
            return [self.value() for _ in range(self._uint(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):                       # map 16 / 32
            return self._map(self._uint(2 << (b - 0xDE)))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one flax "
                         "writes")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, code: int, payload: memoryview):
        if code in (1, 3):
            arr = _ndarray(payload)
            return arr if code == 1 else arr[()]
        if code == 2:
            re, im = _Reader(payload, raw=False).value()
            return complex(re, im)
        raise ValueError(f"msgpack extension type {code} is not one flax "
                         "writes")


def _ndarray(payload: memoryview):
    shape, name, buf = _Reader(payload, raw=True).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    order = lambda m: [m[str(i)] for i in range(len(m))]
    chunks = order(d["chunks"])
    flat = torch.cat(chunks) if isinstance(chunks[0], torch.Tensor) \
        else np.concatenate(chunks)
    return flat.reshape(tuple(order(d["shape"])))


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def restore(data) -> object:
    """The tree of a flax msgpack blob (``bytes`` or a buffer)."""
    r = _Reader(data, raw=False)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return _unchunk_tree(tree)
