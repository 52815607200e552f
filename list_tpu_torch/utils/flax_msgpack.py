"""Reader of the msgpack that ``flax.serialization.msgpack_serialize``
writes (the JAX package's ``.ckpt`` files), with the standard library and
numpy, so that no ``msgpack`` package is needed.

The subset: maps, arrays, str, bin, ints, floats, nil and bool; ext type 1,
an ndarray packed as the msgpack array ``(shape, dtype name, C-order
bytes)``; ext type 3, a numpy scalar packed the same way; and flax's
``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``
maps, which it writes for arrays over ``MAX_CHUNK_SIZE`` (2**30) bytes and
which are joined back into one array.  A ``bfloat16`` leaf, which numpy has
no type for, becomes a ``torch.bfloat16`` tensor of the same bits; every
other array leaf is a read-only numpy array.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_CHUNKED = '__msgpack_chunked_array__'
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _array(payload: bytes):
    shape, dtype, data = _Reader(payload).value()
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == 'bfloat16':
        bits = np.frombuffer(data, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(data, np.dtype(dtype)).reshape(shape)


def _unchunk(d: dict):
    n = len(d['chunks'])
    chunks = [d['chunks'][str(i)] for i in range(n)]
    shape = tuple(d['shape'][str(i)] for i in range(len(d['shape'])))
    cat = (torch.cat([c.reshape(-1) for c in chunks])
           if isinstance(chunks[0], torch.Tensor)
           else np.concatenate([c.reshape(-1) for c in chunks]))
    return cat.reshape(shape)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError('flax msgpack: truncated input')
        self.pos += n
        return bytes(out)

    def unpack(self, fmt: str) -> Any:
        return struct.unpack('>' + fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int) -> Any:
        code = self.unpack('b')
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _array(payload)
        if code == _EXT_NPSCALAR:
            a = _array(payload)
            return a if isinstance(a, torch.Tensor) else a[()]
        raise ValueError(f'flax msgpack: ext type {code} is not read')

    def seq(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def mapping(self, n: int):
        d = {}
        for _ in range(n):
            k = self.value()
            d[k] = self.value()
        return _unchunk(d) if _CHUNKED in d else d

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.mapping(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.seq(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.take(b & 0x1f).decode()
        if b in _FIXED:
            return _FIXED[b](self)
        raise ValueError(f'flax msgpack: byte 0x{b:02x} is not read')


_FIXED = {
    0xc0: lambda r: None,
    0xc2: lambda r: False,
    0xc3: lambda r: True,
    0xc4: lambda r: r.take(r.unpack('B')),
    0xc5: lambda r: r.take(r.unpack('H')),
    0xc6: lambda r: r.take(r.unpack('I')),
    0xc7: lambda r: r.ext(r.unpack('B')),
    0xc8: lambda r: r.ext(r.unpack('H')),
    0xc9: lambda r: r.ext(r.unpack('I')),
    0xca: lambda r: r.unpack('f'),
    0xcb: lambda r: r.unpack('d'),
    0xcc: lambda r: r.unpack('B'),
    0xcd: lambda r: r.unpack('H'),
    0xce: lambda r: r.unpack('I'),
    0xcf: lambda r: r.unpack('Q'),
    0xd0: lambda r: r.unpack('b'),
    0xd1: lambda r: r.unpack('h'),
    0xd2: lambda r: r.unpack('i'),
    0xd3: lambda r: r.unpack('q'),
    0xd4: lambda r: r.ext(1),
    0xd5: lambda r: r.ext(2),
    0xd6: lambda r: r.ext(4),
    0xd7: lambda r: r.ext(8),
    0xd8: lambda r: r.ext(16),
    0xd9: lambda r: r.take(r.unpack('B')).decode(),
    0xda: lambda r: r.take(r.unpack('H')).decode(),
    0xdb: lambda r: r.take(r.unpack('I')).decode(),
    0xdc: lambda r: r.seq(r.unpack('H')),
    0xdd: lambda r: r.seq(r.unpack('I')),
    0xde: lambda r: r.mapping(r.unpack('H')),
    0xdf: lambda r: r.mapping(r.unpack('I')),
}


def msgpack_restore(encoded: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns, with
    bfloat16 leaves as torch tensors."""
    r = _Reader(encoded)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError('flax msgpack: trailing bytes')
    return out

