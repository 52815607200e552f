"""Reader and writer of the msgpack that
``flax.serialization.msgpack_serialize`` writes (the JAX package's
``.ckpt`` files), with the standard library and numpy, so that no
``msgpack`` package is needed.

The subset: maps, arrays, str, bin, ints, floats, nil and bool; ext type 1,
an ndarray packed as the msgpack array ``(shape, dtype name, C-order
bytes)``; ext type 3, a numpy scalar packed the same way; and flax's
``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``
maps, which it writes for arrays over ``MAX_CHUNK_SIZE`` (2**30) bytes and
which are joined back into one array.  A ``bfloat16`` leaf, which numpy has
no type for, becomes a ``torch.bfloat16`` tensor of the same bits; every
other array leaf is a read-only numpy array.

``msgpack_serialize`` writes the same bytes as flax for a tree of dicts
with str keys, ints, floats, str, bytes, None, bools, numpy arrays and
scalars, and torch tensors (packed as the numpy array of their values; a
``torch.bfloat16`` tensor with the dtype name ``bfloat16``), with the
keys of every map sorted and an array leaf over ``MAX_CHUNK_SIZE`` bytes
chunked, as flax writes them.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_CHUNKED = '__msgpack_chunked_array__'
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30


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



# ---- writer -----------------------------------------------------------------

def _sized(small_tag: int, small_max: int, tags, n: int) -> bytes:
    """The header of a str/bin/array/map/ext of length ``n``: the fixed
    form below ``small_max`` (``small_tag`` | n), else 8/16/32-bit."""
    if small_tag is not None and n < small_max:
        return bytes([small_tag | n])
    for tag, fmt, top in zip(tags, ('B', 'H', 'I'), (0xff, 0xffff,
                                                     0xffffffff)):
        if tag is not None and n <= top:
            return bytes([tag]) + struct.pack('>' + fmt, n)
    raise ValueError(f'flax msgpack: length {n} is too large')


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack('>b', v)
    if v >= 0:
        for tag, fmt, top in ((0xcc, 'B', 0xff), (0xcd, 'H', 0xffff),
                              (0xce, 'I', 0xffffffff),
                              (0xcf, 'Q', 0xffffffffffffffff)):
            if v <= top:
                return bytes([tag]) + struct.pack('>' + fmt, v)
    else:
        for tag, fmt, bot in ((0xd0, 'b', -0x80), (0xd1, 'h', -0x8000),
                              (0xd2, 'i', -0x80000000),
                              (0xd3, 'q', -0x8000000000000000)):
            if v >= bot:
                return bytes([tag]) + struct.pack('>' + fmt, v)
    raise ValueError(f'flax msgpack: int {v} is out of range')


def _as_numpy(x) -> Tuple[np.ndarray, str]:
    """(numpy array of the values, dtype name) of an array leaf; a bf16
    tensor's values are its bits as int16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), 'bfloat16'
        x = x.numpy()
    x = np.asarray(x)
    return x, x.dtype.name


def _array_payload(a: np.ndarray, name: str) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack array (shape, dtype
    name, C-order bytes)."""
    out = [_sized(0x90, 16, (None, 0xdc, 0xdd), 3),
           _sized(0x90, 16, (None, 0xdc, 0xdd), a.ndim)]
    out += [_int(int(d)) for d in a.shape]
    nb = name.encode()
    out += [_sized(0xa0, 32, (0xd9, 0xda, 0xdb), len(nb)), nb]
    data = a.tobytes('C')
    out += [_sized(None, 0, (0xc4, 0xc5, 0xc6), len(data)), data]
    return b''.join(out)


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    head = (bytes([fixed]) if fixed is not None
            else _sized(None, 0, (0xc7, 0xc8, 0xc9), n))
    return head + struct.pack('>b', code) + payload


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes if isinstance(x, np.ndarray) else 0


def _chunk(x) -> dict:
    """flax's ``_chunk``: a flat array split into MAX_CHUNK_SIZE-byte
    pieces."""
    a, name = _as_numpy(x)
    flat = a.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    pieces = [flat[i:i + size] for i in range(0, flat.size, size)]
    if name == 'bfloat16':
        pieces = [torch.from_numpy(np.ascontiguousarray(p)).view(
            torch.bfloat16) for p in pieces]
    return {'shape': {str(i): d for i, d in enumerate(a.shape)},
            'chunks': {str(i): p for i, p in enumerate(pieces)}}


def _pack_map(d: dict, out: list, sort: bool) -> None:
    """A map; flax's tree copy sorts the keys of the caller's dicts, not
    those of the chunked-array maps it builds after it."""
    out.append(_sized(0x80, 16, (None, 0xde, 0xdf), len(d)))
    for k in (sorted(d) if sort else d):
        _pack(k, out)
        x = d[k]
        if _nbytes(x) > MAX_CHUNK_SIZE:
            c = _chunk(x)
            out.append(_sized(0x80, 16, (None, 0xde, 0xdf), 3))
            for ck in (_CHUNKED, 'shape', 'chunks'):
                _pack(ck, out)
                if ck == _CHUNKED:
                    _pack(True, out)
                else:
                    _pack_map(c[ck], out, sort=False)
        else:
            _pack(x, out)


def _pack(v, out: list) -> None:
    if v is None:
        out.append(b'\xc0')
    elif isinstance(v, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _array_payload(*_as_numpy(v))))
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        out.append(_ext(_EXT_NDARRAY, _array_payload(*_as_numpy(v))))
    elif isinstance(v, bool):
        out.append(b'\xc3' if v else b'\xc2')
    elif isinstance(v, int):
        out.append(_int(v))
    elif isinstance(v, float):
        out.append(b'\xcb' + struct.pack('>d', v))
    elif isinstance(v, str):
        b = v.encode()
        out += [_sized(0xa0, 32, (0xd9, 0xda, 0xdb), len(b)), b]
    elif isinstance(v, bytes):
        out += [_sized(None, 0, (0xc4, 0xc5, 0xc6), len(v)), v]
    elif isinstance(v, dict):
        _pack_map(v, out, sort=True)
    elif isinstance(v, (list, tuple)):
        out.append(_sized(0x90, 16, (None, 0xdc, 0xdd), len(v)))
        for x in v:
            _pack(x, out)
    else:
        raise TypeError(f'flax msgpack: {type(v).__name__} is not written')


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` gives."""
    out: list = []
    _pack(tree, out)
    return b''.join(out)
