"""HDF5 files of the data trees, in plain Python (numpy, zlib, struct).

The readers and the preprocessing keep the reference's HDF5 files
(``sampled_points.h5``, ``farthest_pointclouds.h5``, ``occupancies.h5``),
and the port runs where ``h5py`` is not installed.  ``File`` covers what
they use, as ``h5py.File`` does: modes 'r', 'w' and 'a'; ``keys()``,
``in``, ``f[name]`` (a ``Dataset``: ``[...]``, ``np.asarray``, ``shape``,
``dtype``, ``compression``); ``create_dataset(name, data=...,
compression='gzip')``.

What it reads: the files ``h5py`` writes by default (superblock version
0, version-1 object headers, datasets in the root group found through its
symbol table), contiguous or chunked layouts, integer and floating-point
data, the deflate filter alone; attributes are ignored.  Anything else
(a group below the root, the shuffle filter, other structure versions)
raises ``NotImplementedError``.

What it writes, when a 'w' or 'a' file is closed: the whole file, in the
same structures: superblock 0, one symbol-table root group, each dataset
contiguous, or with ``compression='gzip'`` as one deflated chunk (level 4,
``h5py``'s default, unless ``compression_opts`` says otherwise).  An 'a'
file is read and written back with its new datasets.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_SIGNATURE = b'\x89HDF\r\n\x1a\n'
UNDEF = 0xffffffffffffffff
_GROUP_LEAF_K = 4  # symbol-table node: up to 2K entries
_GROUP_NODE_K = 16  # group B-tree node: up to 2K children
_CHUNK_NODE_K = 32  # chunk B-tree node (the default of superblock 0)
_HEAP_FREE_NONE = 1  # a local heap's free list when it has no free block


# ---- reading ----------------------------------------------------------------

def _messages(buf: bytes, addr: int) -> List[Tuple[int, bytes]]:
    """(type, body) of every message of the version-1 object header at
    ``addr``, continuation blocks followed."""
    if buf[addr:addr + 4] == b'OHDR':
        raise NotImplementedError('HDF5: version-2 object headers')
    version, _, _, _, size = struct.unpack_from('<BBHII', buf, addr)
    if version != 1:
        raise NotImplementedError(f'HDF5: object header version {version}')
    blocks, out = [(addr + 16, size)], []
    while blocks:
        pos, length = blocks.pop(0)
        end = pos + length
        while pos + 8 <= end:
            mtype, msize, flags = struct.unpack_from('<HHB', buf, pos)
            body = buf[pos + 8:pos + 8 + msize]
            if mtype == 0x10:  # continuation
                blocks.append(struct.unpack_from('<QQ', body))
            elif mtype:
                if flags & 2:
                    raise NotImplementedError('HDF5: shared messages')
                out.append((mtype, body))
            pos += 8 + msize
    return out


def _dataspace(b: bytes) -> Tuple[int, ...]:
    if b[0] != 1:
        raise NotImplementedError(f'HDF5: dataspace version {b[0]}')
    return struct.unpack_from(f'<{b[1]}Q', b, 8)


def _datatype(b: bytes) -> np.dtype:
    cls, bits = b[0] & 0x0f, b[1]
    size = struct.unpack_from('<I', b, 4)[0]
    order = '>' if bits & 1 else '<'
    if cls == 0:
        kind = 'i' if bits & 8 else 'u'
    elif cls == 1 and not bits & 0x40:
        kind = 'f'
    else:
        raise NotImplementedError(f'HDF5: datatype class {cls}')
    return np.dtype(f'{order}{kind}{size}')


def _layout(b: bytes):
    """('contiguous', addr) | ('chunked', btree, chunk dims)."""
    if b[0] == 3 and b[1] == 1:
        return 'contiguous', struct.unpack_from('<Q', b, 2)[0]
    if b[0] == 3 and b[1] == 2:
        nd = b[2]
        addr = struct.unpack_from('<Q', b, 3)[0]
        return 'chunked', addr, struct.unpack_from(f'<{nd}I', b, 11)[:-1]
    raise NotImplementedError(f'HDF5: layout version {b[0]} class {b[1]}')


def _gzip_level(b: bytes) -> int:
    """The level of a version-1 filter pipeline that is deflate alone."""
    if b[0] != 1 or b[1] != 1:
        raise NotImplementedError('HDF5: a filter pipeline other than one '
                                  'version-1 filter')
    fid, namelen, _, nvals = struct.unpack_from('<HHHH', b, 8)
    if fid != 1:
        raise NotImplementedError(f'HDF5: filter {fid}')
    return struct.unpack_from('<I', b, 16 + (namelen + 7) // 8 * 8)[0] \
        if nvals else 4


def _chunks(buf: bytes, addr: int, nd: int):
    """(size, filter mask, element offsets, address) of every chunk under
    the version-1 chunk B-tree node at ``addr``."""
    sig, typ, level, n = struct.unpack_from('<4sBBH', buf, addr)
    if sig != b'TREE' or typ != 1:
        raise ValueError('HDF5: bad chunk B-tree node')
    ks = 8 + 8 * nd
    pos = addr + 24
    for _ in range(n):
        size, mask = struct.unpack_from('<II', buf, pos)
        offs = struct.unpack_from(f'<{nd}Q', buf, pos + 8)
        child = struct.unpack_from('<Q', buf, pos + ks)[0]
        pos += ks + 8
        if level:
            yield from _chunks(buf, child, nd)
        else:
            yield size, mask, offs[:-1], child


def _group(buf: bytes, btree: int, heap: int):
    """(name, object header address) of every entry of a symbol-table
    group."""
    sig, _, dsize, _, daddr = struct.unpack_from('<4sB3xQQQ', buf, heap)
    if sig != b'HEAP':
        raise ValueError('HDF5: bad local heap')
    names = buf[daddr:daddr + dsize]

    def walk(addr):
        sig, typ, level, n = struct.unpack_from('<4sBBH', buf, addr)
        if sig != b'TREE' or typ != 0:
            raise ValueError('HDF5: bad group B-tree node')
        for i in range(n):
            child = struct.unpack_from('<Q', buf, addr + 24 + 16 * i + 8)[0]
            if level:
                yield from walk(child)
                continue
            sig, _, _, nsym = struct.unpack_from('<4sBBH', buf, child)
            if sig != b'SNOD':
                raise ValueError('HDF5: bad symbol-table node')
            for j in range(nsym):
                off, obj = struct.unpack_from('<QQ', buf, child + 8 + 40 * j)
                yield names[off:names.index(b'\0', off)].decode(), obj

    yield from walk(btree)


class Dataset:
    """One dataset of a ``File``: decoded from the file's bytes on each
    read, as ``h5py`` reads from disk."""

    def __init__(self, shape, dtype, read, compression=None,
                 compression_opts=None):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.compression = compression
        self.compression_opts = compression_opts
        self._read = read

    def __getitem__(self, idx):
        return self._read()[idx]

    def __array__(self, dtype=None, copy=None):
        a = self._read()
        return a if dtype is None else a.astype(dtype)


def _dataset(buf: bytes, addr: int) -> Dataset:
    msgs = dict(_messages(buf, addr))
    if 0x0008 not in msgs:
        raise NotImplementedError('HDF5: an object other than a dataset in '
                                  'the root group')
    shape = _dataspace(msgs[0x0001])
    dtype = _datatype(msgs[0x0003])
    layout = _layout(msgs[0x0008])
    level = _gzip_level(msgs[0x000B]) if 0x000B in msgs else None
    count = int(np.prod(shape, dtype=np.int64))

    def read():
        if layout[0] == 'contiguous':
            if layout[1] == UNDEF:
                return np.zeros(shape, dtype)
            return np.frombuffer(buf, dtype, count,
                                 layout[1]).reshape(shape).copy()
        _, btree, chunk = layout
        out = np.zeros(shape, dtype)
        if btree == UNDEF:
            return out
        ccount = int(np.prod(chunk, dtype=np.int64))
        for size, mask, offs, caddr in _chunks(buf, btree, len(chunk) + 1):
            raw = buf[caddr:caddr + size]
            if level is not None and not mask & 1:
                raw = zlib.decompress(raw)
            block = np.frombuffer(raw, dtype, ccount).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offs, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    return Dataset(shape, dtype, read, None if level is None else 'gzip',
                   level)


def _read_file(path: str) -> Dict[str, Dataset]:
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f'{path}: not an HDF5 file (or one with a user '
                         'block)')
    if buf[8] != 0:
        raise NotImplementedError(f'HDF5: superblock version {buf[8]}')
    if buf[13] != 8 or buf[14] != 8:
        raise NotImplementedError('HDF5: offsets or lengths of other than '
                                  '8 bytes')
    root = struct.unpack_from('<Q', buf, 64)[0]
    msgs = dict(_messages(buf, root))
    if 0x0011 not in msgs:
        raise NotImplementedError('HDF5: a root group without a symbol '
                                  'table')
    btree, heap = struct.unpack_from('<QQ', msgs[0x0011])
    return {name: _dataset(buf, obj)
            for name, obj in _group(buf, btree, heap)}


# ---- writing ----------------------------------------------------------------

def _pad8(b: bytes) -> bytes:
    return b + b'\0' * (-len(b) % 8)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack('<HHB3x', mtype, len(body), flags) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in 'iu':
        head = struct.pack('<BBBBI', 0x10, 0x08 if dtype.kind == 'i' else 0,
                           0, 0, size)
        return head + struct.pack('<HH', 0, 8 * size)
    if dtype.kind == 'f' and size in (4, 8):
        exp, mant, bias = {4: (8, 23, 127), 8: (11, 52, 1023)}[size]
        head = struct.pack('<BBBBI', 0x11, 0x20, 8 * size - 1, 0, size)
        return head + struct.pack('<HHBBBBI', 0, 8 * size, mant, exp, 0,
                                  mant, bias)
    raise NotImplementedError(f'HDF5: writing dtype {dtype}')


def _write_file(path: str, items: Dict[str, Tuple[np.ndarray, Optional[int]]]
                ) -> None:
    """Write ``{name: (array, gzip level or None)}`` as a new file."""
    names = sorted(items, key=lambda n: n.encode())
    per_snod = 2 * _GROUP_LEAF_K
    nsnod = max(1, -(-len(names) // per_snod))
    if nsnod > 2 * _GROUP_NODE_K:
        raise NotImplementedError('HDF5: writing more than '
                                  f'{per_snod * 2 * _GROUP_NODE_K} datasets')
    out = bytearray(96)  # the superblock, filled in last

    def alloc(data: bytes) -> int:
        addr = len(out)
        out.extend(_pad8(bytes(data)))
        return addr

    # the local heap of link names: "" at 0, then each name
    heap_data, offsets = bytearray(8), {}
    for n in names:
        offsets[n] = len(heap_data)
        heap_data.extend(_pad8(n.encode() + b'\0'))
    root_size = 8 + 16
    root = alloc(bytes(16 + root_size))
    heap = alloc(bytes(32))
    heap_addr = alloc(bytes(heap_data))
    out[heap:heap + 32] = struct.pack('<4sB3xQQQ', b'HEAP', 0, len(heap_data),
                                      _HEAP_FREE_NONE, heap_addr)

    # datasets: object header, then data or chunk B-tree and chunk
    headers = {}
    for n in names:
        a, level = items[n]
        a = np.asarray(a, a.dtype.newbyteorder('<'), order='C')
        dtype, raw, shape = a.dtype, a.tobytes(), a.shape
        msgs = [_message(0x0001, struct.pack(  # max dims unless a scalar
            f'<BBBB4x{len(shape)}Q{len(shape)}Q', 1, len(shape),
            int(bool(shape)), 0, *shape, *shape)),
            _message(0x0003, _datatype_message(dtype), 1)]
        if level is None or a.size == 0 or not shape:
            msgs.append(_message(0x0005, struct.pack('<BBBBI', 2, 2, 2, 1,
                                                     0), 1))
            addr = alloc(raw) if raw else UNDEF
            msgs.append(_message(0x0008, struct.pack('<BBQQ', 3, 1, addr,
                                                     len(raw))))
        else:
            nd = len(shape) + 1
            ks = 8 + 8 * nd
            comp = zlib.compress(raw, level)
            btree = alloc(bytes(24 + 2 * _CHUNK_NODE_K * 8
                                + (2 * _CHUNK_NODE_K + 1) * ks))
            chunk = alloc(comp)
            node = struct.pack('<4sBBHQQ', b'TREE', 1, 0, 1, UNDEF, UNDEF)
            node += struct.pack(f'<II{nd}Q', len(comp), 0, *([0] * nd))
            node += struct.pack('<Q', chunk)
            node += struct.pack(f'<II{nd}Q', 0, 0, *shape, dtype.itemsize)
            out[btree:btree + len(node)] = node
            msgs.append(_message(0x0005, struct.pack('<BBBBI', 2, 3, 2, 1,
                                                     0), 1))
            msgs.append(_message(0x000B, struct.pack(
                '<BBH4xHHHH8sI4x', 1, 1, 0, 1, 8, 1, 1, b'deflate\0',
                level), 1))
            msgs.append(_message(0x0008, struct.pack(
                f'<BBBQ{nd}I', 3, 2, nd, btree, *shape, dtype.itemsize)))
        body = b''.join(msgs)
        headers[n] = alloc(struct.pack('<BBHII4x', 1, 0, len(msgs), 1,
                                       len(body)) + body)

    # symbol-table nodes, the group B-tree over them, the root header
    snods = []
    for s in range(nsnod):
        group = names[s * per_snod:(s + 1) * per_snod]
        node = bytearray(struct.pack('<4sBBH', b'SNOD', 1, 0, len(group)))
        for n in group:
            node += struct.pack('<QQI4x16x', offsets[n], headers[n], 0)
        node += bytes(8 + 40 * per_snod - len(node))
        snods.append((alloc(bytes(node)), group[-1] if group else None))
    tree = bytearray(struct.pack('<4sBBHQQ', b'TREE', 0, 0, len(snods),
                                 UNDEF, UNDEF))
    tree += struct.pack('<Q', 0)
    for addr, last in snods:
        tree += struct.pack('<QQ', addr, offsets[last] if last else 0)
    tree += bytes(24 + 2 * _GROUP_NODE_K * 8 + (2 * _GROUP_NODE_K + 1) * 8
                  - len(tree))
    btree = alloc(bytes(tree))
    out[root:root + 16 + root_size] = struct.pack(
        '<BBHII4xHHB3xQQ', 1, 0, 1, 1, root_size, 0x0011, 16, 0, btree,
        heap)
    out[:96] = struct.pack(
        '<8sBBBBBBBBHHIQQQQQQI4xQQ', _SIGNATURE, 0, 0, 0, 0, 0, 8, 8, 0,
        _GROUP_LEAF_K, _GROUP_NODE_K, 0, 0, UNDEF, len(out), UNDEF, 0,
        root, 1, btree, heap)
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
        f.write(out)
    os.replace(tmp, path)


class File:
    """An HDF5 file: 'r' reads, 'w' starts empty, 'a' reads what is there;
    'w' and 'a' write the file when closed."""

    def __init__(self, path: str, mode: str = 'r'):
        if mode not in ('r', 'w', 'a'):
            raise ValueError(f'HDF5 File mode {mode!r}: use r, w or a')
        self.path, self.mode = os.fspath(path), mode
        self._data: Dict[str, Dataset] = {}
        self._new: Dict[str, Tuple[np.ndarray, Optional[int]]] = {}
        if mode == 'r' or (mode == 'a' and os.path.exists(self.path)):
            self._data = _read_file(self.path)
        self._dirty = mode == 'w'

    def keys(self) -> List[str]:
        return sorted(list(self._data) + list(self._new))

    def __contains__(self, name) -> bool:
        return name in self._data or name in self._new

    def __getitem__(self, name: str) -> Dataset:
        if name in self._new:
            a, level = self._new[name]
            return Dataset(a.shape, a.dtype, a.copy,
                           'gzip' if level is not None else None, level)
        return self._data[name]

    def create_dataset(self, name: str, data=None, compression=None,
                       compression_opts=None) -> Dataset:
        if self.mode == 'r':
            raise ValueError(f'{self.path}: opened read-only')
        if name in self:
            raise ValueError(f'{self.path}: dataset {name!r} exists')
        if compression not in (None, 'gzip'):
            raise NotImplementedError(f'HDF5: compression {compression!r}')
        level = None if compression is None else (
            4 if compression_opts is None else int(compression_opts))
        self._new[name] = (np.array(data), level)
        self._dirty = True
        return self[name]

    def close(self) -> None:
        if self._dirty and self.mode != 'r':
            items = {n: (np.asarray(d), d.compression_opts
                         if d.compression == 'gzip' else None)
                     for n, d in self._data.items()}
            items.update(self._new)
            _write_file(self.path, items)
            self._dirty = False

    def __enter__(self) -> 'File':
        return self

    def __exit__(self, *exc) -> None:
        self.close()
