"""The checkpoint file format: msgpack, as ``flax.serialization`` writes it.

The JAX package writes its checkpoints with ``flax.serialization.to_bytes``
(``firewheel_tpu/checkpoint.py``).  Neither flax nor msgpack is a
dependency of the port, so this module carries the part of both that those
files use, and a checkpoint written by either package restores in the
other:

* msgpack's types nil, bool, int, float32/64, str, bin, array, map and ext.
  The encoder picks the shortest form of each, as msgpack-python's packer
  does, so equal trees give equal bytes.
* flax's ext code 1, an ndarray (a packed ``(shape, dtype name, C-order
  bytes)``), and code 3, a numpy scalar (packed as a 0-d ndarray).
* flax's chunked form for a leaf of more than :data:`MAX_CHUNK_SIZE` bytes
  (``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``,
  the flattened array in slices), written and read.
* flax's state-dict conventions (``to_state_dict``): a NamedTuple becomes a
  dict of its fields, a list or tuple a dict keyed ``"0"``, ``"1"``, ...,
  and ``()`` an empty dict, as :func:`~firewheel_tpu_torch.convert.
  as_dicts` makes them.

Dict keys are written sorted: the JAX package maps its state through
``jax.tree.map`` before writing it, and that sorts every dict.  A
NamedTuple's fields keep their order, so the bytes equal the JAX package's
wherever its tree holds no NamedTuple (a smoother's state is one); the
leaves are equal everywhere.

Only numpy is imported: the caller converts tensors first.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["MAX_CHUNK_SIZE", "packb", "unpackb", "to_state_dict", "write",
           "to_bytes", "from_bytes"]

#: a leaf larger than this many bytes is written in chunks (flax's limit,
#: below msgpack's 2**31 - 1 bytes for one object)
MAX_CHUNK_SIZE = 2**30

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# -- msgpack --------------------------------------------------------------------

def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack("BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"integer {n} out of msgpack's range")


def _header(n: int, fix: int, fix_max: int, codes: tuple) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (8-bit, 16-bit, 32-bit lengths; None where there is no such
    form) that holds ``n``."""
    if n <= fix_max:
        return struct.pack("B", fix + n)
    for code, fmt, top in zip(codes, (">BB", ">BH", ">BI"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return struct.pack(fmt, code, n)
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _bin_header(n: int) -> bytes:
    return _header(n, 0, -1, (0xC4, 0xC5, 0xC6))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    else:
        head = _header(n, 0, -1, (0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code)


def _array_bytes(a: np.ndarray) -> memoryview:
    """``a``'s C-order bytes, without a copy where ``a`` is contiguous."""
    return memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _pack_ndarray(a: np.ndarray, code: int, out: list) -> None:
    """flax's ext: ``(shape, dtype name, C-order bytes)`` packed, as an ext
    of ``code``."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    inner: list = [b"\x93"]  # a fixarray of three
    for part in (list(a.shape), a.dtype.name, _array_bytes(a)):
        _pack(part, inner)
    out.append(_ext_header(sum(map(_nbytes, inner)), code))
    out.extend(inner)


def _nbytes(piece) -> int:
    return len(piece) if isinstance(piece, bytes) else piece.nbytes


def _pack(obj, out: list) -> None:
    """Append the msgpack encoding of ``obj`` to ``out`` as pieces (bytes,
    or memoryviews of array data)."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        enc = obj.encode("utf-8")
        out.append(_header(len(enc), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB)) + enc)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        out.append(_bin_header(data.nbytes))
        out.append(data)
    elif isinstance(obj, np.ndarray):
        _pack_ndarray(obj, _EXT_NDARRAY, out)
    elif isinstance(obj, np.generic):
        _pack_ndarray(np.asarray(obj), _EXT_NPSCALAR, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD)))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` (None, bool, int, float, str, bytes, lists, dicts, ndarrays
    and numpy scalars) → msgpack bytes."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
          0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
        0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H",
        0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray_from(data: memoryview) -> np.ndarray:
    shape, name, buf = _unpack(_Reader(data))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(tuple(shape))


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray_from(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _unpack(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b not in _LEN:
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
    n = r.unpack(_LEN[b])
    if b <= 0xC6:
        return r.take(n)  # bin: a view of the data, no copy
    if b <= 0xC9:
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    if b <= 0xDB:
        return str(r.take(n), "utf-8")
    if b <= 0xDD:
        return [_unpack(r) for _ in range(n)]
    return _map(r, n)


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data):
    """msgpack bytes → Python objects (arrays as lists, bin as read-only
    memoryviews of ``data``, flax's ext types as numpy)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return obj


# -- flax's state dicts ----------------------------------------------------------

def to_state_dict(tree):
    """flax's ``to_state_dict`` of a tree as the JAX package writes it:
    dicts with sorted string keys, a NamedTuple as a dict of its fields, a
    list or tuple as a dict keyed by position."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: to_state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(x) for i, x in enumerate(tree)}
    return tree


def _chunk(a: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = np.ascontiguousarray(a).reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_large(tree):
    if isinstance(tree, dict):
        return {k: _chunk_large(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _pieces(tree) -> list:
    out: list = []
    _pack(_chunk_large(to_state_dict(tree)), out)
    return out


def write(f, tree) -> int:
    """Write ``tree`` (nested dicts, NamedTuples and tuples of numpy
    leaves) to the binary file ``f`` as ``flax.serialization.to_bytes``
    would, piece by piece (array data is not copied into one buffer).
    Returns the bytes written."""
    n = 0
    for p in _pieces(tree):
        f.write(p)
        n += _nbytes(p)
    return n


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes(tree)``."""
    return b"".join(_pieces(tree))


def _restore(target, state, path: str):
    """flax's ``from_state_dict`` into nested dicts: every key of ``target``
    must be in ``state``; a leaf of ``target`` takes ``state``'s value."""
    if not isinstance(target, dict):
        return state
    if not isinstance(state, dict):
        raise ValueError(f"expected a dict at {path or '/'}, got {type(state).__name__}")
    missing = set(map(str, target)) - set(state)
    if missing:
        raise ValueError(f"keys {sorted(missing)} missing from the state dict at "
                         f"{path or '/'}")
    return {k: _restore(v, state[str(k)], f"{path}/{k}") for k, v in target.items()}


def from_bytes(target, data):
    """``flax.serialization.from_bytes(target, data)`` for a ``target`` of
    nested dicts: the leaves come back as numpy (read-only views of
    ``data``)."""
    return _restore(target, _unchunk(unpackb(data)), "")
