"""flax's msgpack checkpoints, read and written in plain Python.

The JAX package writes its ``.msgpack`` checkpoints with
``flax.serialization.to_bytes`` and its offline int8 checkpoint as the
``NBCQINT8\\x01`` tag followed by the same encoding. The machine with the
card has neither flax nor the ``msgpack`` package, so this module decodes
the subset of msgpack that flax writes:

- nil, bool, ints, float32 / float64, str, bin, arrays (as lists) and maps
  (as dicts, str keys);
- flax's ext types (``flax/serialization.py`` ``_MsgpackExtType``):
  ``ndarray`` = 1, a msgpack ``(shape, dtype name, bytes)``;
  ``native_complex`` = 2, a msgpack ``(real, imag)``; ``npscalar`` = 3, a
  0-d ``ndarray`` returned as its scalar;
- flax's chunked leaves: an array over ``MAX_CHUNK_SIZE`` bytes is written
  as ``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks':
  {...}}`` and comes back as one array.

``restore`` returns what ``flax.serialization.msgpack_restore`` returns:
nested dicts whose array leaves are ``np.frombuffer`` views of the one
buffer given (no copy per leaf; a writable buffer gives writable
leaves). A
``bfloat16`` leaf, which numpy has no dtype for, comes back as a
``torch.bfloat16`` tensor over the same bytes, never rounded. Malformed or
truncated input raises ``ValueError`` naming the source and the byte
offset.

``to_bytes`` writes the bytes ``flax.serialization.to_bytes`` writes for a
tree of dicts, lists, numpy arrays and scalars, Python scalars and None,
chunking as flax does.
"""
from __future__ import annotations

import math
import struct
from typing import Any

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: larger array leaves are chunked
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------- reading

class _Reader:
    """A cursor over ``buf``; ``base`` is the offset of ``buf[0]`` in the
    source, so errors give the byte of the file."""

    def __init__(self, buf: memoryview, source: str, base: int = 0):
        self.buf = buf
        self.source = source
        self.base = base
        self.pos = 0

    def fail(self, message: str, at: int | None = None):
        at = self.pos if at is None else at
        raise ValueError(f"{self.source}: {message} at byte "
                         f"{self.base + at}")

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            self.fail(f"truncated msgpack: {n} bytes needed, "
                      f"{len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def text(self, n: int) -> str:
        at = self.pos
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError:
            self.fail("invalid UTF-8 in a str", at)

    def value(self) -> Any:
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:  # bin 8 / 16 / 32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if 0xC7 <= b <= 0xC9:  # ext 8 / 16 / 32
            return self.ext(self.uint(1 << (b - 0xC7)), at)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8 .. 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8 .. 64
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:  # fixext 1 .. 16
            return self.ext(1 << (b - 0xD4), at)
        if 0xD9 <= b <= 0xDB:  # str 8 / 16 / 32
            return self.text(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16 / 32
            return [self.value() for _ in range(self.uint(2 if b == 0xDC
                                                          else 4))]
        if b in (0xDE, 0xDF):  # map 16 / 32
            return self.map(self.uint(2 if b == 0xDE else 4))
        self.fail(f"invalid msgpack type byte 0x{b:02x}", at)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if not isinstance(key, (str, bytes)):
                self.fail(f"map key of type {type(key).__name__} (flax "
                          f"writes str keys)", key_at)
            out[key] = self.value()
        return out

    def ext(self, n: int, at: int) -> Any:
        code = self.sint(1)
        start = self.pos
        sub = _Reader(self.take(n), self.source, self.base + start)
        if code == EXT_COMPLEX:
            parts = sub.value()
            if not (isinstance(parts, list) and len(parts) == 2):
                sub.fail("a native_complex ext that is not (real, imag)", 0)
            out = complex(parts[0], parts[1])
        elif code in (EXT_NDARRAY, EXT_NPSCALAR):
            out = sub.ndarray()
            if code == EXT_NPSCALAR:
                out = out[()]
        else:
            self.fail(f"msgpack ext type {code} (flax writes 1, 2 and 3)", at)
        if sub.pos != n:
            sub.fail(f"{n - sub.pos} stray bytes after an ext value")
        return out

    def ndarray(self) -> np.ndarray | torch.Tensor:
        """flax's ``(shape, dtype name, bytes)``, a view of the buffer."""
        b = self.take(1)[0]
        if b != 0x93:
            self.fail("an ndarray ext that is not a 3-array", 0)
        shape = self.value()
        if not (isinstance(shape, list)
                and all(isinstance(d, int) and d >= 0 for d in shape)):
            self.fail(f"an ndarray shape {shape!r}")
        name = self.value()
        if isinstance(name, bytes):
            name = name.decode("ascii", "replace")
        b = self.take(1)[0]
        if not 0xC4 <= b <= 0xC6:
            self.fail("an ndarray without bin data", self.pos - 1)
        nbytes = self.uint(1 << (b - 0xC4))
        at = self.pos
        data = self.take(nbytes)
        count = math.prod(shape)
        if name == "bfloat16":  # numpy has no bfloat16: torch's, exactly
            if nbytes != 2 * count:
                self.fail(f"{nbytes} bytes for a bfloat16 {shape}", at)
            if count == 0:
                return torch.empty(shape, dtype=torch.bfloat16)
            return torch.frombuffer(data, dtype=torch.bfloat16).reshape(
                shape)
        try:
            dtype = np.dtype(name)
        except TypeError:
            self.fail(f"unsupported ndarray dtype {name!r}", at)
        if dtype.hasobject or nbytes != dtype.itemsize * count:
            self.fail(f"{nbytes} bytes for a {name} {shape}", at)
        return np.frombuffer(data, dtype=dtype, count=count).reshape(shape)


def _unchunk(d: dict) -> np.ndarray:
    shape = d["shape"]
    chunks = d["chunks"]
    return np.concatenate([chunks[str(i)] for i in range(len(chunks))]
                          ).reshape([shape[str(i)] for i in range(len(shape))])


def _unchunk_leaves(d: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: dicts only."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_leaves(v)
    return d


def restore(data, source: str = "<bytes>", base: int = 0) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the tree, its array
    leaves views of ``data``. ``source`` and ``base`` (the offset of
    ``data`` in it) name the bytes in errors."""
    reader = _Reader(memoryview(data).cast("B"), source, base)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        reader.fail(f"{len(reader.buf) - reader.pos} bytes of trailing data")
    return _unchunk_leaves(tree)


def load(path: str, offset: int = 0) -> Any:
    """The flax msgpack tree in the file ``path`` from byte ``offset`` on
    (the int8 checkpoint's tag comes before it), the file read once into
    one writable buffer (not zero-filled first)."""
    with open(path, "rb") as f:
        buf = np.empty(f.seek(0, 2), np.uint8)
        f.seek(0)
        if f.readinto(buf) != buf.size:
            raise ValueError(f"{path}: short read")
    return restore(memoryview(buf)[offset:], path, offset)


# ---------------------------------------------------------------- writing

def _state_dict(tree: Any) -> Any:
    """``flax.serialization.to_state_dict`` for dicts, lists and tuples,
    then flax's ``_chunk_array_leaves_in_place``."""
    if isinstance(tree, dict):
        return {str(k): _chunk(_state_dict(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _chunk(_state_dict(v)) for i, v in enumerate(tree)}
    return tree


def _chunk(x: Any) -> Any:
    if not (isinstance(x, np.ndarray)
            and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE):
        return x
    size = max(1, int(MAX_CHUNK_SIZE / x.dtype.itemsize))
    flat = x.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in
                       enumerate(range(0, flat.size, size))}}


def _head(out: list, n: int, small: int | None, small_max: int,
          codes: tuple[int, ...]) -> None:
    """A msgpack length header: ``small | n`` up to ``small_max``, else
    the first of ``codes`` (8, 16, 32 bit lengths; None where the type
    has no 8-bit form) that holds ``n``."""
    if small is not None and n <= small_max:
        out.append(bytes([small | n]))
        return
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            out.append(bytes([code]) + n.to_bytes(width, "big"))
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: list, x: int) -> None:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        out.append(struct.pack(">b" if x < 0 else ">B", x))
        return
    if x >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= hi:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if x >= lo:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
    raise ValueError(f"integer {x} does not fit msgpack")


def _pack_bin(out: list, data) -> None:
    _head(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    out.append(data)


def _pack_ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fixed is not None:
        out.append(bytes([fixed, code]))
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(bytes([code]))
    out.append(payload)


def _ndarray_payload(x: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack ``(shape, name, bytes)``."""
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    out: list = [b"\x93"]
    _head(out, x.ndim, 0x90, 0x0F, (None, 0xDC, 0xDD))
    for d in x.shape:
        _pack_int(out, d)
    _pack(out, x.dtype.name)
    _pack_bin(out, x.tobytes("C"))
    return b"".join(out)


def _pack(out: list, x: Any) -> None:
    """msgpack-python's ``packb(x, default=flax's ext packer,
    strict_types=True, use_bin_type=True)``."""
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(out, x)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        data = x.encode("utf-8")
        _head(out, len(data), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif t is bytes:
        _pack_bin(out, x)
    elif t is dict:
        _head(out, len(x), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif t is list:
        _head(out, len(x), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif t is complex:
        _pack_ext(out, EXT_COMPLEX, b"\x92\xcb" + struct.pack(">d", x.real)
                  + b"\xcb" + struct.pack(">d", x.imag))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def to_bytes(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` writes."""
    out: list = []
    _pack(out, _chunk(_state_dict(tree)))
    return b"".join(out)


__all__ = ["MAX_CHUNK_SIZE", "load", "restore", "to_bytes"]
