"""orbax checkpoint directories, read without orbax or tensorstore.

The JAX package saves its trainer's per-epoch checkpoints and its
``best_model`` export with ``orbax.checkpoint.PyTreeCheckpointer``, which
writes three layers, each read here in plain Python:

- ``_METADATA`` (JSON): every leaf's path through the tree (``key_type``
  2 a dict key, 1 a sequence index) and its value type.
- An OCDBT database (tensorstore's "optionally-cooperative distributed
  B+tree") holding the leaves as zarr v2 arrays: ``manifest.ocdbt`` names
  the latest version's root node; B+tree nodes list their keys
  prefix-compressed, and each value is stored inline in its leaf node or
  as an (offset, length) range of a data file (``d/<hash>``, or
  ``ocdbt.process_0/d/<hash>`` for the writing process's files). Every
  manifest and node is a 0x0cdb-tagged header, a body (a zstd frame) and
  a crc32c.
- Per leaf, the zarr v2 keys ``<path joined by '.'>/.zarray`` (JSON: shape,
  chunks, dtype, compressor) and one key per chunk (``0.0``, ``0`` for a
  0-d array), each chunk zstd-compressed at its full chunk shape.

zstd frames go to ``ZSTD_decompress`` of the system ``libzstd`` through
ctypes; without it, loading raises ``RuntimeError`` naming the library and
the checkpoint. What the JAX package never writes (zarr3, a directory that
is not OCDBT, numbered manifests, another compressor, filters, Fortran
order) raises ``NotImplementedError`` naming what was found.

``load`` returns what ``PyTreeCheckpointer().restore(directory)`` returns
with no template for the trees the JAX package saves (numpy leaves, None,
empty dicts): nested dicts and lists of numpy arrays (a ``bfloat16`` array
as a ``torch.bfloat16`` tensor), None and empty dicts.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import itertools
import json
import os
from typing import Any

import numpy as np
import torch

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_MISSING = 2 ** 64 - 1  # offset and length of an empty tree's root
_KEY_SEQUENCE, _KEY_DICT = 1, 2
_ZSTD_CONTENTSIZE_ERROR = 2 ** 64 - 2


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def _crc32c(data) -> int:
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Zstd:
    """``ZSTD_decompress`` of the system libzstd."""

    def __init__(self, checkpoint: str):
        name = ctypes.util.find_library("zstd")
        if name is None:
            raise RuntimeError(
                f"{checkpoint}: reading an orbax checkpoint needs the system "
                f"zstd library (libzstd), which ctypes.util.find_library"
                f"('zstd') does not find")
        lib = ctypes.CDLL(name)
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_decompressBound.argtypes = [ctypes.c_void_p,
                                             ctypes.c_size_t]
        lib.ZSTD_decompressBound.restype = ctypes.c_ulonglong
        self.lib = lib

    def into(self, src, dst: np.ndarray, what: str) -> None:
        """Decompress ``src`` into all of the contiguous array ``dst``."""
        s = np.frombuffer(src, np.uint8)
        n = self.lib.ZSTD_decompress(dst.ctypes.data, dst.nbytes,
                                     s.ctypes.data, s.nbytes)
        if self.lib.ZSTD_isError(n):
            raise ValueError(f"{what}: zstd: "
                             f"{self.lib.ZSTD_getErrorName(n).decode()}")
        if n != dst.nbytes:
            raise ValueError(f"{what}: zstd frame holds {n} bytes, "
                             f"{dst.nbytes} expected")

    def frame(self, src, what: str) -> memoryview:
        """A manifest's or node's frame decompressed (tensorstore records
        the content size in some frames only: the blocks' headers bound
        it)."""
        s = np.frombuffer(src, np.uint8)
        bound = self.lib.ZSTD_decompressBound(s.ctypes.data, s.nbytes)
        if bound >= _ZSTD_CONTENTSIZE_ERROR:
            raise ValueError(f"{what}: not a zstd frame")
        out = np.empty(bound, np.uint8)
        n = self.lib.ZSTD_decompress(out.ctypes.data, out.nbytes,
                                     s.ctypes.data, s.nbytes)
        if self.lib.ZSTD_isError(n):
            raise ValueError(f"{what}: zstd: "
                             f"{self.lib.ZSTD_getErrorName(n).decode()}")
        return memoryview(out)[:n]


class _Cursor:
    """Little-endian fields and LEB128 varints of an OCDBT body."""

    def __init__(self, data, what: str):
        self.data = memoryview(data).cast("B")
        self.what = what
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.pos} "
                             f"({n} bytes needed)")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long at byte "
                                 f"{self.pos}")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


class _Ocdbt:
    """The key -> value map of the latest version of an OCDBT database
    rooted at ``directory``: ``keys`` maps each key to its inline value
    or to a (file, offset, length) reference, which ``get`` reads."""

    def __init__(self, directory: str, zstd: _Zstd):
        self.directory = directory
        self.zstd = zstd
        self.keys: dict[bytes, Any] = {}
        manifest = os.path.join(directory, "manifest.ocdbt")
        with open(manifest, "rb") as f:
            body = self._body(f.read(), _MANIFEST_MAGIC, manifest)
        cur = _Cursor(body, manifest)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise NotImplementedError(
                f"{manifest}: OCDBT manifest kind {kind} (numbered "
                f"manifests); orbax writes a single manifest")
        cur.varint()  # max_inline_value_bytes
        cur.varint()  # max_decoded_node_bytes
        cur.u8()  # version_tree_arity_log2
        if cur.varint() == 1:  # zstd: its level, int32
            cur.take(4)
        files = self._data_files(cur)
        n = cur.varint()
        if n == 0:
            raise ValueError(f"{manifest}: no version")
        generation = cur.varints(n)
        height = [cur.u8() for _ in range(n)]
        file_id, offset, length = (cur.varints(n), cur.varints(n),
                                   cur.varints(n))
        latest = max(range(n), key=generation.__getitem__)
        if offset[latest] != _MISSING:  # else the tree is empty
            self._walk(files[file_id[latest]], offset[latest],
                       length[latest], height[latest], b"")

    @staticmethod
    def _data_files(cur: _Cursor) -> list[str]:
        """The data file table: prefix-compressed paths, relative to the
        database's directory."""
        n = cur.varint()
        prefix = [0] + cur.varints(n - 1) if n else []
        suffix = cur.varints(n)
        cur.varints(n)  # base path lengths: the base is part of the path
        paths, prev = [], b""
        for i in range(n):
            prev = prev[:prefix[i]] + bytes(cur.take(suffix[i]))
            path = prev.decode()
            if path.startswith("/") or ".." in path.split("/"):
                raise ValueError(f"{cur.what}: data file path {path!r} "
                                 f"outside the checkpoint")
            paths.append(path)
        return paths

    def _body(self, data: bytes, magic: int, what: str) -> memoryview:
        """The checked, decompressed body of a manifest or node."""
        if len(data) < 18 or int.from_bytes(data[:4], "big") != magic:
            raise ValueError(f"{what}: not an OCDBT "
                             f"{'manifest' if magic == _MANIFEST_MAGIC else 'node'}")
        if int.from_bytes(data[4:12], "little") != len(data):
            raise ValueError(f"{what}: length field "
                             f"{int.from_bytes(data[4:12], 'little')} for "
                             f"{len(data)} bytes")
        if _crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
            raise ValueError(f"{what}: crc32c mismatch")
        cur = _Cursor(data[:-4], what)
        cur.pos = 12
        version, compression = cur.varint(), cur.varint()
        if version != 0:
            raise NotImplementedError(f"{what}: OCDBT format version "
                                      f"{version}")
        payload = cur.data[cur.pos:]
        if compression == 0:
            return payload
        if compression == 1:
            return self.zstd.frame(payload, what)
        raise NotImplementedError(f"{what}: OCDBT compression "
                                  f"{compression}")

    def _read(self, path: str, offset: int, length: int) -> bytes:
        full = os.path.join(self.directory, path)
        with open(full, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{full}: {length} bytes at {offset} needed, "
                             f"{len(data)} there")
        return data

    def _walk(self, path: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{os.path.join(self.directory, path)}@{offset}"
        cur = _Cursor(self._body(self._read(path, offset, length),
                                 _NODE_MAGIC, what), what)
        if cur.u8() != height:
            raise ValueError(f"{what}: node height differs from its "
                             f"parent's record")
        files = self._data_files(cur)
        n = cur.varint()
        shared = [0] + cur.varints(n - 1) if n else []
        suffix = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            prev = prev[:shared[i]] + bytes(cur.take(suffix[i]))
            keys.append(prev)
        if height:
            child_file, child_offset, child_length = (
                cur.varints(n), cur.varints(n), cur.varints(n))
            for i in range(n):
                self._walk(files[child_file[i]], child_offset[i],
                           child_length[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        lengths = cur.varints(n)
        kinds = [cur.u8() for _ in range(n)]
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids = cur.varints(len(indirect))
        offsets = cur.varints(len(indirect))
        for i, file, off in zip(indirect, ids, offsets):
            self.keys[prefix + keys[i]] = (files[file], off, lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self.keys[prefix + keys[i]] = cur.take(lengths[i])
            elif kinds[i] != 1:
                raise ValueError(f"{what}: value kind {kinds[i]}")

    def get(self, key: str):
        """The value of ``key``, or None where the key is absent."""
        value = self.keys.get(key.encode())
        if isinstance(value, tuple):
            return self._read(*value)
        return value


def _zarr_array(db: _Ocdbt, name: str) -> np.ndarray | torch.Tensor:
    what = f"{db.directory}: {name}"
    raw = db.get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"{what}: no .zarray")
    meta = json.loads(bytes(raw))
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{what}: zarr format "
                                  f"{meta.get('zarr_format')!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise NotImplementedError(f"{what}: compressor "
                                  f"{compressor.get('id')!r}")
    if meta.get("filters"):
        raise NotImplementedError(f"{what}: zarr filters {meta['filters']}")
    if meta.get("order", "C") != "C":
        raise NotImplementedError(f"{what}: zarr order {meta['order']!r}")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype(np.uint16 if bf16 else meta["dtype"])
    if dtype.hasobject or dtype.fields is not None:
        raise NotImplementedError(f"{what}: zarr dtype {meta['dtype']!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in itertools.product(*map(range, grid)):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        data = db.get(key)
        if data is None:  # orbax stores every chunk, fill values too
            raise ValueError(f"{what}: chunk {key} missing")
        if chunks == shape:
            chunk = out
        else:
            chunk = np.empty(chunks, dtype)
        if compressor is None:
            if len(data) != chunk.nbytes:
                raise ValueError(f"{what}: chunk {key} has {len(data)} "
                                 f"bytes, {chunk.nbytes} expected")
            chunk.reshape(-1).view(np.uint8)[:] = np.frombuffer(data,
                                                                np.uint8)
        else:
            db.zstd.into(data, chunk, f"{what}: chunk {key}")
        if chunk is not out:
            out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                      for r in region)]
    if bf16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _leaf(db: _Ocdbt, name: str, value_meta: dict) -> Any:
    kind = value_meta.get("value_type")
    if kind == "np.ndarray":  # the JAX package saves numpy leaves
        return _zarr_array(db, name)
    if kind == "None":
        return None
    if kind == "Dict":  # an empty dict (an optimizer's empty state)
        return {}
    raise NotImplementedError(f"{db.directory}: {name}: orbax value type "
                              f"{kind!r}")


def _containers(node: dict, where: str) -> Any:
    """Nested {(key_type, key): ...} -> dicts and lists."""
    if not (isinstance(node, dict) and node):
        return node
    kinds = {k for k, _ in node}
    if kinds == {_KEY_SEQUENCE}:
        items = sorted((int(k), v) for (_, k), v in node.items())
        if [i for i, _ in items] != list(range(len(items))):
            raise ValueError(f"{where}: sequence indices "
                             f"{[i for i, _ in items]}")
        return [_containers(v, where) for _, v in items]
    if kinds != {_KEY_DICT}:
        raise NotImplementedError(f"{where}: key types {sorted(kinds)}")
    return {k: _containers(v, where) for (_, k), v in node.items()}


def load(directory: str) -> Any:
    """The tree ``PyTreeCheckpointer().restore(directory)`` returns."""
    directory = os.path.abspath(directory)
    meta_path = os.path.join(directory, "_METADATA")
    if not os.path.isfile(meta_path):
        raise NotImplementedError(
            f"{directory}: no _METADATA, so not an orbax PyTree checkpoint "
            f"as the JAX package writes them")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{directory}: zarr3 arrays (orbax "
                                  f"use_zarr3); the JAX package writes "
                                  f"zarr v2")
    if not (meta.get("use_ocdbt") and os.path.isfile(
            os.path.join(directory, "manifest.ocdbt"))):
        raise NotImplementedError(
            f"{directory}: not an OCDBT checkpoint (use_ocdbt="
            f"{meta.get('use_ocdbt')!r}, manifest.ocdbt "
            f"{'present' if os.path.isfile(os.path.join(directory, 'manifest.ocdbt')) else 'absent'})")
    db = _Ocdbt(directory, _Zstd(directory))
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        name = ".".join(str(k["key"]) for k in keys)
        node = root
        for k in keys[:-1]:
            node = node.setdefault((k["key_type"], str(k["key"])), {})
        last = keys[-1]
        node[(last["key_type"], str(last["key"]))] = _leaf(
            db, name, entry["value_metadata"])
    return _containers(root, directory)


__all__ = ["load"]
