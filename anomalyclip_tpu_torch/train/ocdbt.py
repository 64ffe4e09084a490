"""A read-only OCDBT key-value store: the array store under the JAX package's
Orbax checkpoint directories, read in Python without tensorstore.

OCDBT (tensorstore's "Optionally-Cooperative Distributed B+Tree", documented on
its "OCDBT format" page) keeps a directory of immutable files:

- ``manifest.ocdbt``: the store's configuration and its versions, each the
  location of a B-tree root;
- ``d/<id>`` data files: B-tree nodes and the values too large to inline,
  each read at an (offset, length) given by the node that points to it.

A manifest and every node is encoded alike: a magic number (big-endian u32),
the encoded length (u64), the format version (varint), the compression
(0 none, 1 Zstandard), the body, and a CRC-32C of everything before it. A node
names the files it points into in a table of (base path, relative path): an
Orbax directory's top-level tree points into ``ocdbt.process_0/d/``.

``OcdbtStore(path).list()`` gives the keys of the newest version, and
``read(key)`` a value's bytes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple, Union

from anomalyclip_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_VERSION = 0

# where a value lies: its bytes, or (data file, offset, length)
ValueRef = Union[bytes, Tuple[Path, int, int]]


class OcdbtError(ValueError):
    """A file of the store this reader cannot take, with where it failed."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """A cursor over one decoded body; every read names its file and offset
    when the body ends early."""

    __slots__ = ("data", "pos", "where")

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        raise OcdbtError(f"{self.where}: {what} at byte {self.pos} of its body")

    def byte(self) -> int:
        if self.pos >= len(self.data):
            self.fail("body ends")
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"{n} bytes past the end")
        self.pos += n
        return self.data[self.pos - n:self.pos]


def decode_envelope(encoded: bytes, magic: int, where: str) -> bytes:
    """One encoded manifest or node -> its body, after checking its magic,
    length, version and CRC-32C, decompressed."""
    if len(encoded) < 18:
        raise OcdbtError(f"{where}: {len(encoded)} bytes is too short for an OCDBT file")
    got = int.from_bytes(encoded[:4], "big")
    if got != magic:
        raise OcdbtError(f"{where}: magic {got:08x} at byte 0, expected {magic:08x}")
    length = int.from_bytes(encoded[4:12], "little")
    if length != len(encoded):
        raise OcdbtError(f"{where}: length field {length} at byte 4, but {len(encoded)} bytes were read")
    want = int.from_bytes(encoded[-4:], "little")
    if crc32c(encoded[:-4]) != want:
        raise OcdbtError(f"{where}: CRC-32C mismatch at byte {len(encoded) - 4}")
    head = _Reader(encoded[:-4], where)
    head.pos = 12
    version = head.varint()
    if version != _VERSION:
        raise OcdbtError(f"{where}: format version {version} at byte 12, this reader knows {_VERSION}")
    compression = head.byte()
    body = encoded[head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as exc:
            raise OcdbtError(f"{where}: zstd body at byte {head.pos}: {exc}") from exc
    raise OcdbtError(f"{where}: compression {compression} at byte {head.pos - 1}, this reader knows 0 and 1")


def _data_file_table(r: _Reader) -> List[str]:
    """The table of files a node points into -> their paths (base path and
    relative path joined), prefix-coded on the previous path."""
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base_len = r.varints(n)
    paths: List[str] = []
    previous = b""
    for i in range(n):
        if prefix[i] > len(previous):
            r.fail("data file prefix longer than the path before it")
        full = previous[:prefix[i]] + r.raw(suffix[i])
        if base_len[i] > len(full):
            r.fail("data file base path longer than its path")
        paths.append(full.decode())
        previous = full
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """``n`` prefix-coded keys -> (the keys, and in an interior node the
    length of each child's common key prefix, stored before the key bytes)."""
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys: List[bytes] = []
    previous = b""
    for i in range(n):
        if prefix[i] > len(previous):
            r.fail("key prefix longer than the key before it")
        previous = previous[:prefix[i]] + r.raw(suffix[i])
        keys.append(previous)
    return keys, common


class OcdbtStore:
    """The newest version of the store under ``root`` (a directory holding
    ``manifest.ocdbt``), read once when it is opened."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        manifest = self.root / "manifest.ocdbt"
        if not manifest.is_file():
            raise OcdbtError(f"{self.root} holds no manifest.ocdbt")
        where = str(manifest)
        r = _Reader(decode_envelope(manifest.read_bytes(), MANIFEST_MAGIC, where), where)
        r.raw(16)  # the store's uuid
        manifest_kind = r.varint()
        if manifest_kind != 0:
            r.fail(f"manifest kind {manifest_kind} (numbered manifests are not read)")
        r.varints(2)  # the writer's limits: inline value bytes, decoded node bytes
        r.byte()  # the version tree's arity (log2)
        compression = r.varint()
        if compression == 1:
            r.raw(4)  # the writer's zstd level
        elif compression != 0:
            r.fail(f"compression method {compression}")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            self._values: Dict[bytes, ValueRef] = {}
            return
        generations = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # the roots' statistics
        newest = max(range(n), key=generations.__getitem__)
        if file_ids[newest] >= len(files):
            r.fail("root in a data file the manifest does not list")
        self._values = {}
        root_ref = (self._path(files[file_ids[newest]], where), offsets[newest], lengths[newest])
        self._visit(root_ref, heights[newest], b"")

    def _path(self, name: str, where: str) -> Path:
        path = (self.root / name).resolve()
        if self.root.resolve() not in path.parents:
            raise OcdbtError(f"{where}: data file {name!r} lies outside {self.root}")
        return path

    @staticmethod
    def _read_ref(ref: Tuple[Path, int, int]) -> bytes:
        path, offset, length = ref
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at byte {offset} run past its end")
        return data

    def _visit(self, ref: Tuple[Path, int, int], height: int, prefix: bytes) -> None:
        where = f"{ref[0]} (node at byte {ref[1]})"
        r = _Reader(decode_envelope(self._read_ref(ref), NODE_MAGIC, where), where)
        node_height = r.byte()
        if node_height != height:
            r.fail(f"node of height {node_height} where {height} was expected")
        files = [self._path(f, where) for f in _data_file_table(r)]
        n = r.varint()
        if n == 0:
            return
        keys, common = _keys(r, n, interior=height > 0)
        if height == 0:
            lengths = r.varints(n)
            kinds = [r.byte() for _ in range(n)]
            if any(k > 1 for k in kinds):
                r.fail("value kind other than inline (0) or indirect (1)")
            indirect = [i for i in range(n) if kinds[i] == 1]
            file_ids = r.varints(len(indirect))
            offsets = r.varints(len(indirect))
            for i, f, o in zip(indirect, file_ids, offsets):
                if f >= len(files):
                    r.fail("value in a data file the node does not list")
                self._values[prefix + keys[i]] = (files[f], o, lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    self._values[prefix + keys[i]] = r.raw(lengths[i])
            return
        file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # the subtrees' statistics
        for i in range(n):
            if file_ids[i] >= len(files) or common[i] > len(keys[i]):
                r.fail("child reference out of range")
            self._visit((files[file_ids[i]], offsets[i], lengths[i]), height - 1,
                        prefix + keys[i][:common[i]])

    def list(self) -> List[str]:
        """Every key, in order."""
        return [k.decode() for k in sorted(self._values)]

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        ref = self._values.get(key.encode())
        if ref is None:
            raise KeyError(f"{self.root}: no key {key!r}")
        return ref if isinstance(ref, bytes) else self._read_ref(ref)
