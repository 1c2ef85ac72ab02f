"""A read-only OCDBT key-value store: the on-disk B+tree that orbax
checkpoints are written in (tensorstore's ``ocdbt`` driver; format:
https://google.github.io/tensorstore/kvstore/ocdbt/index.html).

A database directory holds ``manifest.ocdbt`` and data files under
``d/``.  Every manifest and B-tree node is framed as

    magic (4 bytes, big-endian) | total length (u64 LE) | version (varint)
    | compression (varint: 0 raw, 1 zstd) | body | CRC-32C of all before (u32 LE)

The manifest body holds the config, a data-file table and the newest
versions (inline; older ones in version-tree nodes, which a reader of the
newest version never needs).  The newest version names the root B-tree
node by (data file, offset, length).  Interior nodes hold child
references; leaf nodes hold values, inline or as (data file, offset,
length).  Keys are prefix-compressed within a node and, below an interior
entry, stripped of that entry's subtree common prefix.  Data-file paths
are ``base_path + relative_path`` relative to the root directory, a
node's base paths prefixed by its own file's base path: an orbax
checkpoint's root tree reaches the per-process databases
(``ocdbt.process_<i>/``) this way.

Every manifest and node is checked against its CRC-32C
(``tfrecord.crc32c``) and decompressed with the package's own zstd
decoder (``zstd.py``).
"""

from __future__ import annotations

import os
import struct

from tensorflowonspark_torch.orbax_layout import zstd
from tensorflowonspark_torch.tfrecord import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # the offset / length of "no root" (an empty version)
_MAX_MANIFEST_BYTES = 64 << 20  # a decoded manifest; nodes: the config's own limit


class _Reader:
    """A cursor over a decoded body; every read is bounds-checked."""

    def __init__(self, buf: bytes, where: str):
        self.buf, self.pos, self.where = buf, 0, where

    def fail(self, what: str):
        raise ValueError(f"ocdbt: {what} at byte {self.pos} of the body of {self.where}")

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            self.fail("truncated body")
        self.pos += 1
        return self.buf[self.pos - 1]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if n > len(self.buf) - self.pos:
            self.fail(f"truncated body ({n} bytes wanted)")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def u64s(self, n: int) -> list[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))


def _unframe(raw: bytes, magic: int, where: str, max_size: int) -> bytes:
    """The body of one manifest or node, its framing and CRC checked, at
    most ``max_size`` bytes decoded."""
    if len(raw) < 18:
        raise ValueError(f"ocdbt: {where} is {len(raw)} bytes, too short to be framed")
    got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt: {where} has magic {got_magic:08x}, expected {magic:08x}")
    if length != len(raw):
        raise ValueError(f"ocdbt: {where} says it is {length} bytes, {len(raw)} were read")
    want = struct.unpack_from("<I", raw, len(raw) - 4)[0]
    if crc32c(raw[:-4]) != want:
        raise ValueError(f"ocdbt: CRC-32C mismatch in {where}")
    head = _Reader(raw[12:-4], where)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {where} has format version {version}; this reader knows 0")
    body = raw[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, max_size=max_size)
    raise ValueError(f"ocdbt: {where} has compression {compression}; this reader knows 0 and 1")


def _data_file_table(r: _Reader, base: str) -> list[tuple[str, str]]:
    """Each data file's (base path, relative path), the base prefixed by
    ``base`` (that of the file the table was read from)."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix, base_len = r.varints(n), r.varints(n)
    paths: list[tuple[str, str]] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file path prefix longer than the previous path")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(full):
            r.fail("data file base path longer than its path")
        full_s = full.decode()
        paths.append((base + full_s[:base_len[i]], full_s[base_len[i]:]))
        prev = full
    return paths


def _ref(files: list[tuple[str, str]], file_id: int, offset: int, length: int,
         r: _Reader) -> tuple[tuple[str, str], int, int]:
    """A (data file, offset, length) reference, its file id checked."""
    if file_id >= len(files):
        r.fail(f"data file id {file_id} outside its table of {len(files)}")
    return files[file_id], offset, length


class OcdbtStore:
    """The newest version of the OCDBT database at ``root`` (a directory),
    read whole at construction: ``list()`` gives its keys in order and
    ``read(key)`` a value (``KeyError`` if absent)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        # key -> (b"", value) inline, or ((base, relative path), offset, length)
        self._values: dict[str, tuple] = {}
        manifest = os.path.join(self.root, "manifest.ocdbt")
        with open(manifest, "rb") as f:
            r = _Reader(_unframe(f.read(), MANIFEST_MAGIC, manifest, _MAX_MANIFEST_BYTES),
                        manifest)
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"ocdbt: {manifest} is a numbered manifest (kind {kind}); "
                             "this reader knows the single-file kind 0")
        r.varint()  # max_inline_value_bytes
        self.max_decoded_node_bytes = r.varint()
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:  # compression: zstd, with its level (int32 LE)
            r.take(4)
        files = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            return  # no version written
        r.varints(n)  # generation numbers, ascending
        heights = [r.byte() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        # statistics (keys, tree bytes, indirect bytes), commit times
        r.varints(3 * n)
        r.u64s(n)
        if offsets[-1] == _MISSING:
            return  # the newest version is empty
        self._walk(_ref(files, ids[-1], offsets[-1], lengths[-1], r), heights[-1], b"")

    def _read_span(self, file: tuple[str, str], offset: int, length: int) -> bytes:
        path = "".join(file)
        if os.path.isabs(path) or os.path.normpath(path).split(os.sep)[0] == os.pardir:
            raise ValueError(f"ocdbt: data file {path!r} lies outside {self.root}")
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"ocdbt: {path} holds {offset + len(data)} bytes, a reference "
                             f"wants [{offset}, {offset + length})")
        return data

    def _walk(self, ref: tuple[tuple[str, str], int, int], height: int,
              prefix: bytes) -> None:
        file, offset, length = ref
        where = f"{''.join(file)}[{offset}:{offset + length}]"
        body = _unframe(self._read_span(file, offset, length), NODE_MAGIC, where,
                        self.max_decoded_node_bytes)
        r = _Reader(body, where)
        if r.byte() != height:
            r.fail(f"node height differs from its reference's ({height})")
        files = _data_file_table(r, file[0])
        n = r.varint()
        keys_prefix = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height else []
        keys: list[bytes] = []
        prev = b""
        for i in range(n):
            if keys_prefix[i] > len(prev):
                r.fail("key prefix longer than the previous key")
            prev = prev[:keys_prefix[i]] + r.take(suffix[i])
            keys.append(prev)
        if height:
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # statistics
            for i in range(n):
                if common[i] > len(keys[i]):
                    r.fail("subtree common prefix longer than its key")
                self._walk(_ref(files, ids[i], offs[i], lens[i], r), height - 1,
                           prefix + keys[i][:common[i]])
            return
        lens = r.varints(n)
        kinds = [r.byte() for _ in range(n)]
        if any(k > 1 for k in kinds):
            r.fail(f"value kind {max(kinds)} (0 inline, 1 indirect)")
        indirect = [i for i in range(n) if kinds[i]]
        ids, offs = r.varints(len(indirect)), r.varints(len(indirect))
        for j, i in enumerate(indirect):
            self._values[(prefix + keys[i]).decode()] = _ref(files, ids[j], offs[j],
                                                                  lens[i], r)
        for i in range(n):
            if not kinds[i]:
                self._values[(prefix + keys[i]).decode()] = (b"", r.take(lens[i]))

    def list(self) -> list[str]:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def read(self, key: str) -> bytes:
        ref = self._values[key]
        if len(ref) == 2:
            return ref[1]
        return self._read_span(*ref)
