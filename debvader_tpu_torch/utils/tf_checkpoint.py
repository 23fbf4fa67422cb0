"""TensorFlow checkpoint reader (and writer) in plain Python: the port's
copy of debvader_tpu/utils/tf_checkpoint.py, with no TF dependency.

The reference ships its pretrained DC2 weights as a TF "TensorBundle"
(``weights_noisy_v4.386--6.61.ckpt.*``, loaded by ``net.load_weights`` in
the reference's model/model.py):

- the ``.index`` file is an SSTable (leveldb's table format): data blocks
  of prefix-compressed keys with a restart point every few entries, an
  index block of block handles, a footer and a magic number; each key is
  a tensor's name and each value its BundleEntryProto (dtype, shape,
  shard, offset, size), the empty key the BundleHeaderProto;
- the ``.data-0000S-of-0000N`` shards hold the raw little-endian bytes.

Keys follow Keras' object-graph naming
(``layer_with_weights-N/kernel/.ATTRIBUTES/VARIABLE_VALUE``);
``weight_import.py`` maps them onto the model.  A bfloat16 tensor is
widened to float32; a missing shard is skipped by
``load_available_tensors``, so a partial snapshot loads partially; a
snappy-compressed block needs the ``snappy`` module and raises without it.

``write_bundle`` is the inverse: it writes a bundle in the layout TF
writes (restart interval 16, 4 KiB data blocks, masked CRC32C block
trailers, one file per shard), without the per-tensor CRC32C that neither
reader checks; it is how the tests and ``chip_smoke.py`` make a
checkpoint from weights they hold.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["BundleEntry", "read_index", "read_tensor", "load_available_tensors", "write_bundle"]

_TABLE_MAGIC = 0xDB4775248B80FB57

# TensorFlow DataType enum values
_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    6: np.int8,
    7: str,  # string (not read)
    9: np.int64,
    10: np.bool_,
    14: "bfloat16",  # no numpy dtype: widened to float32 by read_tensor
    19: np.float16,
}


@dataclass
class BundleEntry:
    dtype: int
    shape: tuple[int, ...]
    shard_id: int
    offset: int
    size: int

    @property
    def numpy_dtype(self):
        return _DTYPES.get(self.dtype, None)


# --------------------------------------------------------------- varint/proto


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_tensor_shape(buf: bytes) -> tuple[int, ...]:
    """TensorShapeProto: repeated Dim { int64 size = 1; string name = 2 } = 2."""
    dims = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 2 and wire == 2:  # Dim message
            ln, pos = _read_varint(buf, pos)
            dim_buf = buf[pos : pos + ln]
            pos += ln
            dpos = 0
            size = None
            while dpos < len(dim_buf):
                dtag, dpos = _read_varint(dim_buf, dpos)
                dfield, dwire = dtag >> 3, dtag & 7
                if dfield == 1 and dwire == 0:
                    size, dpos = _read_varint(dim_buf, dpos)
                elif dwire == 2:
                    ln2, dpos = _read_varint(dim_buf, dpos)
                    dpos += ln2
                else:
                    raise ValueError("unexpected dim field")
            dims.append(size)
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            pos += ln
        else:
            raise ValueError(f"unexpected wire type {wire}")
    return tuple(dims)


def _parse_bundle_entry(buf: bytes) -> BundleEntry:
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5,
    crc32c=6, slices=7."""
    dtype = 0
    shape: tuple[int, ...] = ()
    shard = 0
    offset = 0
    size = 0
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            if field == 1:
                dtype = val
            elif field == 3:
                shard = val
            elif field == 4:
                offset = val
            elif field == 5:
                size = val
        elif wire == 5:  # fixed32 (crc)
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            if field == 2:
                shape = _parse_tensor_shape(sub)
        else:
            raise ValueError(f"unexpected wire type {wire}")
    return BundleEntry(dtype, shape, shard, offset, size)


# ------------------------------------------------------------------- sstable


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Block contents + 1-byte compression type + 4-byte crc."""
    block = data[offset : offset + size]
    ctype = data[offset + size]
    if ctype == 0:  # no compression
        return block
    if ctype == 1:  # snappy
        try:
            import snappy

            return snappy.uncompress(block)
        except ImportError as e:
            raise RuntimeError("snappy-compressed checkpoint; snappy missing") from e
    raise ValueError(f"unknown block compression {ctype}")


def _iter_block_entries(block: bytes):
    """Yield (key, value) pairs from a prefix-compressed table block."""
    n_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos : pos + unshared]
        pos += unshared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key.decode("utf-8", "replace"), value


def _read_handle(buf: bytes, pos: int = 0):
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


def read_index(index_path: str | Path) -> dict[str, BundleEntry]:
    """Parse a .index file into {tensor_key: BundleEntry}."""
    data = Path(index_path).read_bytes()
    footer = data[-48:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"not an SSTable: bad magic {magic:#x}")
    # footer: metaindex handle, index handle (varint-encoded), padding, magic
    _, _, pos = _read_handle(footer, 0)
    index_off, index_size, _ = _read_handle(footer, pos)
    index_block = _read_block(data, index_off, index_size)

    entries: dict[str, BundleEntry] = {}
    for _, handle_val in _iter_block_entries(index_block):
        off, size, _ = _read_handle(handle_val, 0)
        for key, value in _iter_block_entries(_read_block(data, off, size)):
            if not key:  # header entry (BundleHeaderProto)
                continue
            try:
                entries[key] = _parse_bundle_entry(value)
            except (ValueError, IndexError):
                continue
    return entries


def read_tensor(ckpt_prefix: str | Path, key: str, entries: dict[str, BundleEntry] | None = None) -> np.ndarray:
    """Materialize one tensor from its data shard."""
    ckpt_prefix = str(ckpt_prefix)
    entries = entries or read_index(ckpt_prefix + ".index")
    e = entries[key]
    # shard file name: <prefix>.data-0000S-of-0000N
    n_shards = 1 + max(x.shard_id for x in entries.values())
    shard_path = Path(f"{ckpt_prefix}.data-{e.shard_id:05d}-of-{n_shards:05d}")
    if not shard_path.exists():
        raise FileNotFoundError(f"shard {shard_path} missing (stripped snapshot?)")
    with open(shard_path, "rb") as f:
        f.seek(e.offset)
        raw = f.read(e.size)
    dt = e.numpy_dtype
    if dt is None:
        raise ValueError(f"unsupported dtype {e.dtype} for {key}")
    if dt == "bfloat16":
        # bfloat16 is the top half of a float32: widen the bit patterns,
        # never hand back raw uint16 as parameter values
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(e.shape).copy()
    return np.frombuffer(raw, dtype=dt).reshape(e.shape).copy()


def load_available_tensors(ckpt_prefix: str | Path) -> dict[str, np.ndarray]:
    """All tensors whose shard file exists (partial snapshots load
    partially)."""
    entries = read_index(str(ckpt_prefix) + ".index")
    out = {}
    for key, e in entries.items():
        if e.numpy_dtype is None or e.numpy_dtype is str:
            continue
        try:
            out[key] = read_tensor(ckpt_prefix, key, entries)
        except FileNotFoundError:
            continue
    return out


# -------------------------------------------------------------------- writer

_RESTART_INTERVAL = 16
_BLOCK_BYTES = 4096
_CODES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2, np.dtype(np.int32): 3, np.dtype(np.uint8): 4,
          np.dtype(np.int8): 6, np.dtype(np.int64): 9, np.dtype(np.bool_): 10, np.dtype(np.float16): 19}


def _crc_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 & -(c & 1))
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """leveldb's masked CRC32C of a block trailer."""
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire) + payload


def _bundle_entry(code: int, shape: tuple, shard: int, offset: int, size: int) -> bytes:
    """BundleEntryProto, proto3 encoding (zero scalars left out)."""
    dims = b"".join(_field(2, 2, _varint(len(d)) + d) for d in (_field(1, 0, _varint(n)) for n in shape))
    out = _field(1, 0, _varint(code)) + _field(2, 2, _varint(len(dims)) + dims)
    for number, value in ((3, shard), (4, offset), (5, size)):
        if value:
            out += _field(number, 0, _varint(value))
    return out


def _block(entries: list) -> bytes:
    """One table block: prefix-compressed entries, a restart point every
    _RESTART_INTERVAL entries, the restart offsets and their count."""
    out, restarts, last = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        if i % _RESTART_INTERVAL == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while shared < min(len(key), len(last)) and key[shared] == last[shared]:
                shared += 1
        out += _varint(shared) + _varint(len(key) - shared) + _varint(len(value)) + key[shared:] + value
        last = key
    restarts = restarts or [0]
    out += b"".join(struct.pack("<I", r) for r in restarts) + struct.pack("<I", len(restarts))
    return bytes(out)


def _table(entries: list) -> bytes:
    """An SSTable of sorted (key, value) byte pairs: data blocks of about
    _BLOCK_BYTES, an empty metaindex block, the index block and the
    footer."""
    data, index = bytearray(), []

    def put(block: bytes) -> bytes:
        handle = _varint(len(data)) + _varint(len(block))
        data.extend(block + b"\0" + struct.pack("<I", _masked_crc(block + b"\0")))
        return handle

    start, size = 0, 0
    for i, (key, value) in enumerate(entries):
        size += len(key) + len(value) + 3
        if size >= _BLOCK_BYTES or i == len(entries) - 1:
            index.append((key, put(_block(entries[start : i + 1]))))
            start, size = i + 1, 0
    meta = put(_block([]))
    footer = meta + put(_block(index))
    return bytes(data) + footer + b"\0" * (40 - len(footer)) + struct.pack("<Q", _TABLE_MAGIC)


def write_bundle(ckpt_prefix: str | Path, tensors: dict, shards: int = 1, bfloat16=()) -> Path:
    """Write ``tensors`` ({key: array}) as a TensorBundle: ``<prefix>.index``
    and ``<prefix>.data-0000S-of-0000N``, tensor i (in key order) in shard
    i % ``shards``.  Keys named in ``bfloat16`` are stored as bfloat16
    (float32 rounded to nearest even); the rest in their own dtype.
    Returns the index file's path."""
    prefix = Path(ckpt_prefix)
    prefix.parent.mkdir(parents=True, exist_ok=True)
    blobs = [bytearray() for _ in range(shards)]
    records = []
    for i, key in enumerate(sorted(tensors, key=lambda k: k.encode())):
        a = np.ascontiguousarray(tensors[key])
        if key in bfloat16:
            u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
            raw = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype("<u2").tobytes()
            code = 14
        else:
            raw, code = a.astype(a.dtype.newbyteorder("<")).tobytes(), _CODES[a.dtype]
        shard = i % shards
        records.append((key.encode(), _bundle_entry(code, a.shape, shard, len(blobs[shard]), len(raw))))
        blobs[shard] += raw
    # BundleHeaderProto: num_shards = 1, endianness = 2 (LITTLE), version = 3
    header = _field(1, 0, _varint(shards)) + _field(3, 2, _varint(2) + _field(1, 0, _varint(1)))
    for shard, blob in enumerate(blobs):
        Path(f"{prefix}.data-{shard:05d}-of-{shards:05d}").write_bytes(bytes(blob))
    index = Path(f"{prefix}.index")
    index.write_bytes(_table([(b"", header)] + records))
    return index
