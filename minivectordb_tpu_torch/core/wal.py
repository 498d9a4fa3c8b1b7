"""Write-ahead log for the sharded database's fast-ingest mode.

Counterpart of ``minivectordb_tpu/core/wal.py``, with the same framing, so a
``wal.log`` written by either package replays in the other.

The reference persists every single insert by reading, unpickling,
re-pickling and rewriting the WHOLE target shard file
(reference sharded_vector_database.py:134-154) — O(shard_size * d) disk work
per insert. The WAL keeps the same *process-crash* durability contract (an
insert is written out before store_embedding returns; the OS page cache
holds it until writeback — the same guarantee as the reference's
non-fsynced pickle writes) at O(record) cost: mutations are appended as
CRC32-framed pickled records and folded into the shard files on
``compact()`` (which load replays automatically). For full power-loss
durability pass ``fsync=True`` per append (``durability="wal_fsync"`` on
the database), which fsyncs each record before returning.

Record framing: [magic 'MVDW' u32][payload_len u64 LE][crc32 u32 LE][payload]
(payload = pickled op tuple). Appends go through the C++ fast path
(native/fastops, ``mvdb_wal_append``) when its library is built, else pure
Python: the same bytes either way. A torn or corrupt tail record is detected
by CRC/length and ignored (at most the in-flight op is lost — same guarantee
as the reference's torn pickle write).
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib

from minivectordb_tpu_torch.native import fastops

_MAGIC = 0x5744564D  # 'MVDW'
_HEADER = struct.Struct("<IQI")  # magic, payload_len, crc32


def append_record(path: str, op: tuple, fsync: bool = False) -> None:
    payload = pickle.dumps(op)
    ok = fastops.wal_append(path, payload, fsync)
    if ok:
        return
    if ok is False:
        raise OSError(f"WAL append failed: {path}")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    with open(path, "ab") as f:
        f.write(_HEADER.pack(_MAGIC, len(payload), crc))
        f.write(payload)
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def read_records(path: str) -> list[tuple]:
    """Replay all valid records; stops cleanly at a torn/corrupt tail."""
    if not os.path.exists(path):
        return []
    ops = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    n = len(data)
    while off + _HEADER.size <= n:
        magic, plen, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC or off + _HEADER.size + plen > n:
            break  # torn tail
        payload = data[off + _HEADER.size : off + _HEADER.size + plen]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break  # corrupt tail
        ops.append(pickle.loads(payload))
        off += _HEADER.size + plen
    return ops


def truncate(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)
