"""The port's native IO tier and deterministic fills: the JAX package's
``native`` (crc32c, TFRecord framing, indexing and counting, the
splitmix64 fill), bit for bit.

The C++ library is ``csrc/ddl_native.cpp`` (a copy of the repository's
``native/ddl_native.cc``), built by ``ops/_build.build("ddl_native")``
with the host's C++ compiler into the package's ``_build/`` at first
use, and loaded with ``ctypes``. Every call has a bit-identical
pure-Python path, taken when the library cannot be built or loaded, or
when ``DDL_NATIVE=0`` forces it (:func:`native_available` says which;
:func:`load_error` why the library is missing). The fill stays numpy:
the JAX package's C++ and numpy fills compute the same bits.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lib_error: Optional[str] = None


def load_library() -> Optional[ctypes.CDLL]:
    """The CDLL of ``csrc/ddl_native.cpp``, built on first use; None
    when ``DDL_NATIVE`` is off or the build or load failed."""
    global _lib, _lib_tried, _lib_error
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get("DDL_NATIVE", "1") in ("0", "false", "off"):
            _lib_error = "DDL_NATIVE is off"
            return None
        from distributeddeeplearning_tpu_torch.ops import _build

        try:
            lib = _build.load("ddl_native")
        except (OSError, RuntimeError) as e:
            _lib_error = str(e)
            return None
        lib.ddl_crc32c.restype = ctypes.c_uint32
        lib.ddl_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.ddl_masked_crc32c.restype = ctypes.c_uint32
        lib.ddl_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.ddl_tfrecord_write.restype = ctypes.c_int
        lib.ddl_tfrecord_write.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_int,
        ]
        lib.ddl_tfrecord_index.restype = ctypes.c_int64
        lib.ddl_tfrecord_index.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def load_error() -> Optional[str]:
    """Why the library is not loaded (None when it is, or before the
    first attempt)."""
    load_library()
    return _lib_error


# ------------------------------------------------------------------ crc32c

_CRC_TABLE: Optional[np.ndarray] = None


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = np.zeros(256, np.uint32)
        for i in range(256):
            c = np.uint32(i)
            for _ in range(8):
                c = np.uint32(0x82F63B78) ^ (c >> np.uint32(1)) if c & 1 else c >> np.uint32(1)
            table[i] = c
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c_py(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    lib = load_library()
    if lib is not None:
        return int(lib.ddl_crc32c(data, len(data)))
    return _crc32c_py(data)


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC of ``data``."""
    lib = load_library()
    if lib is not None:
        return int(lib.ddl_masked_crc32c(data, len(data)))
    crc = _crc32c_py(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------- TFRecord


def write_tfrecord(path: str, payloads: Sequence[bytes], append: bool = False) -> None:
    """Write ``payloads`` as a TFRecord file (framing + masked CRCs),
    byte-compatible with ``tf.io.TFRecordWriter`` output."""
    lib = load_library()
    if lib is not None:
        buf = b"".join(payloads)
        lens = (ctypes.c_uint64 * len(payloads))(*map(len, payloads))
        rc = lib.ddl_tfrecord_write(str(path).encode(), buf, lens, len(payloads), int(append))
        if rc != 0:
            raise IOError(f"native TFRecord write failed ({rc}) for {path}")
        return
    with open(path, "ab" if append else "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))


def index_tfrecord(path: str, verify: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(payload_offsets, payload_lengths) for every record in ``path``:
    one sequential scan, CRC-verified when ``verify``."""
    lib = load_library()
    if lib is not None:
        n = lib.ddl_tfrecord_index(str(path).encode(), None, None, 0, int(verify))
        if n == -2:
            raise FileNotFoundError(path)
        if n < 0:
            raise IOError(f"corrupt TFRecord file: {path}")
        offsets = np.zeros(n, np.uint64)
        lengths = np.zeros(n, np.uint64)
        if n:
            n2 = lib.ddl_tfrecord_index(
                str(path).encode(),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                n, int(verify))
            if n2 != n:
                raise IOError(f"TFRecord file changed while indexing: {path}")
        return offsets, lengths
    offsets, lengths = [], []
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while True:
            header = f.read(12)
            if not header:
                break
            if len(header) != 12:
                raise IOError(f"corrupt TFRecord file: {path}")
            (length,) = struct.unpack("<Q", header[:8])
            if length + 4 > file_size - (pos + 12):
                raise IOError(f"corrupt TFRecord length field: {path}")
            if verify:
                (stored,) = struct.unpack("<I", header[8:])
                if masked_crc32c(header[:8]) != stored:
                    raise IOError(f"corrupt TFRecord length CRC: {path}")
                payload = f.read(length)
                footer = f.read(4)
                if len(payload) != length or len(footer) != 4:
                    raise IOError(f"corrupt TFRecord file: {path}")
                if masked_crc32c(payload) != struct.unpack("<I", footer)[0]:
                    raise IOError(f"corrupt TFRecord data CRC: {path}")
            else:
                f.seek(length + 4, os.SEEK_CUR)
            offsets.append(pos + 12)
            lengths.append(length)
            pos += 12 + length + 4
    return np.asarray(offsets, np.uint64), np.asarray(lengths, np.uint64)


def read_tfrecord(path: str, verify: bool = True) -> List[bytes]:
    """All record payloads of ``path`` (index + one pass)."""
    offsets, lengths = index_tfrecord(path, verify=verify)
    out = []
    with open(path, "rb") as f:
        for off, length in zip(offsets.tolist(), lengths.tolist()):
            f.seek(off)
            out.append(f.read(length))
    return out


def count_records(path: str, verify: bool = False) -> int:
    """Number of records in a TFRecord file: one framing scan, no
    payload parsing."""
    lib = load_library()
    if lib is not None:
        n = lib.ddl_tfrecord_index(str(path).encode(), None, None, 0, int(verify))
        if n == -2:
            raise FileNotFoundError(path)
        if n < 0:
            raise IOError(f"corrupt TFRecord file: {path}")
        return int(n)
    return len(index_tfrecord(path, verify=verify)[0])


# ------------------------------------------------------- deterministic fill


def fill_uniform(shape, seed: int) -> np.ndarray:
    """float32 uniform [0, 1] array in splitmix64 counter mode:
    ``out[i] = hash(seed + i)``, the top 32 bits over 2**32.

    The upper bound is closed: uint32 draws >= 2**32 - 128 round up to
    1.0 in float32, as in the JAX package."""
    n = int(np.prod(shape))
    out = np.empty(n, np.float32)
    chunk = 1 << 22  # bounds the uint64 temporaries
    s = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            z = np.arange(lo, hi, dtype=np.uint64) + s
            z = z + np.uint64(0x9E3779B97F4A7C15)
            z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            z = z ^ (z >> np.uint64(31))
            bits = (z >> np.uint64(32)).astype(np.uint32)
            out[lo:hi] = bits.astype(np.float32) * np.float32(1.0 / 4294967296.0)
    return out.reshape(shape)


__all__ = [
    "count_records",
    "crc32c",
    "fill_uniform",
    "index_tfrecord",
    "load_error",
    "load_library",
    "masked_crc32c",
    "native_available",
    "read_tfrecord",
    "write_tfrecord",
]
