"""The port's native IO tier (``distributeddeeplearning_tpu_torch/native``,
``csrc/ddl_native.cpp``) against the JAX package's
(``distributeddeeplearning_tpu/native``), twin of ``tests/test_native.py``:

* the crc32c known answer (RFC 3720), native and Python paths; the
  port's library builds from its own source into the package's
  ``_build/`` (never the JAX package's ``native/libddl_native.so``), and
  ``DDL_NATIVE=0`` forces the Python path;
* the Python path writes the same bytes as the native one and reads its
  files;
* round trip, index offsets, append, corruption detected;
* byte-identical TFRecord files from both packages' writers for the
  same records, and each package's ``index_tfrecord`` / ``read_tfrecord``
  / ``count_records`` reading the other's files;
* ``encode_example`` / ``parse_example`` equal to JAX's, bytes and
  values (packed, unpacked and negative int64s).
"""

import ctypes
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import distributeddeeplearning_tpu.native as jax_native
import distributeddeeplearning_tpu_torch.native as native
from distributeddeeplearning_tpu.native import example_proto as jax_proto
from distributeddeeplearning_tpu_torch.native import example_proto as proto

ROOT = Path(__file__).resolve().parent.parent
PAYLOADS = [b"hello tfrecord", b"", b"x" * 1000, bytes(range(256)),
            np.random.RandomState(0).bytes(70_001)]


def test_crc32c_known_answer():
    assert native.crc32c(b"123456789") == 0xE3069283  # RFC 3720 check value
    assert native.crc32c(b"") == 0
    assert native._crc32c_py(b"123456789") == 0xE3069283
    blob = np.random.RandomState(1).bytes(4099)
    assert native.crc32c(blob) == native._crc32c_py(blob) == jax_native.crc32c(blob)
    assert native.masked_crc32c(blob) == jax_native.masked_crc32c(blob)


def test_library_builds_from_the_ports_source_into_build_dir():
    from distributeddeeplearning_tpu_torch.ops import _build

    assert native.native_available(), native.load_error()
    assert native.load_error() is None
    path = _build.library_path("ddl_native")
    assert path.exists() and path.parent == _build.build_dir()
    assert path.parent.resolve() != (ROOT / "native").resolve()
    assert _build._source("ddl_native") == _build.CSRC / "ddl_native.cpp"
    lib = native.load_library()
    assert isinstance(lib, ctypes.CDLL) and Path(lib._name) == path
    # the copy is the repository's source, its two comment lines aside
    ours = (_build.CSRC / "ddl_native.cpp").read_text().splitlines()
    theirs = (ROOT / "native" / "ddl_native.cc").read_text().splitlines()
    assert len(ours) == len(theirs)
    assert sum(a != b for a, b in zip(ours, theirs)) == 2


def test_ddl_native_off_forces_the_python_path(tmp_path):
    code = ("import distributeddeeplearning_tpu_torch.native as n\n"
            "n.write_tfrecord(%r, [b'abc', b''])\n"
            "print(n.native_available(), n.load_error())\n" % str(tmp_path / "off.tfrecord"))
    env = dict(os.environ, PYTHONPATH=str(ROOT), DDL_NATIVE="0")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "DDL_NATIVE", "is", "off"]
    native.write_tfrecord(str(tmp_path / "on.tfrecord"), [b"abc", b""])
    assert (tmp_path / "off.tfrecord").read_bytes() == (tmp_path / "on.tfrecord").read_bytes()


def test_python_path_matches_native(tmp_path, monkeypatch):
    assert native.native_available()
    native_file = tmp_path / "native.tfrecord"
    native.write_tfrecord(str(native_file), PAYLOADS)
    monkeypatch.setattr(native, "load_library", lambda: None)
    py_file = tmp_path / "py.tfrecord"
    native.write_tfrecord(str(py_file), PAYLOADS)
    assert native_file.read_bytes() == py_file.read_bytes()
    assert native.crc32c(b"123456789") == 0xE3069283
    offs, lens = native.index_tfrecord(str(native_file))
    assert list(lens) == [len(p) for p in PAYLOADS]
    assert native.read_tfrecord(str(py_file)) == PAYLOADS
    assert native.count_records(str(py_file)) == len(PAYLOADS)


@pytest.mark.parametrize("path", ["native", "python"])
def test_roundtrip_index_and_append(tmp_path, monkeypatch, path):
    if path == "python":
        monkeypatch.setattr(native, "load_library", lambda: None)
    f = tmp_path / "a.tfrecord"
    native.write_tfrecord(str(f), PAYLOADS)
    assert native.read_tfrecord(str(f)) == PAYLOADS
    assert native.count_records(str(f)) == len(PAYLOADS)
    offsets, lengths = native.index_tfrecord(str(f))
    assert offsets.dtype == lengths.dtype == np.uint64
    assert list(lengths) == [len(p) for p in PAYLOADS]
    blob = f.read_bytes()
    for payload, off, length in zip(PAYLOADS, offsets, lengths):
        assert blob[int(off):int(off) + int(length)] == payload
    native.write_tfrecord(str(f), [b"tail"], append=True)
    assert native.read_tfrecord(str(f))[-1] == b"tail"
    with pytest.raises(FileNotFoundError):
        native.index_tfrecord(str(tmp_path / "missing.tfrecord"))


@pytest.mark.parametrize("path", ["native", "python"])
def test_corruption_detected(tmp_path, monkeypatch, path):
    if path == "python":
        monkeypatch.setattr(native, "load_library", lambda: None)
    f = tmp_path / "bad.tfrecord"
    native.write_tfrecord(str(f), PAYLOADS)
    blob = bytearray(f.read_bytes())
    blob[14] ^= 0xFF  # a payload byte of record 0
    f.write_bytes(bytes(blob))
    with pytest.raises(IOError):
        native.index_tfrecord(str(f), verify=True)
    assert native.count_records(str(f), verify=False) == len(PAYLOADS)
    # a length field that runs past the end fails cleanly, not by hanging
    g = tmp_path / "len.tfrecord"
    g.write_bytes(struct.pack("<Q", 1 << 40) + b"\0" * 20)
    with pytest.raises(IOError):
        native.index_tfrecord(str(g), verify=False)


def test_files_byte_identical_to_jax_and_cross_readable(tmp_path):
    ours, theirs = tmp_path / "port.tfrecord", tmp_path / "jax.tfrecord"
    native.write_tfrecord(str(ours), PAYLOADS)
    jax_native.write_tfrecord(str(theirs), PAYLOADS)
    assert ours.read_bytes() == theirs.read_bytes()
    for reader, f in ((native, theirs), (jax_native, ours)):
        assert reader.read_tfrecord(str(f)) == PAYLOADS
        assert reader.count_records(str(f)) == len(PAYLOADS)
    po, pl = native.index_tfrecord(str(theirs))
    jo, jl = jax_native.index_tfrecord(str(ours))
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pl, jl)


EXAMPLES = [
    {"image/encoded": b"\x89JPGDATA", "image/class/label": [417]},
    {"image/encoded": b"", "image/class/label": [0]},
    {"image/encoded": bytes(range(256)) * 3, "image/class/label": [-3, 2**40, 999]},
    {"a": b"x", "b": [1, 2, 3], "c": b"\x00\x01"},
]


@pytest.mark.parametrize("ex", EXAMPLES, ids=["jpeg", "empty", "multi", "three-keys"])
def test_example_codec_equals_jax(ex):
    payload = proto.encode_example(ex)
    assert payload == jax_proto.encode_example(ex)
    assert proto.parse_example(payload) == jax_proto.parse_example(payload) == ex


def test_example_parse_accepts_unpacked_int64():
    # Int64List.value written unpacked (one varint field per value), the
    # other encoding protobuf allows: both packages parse it the same.
    ints = proto._len_delim(3, b"".join(proto._tag(1, 0) + proto._varint(v) for v in (5, 300)))
    entry = proto._len_delim(1, b"k") + proto._len_delim(2, ints)
    payload = proto._len_delim(1, proto._len_delim(1, entry))
    assert proto.parse_example(payload) == jax_proto.parse_example(payload) == {"k": [5, 300]}
    with pytest.raises(ValueError):
        proto.parse_example(b"\x0b")  # wire type 3 is not supported
