"""Minimal ``tf.train.Example`` wire codec: TF-free record payloads, a
copy of the JAX package's ``native/example_proto.py``.

The TFRecord pipeline stores one ``Example`` proto per record with two
features (``image/encoded`` bytes, ``image/class/label`` int64;
``data/prepare.py``). The schema is tiny and fixed, so this hand-rolled
protobuf encoder/decoder keeps TensorFlow off the write path and off any
reader that needs just these two fields: with ``native``'s framing it is
a complete standalone TFRecord implementation, byte-compatible with
``tf.io.parse_single_example``.

Wire facts used (protobuf encoding spec):
``Example.features = 1``, ``Features.feature = 1`` (map<string,Feature>:
entries are messages with key=1, value=2), ``Feature.bytes_list = 1``,
``Feature.int64_list = 3``, ``BytesList.value = 1``,
``Int64List.value = 1`` (accepting packed and unpacked).
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

FeatureValue = Union[bytes, List[int]]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _feature(value: FeatureValue) -> bytes:
    if isinstance(value, bytes):
        bytes_list = _len_delim(1, value)  # BytesList.value
        return _len_delim(1, bytes_list)  # Feature.bytes_list
    packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in value)
    int64_list = _len_delim(1, packed)  # Int64List.value (packed)
    return _len_delim(3, int64_list)  # Feature.int64_list


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize ``{name: bytes | [int64, ...]}`` as a tf.train.Example.

    Keys are emitted sorted (matching protobuf's deterministic map
    serialization order for string keys).
    """
    entries = b"".join(
        _len_delim(
            1,  # Features.feature map entry
            _len_delim(1, key.encode()) + _len_delim(2, _feature(value)),
        )
        for key, value in sorted(features.items())
    )
    return _len_delim(1, entries)  # Example.features


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _read_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.
    Length-delimited values come back as bytes; varints as int."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            if len(value) != length:
                raise ValueError("truncated length-delimited field")
            pos += length
        elif wire == 5:
            value = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            value = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_feature(buf: bytes) -> FeatureValue:
    for field, _, value in _read_fields(buf):
        if field == 1:  # bytes_list
            for f2, _, v2 in _read_fields(value):
                if f2 == 1:
                    return v2
            return b""
        if field == 3:  # int64_list
            ints: List[int] = []
            for f2, w2, v2 in _read_fields(value):
                if f2 != 1:
                    continue
                if w2 == 0:  # unpacked
                    ints.append(v2)
                else:  # packed
                    pos = 0
                    while pos < len(v2):
                        n, pos = _read_varint(v2, pos)
                        ints.append(n)
            return [n - (1 << 64) if n >= 1 << 63 else n for n in ints]
    raise ValueError("unsupported Feature kind (only bytes/int64 lists)")


def parse_example(payload: bytes) -> Dict[str, FeatureValue]:
    """Decode an Example's bytes/int64 features: inverse of
    :func:`encode_example` (accepts TF-serialized Examples too)."""
    out: Dict[str, FeatureValue] = {}
    for field, _, features_buf in _read_fields(payload):
        if field != 1:
            continue
        for f2, _, entry in _read_fields(features_buf):
            if f2 != 1:
                continue
            key = b""
            value: FeatureValue = b""
            for f3, _, v3 in _read_fields(entry):
                if f3 == 1:
                    key = v3
                elif f3 == 2:
                    value = _parse_feature(v3)
            out[key.decode()] = value
    return out
