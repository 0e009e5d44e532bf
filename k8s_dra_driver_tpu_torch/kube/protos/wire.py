"""The proto3 wire format for the kubelet's DRA and plugin-registration
messages, written by hand.

The reference builds these messages from ``protoc``'s generated
``*_pb2.py``, which need the ``protobuf`` runtime. The port speaks the
same bytes without it: the messages use only varint tags, wire types 0
(``bool``) and 2 (``string``, embedded messages), repeated strings and
messages, and ``map<string, Msg>``, which the wire carries as repeated
entry messages (key 1, value 2).

- A message is a dataclass subclassing :class:`Message`, with the
  proto's field names and defaults and a ``FIELDS`` table of
  :class:`Field`.
- Encoding writes fields in field-number order, skips proto3 defaults
  (empty strings, ``False``) of singular fields, writes every element of
  a repeated field, and writes map entries with both key and value
  present, in the order protobuf's deterministic serialization gives
  them (``_map_order``): the bytes equal protobuf's
  ``SerializeToString(deterministic=True)``.
- Decoding skips unknown fields (wire types 0, 1, 2 and 5) and a known
  field met with another wire type, as protobuf does; later singular
  values and later map keys win.
"""

from __future__ import annotations

from typing import Any, ClassVar, NamedTuple, Optional

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_LEN = 2
WIRE_FIXED32 = 5

BOOL = "bool"
STRING = "string"
MESSAGE = "message"
MAP = "map"         # map<string, message>

_WIRE_OF = {BOOL: WIRE_VARINT, STRING: WIRE_LEN, MESSAGE: WIRE_LEN,
            MAP: WIRE_LEN}


class DecodeError(ValueError):
    """Bytes that are no valid encoding of the message."""


class Field(NamedTuple):
    number: int
    name: str
    kind: str                        # BOOL, STRING, MESSAGE or MAP
    repeated: bool = False
    message: Optional[type] = None   # MESSAGE: its class; MAP: the value's


def _varint(n: int, out: bytearray) -> None:
    if n < 0:
        raise ValueError(f"negative varint {n}")
    while True:
        low = n & 0x7F
        n >>= 7
        if n:
            out.append(low | 0x80)
        else:
            out.append(low)
            return


def _tag(number: int, wire: int, out: bytearray) -> None:
    _varint(number << 3 | wire, out)


def _delimited(number: int, payload: bytes, out: bytearray) -> None:
    _tag(number, WIRE_LEN, out)
    _varint(len(payload), out)
    out += payload


def _utf8(value, f: Field) -> bytes:
    if not isinstance(value, str):
        raise TypeError(f"{f.name}: expected str, got {type(value).__name__}")
    return value.encode("utf-8")


def _message_bytes(value, f: Field) -> bytes:
    if not isinstance(value, f.message):
        raise TypeError(f"{f.name}: expected {f.message.__name__}, got "
                        f"{type(value).__name__}")
    return value.SerializeToString()


def _map_order(key: str) -> tuple:
    """The order of a map's entries under protobuf's (upb's)
    deterministic serialization: bytewise on the UTF-8 key, and where one
    key is a prefix of the other, the longer first ("ab" before "a",
    the empty key last)."""
    return (*key.encode("utf-8"), 256)


def encode(msg: "Message") -> bytes:
    out = bytearray()
    for f in sorted(msg.FIELDS, key=lambda f: f.number):
        value = getattr(msg, f.name)
        if f.kind == MAP:
            for key in sorted(value, key=_map_order):
                entry = bytearray()
                _delimited(1, _utf8(key, f), entry)
                _delimited(2, _message_bytes(value[key], f), entry)
                _delimited(f.number, bytes(entry), out)
        elif f.repeated:
            for item in value:
                payload = (_utf8(item, f) if f.kind == STRING
                           else _message_bytes(item, f))
                _delimited(f.number, payload, out)
        elif f.kind == BOOL:
            if not isinstance(value, bool):
                raise TypeError(f"{f.name}: expected bool, got "
                                f"{type(value).__name__}")
            if value:
                _tag(f.number, WIRE_VARINT, out)
                out.append(1)
        elif f.kind == STRING:
            if value:
                _delimited(f.number, _utf8(value, f), out)
        elif value is not None:
            _delimited(f.number, _message_bytes(value, f), out)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(data):
            raise DecodeError("truncated varint")
        if shift >= 64:
            raise DecodeError("varint longer than 10 bytes")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def _fields(data: bytes):
    """(field number, wire type, value) for each field of ``data``: the
    value is an int for a varint, bytes for a length-delimited field and
    None for a fixed-width one (skipped)."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        if wire == WIRE_VARINT:
            value, pos = _read_varint(data, pos)
        elif wire == WIRE_LEN:
            size, pos = _read_varint(data, pos)
            if pos + size > len(data):
                raise DecodeError("truncated length-delimited field")
            value, pos = data[pos:pos + size], pos + size
        elif wire in (WIRE_FIXED64, WIRE_FIXED32):
            pos += 8 if wire == WIRE_FIXED64 else 4
            if pos > len(data):
                raise DecodeError("truncated fixed-width field")
            value = None
        else:
            raise DecodeError(f"unsupported wire type {wire}")
        yield number, wire, value


def _text(raw: bytes, f: Field) -> str:
    try:
        return bytes(raw).decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"{f.name}: invalid UTF-8") from e


def decode(cls: type, data: bytes) -> "Message":
    by_number = {f.number: f for f in cls.FIELDS}
    values: dict[str, Any] = {}
    for number, wire, raw in _fields(bytes(data)):
        f = by_number.get(number)
        if f is None or wire != _WIRE_OF[f.kind]:
            continue                    # unknown: skipped
        if f.kind == MAP:
            key, value = "", None
            for n, w, r in _fields(raw):
                if n == 1 and w == WIRE_LEN:
                    key = _text(r, f)
                elif n == 2 and w == WIRE_LEN:
                    value = f.message.FromString(r)
            values.setdefault(f.name, {})[key] = (
                value if value is not None else f.message())
        elif f.kind == BOOL:
            values[f.name] = raw != 0
        else:
            item = (_text(raw, f) if f.kind == STRING
                    else f.message.FromString(raw))
            if f.repeated:
                values.setdefault(f.name, []).append(item)
            else:
                values[f.name] = item
    return cls(**values)


class Message:
    """A proto3 message: subclasses are dataclasses whose fields are the
    proto's, with ``FIELDS`` naming each one's number and kind."""

    FIELDS: ClassVar[tuple[Field, ...]] = ()

    def SerializeToString(self) -> bytes:
        """The message's bytes, map entries in deterministic order."""
        return encode(self)

    @classmethod
    def FromString(cls, data: bytes):
        return decode(cls, data)
