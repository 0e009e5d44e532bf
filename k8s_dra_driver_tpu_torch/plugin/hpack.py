"""HPACK (RFC 7541), the header compression of the kubelet sockets' HTTP/2.

The decoder takes everything a peer may send: indexed fields from the
61-entry static table and a dynamic table evicted by entry size (name +
value + 32 bytes), literals with incremental indexing, without indexing
and never indexed, dynamic table size updates, and string literals raw or
Huffman-coded (grpc-go and nghttp2 Huffman-code every string that comes
out shorter).

The encoder is the simplest legal one: a field found whole in the static
table is sent as its index (``:status 200`` is index 8), every other one
as a literal without indexing, with a raw name and value. It never adds
to its dynamic table, so the only state it keeps is the size update it
owes the peer after the peer lowers ``SETTINGS_HEADER_TABLE_SIZE``.

The Huffman code is RFC 7541 Appendix B's. It is canonical: the code
lengths below fix every code (:func:`_canonical`), so the table is kept
as 257 lengths, EOS last.
"""

from __future__ import annotations

import collections

# RFC 7541 Appendix A.
STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""),
)
_STATIC_INDEX = {field: i + 1 for i, field in enumerate(STATIC_TABLE)}

# The protocol's initial SETTINGS_HEADER_TABLE_SIZE, on both sides.
DEFAULT_TABLE_SIZE = 4096
ENTRY_OVERHEAD = 32

# RFC 7541 Appendix B: the code length of each symbol 0-255, then EOS.
HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,   # 0
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,   # 16
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,           # ' '
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,                # '0'
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,                  # '@'
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,               # 'P'
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,                  # '`'
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,              # 'p'
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,   # 128
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,   # 144
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,   # 160
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,   # 176
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,   # 192
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,   # 208
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,   # 224
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,   # 240
    30,                                                               # EOS
)
EOS = 256


def _canonical(lengths) -> tuple:
    """(code, length) of each symbol of the canonical code with these
    lengths: codes of one length are consecutive in symbol order, and
    each length's first code follows the last shorter one."""
    codes = [None] * len(lengths)
    code, prev = 0, 0
    for length, sym in sorted((n, s) for s, n in enumerate(lengths)):
        code <<= length - prev
        codes[sym] = (code, length)
        code, prev = code + 1, length
    return tuple(codes)


HUFFMAN_CODES = _canonical(HUFFMAN_LENGTHS)
_HUFFMAN_DECODE = {(n, code): sym for sym, (code, n) in
                   enumerate(HUFFMAN_CODES)}
_MIN_LENGTH = min(HUFFMAN_LENGTHS)


class HpackError(ValueError):
    """A header block that is no valid HPACK (HTTP/2's
    COMPRESSION_ERROR)."""


# -- primitives (RFC 7541 section 5) -----------------------------------------


def encode_integer(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    """``value`` with an N-bit prefix; ``flags`` fills the first byte's
    bits above the prefix."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes((flags | value,))
    out = bytearray((flags | limit,))
    value -= limit
    while value >= 0x80:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_integer(data: bytes, pos: int, prefix_bits: int) -> tuple:
    """(value, next position) of the integer whose prefix is in the low
    ``prefix_bits`` of ``data[pos]``."""
    if pos >= len(data):
        raise HpackError("integer past the end of the block")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("integer past the end of the block")
        byte = data[pos]
        pos += 1
        value += (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos
        if shift > 28:
            raise HpackError("integer longer than 32 bits")


def huffman_encode(raw: bytes) -> bytes:
    """``raw`` in the Huffman code, padded with the most significant
    bits of EOS (ones) to a whole byte."""
    acc, bits = 0, 0
    for byte in raw:
        code, length = HUFFMAN_CODES[byte]
        acc = (acc << length) | code
        bits += length
    pad = -bits % 8
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((bits + pad) // 8, "big")


def huffman_decode(data: bytes) -> bytes:
    """The string Huffman-coded in ``data``. Refuses an EOS symbol
    inside the string, padding longer than 7 bits, and padding that is
    not all ones (RFC 7541 section 5.2)."""
    out = bytearray()
    code, length = 0, 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            length += 1
            if length < _MIN_LENGTH:
                continue
            sym = _HUFFMAN_DECODE.get((length, code))
            if sym is None:
                if length >= 30:
                    raise HpackError("no Huffman code matches")
                continue
            if sym == EOS:
                raise HpackError("EOS symbol inside a Huffman string")
            out.append(sym)
            code, length = 0, 0
    if length > 7:
        raise HpackError(f"Huffman padding of {length} bits (at most 7)")
    if code != (1 << length) - 1:
        raise HpackError("Huffman padding is not the prefix of EOS")
    return bytes(out)


def encode_string(value: str, huffman: bool = False) -> bytes:
    raw = value.encode("latin-1")
    if huffman:
        raw = huffman_encode(raw)
    return encode_integer(len(raw), 7, 0x80 if huffman else 0) + raw


def decode_string(data: bytes, pos: int) -> tuple:
    if pos >= len(data):
        raise HpackError("string past the end of the block")
    huffman = data[pos] & 0x80
    n, pos = decode_integer(data, pos, 7)
    if pos + n > len(data):
        raise HpackError("string longer than the block")
    raw = bytes(data[pos:pos + n])
    if huffman:
        raw = huffman_decode(raw)
    return raw.decode("latin-1"), pos + n


# Literal representations: (first-byte flags, index prefix bits).
WITH_INDEXING = (0x40, 6)
WITHOUT_INDEXING = (0x00, 4)
NEVER_INDEXED = (0x10, 4)


def encode_indexed(index: int) -> bytes:
    return encode_integer(index, 7, 0x80)


def encode_literal(name, value: str, kind=WITHOUT_INDEXING,
                   huffman: bool = False) -> bytes:
    """A literal field of ``kind``; ``name`` is a table index or a
    string sent as a literal."""
    flags, prefix = kind
    if isinstance(name, int):
        return encode_integer(name, prefix, flags) + \
            encode_string(value, huffman)
    return (encode_integer(0, prefix, flags) + encode_string(name, huffman)
            + encode_string(value, huffman))


def encode_size_update(size: int) -> bytes:
    return encode_integer(size, 5, 0x20)


# -- the two ends -------------------------------------------------------------


class Decoder:
    """One connection's decoding context. ``max_allowed`` is this end's
    SETTINGS_HEADER_TABLE_SIZE: the most a size update may ask for."""

    def __init__(self, max_allowed: int = DEFAULT_TABLE_SIZE):
        self.max_allowed = max_allowed
        self.max_size = max_allowed
        self.size = 0
        self.table: collections.deque = collections.deque()  # newest first

    def _evict(self, room: int) -> None:
        while self.table and self.size + room > self.max_size:
            name, value = self.table.pop()
            self.size -= len(name) + len(value) + ENTRY_OVERHEAD

    def _add(self, name: str, value: str) -> None:
        entry = len(name) + len(value) + ENTRY_OVERHEAD
        self._evict(entry)
        if entry <= self.max_size:   # a larger entry empties the table
            self.table.appendleft((name, value))
            self.size += entry

    def _field(self, index: int) -> tuple:
        if index <= 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.table):
            raise HpackError(f"index {index} past the dynamic table")
        return self.table[i]

    def decode(self, block: bytes) -> list:
        """The (name, value) fields of one whole header block, in
        order; names and values as latin-1 strings."""
        fields = []
        pos = 0
        while pos < len(block):
            byte = block[pos]
            if byte & 0x80:                                   # indexed
                index, pos = decode_integer(block, pos, 7)
                fields.append(self._field(index))
                continue
            if byte & 0xE0 == 0x20:                           # size update
                if fields:
                    raise HpackError("table size update after a field")
                size, pos = decode_integer(block, pos, 5)
                if size > self.max_allowed:
                    raise HpackError(f"table size {size} over the "
                                     f"{self.max_allowed} allowed")
                self.max_size = size
                self._evict(0)
                continue
            if byte & 0x40:
                flags, prefix = WITH_INDEXING
            elif byte & 0x10:
                flags, prefix = NEVER_INDEXED
            else:
                flags, prefix = WITHOUT_INDEXING
            index, pos = decode_integer(block, pos, prefix)
            if index:
                name = self._field(index)[0]
            else:
                name, pos = decode_string(block, pos)
            value, pos = decode_string(block, pos)
            if flags == WITH_INDEXING[0]:
                self._add(name, value)
            fields.append((name, value))
        return fields


class Encoder:
    """One connection's encoding context (module docstring)."""

    def __init__(self):
        self.table_size = DEFAULT_TABLE_SIZE
        self._owed: int | None = None

    def set_peer_table_size(self, size: int) -> None:
        """The peer's SETTINGS_HEADER_TABLE_SIZE: a value below the
        table's size shrinks it, and the next block opens with the size
        update the peer's decoder then expects."""
        if size < self.table_size:
            self.table_size = size
            self._owed = size

    def encode(self, fields) -> bytes:
        out = bytearray()
        if self._owed is not None:
            out += encode_size_update(self._owed)
            self._owed = None
        for name, value in fields:
            index = _STATIC_INDEX.get((name, value))
            out += encode_indexed(index) if index else \
                encode_literal(name, value)
        return bytes(out)
