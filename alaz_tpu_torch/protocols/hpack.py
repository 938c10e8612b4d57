"""HPACK (RFC 7541) header compression — decoder + encoder.

The reference pairs gRPC request/response HEADERS frames with per-connection
client/server HPACK decoders from golang.org/x/net (aggregator/data.go:93-103,
646-657). This is a from-scratch implementation: static table, dynamic table
with size eviction, integer/string primitives, and Huffman coding.

The Huffman code is built canonically from the per-symbol code lengths
(RFC 7541 Appendix B assigns codes in canonical (length, symbol) order), and
is validated against the RFC's Appendix C test vectors in
``tests/test_protocols.py``.
"""

from __future__ import annotations

from typing import List, Tuple

# Code lengths for symbols 0..256 (256 = EOS), RFC 7541 Appendix B.
# ASCII symbols (32..126) are what headers are made of; the canonical
# construction only needs lengths, and the appendix-C vectors pin them down.
_CODE_LENGTHS = [
    # 0-31 control
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    #  ' '  !   "   #   $   %   &   '   (   )   *   +   ,   -   .   /
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    #  0  1  2  3  4  5  6  7  8  9  :  ;  <   =  >   ?
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    #  @   A  B  C  D  E  F  G  H  I  J  K  L  M  N  O
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    #  P  Q  R  S  T  U  V  W  X  Y  Z  [   \   ]   ^   _
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    #  `   a  b  c  d  e  f  g  h  i  j  k  l  m  n  o
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    #  p  q  r  s  t  u  v  w  x  y  z  {   |   }   ~   DEL
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    # 128-159
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    # 160-191
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    # 192-223
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    # 224-255
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    # 256 EOS
    30,
]

assert len(_CODE_LENGTHS) == 257


def _build_canonical() -> tuple[list[tuple[int, int]], dict[tuple[int, int], int]]:
    """Canonical Huffman assignment over (length, symbol) order."""
    order = sorted(range(257), key=lambda s: (_CODE_LENGTHS[s], s))
    codes: list[tuple[int, int]] = [(0, 0)] * 257
    decode: dict[tuple[int, int], int] = {}
    code = 0
    prev_len = _CODE_LENGTHS[order[0]]
    for sym in order:
        ln = _CODE_LENGTHS[sym]
        code <<= ln - prev_len
        prev_len = ln
        codes[sym] = (code, ln)
        decode[(code, ln)] = sym
        code += 1
    return codes, decode


HUFFMAN_CODES, _HUFFMAN_DECODE = _build_canonical()
EOS_SYMBOL = 256


class HpackError(Exception):
    pass


def huffman_encode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    for b in data:
        code, ln = HUFFMAN_CODES[b]
        acc = (acc << ln) | code
        nbits += ln
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        pad = 8 - nbits
        acc = (acc << pad) | ((1 << pad) - 1)  # EOS-prefix padding (all ones)
        out.append(acc & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    acc = 0
    nbits = 0
    table = _HUFFMAN_DECODE
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        # greedily match shortest codes (min length is 5)
        while nbits >= 5:
            matched = False
            for ln in range(5, min(nbits, 30) + 1):
                code = (acc >> (nbits - ln)) & ((1 << ln) - 1)
                sym = table.get((code, ln))
                if sym is not None:
                    if sym == EOS_SYMBOL:
                        raise HpackError("EOS in huffman data")
                    out.append(sym)
                    nbits -= ln
                    acc &= (1 << nbits) - 1
                    matched = True
                    break
            if not matched:
                break
    # remaining bits must be an all-ones EOS prefix, < 8 bits
    if nbits >= 8:
        raise HpackError("huffman padding too long")
    if nbits and (acc & ((1 << nbits) - 1)) != (1 << nbits) - 1:
        raise HpackError("huffman padding not EOS prefix")
    return bytes(out)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def encode_integer(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([flags | value])
    out = bytearray([flags | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_integer(data: bytes, off: int, prefix_bits: int) -> tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    if off >= len(data):
        raise HpackError("integer truncated")
    value = data[off] & limit
    off += 1
    if value < limit:
        return value, off
    shift = 0
    while True:
        if off >= len(data):
            raise HpackError("integer truncated")
        b = data[off]
        off += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, off
        if shift > 63:
            raise HpackError("integer overflow")


def encode_string(s: bytes, huffman: bool = True) -> bytes:
    if huffman:
        enc = huffman_encode(s)
        if len(enc) < len(s):
            return encode_integer(len(enc), 7, 0x80) + enc
    return encode_integer(len(s), 7, 0x00) + s


def decode_string(data: bytes, off: int) -> tuple[bytes, int]:
    if off >= len(data):
        raise HpackError("string truncated")
    huff = bool(data[off] & 0x80)
    length, off = decode_integer(data, off, 7)
    raw = bytes(data[off : off + length])
    if len(raw) < length:
        raise HpackError("string truncated")
    off += length
    return (huffman_decode(raw) if huff else raw), off


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

STATIC_TABLE: List[Tuple[bytes, bytes]] = [
    (b":authority", b""),
    (b":method", b"GET"),
    (b":method", b"POST"),
    (b":path", b"/"),
    (b":path", b"/index.html"),
    (b":scheme", b"http"),
    (b":scheme", b"https"),
    (b":status", b"200"),
    (b":status", b"204"),
    (b":status", b"206"),
    (b":status", b"304"),
    (b":status", b"400"),
    (b":status", b"404"),
    (b":status", b"500"),
    (b"accept-charset", b""),
    (b"accept-encoding", b"gzip, deflate"),
    (b"accept-language", b""),
    (b"accept-ranges", b""),
    (b"accept", b""),
    (b"access-control-allow-origin", b""),
    (b"age", b""),
    (b"allow", b""),
    (b"authorization", b""),
    (b"cache-control", b""),
    (b"content-disposition", b""),
    (b"content-encoding", b""),
    (b"content-language", b""),
    (b"content-length", b""),
    (b"content-location", b""),
    (b"content-range", b""),
    (b"content-type", b""),
    (b"cookie", b""),
    (b"date", b""),
    (b"etag", b""),
    (b"expect", b""),
    (b"expires", b""),
    (b"from", b""),
    (b"host", b""),
    (b"if-match", b""),
    (b"if-modified-since", b""),
    (b"if-none-match", b""),
    (b"if-range", b""),
    (b"if-unmodified-since", b""),
    (b"last-modified", b""),
    (b"link", b""),
    (b"location", b""),
    (b"max-forwards", b""),
    (b"proxy-authenticate", b""),
    (b"proxy-authorization", b""),
    (b"range", b""),
    (b"referer", b""),
    (b"refresh", b""),
    (b"retry-after", b""),
    (b"server", b""),
    (b"set-cookie", b""),
    (b"strict-transport-security", b""),
    (b"transfer-encoding", b""),
    (b"user-agent", b""),
    (b"vary", b""),
    (b"via", b""),
    (b"www-authenticate", b""),
]

_STATIC_LOOKUP = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE):
    _STATIC_LOOKUP.setdefault((_n, _v), _i + 1)
    _STATIC_LOOKUP.setdefault(_n, _i + 1)


class _DynamicTable:
    def __init__(self, max_size: int = 4096):
        self.entries: list[tuple[bytes, bytes]] = []
        self.size = 0
        self.max_size = max_size

    @staticmethod
    def entry_size(name: bytes, value: bytes) -> int:
        return len(name) + len(value) + 32  # RFC 7541 §4.1

    def add(self, name: bytes, value: bytes) -> None:
        self.entries.insert(0, (name, value))
        self.size += self.entry_size(name, value)
        self._evict()

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        self._evict()

    def _evict(self) -> None:
        while self.size > self.max_size and self.entries:
            n, v = self.entries.pop()
            self.size -= self.entry_size(n, v)

    def get(self, index: int) -> tuple[bytes, bytes]:
        """1-based HPACK index across static + dynamic tables."""
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        di = index - len(STATIC_TABLE) - 1
        if 0 <= di < len(self.entries):
            return self.entries[di]
        raise HpackError(f"invalid index {index}")


class Decoder:
    """Stateful HPACK decoder — one per connection direction, exactly like
    the per-conn client/server decoders in data.go:93-103."""

    def __init__(self, max_table_size: int = 4096):
        self.table = _DynamicTable(max_table_size)

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        headers: list[tuple[str, str]] = []
        off = 0
        while off < len(block):
            b = block[off]
            if b & 0x80:  # indexed
                index, off = decode_integer(block, off, 7)
                name, value = self.table.get(index)
            elif b & 0x40:  # literal with incremental indexing
                index, off = decode_integer(block, off, 6)
                name = self.table.get(index)[0] if index else None
                if name is None:
                    name, off = decode_string(block, off)
                value, off = decode_string(block, off)
                self.table.add(name, value)
            elif b & 0x20:  # dynamic table size update
                size, off = decode_integer(block, off, 5)
                self.table.resize(size)
                continue
            else:  # literal without indexing / never indexed (0x00 / 0x10)
                index, off = decode_integer(block, off, 4)
                name = self.table.get(index)[0] if index else None
                if name is None:
                    name, off = decode_string(block, off)
                value, off = decode_string(block, off)
            headers.append((name.decode("latin-1"), value.decode("latin-1")))
        return headers


class Encoder:
    """Minimal encoder (static-table aware, literal-with-indexing) — used by
    the simulator/tests to fabricate gRPC HEADERS blocks."""

    def __init__(self, max_table_size: int = 4096, huffman: bool = True):
        self.table = _DynamicTable(max_table_size)
        self.huffman = huffman
        self._dyn_lookup: dict[tuple[bytes, bytes], int] = {}

    def encode(self, headers: list[tuple[str, str]]) -> bytes:
        out = bytearray()
        for name_s, value_s in headers:
            name = name_s.encode("latin-1")
            value = value_s.encode("latin-1")
            idx = _STATIC_LOOKUP.get((name, value))
            if isinstance(idx, int) and STATIC_TABLE[idx - 1][1] == value:
                out += encode_integer(idx, 7, 0x80)
                continue
            # dynamic full match
            for di, (n, v) in enumerate(self.table.entries):
                if n == name and v == value:
                    out += encode_integer(len(STATIC_TABLE) + 1 + di, 7, 0x80)
                    break
            else:
                name_idx = _STATIC_LOOKUP.get(name, 0)
                if isinstance(name_idx, int) and name_idx:
                    out += encode_integer(name_idx, 6, 0x40)
                else:
                    out += encode_integer(0, 6, 0x40)
                    out += encode_string(name, self.huffman)
                out += encode_string(value, self.huffman)
                self.table.add(name, value)
        return bytes(out)
