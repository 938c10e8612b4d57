"""Pure-Python decompressors for Kafka record batches.

The reference's codec table (aggregator/kafka/decompress.go) handles gzip,
snappy, lz4, and zstd via Go libraries. Python ships gzip; snappy and lz4
get small from-scratch decoders here (their *decompression* formats are
simple tag machines), so Kafka payloads decode without optional C
libraries. zstd is a full entropy coder (FSE + Huffman) — reimplementing
it buys nothing, so it binds the system ``libzstd`` via ctypes
(``zstd_decompress`` below), with the optional ``zstandard`` wheel (which
bundles its own libzstd) as fallback. The reference decodes zstd
unconditionally
(decompress.go:87); here every mainstream base image ships libzstd, so
the decode path works in a bare environment too — only an image with
neither library logs a loud per-process warning instead of silently
yielding nothing.

Formats:
- snappy raw block (https://github.com/google/snappy/blob/main/format_description.txt):
  uncompressed-length varint, then literal/copy tags.
- snappy xerial framing (what Kafka's Java client writes): 8-byte magic
  ``\\x82SNAPPY\\x00`` + version/compat ints, then length-prefixed raw blocks.
- lz4 block (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md):
  token-based literal/match sequences.
- lz4 frame: magic 0x184D2204 + descriptor + length-prefixed blocks
  (optionally uncompressed, high bit of the size).
"""

from __future__ import annotations

import struct


class CorruptData(Exception):
    pass


# ---------------------------------------------------------------------------
# snappy
# ---------------------------------------------------------------------------

_XERIAL_MAGIC = b"\x82SNAPPY\x00"


def snappy_decompress_raw(data: bytes) -> bytes:
    """Raw snappy block format."""
    # preamble: uncompressed length as little-endian varint
    n = 0
    shift = 0
    pos = 0
    while True:
        if pos >= len(data):
            raise CorruptData("truncated length varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
        if shift > 32:
            raise CorruptData("length varint too long")

    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        elem_type = tag & 0x03
        if elem_type == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > len(data):
                    raise CorruptData("truncated literal length")
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if pos + length > len(data):
                raise CorruptData("truncated literal")
            out += data[pos : pos + length]
            pos += length
        else:
            if elem_type == 1:  # copy, 1-byte offset
                length = ((tag >> 2) & 0x07) + 4
                if pos >= len(data):
                    raise CorruptData("truncated copy1")
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif elem_type == 2:  # copy, 2-byte offset
                length = (tag >> 2) + 1
                if pos + 2 > len(data):
                    raise CorruptData("truncated copy2")
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:  # copy, 4-byte offset
                length = (tag >> 2) + 1
                if pos + 4 > len(data):
                    raise CorruptData("truncated copy4")
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise CorruptData("bad copy offset")
            # overlapping copies are the point: copy byte-by-byte semantics
            start = len(out) - offset
            for i in range(length):
                out.append(out[start + i])
    if len(out) != n:
        raise CorruptData(f"length mismatch: {len(out)} != {n}")
    return bytes(out)


def snappy_decompress(data: bytes) -> bytes:
    """Snappy with Kafka's xerial framing auto-detected."""
    if data[:8] == _XERIAL_MAGIC:
        pos = 16  # magic + version + compat
        out = bytearray()
        while pos + 4 <= len(data):
            (block_len,) = struct.unpack_from(">I", data, pos)
            pos += 4
            out += snappy_decompress_raw(data[pos : pos + block_len])
            pos += block_len
        return bytes(out)
    return snappy_decompress_raw(data)


# ---------------------------------------------------------------------------
# lz4
# ---------------------------------------------------------------------------

_LZ4_FRAME_MAGIC = 0x184D2204


def lz4_block_decompress(data: bytes) -> bytes:
    """LZ4 block format (token machine)."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        token = data[pos]
        pos += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if pos >= n:
                    raise CorruptData("truncated literal length")
                b = data[pos]
                pos += 1
                lit_len += b
                if b != 255:
                    break
        if pos + lit_len > n:
            raise CorruptData("truncated literals")
        out += data[pos : pos + lit_len]
        pos += lit_len
        if pos >= n:
            break  # last sequence has no match
        if pos + 2 > n:
            raise CorruptData("truncated offset")
        offset = int.from_bytes(data[pos : pos + 2], "little")
        pos += 2
        if offset == 0 or offset > len(out):
            raise CorruptData("bad match offset")
        match_len = (token & 0x0F) + 4
        if (token & 0x0F) == 15:
            while True:
                if pos >= n:
                    raise CorruptData("truncated match length")
                b = data[pos]
                pos += 1
                match_len += b
                if b != 255:
                    break
        start = len(out) - offset
        for i in range(match_len):
            out.append(out[start + i])
    return bytes(out)


# ---------------------------------------------------------------------------
# zstd — ctypes binding to the system libzstd (streaming API, so frames
# without a content-size header decode too)
# ---------------------------------------------------------------------------

_zstd_lib = None
_zstd_lib_tried = False
_ZstdBuf = None  # ZSTD_inBuffer/ZSTD_outBuffer layout (identical structs)


def _load_libzstd():
    global _zstd_lib, _zstd_lib_tried, _ZstdBuf
    if _zstd_lib_tried:
        return _zstd_lib
    _zstd_lib_tried = True
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    ct = ctypes

    class _Buf(ct.Structure):
        _fields_ = [
            ("ptr", ct.c_void_p),
            ("size", ct.c_size_t),
            ("pos", ct.c_size_t),
        ]

    lib.ZSTD_createDStream.restype = ct.c_void_p
    lib.ZSTD_freeDStream.argtypes = [ct.c_void_p]
    lib.ZSTD_isError.argtypes = [ct.c_size_t]
    lib.ZSTD_isError.restype = ct.c_uint
    lib.ZSTD_DStreamOutSize.restype = ct.c_size_t
    lib.ZSTD_decompressStream.argtypes = [
        ct.c_void_p, ct.POINTER(_Buf), ct.POINTER(_Buf)
    ]
    lib.ZSTD_decompressStream.restype = ct.c_size_t
    _ZstdBuf = _Buf
    _zstd_lib = lib
    return lib


def zstd_decompress_ctypes(data: bytes, max_out: int = 1 << 30) -> bytes:
    """Decompress one or more zstd frames via libzstd's streaming API
    (ZSTD_decompressStream), bounded at ``max_out`` as a zip-bomb guard."""
    import ctypes as ct

    lib = _load_libzstd()
    if lib is None:
        raise CorruptData("libzstd unavailable")
    _Buf = _ZstdBuf

    ds = lib.ZSTD_createDStream()
    if not ds:
        raise CorruptData("ZSTD_createDStream failed")
    try:
        src = ct.create_string_buffer(data, len(data))
        inbuf = _Buf(ct.cast(src, ct.c_void_p), len(data), 0)
        chunk = int(lib.ZSTD_DStreamOutSize())
        out = bytearray()
        dst = ct.create_string_buffer(chunk)
        ret = 0
        while inbuf.pos < inbuf.size:
            outbuf = _Buf(ct.cast(dst, ct.c_void_p), chunk, 0)
            ret = lib.ZSTD_decompressStream(
                ds, ct.byref(outbuf), ct.byref(inbuf)
            )
            if lib.ZSTD_isError(ret):
                raise CorruptData("zstd: corrupt frame")
            out += dst.raw[: outbuf.pos]
            if len(out) > max_out:
                raise CorruptData("zstd: output exceeds bound")
        if ret != 0:
            # input exhausted mid-frame (ret is the bytes-still-needed
            # hint): partial output must NOT pass as a decoded batch
            raise CorruptData("zstd: truncated frame")
        return bytes(out)
    finally:
        lib.ZSTD_freeDStream(ds)


_zstd_warned = False


def _zstd_decompress_wheel(zstandard, data: bytes, max_out: int) -> bytes:
    """Wheel-path decode matching the ctypes contract. Input is fed in
    small chunks so the bomb bound is checked *during* expansion (a
    single decompress(whole_buffer) call would materialize the full
    output before any check could run); decompressobj handles frames
    with no content-size header, dobj.eof distinguishes a finished
    frame from truncation, unused_data chains concatenated frames."""
    chunk_sz = 4096
    out = bytearray()
    buf = data
    while buf:
        dobj = zstandard.ZstdDecompressor().decompressobj()
        pos = 0
        while pos < len(buf) and not dobj.eof:
            step = buf[pos : pos + chunk_sz]
            pos += len(step)
            try:
                out += dobj.decompress(step)
            except zstandard.ZstdError as exc:
                raise CorruptData(f"zstd: {exc}") from exc
            if len(out) > max_out:
                raise CorruptData("zstd: output exceeds bound")
        if not dobj.eof:
            raise CorruptData("zstd: truncated frame")
        buf = dobj.unused_data + buf[pos:]
    return bytes(out)


def zstd_decompress(data: bytes, max_out: int = 1 << 30) -> bytes:
    """zstd via the system libzstd (ctypes), falling back to the
    optional ``zstandard`` wheel (which bundles its own libzstd) where
    the system library is absent. Both backends share one contract: all
    concatenated frames decode, truncation raises, output is bounded at
    ``max_out``. Raises CorruptData on bad data; logs once and raises
    if no backend exists at all (the reference decodes zstd
    unconditionally, decompress.go:87 — silence here would drop every
    batch invisibly)."""
    if _load_libzstd() is not None:
        return zstd_decompress_ctypes(data, max_out=max_out)
    try:
        import zstandard  # type: ignore
    except ImportError:
        pass
    else:
        return _zstd_decompress_wheel(zstandard, data, max_out)
    global _zstd_warned
    if not _zstd_warned:
        _zstd_warned = True
        from alaz_tpu_torch.logging import get_logger

        get_logger("protocols.compression").warning(
            "zstd-compressed Kafka batch but neither the zstandard module "
            "nor libzstd is installed — batches will be dropped"
        )
    raise CorruptData("no zstd backend available")


def lz4_frame_decompress(data: bytes) -> bytes:
    """LZ4 frame format (the container Kafka writes)."""
    if len(data) < 7 or struct.unpack_from("<I", data, 0)[0] != _LZ4_FRAME_MAGIC:
        # not a frame: treat as a bare block
        return lz4_block_decompress(data)
    flg = data[4]
    pos = 6  # magic + FLG + BD
    if flg & 0x08:  # content size present
        pos += 8
    if flg & 0x01:  # dict id
        pos += 4
    pos += 1  # header checksum
    content_checksum = bool(flg & 0x04)
    block_checksum = bool(flg & 0x10)
    out = bytearray()
    while pos + 4 <= len(data):
        (block_size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if block_size == 0:  # EndMark
            break
        uncompressed = bool(block_size & 0x80000000)
        block_size &= 0x7FFFFFFF
        block = data[pos : pos + block_size]
        pos += block_size
        if block_checksum:
            pos += 4
        out += block if uncompressed else lz4_block_decompress(block)
    if content_checksum:
        pos += 4
    return bytes(out)
