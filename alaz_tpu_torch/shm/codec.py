"""Wire framing for the shm rings (ISSUE 15).

Three payload families cross the fork boundary:

- **event batches** — L7/TCP/PROC wire dtypes byte-for-byte
  (``events/schema.py``; alazspec already pins those layouts), one
  record per shard slice. No new serialization: the wire dtype IS the
  contract, same as the socket frames.
- **control** — close waves / seals as two ``<q`` words; k8s resource
  messages pickled (control plane, never row-counted).
- **window results** — the worker's per-window ``EdgePartial`` keyed by
  its LOCAL interner ids, plus the **interner delta**: the string table
  rows the worker interned since its previous ship. The parent folds
  the delta into the shared Interner and remaps uids before
  ``build_from_partials`` — the id-exchange that replaces PR 5's shared
  lock-striped interner with zero cross-process locking.

The window frame layout (header, delta framing, column order) is pinned
in ``resources/specs/wire_layouts.json`` ``shm_ring`` — both sides of
the spawn boundary import THIS module, and alazspec anchors any drift.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from alaz_tpu_torch.graph.builder import EdgePartial

# window-frame header: window id, raw request rows folded into the
# partial, group count, label flag, interner-delta [base, base+count),
# and the span-plane stamps (CLOCK_MONOTONIC — comparable across
# processes on the deployment target): first-row seen, close start,
# close duration.
WIN_HEADER = struct.Struct("<qQIIIIddd")
ACK_FRAME = struct.Struct("<qq")  # (wave, upto; W_FLOOR-1 = None)
SEAL_FRAME = struct.Struct("<q")
CLOSE_FRAME = struct.Struct("<qq")  # (wave, upto)

UPTO_NONE = -(2**62) - 1  # distinct from W_FLOOR ("close everything")

# EdgePartial column order + dtypes — the serialization contract
# (alazspec `shm_ring.window_columns`). label_sum rides only when
# has_label is set.
PARTIAL_COLUMNS: Tuple[Tuple[str, str], ...] = (
    ("from_uid", "<i4"),
    ("to_uid", "<i4"),
    ("from_type", "|u1"),
    ("to_type", "|u1"),
    ("proto", "<i4"),
    ("count", "<f8"),
    ("lat_sum", "<f8"),
    ("lat_max", "<f8"),
    ("err5_sum", "<f8"),
    ("err4_sum", "<f8"),
    ("tls_sum", "<f8"),
)
LABEL_COLUMN = ("label_sum", "<f8")


def win_header_layout_string() -> str:
    return (
        f"ShmWinHeader:{WIN_HEADER.size};window:0:8;rows:8:8;n_groups:16:4;"
        "has_label:20:4;delta_base:24:4;delta_count:28:4;first_row_t:32:8;"
        "close_start_t:40:8;close_dur_s:48:8"
    )


def encode_window(
    window: int,
    partial: EdgePartial,
    delta_base: int,
    delta_strings: List[str],
    first_row_t: float,
    close_start_t: float,
    close_dur_s: float,
) -> bytes:
    """One closed window → bytes: header, delta table (u32 lengths +
    utf-8 blob), then the partial's columns in PARTIAL_COLUMNS order."""
    blobs = [s.encode("utf-8") for s in delta_strings]
    has_label = partial.label_sum is not None
    parts = [
        WIN_HEADER.pack(
            int(window),
            int(partial.rows),
            int(partial.from_uid.shape[0]),
            1 if has_label else 0,
            int(delta_base),
            len(blobs),
            float(first_row_t),
            float(close_start_t),
            float(close_dur_s),
        ),
        np.asarray([len(b) for b in blobs], dtype=np.uint32).tobytes(),
    ]
    parts.extend(blobs)
    cols = list(PARTIAL_COLUMNS) + ([LABEL_COLUMN] if has_label else [])
    for name, dt in cols:
        parts.append(
            np.ascontiguousarray(getattr(partial, name), dtype=np.dtype(dt))
            .tobytes()
        )
    return b"".join(parts)


def decode_window(payload) -> Tuple[int, EdgePartial, int, List[str], float, float, float]:
    """Inverse of :func:`encode_window`:
    (window, partial-with-LOCAL-uids, delta_base, delta_strings,
    first_row_t, close_start_t, close_dur_s)."""
    (
        window, rows, n_groups, has_label, delta_base, delta_count,
        first_row_t, close_start_t, close_dur_s,
    ) = WIN_HEADER.unpack_from(payload, 0)
    off = WIN_HEADER.size
    lens = np.frombuffer(payload, dtype=np.uint32, count=delta_count, offset=off)
    off += 4 * delta_count
    strings: List[str] = []
    for n in lens.tolist():
        strings.append(bytes(payload[off : off + n]).decode("utf-8"))
        off += n
    cols = {}
    spec = list(PARTIAL_COLUMNS) + ([LABEL_COLUMN] if has_label else [])
    for name, dt in spec:
        dtype = np.dtype(dt)
        arr = np.frombuffer(payload, dtype=dtype, count=n_groups, offset=off)
        off += dtype.itemsize * n_groups
        cols[name] = arr.copy()  # writable: the parent remaps uids in place
    partial = EdgePartial(
        from_uid=cols["from_uid"],
        to_uid=cols["to_uid"],
        from_type=cols["from_type"],
        to_type=cols["to_type"],
        proto=cols["proto"],
        count=cols["count"],
        lat_sum=cols["lat_sum"],
        lat_max=cols["lat_max"],
        err5_sum=cols["err5_sum"],
        err4_sum=cols["err4_sum"],
        tls_sum=cols["tls_sum"],
        label_sum=cols.get("label_sum"),
        rows=int(rows),
    )
    return (
        int(window), partial, int(delta_base), strings,
        float(first_row_t), float(close_start_t), float(close_dur_s),
    )


def encode_events(events: np.ndarray):
    """Wire-dtype rows → a byte view (the dtype layouts alazspec already
    pins are the serialization). Zero-copy when the slice is already
    contiguous: the ring write is the ONE copy — a ``tobytes`` here
    would pay a second full-row-width pass on the scatter thread."""
    arr = np.ascontiguousarray(events)
    try:
        return memoryview(arr).cast("B")
    except (TypeError, ValueError):  # exotic dtype without PEP-3118 view
        return arr.tobytes()


def decode_events(payload, dtype: np.dtype) -> np.ndarray:
    """Byte buffer → a WRITABLE wire-dtype array. When the ring already
    handed us a fresh writable uint8 array (its one mandatory copy-out),
    this is a zero-copy reinterpret; a bytes payload (tests, exotic
    paths) pays the copy here instead."""
    arr = np.frombuffer(payload, dtype=dtype)
    if isinstance(payload, np.ndarray) and payload.flags.writeable:
        return arr
    return arr.copy()


def encode_close(wave: int, upto: Optional[int]) -> bytes:
    return CLOSE_FRAME.pack(int(wave), UPTO_NONE if upto is None else int(upto))


def decode_close(payload: bytes) -> Tuple[int, Optional[int]]:
    wave, upto = CLOSE_FRAME.unpack_from(payload, 0)
    return int(wave), (None if upto == UPTO_NONE else int(upto))
