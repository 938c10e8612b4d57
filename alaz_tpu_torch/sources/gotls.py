"""Go-TLS uprobe target discovery — the collector.go:319-516 analog (G4).

Go binaries terminate ``crypto/tls.(*Conn).Read`` via multiple RET sites
and crash under uretprobes, so the reference parses the ELF, checks the
Go build info (register ABI needs >= go1.17), locates the
``crypto/tls.(*Conn).Write``/``Read`` symbols, and disassembles the Read
body to attach an exit uprobe at every RET (ARCHITECTURE.md:93-97 of the
reference). This module reproduces that discovery pipeline: a pure-Python
ELF reader (symtab/dynsym + program headers for vaddr→file-offset), a
``.go.buildinfo`` version parser, and RET-offset extraction via objdump
(the binutils disassembler plays the golang.org/x/arch role). The output
is the attach plan an agent needs: enter offsets for Write/Read and one
exit offset per RET of Read.
"""

from __future__ import annotations

import re
import struct
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.gotls")

GO_WRITE_SYMBOL = "crypto/tls.(*Conn).Write"
GO_READ_SYMBOL = "crypto/tls.(*Conn).Read"
MAX_EXE_BYTES = 200 * 1024 * 1024  # collector.go guards >200MB executables

_BUILDINFO_MAGIC = b"\xff Go buildinf:"


@dataclass
class ElfSymbol:
    name: str
    vaddr: int
    size: int
    file_offset: int


@dataclass
class GoTlsPlan:
    """Everything an attach hook needs (collector.go:403-511)."""

    go_version: str
    write: ElfSymbol
    read: ElfSymbol
    read_ret_offsets: List[int] = field(default_factory=list)  # file offsets


class ElfError(Exception):
    pass


def _read_elf_symbols(data: bytes, wanted: set[str]) -> dict[str, ElfSymbol]:
    """Minimal ELF64 little-endian reader: section headers → symtab/dynsym
    entries whose names are in ``wanted``, with vaddr→file-offset resolved
    through PT_LOAD program headers."""
    if len(data) < 64 or data[:4] != b"\x7fELF":
        raise ElfError("not an ELF")
    if data[4] != 2 or data[5] != 1:
        raise ElfError("only ELF64 little-endian supported")
    (e_phoff, e_shoff) = struct.unpack_from("<QQ", data, 0x20)
    (e_phentsize, e_phnum, e_shentsize, e_shnum) = struct.unpack_from(
        "<HHHH", data, 0x36
    )

    # program headers: vaddr → file offset mapping via PT_LOAD
    loads: list[tuple[int, int, int]] = []  # (vaddr, filesz, offset)
    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        (p_type,) = struct.unpack_from("<I", data, off)
        if p_type != 1:  # PT_LOAD
            continue
        p_offset, p_vaddr, _p_paddr, p_filesz = struct.unpack_from(
            "<QQQQ", data, off + 8
        )
        loads.append((p_vaddr, p_filesz, p_offset))

    def to_offset(vaddr: int) -> int:
        for p_vaddr, p_filesz, p_offset in loads:
            if p_vaddr <= vaddr < p_vaddr + p_filesz:
                return vaddr - p_vaddr + p_offset
        raise ElfError(f"vaddr {vaddr:#x} not in any PT_LOAD")

    # section headers: find symtab/dynsym + their string tables
    sections = []
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        sh_name, sh_type = struct.unpack_from("<II", data, off)
        sh_offset, sh_size, sh_link = struct.unpack_from("<QQI", data, off + 0x18)
        sh_entsize = struct.unpack_from("<Q", data, off + 0x38)[0]
        sections.append((sh_type, sh_offset, sh_size, sh_link, sh_entsize))

    out: dict[str, ElfSymbol] = {}
    for sh_type, sh_offset, sh_size, sh_link, sh_entsize in sections:
        if sh_type not in (2, 11):  # SHT_SYMTAB, SHT_DYNSYM
            continue
        if sh_entsize == 0 or sh_link >= len(sections):
            continue
        _, str_off, str_size, _, _ = sections[sh_link]
        strtab = data[str_off : str_off + str_size]
        for off in range(sh_offset, sh_offset + sh_size, sh_entsize):
            st_name, _info, _other, _shndx, st_value, st_size = struct.unpack_from(
                "<IBBHQQ", data, off
            )
            end = strtab.find(b"\x00", st_name)
            name = strtab[st_name:end].decode("utf-8", "replace")
            if name in wanted and name not in out and st_value:
                try:
                    out[name] = ElfSymbol(
                        name=name,
                        vaddr=st_value,
                        size=st_size,
                        file_offset=to_offset(st_value),
                    )
                except ElfError:
                    continue
    return out


def go_build_version(source: bytes | str | Path) -> Optional[str]:
    """Parse the Go buildinfo blob (the debug/buildinfo check,
    collector.go:362-401): scan for the magic, then read the version
    string — inline (flags bit 1, go >= 1.18) or via the pointer pair
    (older layouts return None here; the reference also only needs the
    'is this modern Go' answer). ``source`` may be pre-read bytes so the
    caller reads the (possibly 200MB) binary once."""
    data = source if isinstance(source, bytes) else Path(source).read_bytes()
    idx = data.find(_BUILDINFO_MAGIC)
    if idx < 0 or idx + 33 > len(data):
        return None
    flags = data[idx + 15]
    if flags & 0x2:  # inline varint-prefixed strings
        p = idx + 32
        n = 0
        shift = 0
        while p < len(data):
            b = data[p]
            p += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        if p + n <= len(data):
            return data[p : p + n].decode("utf-8", "replace")
    return None


def go_version_at_least(version: str, major: int, minor: int) -> bool:
    m = re.match(r"go(\d+)\.(\d+)", version or "")
    if not m:
        return False
    return (int(m.group(1)), int(m.group(2))) >= (major, minor)


# Match the disassembly line of any return instruction. The byte column
# may carry prefixes before the final c3 ("f3 c3  repz ret" from some
# toolchains/cgo objects, "f2 c3  bnd ret" with CET) and the mnemonic
# varies (ret/retq/repz ret); arm64 objdump prints one 8-hex word
# ("d65f03c0  ret"). Keying on the mnemonic containing a ret token —
# not on a lone "c3 ret" — keeps exit uprobes on every encoding.
_RET_LINE = re.compile(
    r"^\s*([0-9a-f]+):\s+(?:[0-9a-f]{2}\s+)*(?:[0-9a-f]{8}\s+)?"
    r"(?:(?:repz?|bnd)\s+)?retq?\b",
    re.IGNORECASE,
)


def find_ret_offsets(
    path: str | Path, sym: ElfSymbol, objdump: str = "objdump"
) -> List[int]:
    """Disassemble ``sym``'s body and return the FILE offset of every RET
    (collector.go:457-511 attaches an exit uprobe at each; uretprobes
    crash Go because they rewrite the stack the goroutine scheduler
    walks). binutils objdump is the disassembler; a plain 0xC3 byte scan
    would false-positive inside immediates/displacements."""
    if sym.size <= 0:
        return []
    try:
        proc = subprocess.run(
            [
                objdump,
                "-d",
                "--start-address", hex(sym.vaddr),
                "--stop-address", hex(sym.vaddr + sym.size),
                str(path),
            ],
            capture_output=True,
            text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        log.warning(f"objdump failed for {path}: {exc}")
        return []
    if proc.returncode != 0:
        return []
    out: List[int] = []
    delta = sym.file_offset - sym.vaddr  # vaddr → file offset shift
    for line in proc.stdout.splitlines():
        m = _RET_LINE.match(line)
        if m:
            out.append(int(m.group(1), 16) + delta)
    return out


def discover_go_tls(exe_path: str | Path) -> Optional[GoTlsPlan]:
    """Full discovery pipeline for one executable: modern-Go check, both
    symbols resolved, Read's RET sites disassembled. None when the binary
    is not an eligible Go TLS user."""
    path = Path(exe_path)
    try:
        if path.stat().st_size > MAX_EXE_BYTES:
            return None
        data = path.read_bytes()  # one read shared by both parsers
        version = go_build_version(data)
        if version is None or not go_version_at_least(version, 1, 17):
            return None
        syms = _read_elf_symbols(data, {GO_WRITE_SYMBOL, GO_READ_SYMBOL})
    except (OSError, ElfError):
        return None
    write = syms.get(GO_WRITE_SYMBOL)
    read = syms.get(GO_READ_SYMBOL)
    if write is None or read is None:
        return None
    return GoTlsPlan(
        go_version=version,
        write=write,
        read=read,
        read_ret_offsets=find_ret_offsets(path, read),
    )
