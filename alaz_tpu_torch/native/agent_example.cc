// Minimal out-of-process agent: ships pre-attributed AlzRecord edges to
// the service's ingest socket using the frame protocol documented in
// sources/ingest_server.py (16-byte header + packed records, one writev
// per batch, zero serialization). This is the reference integration for
// native capture agents — anything that can fill AlzRecord structs can
// feed the framework.
//
// Usage: agent_example <unix-socket-path> [n_records] [window_ms0]
// Built by `make agent` (not part of the default target).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/socket.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <unistd.h>
#include <vector>

// Source-stamp marker (the Makefile passes -DALZ_BIN_STAMP with the
// sha256 prefix of agent_example.cc): executables can't be dlopen'd for
// an alz_source_hash() call, so the alazspec staleness guard byte-scans
// the binary for this marker instead (ROADMAP ALZ020 follow-up).
#ifndef ALZ_BIN_STAMP
#define ALZ_BIN_STAMP "unstamped"
#endif
__attribute__((used)) static const char kAlzSourceStamp[] =
    "ALZ_SOURCE_STAMP:" ALZ_BIN_STAMP;

struct AlzRecord {  // mirrors ingest.cc / NATIVE_RECORD_DTYPE (32 bytes)
  int64_t start_time_ms;
  uint64_t latency_ns;
  int32_t from_uid;
  int32_t to_uid;
  uint32_t status;
  uint8_t from_type;
  uint8_t to_type;
  uint8_t protocol;
  uint8_t flags;
};

struct FrameHeader {  // little-endian; matches ingest_server.FRAME_HEADER
  uint32_t magic;
  uint8_t kind;
  uint8_t tenant;  // fleet id (ISSUE 14); zero-init = the legacy tenant
  uint8_t pad[2];
  uint32_t count;
  uint32_t length;
};

static_assert(sizeof(AlzRecord) == 32, "wire record must be 32 bytes");
static_assert(sizeof(FrameHeader) == 16, "frame header must be 16 bytes");

constexpr uint32_t kMagic = 0x414C5A31;  // "ALZ1"
constexpr uint8_t kKindNative = 4;

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <socket-path> [n_records] [window_ms0]\n",
                 argv[0]);
    return 2;
  }
  const char* path = argv[1];
  unsigned long n_arg = argc > 2 ? std::strtoul(argv[2], nullptr, 10) : 1000;
  // header length is u32 bytes: cap so count * 32 cannot overflow it
  if (n_arg == 0 || n_arg > (UINT32_MAX / sizeof(AlzRecord))) {
    std::fprintf(stderr, "n_records out of range: %s\n", argv[2]);
    return 2;
  }
  uint32_t n = static_cast<uint32_t>(n_arg);
  int64_t t0 = argc > 3 ? std::atoll(argv[3]) : 1000;

  std::vector<AlzRecord> recs(n);
  uint32_t state = 42;
  for (uint32_t i = 0; i < n; ++i) {
    state = state * 1664525u + 1013904223u;
    AlzRecord& r = recs[i];
    std::memset(&r, 0, sizeof(r));
    r.start_time_ms = t0 + (i % 3) * 1000;  // three windows
    r.latency_ns = 1000 + (state & 0xFFFF);
    r.from_uid = static_cast<int32_t>(state % 20);
    r.to_uid = 100 + static_cast<int32_t>((state >> 8) % 8);
    r.status = (state & 31) == 0 ? 500 : 200;
    r.from_type = 1;  // pod
    r.to_type = 2;    // service
    r.protocol = 1 + state % 8;
    r.flags = state & 1;  // tls bit
  }

  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) {
    std::perror("socket");
    return 1;
  }
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, path, sizeof(addr.sun_path) - 1);
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    std::perror("connect");
    return 1;
  }

  FrameHeader hdr{};
  hdr.magic = kMagic;
  hdr.kind = kKindNative;
  hdr.count = n;
  hdr.length = n * sizeof(AlzRecord);
  iovec iov[2] = {
      {&hdr, sizeof(hdr)},
      {recs.data(), recs.size() * sizeof(AlzRecord)},
  };
  ssize_t want = static_cast<ssize_t>(sizeof(hdr) + hdr.length);
  ssize_t sent = writev(fd, iov, 2);
  while (sent >= 0 && sent < want) {  // short writes on large batches
    size_t off = static_cast<size_t>(sent);
    const uint8_t* base;
    size_t remaining;
    if (off < sizeof(hdr)) {
      base = reinterpret_cast<const uint8_t*>(&hdr) + off;
      remaining = sizeof(hdr) - off;
      ssize_t k = write(fd, base, remaining);
      if (k < 0) break;
      sent += k;
      continue;
    }
    off -= sizeof(hdr);
    base = reinterpret_cast<const uint8_t*>(recs.data()) + off;
    remaining = hdr.length - off;
    ssize_t k = write(fd, base, remaining);
    if (k < 0) break;
    sent += k;
  }
  close(fd);
  if (sent != want) {
    std::perror("write");
    return 1;
  }
  std::printf("sent %u records (%u bytes)\n", n, hdr.length);
  return 0;
}
