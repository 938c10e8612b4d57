// Host ingest plane: lock-free ring buffer + windowed edge accumulator.
//
// This is the native core of the graph batcher (SURVEY §2.1 "TPU-native
// equivalents": the C++ analog of the reference's kernel-side event plane,
// playing the role l7.c's maps play — bounded, drop-not-block, fixed-size
// records). Producers push resolved edge records into a SPSC ring; the
// consumer drains into per-window accumulators keyed
// (from_uid, to_uid, protocol); closed windows export COO arrays +
// per-node tables directly into caller-provided (numpy) buffers.
//
// Window semantics mirror WindowedGraphStore (graph/builder.py): multiple
// windows may be open at once, a window becomes ready to close when the
// watermark (max window id seen) passes it, and rows for already-closed
// windows are dropped as late (the aggregator retry queue legitimately
// delivers old-window rows after new-window rows — reference requeue
// behavior /root/reference/aggregator/data.go:404-437).
//
// Build: make -C alaz_tpu/native   → libalaz_ingest.so (ctypes-loaded by
// alaz_tpu/graph/native.py; the pure-numpy GraphBuilder is the fallback).
// `make tsan` additionally builds a -fsanitize=thread test binary.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

// Stamped by the Makefile with the sha256 prefix of this source file so
// alazspec (tools/alazspec) can flag a .so built from a different
// ingest.cc than the one checked in (the classic "stale kernel object"
// failure mode of the reference's bpf2go artifacts).
#ifndef ALZ_SOURCE_HASH
#define ALZ_SOURCE_HASH "unstamped"
#endif

// Byte-scannable twin of alz_source_hash() for builds that cannot be
// dlopen'd from the checking process: the ASan/UBSan shared objects
// (loading them requires the sanitizer runtime preloaded), like
// tsan_test/agent_example before them, carry the marker in .rodata so
// check_binary_stamps can flag a stale sanitizer build without loading
// it. Executable builds that link this file (tsan_test) define
// ALZ_BIN_STAMP and emit their OWN marker covering every linked source;
// suppress this one there so the byte scan finds exactly one stamp.
#ifndef ALZ_BIN_STAMP
__attribute__((used)) static const char kAlzSourceStamp[] =
    "ALZ_SOURCE_STAMP:" ALZ_SOURCE_HASH;
#endif

extern "C" {

// Mirror of events/schema.py L7Protocol (the reference's
// BPF_L7_PROTOCOL_* constants, l7.go:19-28). The `protocol` byte of
// AlzRecord and the one-hot clamp in alz_close_window_feats are typed
// against THIS enum; alazspec diffs it value-for-value against the
// Python enum, so a protocol added on one side only fails tier-1
// instead of silently folding into a neighbor's one-hot slot.
enum AlzProtocol {
  ALZ_PROTO_UNKNOWN = 0,
  ALZ_PROTO_HTTP = 1,
  ALZ_PROTO_AMQP = 2,
  ALZ_PROTO_POSTGRES = 3,
  ALZ_PROTO_HTTP2 = 4,
  ALZ_PROTO_REDIS = 5,
  ALZ_PROTO_KAFKA = 6,
  ALZ_PROTO_MYSQL = 7,
  ALZ_PROTO_MONGO = 8,
};

// One-hot clamp bound for the feature pass below. Kept as a literal
// (not ALZ_PROTO_MONGO + 1) so a 10th protocol added to both enums but
// not here still fails tier-1: alazspec checks kProtoCount ==
// len(L7Protocol), which a named-member clamp could never catch.
constexpr uint32_t kProtoCount = 9;

// 32-byte wire record; mirrored by NATIVE_RECORD_DTYPE in graph/native.py.
// flags: bit0 = tls, bit1 = failed (request not completed)
struct AlzRecord {
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

struct EdgeSlot {
  int32_t from_uid;
  int32_t to_uid;
  uint8_t protocol;
  uint8_t _pad;
  int32_t src_slot;
  int32_t dst_slot;
  uint64_t count;
  uint64_t lat_sum;
  uint64_t lat_max;
  uint32_t err5;
  uint32_t err4;
  uint32_t tls_cnt;
};

struct NodeSlot {
  int32_t uid;
  int32_t slot;  // dense node index
  uint8_t type;
  uint8_t used;
};

// ---------------------------------------------------------------------------
// L7 engine wire mirrors (ISSUE 16). These are byte-for-byte images of the
// PACKED numpy dtypes the Python plane pins (events/schema.py
// L7_EVENT_DTYPE, datastore/dto.py REQUEST_DTYPE) — the same arrays the
// shm_ring ABI already carries between shard processes, so a shard worker
// can hand a ring-slot view straight to alz_process_l7 with zero per-row
// Python work. graph/native.py refuses the .so at load when the layout
// strings below disagree with dtype_layout() (the AlzRecord precedent).
// ---------------------------------------------------------------------------

#pragma pack(push, 1)

struct AlzL7Event {
  uint32_t pid;
  uint64_t fd;
  uint64_t write_time_ns;
  uint64_t duration_ns;
  uint8_t protocol;
  uint8_t method;
  uint8_t tls;
  uint8_t failed;
  uint32_t status;
  uint32_t payload_size;
  uint8_t payload_read_complete;
  uint32_t tid;
  uint32_t seq;
  int16_t kafka_api_version;
  uint32_t mysql_prep_stmt_id;
  uint32_t saddr;
  uint16_t sport;
  uint32_t daddr;
  uint16_t dport;
  uint64_t event_read_time_ns;
  uint8_t payload[256];
};
static_assert(sizeof(AlzL7Event) == 331, "L7_EVENT_DTYPE mirror drifted");

struct AlzRequest {
  int64_t start_time_ms;
  uint64_t latency_ns;
  uint32_t from_ip;
  uint8_t from_type;
  int32_t from_uid;
  uint16_t from_port;
  uint32_t to_ip;
  uint8_t to_type;
  int32_t to_uid;
  uint16_t to_port;
  uint8_t protocol;
  uint8_t tls;
  uint8_t completed;
  uint32_t status_code;
  int32_t fail_reason;
  uint8_t method;
  int32_t path;
};
static_assert(sizeof(AlzRequest) == 54, "REQUEST_DTYPE mirror drifted");

#pragma pack(pop)

}  // extern "C"

namespace {

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

class NodeTable {
 public:
  explicit NodeTable(uint32_t cap_pow2) : mask_(cap_pow2 - 1), slots_(cap_pow2) {}

  // uid -> dense slot (insert on miss); -1 when full
  int32_t get_or_add(int32_t uid, uint8_t type, std::vector<int32_t>* uids,
                     std::vector<uint8_t>* types) {
    uint64_t h = mix64(static_cast<uint64_t>(static_cast<uint32_t>(uid)));
    for (uint32_t probe = 0; probe <= mask_; ++probe) {
      NodeSlot& s = slots_[(h + probe) & mask_];
      if (!s.used) {
        s.used = 1;
        s.uid = uid;
        s.type = type;
        s.slot = static_cast<int32_t>(uids->size());
        uids->push_back(uid);
        types->push_back(type);
        return s.slot;
      }
      if (s.uid == uid) return s.slot;
    }
    return -1;
  }

 private:
  uint32_t mask_;
  std::vector<NodeSlot> slots_;
};

// One open window's edge accumulator: a dense append-only arena of
// EdgeSlots plus an open-addressing index (key -> arena position). The
// index rehashes as the arena grows, so straggler windows stay tiny while
// the hot window grows to full size; recycling keeps arena capacity.
class WindowAcc {
 public:
  WindowAcc() { reset_index(64); }

  void open(int64_t window_id) {
    window_id_ = window_id;
    edges_.clear();
    if (index_.size() > 64 && edges_.capacity() < index_.size() / 4) {
      reset_index(64);  // shrink index for a recycled straggler table
    } else {
      std::memset(index_.data(), 0, index_.size() * sizeof(IndexSlot));
    }
  }

  int64_t window_id() const { return window_id_; }
  const std::vector<EdgeSlot>& edges() const { return edges_; }

  // nullptr when the caller-imposed edge cap is reached
  EdgeSlot* get_or_add(int32_t fu, int32_t tu, uint8_t proto, uint32_t max_edges) {
    if (edges_.size() * 2 >= index_.size()) grow_index();
    uint64_t h = mix64((static_cast<uint64_t>(static_cast<uint32_t>(fu)) << 32) ^
                       (static_cast<uint64_t>(static_cast<uint32_t>(tu)) << 8) ^ proto);
    uint32_t mask = static_cast<uint32_t>(index_.size() - 1);
    for (uint32_t probe = 0; probe <= mask; ++probe) {
      IndexSlot& s = index_[(h + probe) & mask];
      if (!s.used) {
        if (edges_.size() >= max_edges) return nullptr;
        s.used = 1;
        s.from_uid = fu;
        s.to_uid = tu;
        s.protocol = proto;
        s.idx = static_cast<uint32_t>(edges_.size());
        edges_.push_back(EdgeSlot{});
        EdgeSlot& e = edges_.back();
        std::memset(&e, 0, sizeof(e));
        e.from_uid = fu;
        e.to_uid = tu;
        e.protocol = proto;
        return &e;
      }
      if (s.from_uid == fu && s.to_uid == tu && s.protocol == proto) {
        return &edges_[s.idx];
      }
    }
    return nullptr;
  }

 private:
  struct IndexSlot {
    int32_t from_uid;
    int32_t to_uid;
    uint32_t idx;
    uint8_t protocol;
    uint8_t used;
  };

  void reset_index(uint32_t cap) {
    index_.assign(cap, IndexSlot{});
  }

  void grow_index() {
    std::vector<IndexSlot> old = std::move(index_);
    reset_index(static_cast<uint32_t>(old.size() * 2));
    uint32_t mask = static_cast<uint32_t>(index_.size() - 1);
    for (const IndexSlot& s : old) {
      if (!s.used) continue;
      uint64_t h = mix64(
          (static_cast<uint64_t>(static_cast<uint32_t>(s.from_uid)) << 32) ^
          (static_cast<uint64_t>(static_cast<uint32_t>(s.to_uid)) << 8) ^ s.protocol);
      for (uint32_t probe = 0; probe <= mask; ++probe) {
        IndexSlot& d = index_[(h + probe) & mask];
        if (!d.used) {
          d = s;
          break;
        }
      }
    }
  }

  int64_t window_id_ = INT64_MIN;
  std::vector<EdgeSlot> edges_;
  std::vector<IndexSlot> index_;
};

constexpr int kMaxOpenWindows = 8;

struct Ingest {
  // SPSC ring
  std::vector<AlzRecord> ring;
  uint32_t ring_mask;
  std::atomic<uint64_t> head{0};  // producer writes
  std::atomic<uint64_t> tail{0};  // consumer reads
  std::atomic<uint64_t> ring_dropped{0};
  std::atomic<uint64_t> late_dropped{0};
  std::atomic<uint64_t> acc_dropped{0};  // node/edge table capacity drops

  // window state (consumer-side only)
  int64_t window_ms;
  int64_t watermark = INT64_MIN;    // max window id seen
  int64_t closed_upto = INT64_MIN;  // windows <= this are emitted, never reopened
  uint32_t max_edges;

  std::vector<WindowAcc*> open;  // open windows, unordered, <= kMaxOpenWindows
  std::vector<WindowAcc*> pool;  // recycled accumulators

  NodeTable nodes;
  // persistent node identity (slots stable across windows)
  std::vector<int32_t> node_uids;
  std::vector<uint8_t> node_types;

  // close_window_feats scratch (consumer-side; persistent so a steady
  // stream of windows allocates nothing)
  std::vector<uint32_t> dst_off;                       // node_count + 1
  // per-node stats interleaved: one 64-byte struct == one cache line
  // per node, so the histogram pass touches 2 lines per edge (src+dst)
  // instead of ~10 across 8 separate arrays. A/B at 110k nodes measured
  // NO difference (the 7 MB accumulator set is L3-resident either way);
  // the interleave is kept for the fleet-scale case where per-node
  // state outgrows L3 and the 8-line pattern would miss on every edge.
  struct alignas(64) NodeAcc {
    double out_cnt, in_cnt, out_err, in_err, out_lat, in_lat, out_deg,
        in_deg;
  };
  static_assert(sizeof(NodeAcc) == 64, "one cache line per node");
  std::vector<NodeAcc> nacc;                           // per-node stats

  // degree-cap scratch (close-path sampling, ISSUE 16): per-edge
  // priorities, a dst-grouped placement order and the survivor flags —
  // persistent like dst_off/nacc so capped closes allocate nothing steady
  // state.
  std::vector<uint64_t> eprio;
  std::vector<uint32_t> eorder;
  std::vector<uint8_t> ekeep;

  Ingest(int64_t wms, uint32_t ring_cap, uint32_t edge_cap, uint32_t node_cap)
      : ring(ring_cap), ring_mask(ring_cap - 1), window_ms(wms),
        max_edges(edge_cap), nodes(node_cap) {}

  ~Ingest() {
    for (WindowAcc* a : open) delete a;
    for (WindowAcc* a : pool) delete a;
  }

  WindowAcc* find_open(int64_t w) {
    for (WindowAcc* a : open) {
      if (a->window_id() == w) return a;
    }
    return nullptr;
  }

  WindowAcc* oldest_open() {
    WindowAcc* best = nullptr;
    for (WindowAcc* a : open) {
      if (best == nullptr || a->window_id() < best->window_id()) best = a;
    }
    return best;
  }

  WindowAcc* acquire(int64_t w) {
    WindowAcc* a;
    if (!pool.empty()) {
      a = pool.back();
      pool.pop_back();
    } else {
      a = new WindowAcc();
    }
    a->open(w);
    open.push_back(a);
    return a;
  }

  void release(WindowAcc* a) {
    for (size_t i = 0; i < open.size(); ++i) {
      if (open[i] == a) {
        open[i] = open.back();
        open.pop_back();
        break;
      }
    }
    pool.push_back(a);
  }
};

inline uint32_t next_pow2(uint32_t v) {
  uint32_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

void accumulate(Ingest* ig, WindowAcc* acc, const AlzRecord& r) {
  int32_t src = ig->nodes.get_or_add(r.from_uid, r.from_type, &ig->node_uids,
                                     &ig->node_types);
  int32_t dst = ig->nodes.get_or_add(r.to_uid, r.to_type, &ig->node_uids,
                                     &ig->node_types);
  if (src < 0 || dst < 0) {  // node table full: drop
    ig->acc_dropped.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  EdgeSlot* e = acc->get_or_add(r.from_uid, r.to_uid, r.protocol, ig->max_edges);
  if (e == nullptr) {  // edge cap reached: drop
    ig->acc_dropped.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  if (e->count == 0) {
    e->src_slot = src;
    e->dst_slot = dst;
  }
  e->count += 1;
  e->lat_sum += r.latency_ns;
  if (r.latency_ns > e->lat_max) e->lat_max = r.latency_ns;
  // err5 matches GraphBuilder: (status >= 500) | !completed — status 0 on a
  // completed request is a success for non-HTTP protocols
  if (r.status >= 500 || (r.flags & 0x2)) e->err5 += 1;
  else if (r.status >= 400) e->err4 += 1;
  if (r.flags & 0x1) e->tls_cnt += 1;
}

}  // namespace

extern "C" {

void* alz_create(int64_t window_ms, uint32_t ring_capacity, uint32_t max_edges,
                 uint32_t max_nodes) {
  return new Ingest(window_ms, next_pow2(ring_capacity), max_edges,
                    next_pow2(max_nodes * 2));
}

void alz_destroy(void* p) { delete static_cast<Ingest*>(p); }

// Producer side: push n records; returns how many were accepted (the rest
// are counted dropped — the l7.go:764-770 drop-not-block contract).
uint32_t alz_push(void* p, const AlzRecord* recs, uint32_t n) {
  Ingest* ig = static_cast<Ingest*>(p);
  uint64_t head = ig->head.load(std::memory_order_relaxed);
  uint64_t tail = ig->tail.load(std::memory_order_acquire);
  uint32_t space = static_cast<uint32_t>(ig->ring.size() - (head - tail));
  uint32_t take = n < space ? n : space;
  for (uint32_t i = 0; i < take; ++i) {
    ig->ring[(head + i) & ig->ring_mask] = recs[i];
  }
  ig->head.store(head + take, std::memory_order_release);
  if (take < n) ig->ring_dropped.fetch_add(n - take, std::memory_order_relaxed);
  return take;
}

// Backpressure drops (ring full) and lateness drops (row for an
// already-emitted window), exported separately so the service gauges do
// not conflate the two failure modes.
uint64_t alz_ring_dropped(void* p) {
  return static_cast<Ingest*>(p)->ring_dropped.load(std::memory_order_relaxed);
}

uint64_t alz_late_dropped(void* p) {
  return static_cast<Ingest*>(p)->late_dropped.load(std::memory_order_relaxed);
}

uint64_t alz_acc_dropped(void* p) {
  return static_cast<Ingest*>(p)->acc_dropped.load(std::memory_order_relaxed);
}

uint64_t alz_dropped(void* p) {  // combined, kept for callers wanting a total
  Ingest* ig = static_cast<Ingest*>(p);
  return ig->ring_dropped.load(std::memory_order_relaxed) +
         ig->late_dropped.load(std::memory_order_relaxed);
}

// Consumer side: drain the ring into per-window accumulators. Returns the
// oldest window id that is ready to close (watermark passed it, like the
// numpy store's `_close_upto(watermark - 1)`), or -2^62.. INT64_MIN when
// nothing is ready. May return ready windows on repeated calls with an
// empty ring — callers loop drain/close until INT64_MIN. If the open-window
// bound is hit, the oldest open window is force-signaled ready and the
// offending record stays in the ring for the next drain.
int64_t alz_drain(void* p) {
  Ingest* ig = static_cast<Ingest*>(p);
  uint64_t tail = ig->tail.load(std::memory_order_relaxed);
  uint64_t head = ig->head.load(std::memory_order_acquire);
  while (tail < head) {
    const AlzRecord& r = ig->ring[tail & ig->ring_mask];
    int64_t w = r.start_time_ms / ig->window_ms;
    if (w <= ig->closed_upto) {
      ig->late_dropped.fetch_add(1, std::memory_order_relaxed);
      ++tail;
      continue;
    }
    WindowAcc* acc = ig->find_open(w);
    if (acc == nullptr) {
      if (ig->open.size() >= kMaxOpenWindows) {
        // out of accumulators: force-close the oldest; record stays queued
        ig->tail.store(tail, std::memory_order_release);
        return ig->oldest_open()->window_id();
      }
      acc = ig->acquire(w);
    }
    accumulate(ig, acc, r);
    if (w > ig->watermark) ig->watermark = w;
    ++tail;
  }
  ig->tail.store(tail, std::memory_order_release);
  WindowAcc* oldest = ig->oldest_open();
  if (oldest != nullptr && oldest->window_id() < ig->watermark) {
    return oldest->window_id();
  }
  return INT64_MIN;
}

// Oldest open window id (the one alz_close_window would close), or
// INT64_MIN when no window is open.
int64_t alz_current_window(void* p) {
  Ingest* ig = static_cast<Ingest*>(p);
  WindowAcc* oldest = ig->oldest_open();
  return oldest == nullptr ? INT64_MIN : oldest->window_id();
}

uint32_t alz_node_count(void* p) {
  return static_cast<uint32_t>(static_cast<Ingest*>(p)->node_uids.size());
}

// Close the oldest open window: export aggregated edges into caller
// buffers (each sized >= max_edges) and mark it emitted. Returns the edge
// count, -1 if buffers are too small, -2 if no window is open. Node tables
// persist across windows; fetch them with alz_export_nodes.
int32_t alz_close_window(void* p, uint32_t buf_cap, int64_t* window_start_ms,
                         int32_t* src, int32_t* dst, uint8_t* protocol,
                         uint64_t* count, uint64_t* lat_sum, uint64_t* lat_max,
                         uint32_t* err5, uint32_t* err4, uint32_t* tls_cnt) {
  Ingest* ig = static_cast<Ingest*>(p);
  WindowAcc* acc = ig->oldest_open();
  if (acc == nullptr) return -2;
  const std::vector<EdgeSlot>& edges = acc->edges();
  if (edges.size() > buf_cap) return -1;
  *window_start_ms = acc->window_id() * ig->window_ms;
  int32_t n = 0;
  for (const EdgeSlot& e : edges) {
    src[n] = e.src_slot;
    dst[n] = e.dst_slot;
    protocol[n] = e.protocol;
    count[n] = e.count;
    lat_sum[n] = e.lat_sum;
    lat_max[n] = e.lat_max;
    err5[n] = e.err5;
    err4[n] = e.err4;
    tls_cnt[n] = e.tls_cnt;
    ++n;
  }
  if (acc->window_id() > ig->closed_upto) ig->closed_upto = acc->window_id();
  ig->release(acc);
  return n;
}

// Edge count of the oldest open window (what close_window would export),
// or -1 when no window is open — lets callers right-size padded buffers
// before the close call.
int64_t alz_current_edge_count(void* p) {
  Ingest* ig = static_cast<Ingest*>(p);
  WindowAcc* oldest = ig->oldest_open();
  return oldest == nullptr ? -1 : static_cast<int64_t>(oldest->edges().size());
}

// Feature-dim contract with graph/builder.py (EDGE_FEATURE_DIM /
// NODE_FEATURE_DIM); the Python binding asserts against these at load.
constexpr uint32_t kEdgeFeatDim = 16;
constexpr uint32_t kNodeFeatDim = 32;
uint32_t alz_edge_feat_dim(void) { return kEdgeFeatDim; }
uint32_t alz_node_feat_dim(void) { return kNodeFeatDim; }

// Close the oldest open window with on-core assembly: edges come out
// **dst-sorted** (counting sort over dense node slots — the layout the
// Pallas scatter kernel requires, snapshot.py:99-114) and both feature
// matrices are computed here in one pass, replacing the numpy
// bincount/log1p/argsort stage that dominated the host path (~120 ms per
// 256k-edge window → ~10 ms). Buffers: src/dst/etype/count sized e_cap;
// ef e_cap*16 floats; nf n_cap*32 floats. ef/nf rows must arrive
// zeroed — only nonzero slots are written (cols 7..15 one-hot, nf cols
// 0..11).
//
// degree_cap > 0 folds alz_sample_degree_cap into the close (ISSUE 16,
// carried ROADMAP item): every over-cap dst keeps the `cap` edges with
// the smallest sample_priorities(seed, window, dst-uid, src-uid, proto)
// — the SAME pure-function draw as graph/builder.py, so serial numpy
// builds and this path select identically. Node features keep the FULL
// pre-cap aggregate (the builder contract: a hot-key dst keeps its real
// in-degree signal); only edge emission is cut. sampled_out[0]/[1]
// report cut edges/rows for the ledger's sampled/degree_cap row.
// Returns the emitted (post-cap) edge count; -1 e_cap too small, -2 no
// open window, -3 n_cap smaller than the node table.
int32_t alz_close_window_feats(void* p, uint32_t e_cap, uint32_t n_cap,
                               int64_t* window_start_ms, float window_s,
                               uint32_t degree_cap, uint64_t sample_seed,
                               int32_t* src, int32_t* dst, int32_t* etype,
                               uint64_t* count, float* ef, float* nf,
                               int64_t* sampled_out) {
  Ingest* ig = static_cast<Ingest*>(p);
  WindowAcc* acc = ig->oldest_open();
  if (acc == nullptr) return -2;
  const std::vector<EdgeSlot>& edges = acc->edges();
  const uint32_t n = static_cast<uint32_t>(edges.size());
  const uint32_t n_nodes = static_cast<uint32_t>(ig->node_uids.size());
  if (n > e_cap) return -1;
  if (n_nodes > n_cap) return -3;
  *window_start_ms = acc->window_id() * ig->window_ms;
  sampled_out[0] = 0;
  sampled_out[1] = 0;

  ig->dst_off.assign(n_nodes + 1, 0);
  ig->nacc.assign(n_nodes, Ingest::NodeAcc{});
  Ingest::NodeAcc* nacc = ig->nacc.data();

  // pass 1: dst histogram + per-node accumulators (2 cache lines/edge).
  // Runs over ALL edges — node features see the pre-cap aggregate.
  uint32_t max_in_deg = 0;
  for (const EdgeSlot& e : edges) {
    const uint32_t deg = ++ig->dst_off[e.dst_slot + 1];
    if (deg > max_in_deg) max_in_deg = deg;
    const double c = static_cast<double>(e.count);
    Ingest::NodeAcc& s = nacc[e.src_slot];
    Ingest::NodeAcc& d = nacc[e.dst_slot];
    s.out_cnt += c;
    d.in_cnt += c;
    s.out_err += e.err5;
    d.in_err += e.err5;
    s.out_lat += static_cast<double>(e.lat_sum);
    d.in_lat += static_cast<double>(e.lat_sum);
    s.out_deg += 1.0;
    d.in_deg += 1.0;
  }
  for (uint32_t i = 0; i < n_nodes; ++i) ig->dst_off[i + 1] += ig->dst_off[i];

  // cap pass: bottom-k per over-cap dst by (priority, arena index). The
  // priority replicates graph/builder.py sample_priorities bit-for-bit:
  // base = mix64((seed << 32) ^ window_start_ms); per edge
  // mix64((u64(i64(dst_uid)) << 32) ^ u64(i64(src_uid)) ^ (proto << 56)
  // ^ base) — sign-extended uids, exactly the numpy int64→uint64 casts.
  uint32_t n_emit = n;
  const bool capped = degree_cap > 0 && max_in_deg > degree_cap;
  if (capped) {
    const uint64_t base =
        mix64((sample_seed << 32) ^ static_cast<uint64_t>(*window_start_ms));
    ig->eprio.resize(n);
    ig->eorder.resize(n);
    ig->ekeep.assign(n, 1);
    // dst-grouped placement (same counting sort as pass 2, on a copy of
    // the offsets) so each dst's edges are a contiguous slice of eorder
    std::vector<uint32_t> place(ig->dst_off.begin(), ig->dst_off.end() - 1);
    for (uint32_t i = 0; i < n; ++i) {
      const EdgeSlot& e = edges[i];
      uint64_t x =
          (static_cast<uint64_t>(static_cast<int64_t>(e.to_uid)) << 32) ^
          static_cast<uint64_t>(static_cast<int64_t>(e.from_uid)) ^
          (static_cast<uint64_t>(e.protocol) << 56);
      ig->eprio[i] = mix64(x ^ base);
      ig->eorder[place[e.dst_slot]++] = i;
    }
    const uint64_t* prio = ig->eprio.data();
    for (uint32_t g = 0; g < n_nodes; ++g) {
      // after the prefix sum, dst slot g's edges span
      // [dst_off[g], dst_off[g+1]) of the placement order
      const uint32_t g0 = ig->dst_off[g];
      const uint32_t g1 = ig->dst_off[g + 1];
      const uint32_t size = g1 - g0;
      if (size <= degree_cap) continue;
      uint32_t* beg = ig->eorder.data() + g0;
      uint32_t* end = ig->eorder.data() + g1;
      std::nth_element(beg, beg + degree_cap, end,
                       [prio](uint32_t a, uint32_t b) {
                         return prio[a] != prio[b] ? prio[a] < prio[b] : a < b;
                       });
      for (uint32_t* it = beg + degree_cap; it != end; ++it) {
        ig->ekeep[*it] = 0;
        sampled_out[0] += 1;
        sampled_out[1] += static_cast<int64_t>(edges[*it].count);
      }
    }
    n_emit = n - static_cast<uint32_t>(sampled_out[0]);
    // rebuild the dst histogram over the SURVIVORS for pass 2 placement
    ig->dst_off.assign(n_nodes + 1, 0);
    for (uint32_t i = 0; i < n; ++i) {
      if (ig->ekeep[i]) ig->dst_off[edges[i].dst_slot + 1] += 1;
    }
    for (uint32_t i = 0; i < n_nodes; ++i) ig->dst_off[i + 1] += ig->dst_off[i];
  }

  // pass 2: place each edge at its sorted position, features inline
  const double ws = window_s > 1e-6f ? static_cast<double>(window_s) : 1e-6;
  for (uint32_t i = 0; i < n; ++i) {
    const EdgeSlot& e = edges[i];
    if (capped && !ig->ekeep[i]) continue;
    const uint32_t pos = ig->dst_off[e.dst_slot]++;
    src[pos] = e.src_slot;
    dst[pos] = e.dst_slot;
    etype[pos] = e.protocol;
    count[pos] = e.count;
    float* f = ef + static_cast<size_t>(pos) * kEdgeFeatDim;
    const double c = static_cast<double>(e.count);
    const double cdiv = c > 1.0 ? c : 1.0;
    f[0] = static_cast<float>(std::log1p(c));
    f[1] = static_cast<float>(std::log1p(static_cast<double>(e.lat_sum) / cdiv) / 20.0);
    f[2] = static_cast<float>(std::log1p(static_cast<double>(e.lat_max)) / 20.0);
    f[3] = static_cast<float>(e.err5 / cdiv);
    f[4] = static_cast<float>(e.err4 / cdiv);
    f[5] = static_cast<float>(e.tls_cnt / cdiv);
    f[6] = static_cast<float>(std::log1p(c / ws));
    const uint32_t proto =
        e.protocol >= kProtoCount ? kProtoCount - 1 : e.protocol;
    f[7 + proto] = 1.0f;
  }

  // node features (cols 0..11; 12+ stay zero for k8s enrichment)
  for (uint32_t i = 0; i < n_nodes; ++i) {
    float* f = nf + static_cast<size_t>(i) * kNodeFeatDim;
    const uint8_t t = ig->node_types[i];
    if (t < 4) f[t] = 1.0f;
    const Ingest::NodeAcc& a = nacc[i];
    const double oc = a.out_cnt > 1.0 ? a.out_cnt : 1.0;
    const double ic = a.in_cnt > 1.0 ? a.in_cnt : 1.0;
    f[4] = static_cast<float>(std::log1p(a.out_cnt));
    f[5] = static_cast<float>(std::log1p(a.in_cnt));
    f[6] = static_cast<float>(a.out_err / oc);
    f[7] = static_cast<float>(a.in_err / ic);
    f[8] = static_cast<float>(std::log1p(a.out_lat / oc) / 20.0);
    f[9] = static_cast<float>(std::log1p(a.in_lat / ic) / 20.0);
    f[10] = static_cast<float>(std::log1p(a.out_deg));
    f[11] = static_cast<float>(std::log1p(a.in_deg));
  }

  if (acc->window_id() > ig->closed_upto) ig->closed_upto = acc->window_id();
  ig->release(acc);
  return static_cast<int32_t>(n_emit);
}

// ---------------------------------------------------------------------------
// Generic grouped reduction over packed int64 keys — the numpy builder's
// per-window argsort+reduceat grouping stage, moved on-core (ROADMAP
// "Ingest follow-ups"; graph/builder.py group_reduce routes here when the
// .so is loaded, with the numpy path kept as the fallback). STATELESS on
// purpose: no Ingest handle, no shared scratch — the sharded ingest
// pipeline calls it concurrently from every shard worker for the
// per-window partial aggregation AND from the merge stage for the
// per-edge-key recombine.
//
// Inputs: keys[n]; n_sum double columns to per-group SUM; n_max double
// columns to per-group MAX. Outputs (caller buffers, each sized out_cap
// >= the group count — n always suffices): ascending unique keys (the
// exact group order np.argsort produces), per-group row counts, a
// representative row index per group (first-seen), and the reduced
// columns. Sums are order-sensitive only for non-integer-valued doubles;
// every column the builder feeds is integer-valued, so results are
// bit-identical to the numpy reduceat path. Returns the group count, or
// -1 when out_cap is too small.
int64_t alz_group_edges(const int64_t* keys, uint64_t n,
                        const double* const* sum_cols, uint32_t n_sum,
                        const double* const* max_cols, uint32_t n_max,
                        uint64_t out_cap, int64_t* out_keys, double* out_count,
                        int64_t* out_rep, double* const* out_sums,
                        double* const* out_maxes) {
  if (n == 0) return 0;
  // group ids live in uint32 — refuse inputs past 2^31 rows (window
  // scale is orders of magnitude below; callers treat <0 as "use the
  // numpy fallback", so the bound degrades gracefully, never hangs)
  if (n > (1ull << 31)) return -1;
  // Pass 1: open-addressing probe assigns a dense group id per distinct
  // key and a per-row group index — O(n), no sort of the row stream.
  // Pass 2 ranks the E distinct keys ascending (E log E over groups
  // only) and accumulates every reduction straight into the caller's
  // output buffers through the rank remap. The working set is
  // E-proportional (the aggregated edge list), not n-proportional — the
  // reason this beats sorting the full row stream at service-map
  // compression ratios.
  uint64_t cap = 64;
  while (cap < 2 * n) cap <<= 1;
  const uint64_t mask = cap - 1;
  std::vector<uint32_t> index(cap, UINT32_MAX);
  std::vector<int64_t> gkeys;
  std::vector<int64_t> grep;
  gkeys.reserve(1024);
  grep.reserve(1024);
  std::vector<uint32_t> ginv(n);
  for (uint64_t i = 0; i < n; ++i) {
    const int64_t key = keys[i];
    uint64_t h = mix64(static_cast<uint64_t>(key));
    for (;; ++h) {
      uint32_t& slot = index[h & mask];
      if (slot == UINT32_MAX) {
        slot = static_cast<uint32_t>(gkeys.size());
        ginv[i] = slot;
        gkeys.push_back(key);
        grep.push_back(static_cast<int64_t>(i));
        break;
      }
      if (gkeys[slot] == key) {
        ginv[i] = slot;
        break;
      }
    }
  }
  const uint64_t n_groups = gkeys.size();
  if (n_groups > out_cap) return -1;

  // rank groups by ascending key — the group order the numpy path's
  // argsort produces, which is also the dst-major order the batcher needs
  std::vector<uint32_t> order(n_groups);
  for (uint32_t g = 0; g < n_groups; ++g) order[g] = g;
  std::sort(order.begin(), order.end(),
            [&gkeys](uint32_t x, uint32_t y) { return gkeys[x] < gkeys[y]; });
  std::vector<uint32_t> rank(n_groups);
  for (uint32_t o = 0; o < n_groups; ++o) {
    const uint32_t g = order[o];
    rank[g] = o;
    out_keys[o] = gkeys[g];
    out_rep[o] = grep[g];
    out_count[o] = 0.0;
  }
  for (uint32_t c = 0; c < n_sum; ++c)
    std::memset(out_sums[c], 0, n_groups * sizeof(double));

  // pass 2: accumulate into the ranked outputs (E-sized, cache-warm)
  for (uint64_t i = 0; i < n; ++i) {
    const uint32_t o = rank[ginv[i]];
    out_count[o] += 1.0;
    for (uint32_t c = 0; c < n_sum; ++c) out_sums[c][o] += sum_cols[c][i];
    for (uint32_t c = 0; c < n_max; ++c) {
      const double v = max_cols[c][i];
      double& m = out_maxes[c][o];
      if (out_count[o] == 1.0 || v > m) m = v;
    }
  }
  return static_cast<int64_t>(n_groups);
}

// ---------------------------------------------------------------------------
// Degree-capped neighbor sampling (ISSUE 7). Operates over the
// dst-grouped aggregated edge list the grouping stage emits (dst[] is
// dst-sorted — ascending dst-major group keys, alz_group_edges'
// contract): for every dst whose in-degree exceeds `cap`, keep the
// `cap` edges with the SMALLEST priority (bottom-k — the deterministic
// form of reservoir sampling: with hash-random priorities, bottom-k is
// a uniform sample, and the same (seed, window, dst-uid, src-uid) keys
// always draw the same sample, so N-worker merges and reruns select
// identically). Priorities are computed caller-side (one shared
// definition, graph/builder.py sample_priorities, mix64 over the uid
// pair) so the C++ path and the numpy fallback can never hash apart.
//
// STATELESS like alz_group_edges — the sharded merge calls it on the
// merge thread, parity tests call it concurrently. Selection ties
// break by ascending row index, matching numpy's stable lexsort, so
// both backends are bit-identical. Kept indices are written ascending
// (the dst-major order of the input survives the cut). Returns the
// kept count; -1 when out_cap is too small (never with out_cap == n),
// -2 on cap == 0 (unlimited is the CALLER's fast path, not a mode
// here).
int64_t alz_sample_degree_cap(const int32_t* dst, const uint64_t* prio,
                              int64_t n, uint32_t cap, int64_t* out_idx,
                              uint64_t out_cap) {
  if (cap == 0) return -2;
  int64_t kept = 0;
  std::vector<int64_t> heavy;  // per-group scratch, reused across groups
  int64_t g0 = 0;
  while (g0 < n) {
    const int32_t d = dst[g0];
    int64_t g1 = g0 + 1;
    while (g1 < n && dst[g1] == d) ++g1;
    const int64_t size = g1 - g0;
    if (size <= static_cast<int64_t>(cap)) {
      if (kept + size > static_cast<int64_t>(out_cap)) return -1;
      for (int64_t i = g0; i < g1; ++i) out_idx[kept++] = i;
    } else {
      heavy.resize(static_cast<size_t>(size));
      for (int64_t i = 0; i < size; ++i) heavy[static_cast<size_t>(i)] = g0 + i;
      // O(size) partial selection of the cap smallest (prio, idx) pairs
      std::nth_element(
          heavy.begin(), heavy.begin() + cap, heavy.end(),
          [prio](int64_t a, int64_t b) {
            return prio[a] != prio[b] ? prio[a] < prio[b] : a < b;
          });
      std::sort(heavy.begin(), heavy.begin() + cap);  // restore dst-major order
      if (kept + static_cast<int64_t>(cap) > static_cast<int64_t>(out_cap))
        return -1;
      for (uint32_t i = 0; i < cap; ++i) out_idx[kept++] = heavy[i];
    }
    g0 = g1;
  }
  return kept;
}

// ---------------------------------------------------------------------------
// Native batch L7 engine (ISSUE 16): the `_process_l7_inner` join +
// attribution + REQUEST-row emission body in one pass over the batch.
// STATELESS like alz_group_edges — every piece of mutable state stays
// Python-owned and arrives as arrays:
//
//  - the socket-line table comes in FLATTENED (per-line entry slices of
//    one concatenated arena, lines lexsorted by (pid, fd), offsets
//    sl_off[n_lines+1]) — a snapshot the binding caches and rebuilds only
//    when the store's revision counter moves;
//  - pod/service attribution tables are the _IpTable._compile() arrays
//    (sorted u32 ips / i32 uids — recompiles swap arrays, never mutate,
//    so handing them over without a lock is safe);
//  - emitted REQUEST rows land in `out` in ORIGINAL row order (the order
//    the numpy boolean-mask path preserves), with kept_idx/unmatched_idx
//    reporting ascending original indexes so the Python side can requeue
//    retry rows and keep DropLedger `filtered` accounting EXACT:
//    counts[0] = unmatched (no_socket/requeue), counts[1] = not_pod.
//
// The caller holds the GIL only to hand these blocks off — ctypes
// releases it for the call, so thread-mode shards overlap here too.
// Stateful corners stay Python (the backend's documented refusal
// surface): retry scheduling, outbound reverse-DNS interning, payload
// path enrichment, h2/kafka reassembly, proc/k8s folds, rate limiting.
// ---------------------------------------------------------------------------

// _IpTable.lookup for one ip: searchsorted(side=left), clip to size-1,
// exact-match test; uid 0 on miss (the np.where(found, uids, 0) contract)
static int32_t alz_ip_lookup_(const uint32_t* ips, const int32_t* uids,
                              int64_t n, uint32_t ip, bool* found) {
  if (n == 0) {
    *found = false;
    return 0;
  }
  int64_t idx = std::lower_bound(ips, ips + n, ip) - ips;
  if (idx >= n) idx = n - 1;
  *found = ips[idx] == ip;
  return *found ? uids[idx] : 0;
}

// Open-addressed exact-match mirror of alz_ip_lookup_ for the batch hot
// loop: the compiled tables are consulted 2-3x PER ROW, and a dependent-
// load binary search chain costs ~10 mispredict-prone probes per lookup
// where one L1-resident probe suffices. Built per call (the tables are
// snapshots that never mutate in place) when the batch is large enough
// to amortize the inserts — a pure access-path swap, the (found, uid)
// result for every ip is identical to the binary search by construction.
struct AlzIpHash {
  std::vector<uint32_t> key;
  std::vector<int32_t> uid;
  std::vector<uint8_t> used;
  uint32_t mask = 0;

  void build(const uint32_t* ips, const int32_t* uids, int64_t n) {
    uint32_t cap = 16;
    while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
    mask = cap - 1;
    key.assign(cap, 0);
    uid.assign(cap, 0);
    used.assign(cap, 0);
    for (int64_t i = 0; i < n; ++i) {
      uint32_t slot = (ips[i] * 0x9E3779B9u) & mask;
      while (used[slot]) slot = (slot + 1) & mask;  // keys are unique
      key[slot] = ips[i];
      uid[slot] = uids[i];
      used[slot] = 1;
    }
  }

  int32_t lookup(uint32_t ip, bool* found) const {
    uint32_t slot = (ip * 0x9E3779B9u) & mask;
    while (used[slot]) {
      if (key[slot] == ip) {
        *found = true;
        return uid[slot];
      }
      slot = (slot + 1) & mask;
    }
    *found = false;
    return 0;
  }
};

// SocketLine.get_values (sockline.py) case-for-case for ONE timestamp
// over flattened entries [a, b); uint64 subtractions wrap exactly like
// the numpy side's. Returns the selected LOCAL entry index, or -1.
static int64_t alz_sockline_pick_(const uint64_t* ts, const uint8_t* open_,
                                  const uint32_t* daddr, const uint16_t* dport,
                                  int64_t a, int64_t b, uint64_t t) {
  const int64_t nL = b - a;
  if (nL == 0) return -1;
  const uint64_t* base = ts + a;
  const int64_t idx = std::lower_bound(base, ts + b, t) - base;  // side="left"
  if (idx == nL) {  // after the last entry
    if (open_[b - 1]) return nL - 1;
    if (nL >= 2 && open_[b - 2] && (t - ts[b - 2]) < 60000000000ULL)
      return nL - 2;  // ONE_MINUTE_NS close-race tolerance
    return -1;
  }
  if (idx == 0) return open_[a] ? 0 : -1;  // before the first entry
  const int64_t prev = idx - 1;
  if (open_[a + prev]) return prev;
  // landed on a close: neighbor-agreement heuristic
  const int64_t cp = prev - 1;
  const int64_t ca = prev + 1;  // == idx, < nL in this branch
  if (cp < 0 || !open_[a + cp] || !open_[a + ca]) return -1;
  if (daddr[a + cp] != daddr[a + ca] || dport[a + cp] != dport[a + ca])
    return -1;
  return (t - ts[a + cp]) < (ts[a + ca] - t) ? cp : ca;
}

int64_t alz_process_l7(const AlzL7Event* ev, int64_t n, uint64_t now_ns,
                       const uint32_t* sl_pid, const uint64_t* sl_fd,
                       const int64_t* sl_off, int64_t n_lines,
                       const uint64_t* sl_ts, const uint8_t* sl_open,
                       const uint32_t* sl_saddr, const uint16_t* sl_sport,
                       const uint32_t* sl_daddr, const uint16_t* sl_dport,
                       uint8_t* sl_touched, const uint32_t* pod_ips,
                       const int32_t* pod_uids, int64_t n_pod,
                       const uint32_t* svc_ips, const int32_t* svc_uids,
                       int64_t n_svc, AlzRequest* out, int64_t* kept_idx,
                       int64_t* unmatched_idx, int64_t* counts) {
  (void)now_ns;  // _last_match writeback happens Python-side via sl_touched
  counts[0] = 0;
  counts[1] = 0;
  if (n <= 0) return 0;

  // -- phase 1: V1 socket-line join for rows without embedded addresses.
  // `matched` exists only when the batch HAS V1 rows — the all-V2 hot
  // path (every row carries addresses) skips the flag vector entirely
  // and phase 2 runs branch-free on it.
  std::vector<uint8_t> matched;
  std::vector<uint32_t> jsa, jda;
  std::vector<uint16_t> jsp, jdp;
  std::vector<std::pair<uint64_t, int64_t>> keyed;
  for (int64_t i = 0; i < n; ++i) {
    if (ev[i].daddr == 0) {
      // the SAME hashed conn key the numpy path groups on — collisions
      // fold (pid, fd) pairs together there, so they must fold here too
      const uint64_t key = (static_cast<uint64_t>(ev[i].pid) << 32) ^
                           (ev[i].fd * 0x9E3779B97F4A7C15ULL);
      keyed.emplace_back(key, i);
    }
  }
  const bool any_v1 = !keyed.empty();
  if (any_v1) {
    matched.assign(static_cast<size_t>(n), 1);
    for (const auto& k : keyed) matched[static_cast<size_t>(k.second)] = 0;
    jsa.resize(static_cast<size_t>(n));
    jsp.resize(static_cast<size_t>(n));
    jda.resize(static_cast<size_t>(n));
    jdp.resize(static_cast<size_t>(n));
    // stable: rows inside a key group stay in original order, so the
    // group head is the first occurrence — numpy's sel[0]
    std::stable_sort(
        keyed.begin(), keyed.end(),
        [](const std::pair<uint64_t, int64_t>& x,
           const std::pair<uint64_t, int64_t>& y) { return x.first < y.first; });
    size_t g0 = 0;
    while (g0 < keyed.size()) {
      size_t g1 = g0 + 1;
      while (g1 < keyed.size() && keyed[g1].first == keyed[g0].first) ++g1;
      const AlzL7Event& head = ev[keyed[g0].second];
      // binary search the (pid, fd) pair in the lexsorted snapshot keys
      int64_t lo = 0, hi = n_lines;
      while (lo < hi) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (sl_pid[mid] < head.pid ||
            (sl_pid[mid] == head.pid && sl_fd[mid] < head.fd)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      if (lo < n_lines && sl_pid[lo] == head.pid && sl_fd[lo] == head.fd) {
        const int64_t a = sl_off[lo];
        const int64_t b = sl_off[lo + 1];
        for (size_t k = g0; k < g1; ++k) {
          const int64_t row = keyed[k].second;
          const int64_t sel = alz_sockline_pick_(sl_ts, sl_open, sl_daddr,
                                                 sl_dport, a, b,
                                                 ev[row].write_time_ns);
          if (sel < 0) continue;
          jsa[static_cast<size_t>(row)] = sl_saddr[a + sel];
          jsp[static_cast<size_t>(row)] = sl_sport[a + sel];
          jda[static_cast<size_t>(row)] = sl_daddr[a + sel];
          jdp[static_cast<size_t>(row)] = sl_dport[a + sel];
          matched[static_cast<size_t>(row)] = 1;
          sl_touched[a + sel] = 1;
        }
      }
      g0 = g1;
    }
  }

  // -- phase 2: sequential original-order pass — requeue partition,
  // pod/service attribution, REQUEST row fill (the numpy boolean-mask
  // order is ascending original index, reproduced exactly). Attribution
  // goes through the L1-resident hash mirrors when the batch is large
  // enough to amortize building them (2-3 lookups per row; identical
  // (found, uid) results either way), and the service probe is skipped
  // when the destination already matched a pod — the to_type chain
  // never consults it in that case.
  const bool use_hash = n >= 64 && n >= (n_pod + n_svc) / 4;
  AlzIpHash pod_h, svc_h;
  if (use_hash) {
    pod_h.build(pod_ips, pod_uids, n_pod);
    svc_h.build(svc_ips, svc_uids, n_svc);
  }
  int64_t n_emit = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i + 4 < n) {
      // the 331-byte rows defeat the adjacent-line prefetcher; pull the
      // row 4 ahead while this one's lookups resolve
      __builtin_prefetch(ev + i + 4);
    }
    if (any_v1 && !matched[static_cast<size_t>(i)]) {
      unmatched_idx[counts[0]++] = i;
      continue;
    }
    const AlzL7Event& e = ev[i];
    const bool via_join = e.daddr == 0;
    const uint32_t sa = via_join ? jsa[static_cast<size_t>(i)] : e.saddr;
    const uint16_t sp = via_join ? jsp[static_cast<size_t>(i)] : e.sport;
    const uint32_t da = via_join ? jda[static_cast<size_t>(i)] : e.daddr;
    const uint16_t dp = via_join ? jdp[static_cast<size_t>(i)] : e.dport;
    bool from_pod = false;
    const int32_t from_uid =
        use_hash ? pod_h.lookup(sa, &from_pod)
                 : alz_ip_lookup_(pod_ips, pod_uids, n_pod, sa, &from_pod);
    if (!from_pod) {  // From must be a pod (setFromToV2 contract)
      counts[1] += 1;
      continue;
    }
    bool to_pod = false, to_svc = false;
    const int32_t to_pod_uid =
        use_hash ? pod_h.lookup(da, &to_pod)
                 : alz_ip_lookup_(pod_ips, pod_uids, n_pod, da, &to_pod);
    const int32_t to_svc_uid =
        to_pod ? 0
               : (use_hash
                      ? svc_h.lookup(da, &to_svc)
                      : alz_ip_lookup_(svc_ips, svc_uids, n_svc, da, &to_svc));
    AlzRequest& r = out[n_emit];
    r.start_time_ms = static_cast<int64_t>(e.write_time_ns / 1000000ULL);
    r.latency_ns = e.duration_ns;
    r.from_ip = sa;
    r.from_type = 1;  // EP_POD
    r.from_uid = from_uid;
    r.from_port = sp;
    r.to_ip = da;
    r.to_type = to_pod ? 1 : (to_svc ? 2 : 3);  // EP_POD/EP_SERVICE/EP_OUTBOUND
    r.to_uid = to_pod ? to_pod_uid : (to_svc ? to_svc_uid : 0);
    r.to_port = dp;
    r.protocol = e.protocol;
    r.tls = e.tls;
    r.completed = 1;
    r.status_code = e.status;
    r.fail_reason = 0;
    r.method = e.method;
    r.path = 0;
    kept_idx[n_emit] = i;
    ++n_emit;
  }
  return n_emit;
}

uint32_t alz_export_nodes(void* p, uint32_t buf_cap, int32_t* uids, uint8_t* types) {
  Ingest* ig = static_cast<Ingest*>(p);
  uint32_t n = static_cast<uint32_t>(ig->node_uids.size());
  if (n > buf_cap) n = buf_cap;
  std::memcpy(uids, ig->node_uids.data(), n * sizeof(int32_t));
  std::memcpy(types, ig->node_types.data(), n * sizeof(uint8_t));
  return n;
}

// ---------------------------------------------------------------------------
// ABI self-description (alazspec ALZ020/ALZ022). The loaded .so reports
// the layout it was COMPILED with — offsetof/sizeof truth, not parser
// output — so graph/native.py can refuse a drifted binary at load and
// tools/alazspec can triangulate source ↔ binary ↔ numpy dtype.
// Format: "AlzRecord:<sizeof>;<field>:<offset>:<size>;..." — mirrored by
// events/schema.py dtype_layout() on the Python side.
// ---------------------------------------------------------------------------

const char* alz_abi_record_layout(void) {
  static const std::string layout = [] {
    char buf[512];
    std::snprintf(
        buf, sizeof(buf),
        "AlzRecord:%zu;"
        "start_time_ms:%zu:%zu;latency_ns:%zu:%zu;from_uid:%zu:%zu;"
        "to_uid:%zu:%zu;status:%zu:%zu;from_type:%zu:%zu;"
        "to_type:%zu:%zu;protocol:%zu:%zu;flags:%zu:%zu",
        sizeof(AlzRecord),
        offsetof(AlzRecord, start_time_ms), sizeof(AlzRecord::start_time_ms),
        offsetof(AlzRecord, latency_ns), sizeof(AlzRecord::latency_ns),
        offsetof(AlzRecord, from_uid), sizeof(AlzRecord::from_uid),
        offsetof(AlzRecord, to_uid), sizeof(AlzRecord::to_uid),
        offsetof(AlzRecord, status), sizeof(AlzRecord::status),
        offsetof(AlzRecord, from_type), sizeof(AlzRecord::from_type),
        offsetof(AlzRecord, to_type), sizeof(AlzRecord::to_type),
        offsetof(AlzRecord, protocol), sizeof(AlzRecord::protocol),
        offsetof(AlzRecord, flags), sizeof(AlzRecord::flags));
    return std::string(buf);
  }();
  return layout.c_str();
}

// L7 engine wire mirrors, same offsetof/sizeof self-description: the
// binding refuses to route process_l7 through a .so whose compiled
// layouts disagree with L7_EVENT_DTYPE / REQUEST_DTYPE.
const char* alz_abi_l7_event_layout(void) {
  static const std::string layout = [] {
    char buf[1024];
    std::snprintf(
        buf, sizeof(buf),
        "AlzL7Event:%zu;"
        "pid:%zu:%zu;fd:%zu:%zu;write_time_ns:%zu:%zu;duration_ns:%zu:%zu;"
        "protocol:%zu:%zu;method:%zu:%zu;tls:%zu:%zu;failed:%zu:%zu;"
        "status:%zu:%zu;payload_size:%zu:%zu;payload_read_complete:%zu:%zu;"
        "tid:%zu:%zu;seq:%zu:%zu;kafka_api_version:%zu:%zu;"
        "mysql_prep_stmt_id:%zu:%zu;saddr:%zu:%zu;sport:%zu:%zu;"
        "daddr:%zu:%zu;dport:%zu:%zu;event_read_time_ns:%zu:%zu;"
        "payload:%zu:%zu",
        sizeof(AlzL7Event),
        offsetof(AlzL7Event, pid), sizeof(AlzL7Event::pid),
        offsetof(AlzL7Event, fd), sizeof(AlzL7Event::fd),
        offsetof(AlzL7Event, write_time_ns), sizeof(AlzL7Event::write_time_ns),
        offsetof(AlzL7Event, duration_ns), sizeof(AlzL7Event::duration_ns),
        offsetof(AlzL7Event, protocol), sizeof(AlzL7Event::protocol),
        offsetof(AlzL7Event, method), sizeof(AlzL7Event::method),
        offsetof(AlzL7Event, tls), sizeof(AlzL7Event::tls),
        offsetof(AlzL7Event, failed), sizeof(AlzL7Event::failed),
        offsetof(AlzL7Event, status), sizeof(AlzL7Event::status),
        offsetof(AlzL7Event, payload_size), sizeof(AlzL7Event::payload_size),
        offsetof(AlzL7Event, payload_read_complete),
        sizeof(AlzL7Event::payload_read_complete),
        offsetof(AlzL7Event, tid), sizeof(AlzL7Event::tid),
        offsetof(AlzL7Event, seq), sizeof(AlzL7Event::seq),
        offsetof(AlzL7Event, kafka_api_version),
        sizeof(AlzL7Event::kafka_api_version),
        offsetof(AlzL7Event, mysql_prep_stmt_id),
        sizeof(AlzL7Event::mysql_prep_stmt_id),
        offsetof(AlzL7Event, saddr), sizeof(AlzL7Event::saddr),
        offsetof(AlzL7Event, sport), sizeof(AlzL7Event::sport),
        offsetof(AlzL7Event, daddr), sizeof(AlzL7Event::daddr),
        offsetof(AlzL7Event, dport), sizeof(AlzL7Event::dport),
        offsetof(AlzL7Event, event_read_time_ns),
        sizeof(AlzL7Event::event_read_time_ns),
        offsetof(AlzL7Event, payload), sizeof(AlzL7Event::payload));
    return std::string(buf);
  }();
  return layout.c_str();
}

const char* alz_abi_request_layout(void) {
  static const std::string layout = [] {
    char buf[1024];
    std::snprintf(
        buf, sizeof(buf),
        "AlzRequest:%zu;"
        "start_time_ms:%zu:%zu;latency_ns:%zu:%zu;from_ip:%zu:%zu;"
        "from_type:%zu:%zu;from_uid:%zu:%zu;from_port:%zu:%zu;"
        "to_ip:%zu:%zu;to_type:%zu:%zu;to_uid:%zu:%zu;to_port:%zu:%zu;"
        "protocol:%zu:%zu;tls:%zu:%zu;completed:%zu:%zu;"
        "status_code:%zu:%zu;fail_reason:%zu:%zu;method:%zu:%zu;path:%zu:%zu",
        sizeof(AlzRequest),
        offsetof(AlzRequest, start_time_ms), sizeof(AlzRequest::start_time_ms),
        offsetof(AlzRequest, latency_ns), sizeof(AlzRequest::latency_ns),
        offsetof(AlzRequest, from_ip), sizeof(AlzRequest::from_ip),
        offsetof(AlzRequest, from_type), sizeof(AlzRequest::from_type),
        offsetof(AlzRequest, from_uid), sizeof(AlzRequest::from_uid),
        offsetof(AlzRequest, from_port), sizeof(AlzRequest::from_port),
        offsetof(AlzRequest, to_ip), sizeof(AlzRequest::to_ip),
        offsetof(AlzRequest, to_type), sizeof(AlzRequest::to_type),
        offsetof(AlzRequest, to_uid), sizeof(AlzRequest::to_uid),
        offsetof(AlzRequest, to_port), sizeof(AlzRequest::to_port),
        offsetof(AlzRequest, protocol), sizeof(AlzRequest::protocol),
        offsetof(AlzRequest, tls), sizeof(AlzRequest::tls),
        offsetof(AlzRequest, completed), sizeof(AlzRequest::completed),
        offsetof(AlzRequest, status_code), sizeof(AlzRequest::status_code),
        offsetof(AlzRequest, fail_reason), sizeof(AlzRequest::fail_reason),
        offsetof(AlzRequest, method), sizeof(AlzRequest::method),
        offsetof(AlzRequest, path), sizeof(AlzRequest::path));
    return std::string(buf);
  }();
  return layout.c_str();
}

// sha256 prefix of the ingest.cc this binary was compiled from (the
// Makefile stamp); "unstamped" for out-of-band builds.
const char* alz_source_hash(void) { return ALZ_SOURCE_HASH; }

}  // extern "C"
