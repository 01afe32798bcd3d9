// Native host-runtime components for os1-tpu.
//
// The reference system is all-C++ (SURVEY.md §2); this build keeps its
// compute path in XLA but implements the host runtime's hot paths natively:
//
//  * DBoW2 binary-vocabulary loader — one mmap'd pass over the 45-byte
//    records (the reference's ~100x binary-load win, README.md:24 /
//    TemplatedVocabulary.h:1563, reproduced here; the Python fallback parses
//    record-by-record and is ~100x slower on a 10^6-node vocabulary).
//  * SPSC frame ring buffer — the Video producer/consumer handover
//    (Video.cpp:40-73) as a lock-free-read mailbox with both lossless
//    (blocking) and realtime (latest-wins) modes.
//  * Grayscale conversion (BT.601) u8/RGB -> f32, the ingest-edge transform
//    (Tracking.cc:96-109).
//
// Exposed via a C ABI consumed with ctypes (no pybind11 in this toolchain).
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// DBoW2 binary vocabulary loader.
// Record layout (45 bytes): parent int32 | isLeaf u8 | desc u8[32] | weight f64.
// ---------------------------------------------------------------------------

// Returns the node count (records + root) or -1; writes k and L.
int64_t vocab_count(const char* path, int32_t* k, int32_t* L) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char header[4];
  if (fread(header, 1, 4, f) != 4) {
    fclose(f);
    return -1;
  }
  *k = header[0];
  *L = header[1];
  fclose(f);
  return (st.st_size - 4) / 45 + 1;
}

// Fills flat arrays sized for n_nodes (from vocab_count) and branching kb:
//   desc     [n_nodes * 8]  u32 (little-endian bit order)
//   children [n_nodes * kb] i32, -1 padded
//   weight   [n_nodes]      f32
//   word     [n_nodes]      i32, -1 for internal nodes
// Returns number of words, or -1 on error.
int64_t vocab_load(const char* path, uint32_t* desc, int32_t* children,
                   float* weight, int32_t* word, int64_t n_nodes,
                   int32_t kb) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  const unsigned char* data = static_cast<const unsigned char*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  if (data == MAP_FAILED) {
    close(fd);
    return -1;
  }
  const int64_t n_rec = (st.st_size - 4) / 45;
  if (n_rec + 1 != n_nodes) {
    munmap(const_cast<unsigned char*>(data), st.st_size);
    close(fd);
    return -1;
  }

  int32_t* child_count = new int32_t[n_nodes]();
  memset(children, 0xFF, sizeof(int32_t) * n_nodes * kb);
  memset(word, 0xFF, sizeof(int32_t) * n_nodes);
  memset(desc, 0, sizeof(uint32_t) * 8);  // root has no descriptor
  weight[0] = 0.0f;

  int64_t n_words = 0;
  const unsigned char* p = data + 4;
  for (int64_t i = 1; i < n_nodes; ++i, p += 45) {
    int32_t parent;
    memcpy(&parent, p, 4);
    if (parent >= 0 && parent < n_nodes && child_count[parent] < kb) {
      children[parent * kb + child_count[parent]++] = static_cast<int32_t>(i);
    }
    const uint8_t is_leaf = p[4];
    memcpy(desc + i * 8, p + 5, 32);
    double w;
    memcpy(&w, p + 37, 8);
    weight[i] = static_cast<float>(w);
    if (is_leaf) word[i] = static_cast<int32_t>(n_words++);
  }
  delete[] child_count;
  munmap(const_cast<unsigned char*>(
             const_cast<unsigned char*>(data)),
         st.st_size);
  close(fd);
  return n_words;
}

// ---------------------------------------------------------------------------
// BoW vocabulary-tree descent (TemplatedVocabulary::transform analogue).
//
// The per-keyframe hot path: ~1k descriptors walk a k-ary tree of up to
// ~10^6 nodes. On the device each dispatch has a fixed latency and
// contends with the tracker's per-frame program; natively this is ~0.5M
// popcounts — well under a millisecond — so keyframe-rate BoW never touches
// the device (reference runs it on the CPU too, KeyFrame::ComputeBoW).
// ---------------------------------------------------------------------------

static inline int hamming256(const uint32_t* a, const uint32_t* b) {
  int d = 0;
  for (int w = 0; w < 8; ++w) d += __builtin_popcount(a[w] ^ b[w]);
  return d;
}

void bow_transform(const uint32_t* desc, const uint8_t* valid, int64_t n,
                   const uint32_t* node_desc, const int32_t* children,
                   const float* node_weight, const int32_t* node_word,
                   int32_t kb, int32_t depth, int32_t* out_word,
                   float* out_weight) {
  for (int64_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) {
      out_word[i] = -1;
      out_weight[i] = 0.0f;
      continue;
    }
    const uint32_t* d = desc + i * 8;
    int32_t cur = 0;
    for (int32_t lvl = 0; lvl < depth; ++lvl) {
      const int32_t* ch = children + static_cast<int64_t>(cur) * kb;
      if (ch[0] < 0) break;  // early leaf (small training cluster)
      int best = ch[0];
      int bestd = 1 << 30;
      for (int32_t c = 0; c < kb && ch[c] >= 0; ++c) {
        const int dist =
            hamming256(d, node_desc + static_cast<int64_t>(ch[c]) * 8);
        if (dist < bestd) {
          bestd = dist;
          best = ch[c];
        }
      }
      cur = best;
    }
    out_word[i] = node_word[cur];
    out_weight[i] = node_weight[cur];
  }
}

// ---------------------------------------------------------------------------
// Hierarchical binary k-medians vocabulary training (DBoW2's construction:
// k-means with bitwise-majority centroids — the mean under Hamming metric).
// Deterministic under `seed`. Descriptors are packed uint32[8].
// ---------------------------------------------------------------------------

namespace {

struct SplitMix64 {
  uint64_t s;
  explicit SplitMix64(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform in [0, n)
  uint64_t below(uint64_t n) { return next() % n; }
};

// One k-medians pass over descs[idx[0..m)]. Writes up to k packed centers
// and the final assignment; returns the surviving center count (empty
// clusters dropped). Assignment runs on 2 threads (host has 2 cores).
int32_t kmedians(const uint32_t* descs, const int64_t* idx, int64_t m,
                 int32_t k, int iters, SplitMix64* rng, uint32_t* centers,
                 int32_t* assign) {
  if (m <= 0) return 0;
  if (k > m) k = static_cast<int32_t>(m);
  // Init: k distinct random members (deterministic).
  {
    // Reservoir-free distinct draw: sort-free, retry on collision.
    int32_t got = 0;
    while (got < k) {
      const int64_t pick = idx[rng->below(static_cast<uint64_t>(m))];
      bool dup = false;
      for (int32_t c = 0; c < got; ++c) {
        if (hamming256(centers + c * 8, descs + pick * 8) == 0) {
          dup = true;
          break;
        }
      }
      if (!dup) {
        memcpy(centers + got * 8, descs + pick * 8, 32);
        ++got;
      } else if (rng->below(8) == 0) {
        // Duplicate-heavy cluster: accept fewer centers rather than spin.
        break;
      }
    }
    k = got;
  }
  if (k <= 1) {
    for (int64_t i = 0; i < m; ++i) assign[i] = 0;
    return k;
  }

  std::vector<int64_t> counts(k);
  std::vector<int64_t> bitcnt(static_cast<size_t>(k) * 256);
  for (int it = 0; it < iters; ++it) {
    std::fill(counts.begin(), counts.end(), 0);
    std::fill(bitcnt.begin(), bitcnt.end(), 0);

    auto worker = [&](int64_t lo, int64_t hi, int64_t* cnts, int64_t* bits) {
      for (int64_t i = lo; i < hi; ++i) {
        const uint32_t* d = descs + idx[i] * 8;
        int best = 0, bestd = 1 << 30;
        for (int32_t c = 0; c < k; ++c) {
          const int dist = hamming256(d, centers + c * 8);
          if (dist < bestd) {
            bestd = dist;
            best = c;
          }
        }
        assign[i] = best;
        cnts[best]++;
        int64_t* bc = bits + static_cast<int64_t>(best) * 256;
        for (int w = 0; w < 8; ++w) {
          uint32_t v = d[w];
          while (v) {
            const int b = __builtin_ctz(v);
            bc[w * 32 + b]++;
            v &= v - 1;
          }
        }
      }
    };

    if (m > 65536) {
      std::vector<int64_t> counts2(k, 0);
      std::vector<int64_t> bitcnt2(static_cast<size_t>(k) * 256, 0);
      const int64_t mid = m / 2;
      std::thread t(worker, 0, mid, counts.data(), bitcnt.data());
      worker(mid, m, counts2.data(), bitcnt2.data());
      t.join();
      for (int32_t c = 0; c < k; ++c) counts[c] += counts2[c];
      for (size_t i = 0; i < bitcnt.size(); ++i) bitcnt[i] += bitcnt2[i];
    } else {
      worker(0, m, counts.data(), bitcnt.data());
    }

    // Majority-vote centroids; drop empty clusters.
    int32_t k_new = 0;
    bool changed = false;
    for (int32_t c = 0; c < k; ++c) {
      if (counts[c] == 0) {
        changed = true;
        continue;
      }
      uint32_t nc[8] = {0};
      const int64_t* bc = bitcnt.data() + static_cast<int64_t>(c) * 256;
      const int64_t half = counts[c];  // bit set iff 2*cnt >= count
      for (int b = 0; b < 256; ++b)
        if (2 * bc[b] >= half) nc[b / 32] |= 1u << (b % 32);
      if (memcmp(nc, centers + c * 8, 32) != 0) changed = true;
      memcpy(centers + k_new * 8, nc, 32);
      ++k_new;
    }
    k = k_new;
    if (!changed || k <= 1) break;
  }
  // Final assignment against the settled centers.
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t* d = descs + idx[i] * 8;
    int best = 0, bestd = 1 << 30;
    for (int32_t c = 0; c < k; ++c) {
      const int dist = hamming256(d, centers + c * 8);
      if (dist < bestd) {
        bestd = dist;
        best = c;
      }
    }
    assign[i] = best;
  }
  return k;
}

struct TrainState {
  const uint32_t* descs;
  int32_t kb, depth;
  int iters;
  uint32_t* node_desc;
  int32_t* children;
  int32_t* node_word;
  int32_t* leaf_count;
  int64_t max_nodes;
  int64_t n_nodes;
  int64_t n_words;
  SplitMix64 rng;
  std::vector<uint32_t> cbuf;
  std::vector<int32_t> abuf;
};

// Recursive split; idx is reordered in place so children own contiguous
// ranges. Returns false on node-capacity overflow.
bool split_node(TrainState* ts, int32_t node, int64_t* idx, int64_t m,
                int32_t level) {
  if (level == ts->depth || m <= ts->kb) {
    ts->node_word[node] = static_cast<int32_t>(ts->n_words++);
    ts->leaf_count[node] = static_cast<int32_t>(m);
    return true;
  }
  uint32_t* centers = ts->cbuf.data();
  int32_t* assign = ts->abuf.data();
  const int32_t k =
      kmedians(ts->descs, idx, m, ts->kb, ts->iters, &ts->rng, centers, assign);
  if (k <= 1) {  // degenerate cluster (all-identical descriptors)
    ts->node_word[node] = static_cast<int32_t>(ts->n_words++);
    ts->leaf_count[node] = static_cast<int32_t>(m);
    return true;
  }
  // Partition idx by assignment (stable counting sort).
  std::vector<int64_t> start(k + 1, 0);
  for (int64_t i = 0; i < m; ++i) start[assign[i] + 1]++;
  for (int32_t c = 0; c < k; ++c) start[c + 1] += start[c];
  std::vector<int64_t> tmp(m);
  {
    std::vector<int64_t> pos(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < m; ++i) tmp[pos[assign[i]]++] = idx[i];
  }
  memcpy(idx, tmp.data(), sizeof(int64_t) * m);

  // Create the child nodes first (ids allocated breadth-locally so parents
  // always precede children, as the binary format requires).
  std::vector<int32_t> child_ids(k);
  for (int32_t c = 0; c < k; ++c) {
    if (ts->n_nodes >= ts->max_nodes) return false;
    const int32_t id = static_cast<int32_t>(ts->n_nodes++);
    child_ids[c] = id;
    memcpy(ts->node_desc + static_cast<int64_t>(id) * 8, centers + c * 8, 32);
    ts->children[static_cast<int64_t>(node) * ts->kb + c] = id;
  }
  for (int32_t c = 0; c < k; ++c) {
    if (!split_node(ts, child_ids[c], idx + start[c], start[c + 1] - start[c],
                    level + 1))
      return false;
  }
  return true;
}

}  // namespace

// Trains a vocabulary tree over m packed descriptors. Fills node_desc
// [max_nodes*8], children [max_nodes*kb] (-1 padded), node_word [max_nodes]
// (-1 internal), leaf_count [max_nodes] (training descriptors per leaf, for
// idf). Returns node count, or -1 on overflow.
int64_t vocab_train(const uint32_t* descs, int64_t m, int32_t kb,
                    int32_t depth, uint32_t seed, int32_t iters,
                    uint32_t* node_desc, int32_t* children, int32_t* node_word,
                    int32_t* leaf_count, int64_t max_nodes) {
  if (m <= 0 || max_nodes < 1) return -1;
  memset(children, 0xFF, sizeof(int32_t) * max_nodes * kb);
  memset(node_word, 0xFF, sizeof(int32_t) * max_nodes);
  memset(leaf_count, 0, sizeof(int32_t) * max_nodes);
  memset(node_desc, 0, sizeof(uint32_t) * 8);

  TrainState ts{descs,     kb,        depth,     iters,
                node_desc, children,  node_word, leaf_count,
                max_nodes, 1,         0,         SplitMix64(seed),
                {},        {}};
  ts.cbuf.resize(static_cast<size_t>(kb) * 8);
  ts.abuf.resize(m);
  std::vector<int64_t> idx(m);
  for (int64_t i = 0; i < m; ++i) idx[i] = i;
  if (!split_node(&ts, 0, idx.data(), m, 0)) return -1;
  return ts.n_nodes;
}

// ---------------------------------------------------------------------------
// SPSC frame ring buffer (Video producer/consumer handover).
// ---------------------------------------------------------------------------

struct RingBuffer {
  uint8_t* data;
  int64_t slot_bytes;
  int64_t capacity;
  std::atomic<int64_t> head{0};  // next write sequence number
  std::atomic<int64_t> tail{0};  // next read sequence number
  bool realtime;                 // true: overwrite oldest (latest wins)
  std::mutex m;
  std::condition_variable cv;
  std::atomic<bool> closed{false};
};

void* ring_create(int64_t capacity, int64_t slot_bytes, int realtime) {
  RingBuffer* rb = new RingBuffer();
  rb->data = new uint8_t[capacity * slot_bytes];
  rb->slot_bytes = slot_bytes;
  rb->capacity = capacity;
  rb->realtime = realtime != 0;
  return rb;
}

void ring_destroy(void* h) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  delete[] rb->data;
  delete rb;
}

void ring_close(void* h) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  rb->closed = true;
  rb->cv.notify_all();
}

// Push one frame. Lossless mode blocks while full (up to timeout_ms);
// realtime mode drops the oldest. Returns 1 ok, 0 timeout/closed.
int ring_push(void* h, const uint8_t* frame, int64_t timeout_ms) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  std::unique_lock<std::mutex> lk(rb->m);
  if (!rb->realtime) {
    if (!rb->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
          return rb->closed || rb->head - rb->tail < rb->capacity;
        }))
      return 0;
    if (rb->closed) return 0;
  } else if (rb->head - rb->tail >= rb->capacity) {
    rb->tail++;  // drop oldest
  }
  const int64_t slot = rb->head % rb->capacity;
  memcpy(rb->data + slot * rb->slot_bytes, frame, rb->slot_bytes);
  rb->head++;
  rb->cv.notify_all();
  return 1;
}

// Pop one frame into out. Returns 1 ok, 0 timeout/closed-and-empty.
int ring_pop(void* h, uint8_t* out, int64_t timeout_ms) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  std::unique_lock<std::mutex> lk(rb->m);
  if (!rb->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                       [&] { return rb->closed || rb->head > rb->tail; }))
    return 0;
  if (rb->head == rb->tail) return 0;  // closed and drained
  const int64_t slot = rb->tail % rb->capacity;
  memcpy(out, rb->data + slot * rb->slot_bytes, rb->slot_bytes);
  rb->tail++;
  rb->cv.notify_all();
  return 1;
}

int64_t ring_size(void* h) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  return rb->head - rb->tail;
}

// ---------------------------------------------------------------------------
// Ingest-edge conversions.
// ---------------------------------------------------------------------------

void gray_u8_to_f32(const uint8_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]);
}

// Interleaved RGB u8 -> BT.601 luminance f32.
void rgb_u8_to_gray_f32(const uint8_t* src, float* dst, int64_t n_pixels) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    const float r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
    dst[i] = 0.299f * r + 0.587f * g + 0.114f * b;
  }
}

// ---------------------------------------------------------------------------
// Distinctive-descriptor selection (MapPoint::ComputeDistinctiveDescriptors,
// reference MapPoint.cc:227-293): for each point, among its live observing
// features' descriptors pick the one with minimum median Hamming distance to
// the others. The numpy form (unpackbits + einsum + nanmedian over
// [n, M, M, 256]) cost ~26 ms per 1000 points on the keyframe-event path;
// popcount + nth_element here runs it in well under a millisecond.
//   descs: [n, M, 8] uint32 (256-bit descriptors), live: [n, M] uint8,
//   out_best: [n] int32 — live slot index of the distinctive descriptor
//   (first live slot when fewer than 2 live observations).
void point_distinctive_desc(const uint32_t* descs, const uint8_t* live,
                            int64_t n, int32_t M, int32_t* out_best) {
  std::vector<float> med(M);
  std::vector<int> dists;
  for (int64_t p = 0; p < n; ++p) {
    const uint32_t* d0 = descs + p * M * 8;
    const uint8_t* lv = live + p * M;
    int32_t best = -1;
    float best_med = 1e30f;
    for (int32_t a = 0; a < M; ++a) {
      if (!lv[a]) continue;
      if (best < 0) best = a;  // first live fallback
      dists.clear();
      for (int32_t b = 0; b < M; ++b) {
        if (!lv[b]) continue;
        int dist = 0;
        if (a != b) {
          for (int w = 0; w < 8; ++w)
            dist += __builtin_popcount(d0[a * 8 + w] ^ d0[b * 8 + w]);
        }
        dists.push_back(dist);
      }
      const size_t k = dists.size();
      if (k < 2) break;  // single live observation: keep it
      // Median with numpy semantics (mean of middle pair for even k).
      std::sort(dists.begin(), dists.end());
      const float m = (k & 1) ? float(dists[k / 2])
                              : 0.5f * (dists[k / 2 - 1] + dists[k / 2]);
      if (m < best_med) { best_med = m; best = a; }
    }
    out_best[p] = best;
  }
}

}  // extern "C"
