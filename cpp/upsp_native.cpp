// upsp_native: host-side native kernels for the uPSP engine.
//
// The accelerator owns the compute path (JAX/XLA); this library owns the
// host-runtime hot spots around it, mirroring the roles the reference
// implements natively (SURVEY.md N2/N5/N19/N20 — studied, not copied):
//   - packed 10/12-bit pixel unpacking (video ingest feeding device buffers)
//   - median-split BVH construction over triangle soups (phase-0 setup)
//   - blocked out-of-core float32 matrix transpose (flat-file tooling)
//   - asynchronous positioned-write queue (write-behind for output files)
//
// Exposed as a plain C ABI consumed via ctypes (upsp_tpu/native.py); every
// entry point has a pure-numpy fallback so the Python package works without
// the shared library.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// packed pixel unpacking (MSBit-first, Vision Research / Photron layout)

void upsp_unpack_12bpp(const uint8_t* src, int64_t n_bytes, uint16_t* dst) {
  const int64_t groups = n_bytes / 3;
  const int n_threads = std::max(1u, std::thread::hardware_concurrency());
  auto work = [&](int64_t g0, int64_t g1) {
    for (int64_t g = g0; g < g1; ++g) {
      const uint8_t* b = src + g * 3;
      dst[g * 2] = static_cast<uint16_t>((b[0] << 4) | (b[1] >> 4));
      dst[g * 2 + 1] = static_cast<uint16_t>(((b[1] & 0x0F) << 8) | b[2]);
    }
  };
  if (groups < (1 << 16) || n_threads == 1) {
    work(0, groups);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t per = (groups + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t g0 = t * per;
    const int64_t g1 = std::min(groups, g0 + per);
    if (g0 < g1) pool.emplace_back(work, g0, g1);
  }
  for (auto& th : pool) th.join();
}

void upsp_unpack_10bpp(const uint8_t* src, int64_t n_bytes, uint16_t* dst) {
  const int64_t groups = n_bytes / 5;
  for (int64_t g = 0; g < groups; ++g) {
    const uint8_t* b = src + g * 5;
    uint16_t* p = dst + g * 4;
    p[0] = static_cast<uint16_t>((b[0] << 2) | (b[1] >> 6));
    p[1] = static_cast<uint16_t>(((b[1] & 0x3F) << 4) | (b[2] >> 4));
    p[2] = static_cast<uint16_t>(((b[2] & 0x0F) << 6) | (b[3] >> 2));
    p[3] = static_cast<uint16_t>(((b[3] & 0x03) << 8) | b[4]);
  }
}

// ---------------------------------------------------------------------------
// median-split BVH build -> flattened escape-link arrays (DFS order).
// Layout contract matches upsp_tpu/geometry/bvh.py: leaves hold a contiguous
// range of reordered triangles; on miss jump to escape[i], on hit go to i+1.

namespace {

struct BuildCtx {
  const float* tri_min;  // (T,3)
  const float* tri_max;
  const float* centroid;
  int64_t* order;
  int leaf_size;
  int method;  // 0 = median split, 1 = SAH buckets
  // outputs (appended per emitted node)
  std::vector<float> bmin, bmax;
  std::vector<int32_t> leaf_start, leaf_count;
};

inline float box_area(const float lo[3], const float hi[3]) {
  const float dx = hi[0] - lo[0], dy = hi[1] - lo[1], dz = hi[2] - lo[2];
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}

// SAH bucket split: bin the centroid extent of every axis into NB buckets,
// evaluate the surface-area cost N_L*A_L + N_R*A_R at each bucket boundary,
// and partition at the global minimum.  Same greedy objective the
// reference's pbrt-derived builder optimizes (pspRT.cpp:499-525 —
// re-derived, not copied); cuts traversal work ~15-30% on elongated wind-
// tunnel meshes where a pure median split yields high-overlap children.
// Returns the partition point, or -1 when no usable SAH split exists
// (degenerate extent / all triangles land in one bucket).
int64_t sah_partition(BuildCtx& c, int64_t start, int64_t count,
                      const float clo[3], const float chi[3]) {
  constexpr int NB = 12;
  float best_cost = 3e38f;
  int best_axis = -1, best_cut = -1;
  for (int a = 0; a < 3; ++a) {
    const float ext = chi[a] - clo[a];
    if (!(ext > 0.0f)) continue;
    int32_t n[NB] = {0};
    float blo[NB][3], bhi[NB][3];
    for (int b = 0; b < NB; ++b)
      for (int k = 0; k < 3; ++k) {
        blo[b][k] = 3e38f;
        bhi[b][k] = -3e38f;
      }
    const float inv = NB / ext;
    for (int64_t i = start; i < start + count; ++i) {
      const int64_t t = c.order[i];
      int b = static_cast<int>((c.centroid[t * 3 + a] - clo[a]) * inv);
      b = std::min(std::max(b, 0), NB - 1);
      ++n[b];
      for (int k = 0; k < 3; ++k) {
        blo[b][k] = std::min(blo[b][k], c.tri_min[t * 3 + k]);
        bhi[b][k] = std::max(bhi[b][k], c.tri_max[t * 3 + k]);
      }
    }
    // suffix sweep: cost of the right side after each cut
    float rcost[NB];  // rcost[b] = N_R*A_R for a cut after bucket b-1
    {
      float lo[3] = {3e38f, 3e38f, 3e38f}, hi[3] = {-3e38f, -3e38f, -3e38f};
      int32_t nr = 0;
      for (int b = NB - 1; b >= 1; --b) {
        nr += n[b];
        for (int k = 0; k < 3; ++k) {
          lo[k] = std::min(lo[k], blo[b][k]);
          hi[k] = std::max(hi[k], bhi[b][k]);
        }
        rcost[b] = nr ? nr * box_area(lo, hi) : 0.0f;
      }
    }
    // prefix sweep: evaluate each cut
    {
      float lo[3] = {3e38f, 3e38f, 3e38f}, hi[3] = {-3e38f, -3e38f, -3e38f};
      int32_t nl = 0;
      for (int b = 0; b < NB - 1; ++b) {
        nl += n[b];
        for (int k = 0; k < 3; ++k) {
          lo[k] = std::min(lo[k], blo[b][k]);
          hi[k] = std::max(hi[k], bhi[b][k]);
        }
        if (nl == 0 || nl == count) continue;
        const float cost = nl * box_area(lo, hi) + rcost[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = a;
          best_cut = b;
        }
      }
    }
  }
  if (best_axis < 0) return -1;
  const float inv = NB / (chi[best_axis] - clo[best_axis]);
  const float lo_a = clo[best_axis];
  const float* cen = c.centroid;
  const int cut = best_cut;
  int64_t* mid_ptr = std::partition(
      c.order + start, c.order + start + count,
      [cen, best_axis, lo_a, inv, cut](int64_t t) {
        int b = static_cast<int>((cen[t * 3 + best_axis] - lo_a) * inv);
        b = std::min(std::max(b, 0), NB - 1);
        return b <= cut;
      });
  const int64_t mid = mid_ptr - c.order;
  if (mid == start || mid == start + count) return -1;
  return mid;
}

void build_rec(BuildCtx& c, int64_t start, int64_t count) {
  const size_t idx = c.leaf_start.size();
  float lo[3] = {3e38f, 3e38f, 3e38f}, hi[3] = {-3e38f, -3e38f, -3e38f};
  for (int64_t i = start; i < start + count; ++i) {
    const int64_t t = c.order[i];
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], c.tri_min[t * 3 + k]);
      hi[k] = std::max(hi[k], c.tri_max[t * 3 + k]);
    }
  }
  for (int k = 0; k < 3; ++k) {
    c.bmin.push_back(lo[k]);
    c.bmax.push_back(hi[k]);
  }
  c.leaf_start.push_back(static_cast<int32_t>(start));
  c.leaf_count.push_back(static_cast<int32_t>(count));

  if (count <= c.leaf_size) return;

  float clo[3] = {3e38f, 3e38f, 3e38f}, chi[3] = {-3e38f, -3e38f, -3e38f};
  for (int64_t i = start; i < start + count; ++i) {
    const int64_t t = c.order[i];
    for (int k = 0; k < 3; ++k) {
      clo[k] = std::min(clo[k], c.centroid[t * 3 + k]);
      chi[k] = std::max(chi[k], c.centroid[t * 3 + k]);
    }
  }
  int axis = 0;
  float ext = chi[0] - clo[0];
  for (int k = 1; k < 3; ++k) {
    if (chi[k] - clo[k] > ext) {
      ext = chi[k] - clo[k];
      axis = k;
    }
  }

  int64_t mid = start + count / 2;
  bool partitioned = false;
  if (c.method == 1 && ext > 0.0f) {
    const int64_t m = sah_partition(c, start, count, clo, chi);
    if (m >= 0) {
      mid = m;
      partitioned = true;
    }
  }
  const float* cen = c.centroid;
  if (!partitioned && ext > 0.0f) {
    std::nth_element(
        c.order + start, c.order + mid, c.order + start + count,
        [cen, axis](int64_t a, int64_t b) {
          return cen[a * 3 + axis] < cen[b * 3 + axis];
        });
  }
  // degenerate clusters (coincident centroids) still split by count so leaf
  // sizes stay bounded — oversized leaves explode the device traversal blocks
  c.leaf_start[idx] = -1;  // becomes internal
  c.leaf_count[idx] = 0;
  build_rec(c, start, mid - start);
  build_rec(c, mid, start + count - mid);
}

int64_t subtree_sizes(const std::vector<int32_t>& leaf_start,
                      std::vector<int64_t>& sz, int64_t i) {
  if (leaf_start[i] >= 0) {
    sz[i] = 1;
    return 1;
  }
  const int64_t left = i + 1;
  const int64_t ls = subtree_sizes(leaf_start, sz, left);
  const int64_t rs = subtree_sizes(leaf_start, sz, left + ls);
  sz[i] = 1 + ls + rs;
  return sz[i];
}

}  // namespace

// Returns the node count (M).  Caller passes output buffers sized for the
// worst case (2*ceil(T/leaf)-1 <= 2*T nodes); a first call with null outputs
// is NOT supported — use upsp_bvh_max_nodes() to size them.
int64_t upsp_bvh_max_nodes(int64_t n_tris) { return 2 * n_tris + 1; }

// method: 0 = median split (fast build), 1 = SAH buckets (fast traversal;
// the reference's deliberate choice at campaign scale, pspRT.cpp:499-525).
int64_t upsp_bvh_build(const float* vertices, const int32_t* triangles,
                       int64_t n_tris, int leaf_size, int method,
                       // outputs
                       float* bbox_min, float* bbox_max, int32_t* escape,
                       int32_t* leaf_start, int32_t* leaf_count,
                       int64_t* order_out) {
  std::vector<float> tri_min(n_tris * 3), tri_max(n_tris * 3),
      centroid(n_tris * 3);
  for (int64_t t = 0; t < n_tris; ++t) {
    for (int k = 0; k < 3; ++k) {
      const float a = vertices[triangles[t * 3 + 0] * 3 + k];
      const float b = vertices[triangles[t * 3 + 1] * 3 + k];
      const float cc = vertices[triangles[t * 3 + 2] * 3 + k];
      const float lo = std::min(a, std::min(b, cc));
      const float hi = std::max(a, std::max(b, cc));
      tri_min[t * 3 + k] = lo;
      tri_max[t * 3 + k] = hi;
      centroid[t * 3 + k] = 0.5f * (lo + hi);
    }
  }
  std::vector<int64_t> order(n_tris);
  std::iota(order.begin(), order.end(), 0);

  BuildCtx ctx{tri_min.data(), tri_max.data(), centroid.data(), order.data(),
               leaf_size, method};
  ctx.bmin.reserve(n_tris * 3);
  build_rec(ctx, 0, n_tris);

  const int64_t M = static_cast<int64_t>(ctx.leaf_start.size());
  std::vector<int64_t> sz(M);
  subtree_sizes(ctx.leaf_start, sz, 0);

  // escape links via explicit DFS
  std::vector<std::pair<int64_t, int64_t>> stack{{0, M}};
  std::vector<int32_t> esc(M, static_cast<int32_t>(M));
  while (!stack.empty()) {
    auto [i, e] = stack.back();
    stack.pop_back();
    esc[i] = static_cast<int32_t>(e);
    if (ctx.leaf_start[i] < 0) {
      const int64_t left = i + 1;
      const int64_t right = left + sz[left];
      stack.push_back({left, right});
      stack.push_back({right, e});
    }
  }

  std::memcpy(bbox_min, ctx.bmin.data(), M * 3 * sizeof(float));
  std::memcpy(bbox_max, ctx.bmax.data(), M * 3 * sizeof(float));
  std::memcpy(escape, esc.data(), M * sizeof(int32_t));
  std::memcpy(leaf_start, ctx.leaf_start.data(), M * sizeof(int32_t));
  std::memcpy(leaf_count, ctx.leaf_count.data(), M * sizeof(int32_t));
  std::memcpy(order_out, order.data(), n_tris * sizeof(int64_t));
  return M;
}

// ---------------------------------------------------------------------------
// batched closest-hit BVH traversal (escape-link layout, Moller-Trumbore).
// Semantics identical to upsp_tpu/ops/raycast.py:bvh_intersect (same eps).

namespace {

struct BVHView {
  const float* bbox_min;   // (M,3)
  const float* bbox_max;   // (M,3)
  const int32_t* escape;   // (M,)
  const int32_t* leaf_start;  // (M,) -1 internal
  const int32_t* leaf_count;  // (M,)
  const float* tri_v0;     // (T,3) reordered
  const float* tri_e1;
  const float* tri_e2;
  const int32_t* tri_id;   // (T,)
  int64_t n_nodes;
};

inline void intersect_one(const BVHView& b, const float* o, const float* d,
                          float* out_t, int32_t* out_prim) {
  float inv[3];
  for (int k = 0; k < 3; ++k)
    inv[k] = std::abs(d[k]) > 1e-30f ? 1.0f / d[k] : (d[k] >= 0 ? 1e30f : -1e30f);
  float best_t = 3e38f;
  int32_t best_prim = -1;
  int64_t node = 0;
  const float eps = 1e-9f;
  while (node < b.n_nodes) {
    float tnear = -3e38f, tfar = 3e38f;
    for (int k = 0; k < 3; ++k) {
      const float t0 = (b.bbox_min[node * 3 + k] - o[k]) * inv[k];
      const float t1 = (b.bbox_max[node * 3 + k] - o[k]) * inv[k];
      tnear = std::max(tnear, std::min(t0, t1));
      tfar = std::min(tfar, std::max(t0, t1));
    }
    const bool box_hit = tfar >= std::max(tnear, 0.0f) && tnear < best_t;
    const int32_t start = b.leaf_start[node];
    if (box_hit && start >= 0) {
      const int32_t count = b.leaf_count[node];
      for (int32_t j = 0; j < count; ++j) {
        const float* v0 = b.tri_v0 + (start + j) * 3;
        const float* e1 = b.tri_e1 + (start + j) * 3;
        const float* e2 = b.tri_e2 + (start + j) * 3;
        const float p0 = d[1] * e2[2] - d[2] * e2[1];
        const float p1 = d[2] * e2[0] - d[0] * e2[2];
        const float p2 = d[0] * e2[1] - d[1] * e2[0];
        const float det = e1[0] * p0 + e1[1] * p1 + e1[2] * p2;
        if (std::abs(det) <= eps) continue;
        const float idet = 1.0f / det;
        const float s0 = o[0] - v0[0], s1 = o[1] - v0[1], s2 = o[2] - v0[2];
        const float u = (s0 * p0 + s1 * p1 + s2 * p2) * idet;
        if (u < 0.0f || u > 1.0f) continue;
        const float q0 = s1 * e1[2] - s2 * e1[1];
        const float q1 = s2 * e1[0] - s0 * e1[2];
        const float q2 = s0 * e1[1] - s1 * e1[0];
        const float v = (d[0] * q0 + d[1] * q1 + d[2] * q2) * idet;
        if (v < 0.0f || u + v > 1.0f) continue;
        const float t = (e2[0] * q0 + e2[1] * q1 + e2[2] * q2) * idet;
        if (t > eps && t < best_t) {
          best_t = t;
          best_prim = b.tri_id[start + j];
        }
      }
    }
    node = (box_hit && start < 0) ? node + 1 : b.escape[node];
  }
  *out_t = best_prim >= 0 ? best_t : 3e38f;
  *out_prim = best_prim;
}

}  // namespace

void upsp_bvh_intersect(
    const float* bbox_min, const float* bbox_max, const int32_t* escape,
    const int32_t* leaf_start, const int32_t* leaf_count, const float* tri_v0,
    const float* tri_e1, const float* tri_e2, const int32_t* tri_id,
    int64_t n_nodes, const float* origins, const float* directions,
    int64_t n_rays, float* out_t, int32_t* out_prim) {
  BVHView b{bbox_min, bbox_max, escape, leaf_start, leaf_count,
            tri_v0, tri_e1, tri_e2, tri_id, n_nodes};
  const int n_threads = std::max(1u, std::thread::hardware_concurrency());
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r)
      intersect_one(b, origins + r * 3, directions + r * 3, out_t + r,
                    out_prim + r);
  };
  if (n_rays < 4096 || n_threads == 1) {
    work(0, n_rays);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t per = (n_rays + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * per;
    const int64_t r1 = std::min(n_rays, r0 + per);
    if (r0 < r1) pool.emplace_back(work, r0, r1);
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// blocked float32 transpose between flat files (upsp_matrix_transpose role)

int upsp_transpose_f32(const char* src_path, const char* dst_path,
                       int64_t rows, int64_t cols, int64_t block) {
  const int fin = open(src_path, O_RDONLY);
  if (fin < 0) return -1;
  const int fout = open(dst_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fout < 0) {
    close(fin);
    return -2;
  }
  if (ftruncate(fout, rows * cols * 4) != 0) {
    close(fin);
    close(fout);
    return -3;
  }
  std::vector<float> in(block * block), out(block * block);
  for (int64_t c0 = 0; c0 < cols; c0 += block) {
    const int64_t cw = std::min(block, cols - c0);
    for (int64_t r0 = 0; r0 < rows; r0 += block) {
      const int64_t rw = std::min(block, rows - r0);
      for (int64_t r = 0; r < rw; ++r) {
        const off_t off = ((r0 + r) * cols + c0) * 4;
        if (pread(fin, in.data() + r * cw, cw * 4, off) != cw * 4) {
          close(fin);
          close(fout);
          return -4;
        }
      }
      for (int64_t r = 0; r < rw; ++r)
        for (int64_t c = 0; c < cw; ++c) out[c * rw + r] = in[r * cw + c];
      for (int64_t c = 0; c < cw; ++c) {
        const off_t off = ((c0 + c) * rows + r0) * 4;
        if (pwrite(fout, out.data() + c * rw, rw * 4, off) != rw * 4) {
          close(fin);
          close(fout);
          return -5;
        }
      }
    }
  }
  close(fin);
  close(fout);
  return 0;
}

// ---------------------------------------------------------------------------
// asynchronous positioned-write queue (write-behind)

namespace {

struct AsyncWriter {
  int fd = -1;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::pair<int64_t, std::vector<uint8_t>>> queue;
  std::atomic<bool> stop{false};
  std::atomic<int> errors{0};
  std::atomic<int64_t> pending{0};

  void run() {
    for (;;) {
      std::pair<int64_t, std::vector<uint8_t>> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !queue.empty(); });
        if (queue.empty()) {
          if (stop.load()) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
      }
      const auto& buf = job.second;
      // pwrite may legally write fewer bytes than asked (EINTR, and any
      // single write is capped at ~2^31 bytes by the kernel — a 65k-node
      // x 50k-frame phase-2 block is ~13 GB): loop until done.
      size_t done = 0;
      while (done < buf.size()) {
        ssize_t n = pwrite(fd, buf.data() + done, buf.size() - done,
                           job.first + static_cast<int64_t>(done));
        if (n < 0) {
          if (errno == EINTR) continue;
          errors.fetch_add(1);
          break;
        }
        done += static_cast<size_t>(n);
      }
      pending.fetch_sub(1);
      cv.notify_all();
    }
  }
};

}  // namespace

void* upsp_awrite_open(const char* path) {
  auto* w = new AsyncWriter();
  w->fd = open(path, O_WRONLY | O_CREAT, 0644);
  if (w->fd < 0) {
    delete w;
    return nullptr;
  }
  w->worker = std::thread([w] { w->run(); });
  return w;
}

int upsp_awrite_submit(void* handle, int64_t offset, const uint8_t* data,
                       int64_t n_bytes) {
  auto* w = static_cast<AsyncWriter*>(handle);
  if (!w) return -1;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.emplace_back(offset,
                          std::vector<uint8_t>(data, data + n_bytes));
    w->pending.fetch_add(1);
  }
  w->cv.notify_all();
  return 0;
}

int upsp_awrite_close(void* handle) {
  auto* w = static_cast<AsyncWriter*>(handle);
  if (!w) return -1;
  {
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv.wait(lk, [&] { return w->queue.empty() && w->pending.load() == 0; });
    w->stop.store(true);
  }
  w->cv.notify_all();
  w->worker.join();
  close(w->fd);
  const int errs = w->errors.load();
  delete w;
  return errs == 0 ? 0 : -2;
}

}  // extern "C"
