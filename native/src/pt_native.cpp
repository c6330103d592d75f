// Native host-runtime components of the path tracer.
//
// The reference implements its whole host runtime in C++ (scene/OBJ
// loading, image output — reference: src/scene.cpp, src/image.cpp); these
// are the framework's native equivalents for the host-side hot paths:
//
//   * pt_parse_obj   — fast Wavefront OBJ triangulation (the Python parser
//                      is the fallback; this one is ~50x faster on the
//                      80k-tri benchmark meshes)
//   * pt_build_bvh   — binned-SAH BVH with skip-pointer flattening,
//                      semantics identical to scene/bvh.py (leaf-contiguous
//                      triangle reorder, depth-first layout, escape
//                      indices) so the two builders are interchangeable
//   * pt_write_png   — zlib PNG encoder (reference writes PNG via stb,
//                      src/image.cpp:22-39)
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

struct ObjResult {
  int64_t tri_count;
  float* verts;    // [T,3,3]
  float* normals;  // [T,3,3]
  float* uvs;      // [T,3,2]
};

static inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t') p++;
  return p;
}

ObjResult* pt_parse_obj(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[size] = '\0';

  std::vector<float> vs, vns, vts;
  struct Corner { int v, t, n; };
  std::vector<Corner> face_corners;
  std::vector<int> face_sizes;

  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end) {
    p = skip_ws(p);
    if (p[0] == 'v' && p[1] == ' ') {
      char* q;
      float x = strtof(p + 2, &q);
      float y = strtof(q, &q);
      float z = strtof(q, &q);
      vs.push_back(x); vs.push_back(y); vs.push_back(z);
    } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') {
      char* q;
      float x = strtof(p + 3, &q);
      float y = strtof(q, &q);
      float z = strtof(q, &q);
      vns.push_back(x); vns.push_back(y); vns.push_back(z);
    } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
      char* q;
      float u = strtof(p + 3, &q);
      float v = strtof(q, &q);
      vts.push_back(u); vts.push_back(v);
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 2;
      int count = 0;
      while (true) {
        q = skip_ws(q);
        if (*q == '\n' || *q == '\r' || *q == '\0') break;
        char* e;
        long vi = strtol(q, &e, 10);
        long ti = 0, ni = 0;
        if (*e == '/') {
          if (e[1] == '/') {
            ni = strtol(e + 2, &e, 10);
          } else {
            ti = strtol(e + 1, &e, 10);
            if (*e == '/') ni = strtol(e + 1, &e, 10);
          }
        }
        face_corners.push_back({(int)vi, (int)ti, (int)ni});
        count++;
        q = e;
      }
      face_sizes.push_back(count);
    }
    while (p < end && *p != '\n') p++;
    p++;
  }

  const int64_t nv = (int64_t)vs.size() / 3;
  const int64_t nn = (int64_t)vns.size() / 3;
  const int64_t nt = (int64_t)vts.size() / 2;
  auto rv = [&](int idx) { return idx > 0 ? idx - 1 : (int)(nv + idx); };
  auto rn = [&](int idx) { return idx > 0 ? idx - 1 : (int)(nn + idx); };
  auto rt = [&](int idx) { return idx > 0 ? idx - 1 : (int)(nt + idx); };

  int64_t tris = 0;
  for (int s : face_sizes) tris += std::max(0, s - 2);

  ObjResult* out = (ObjResult*)malloc(sizeof(ObjResult));
  out->tri_count = tris;
  out->verts = (float*)malloc(tris * 9 * sizeof(float));
  out->normals = (float*)malloc(tris * 9 * sizeof(float));
  out->uvs = (float*)malloc(tris * 6 * sizeof(float));

  int64_t corner_base = 0, t = 0;
  for (int s : face_sizes) {
    for (int k = 1; k + 1 < s; k++) {
      const Corner c[3] = {face_corners[corner_base],
                           face_corners[corner_base + k],
                           face_corners[corner_base + k + 1]};
      float pv[3][3];
      for (int i = 0; i < 3; i++) {
        const float* v = &vs[3 * rv(c[i].v)];
        pv[i][0] = v[0]; pv[i][1] = v[1]; pv[i][2] = v[2];
        memcpy(&out->verts[t * 9 + i * 3], v, 3 * sizeof(float));
      }
      bool has_n = nn > 0 && c[0].n && c[1].n && c[2].n;
      if (has_n) {
        for (int i = 0; i < 3; i++)
          memcpy(&out->normals[t * 9 + i * 3], &vns[3 * rn(c[i].n)],
                 3 * sizeof(float));
      } else {
        float e1[3] = {pv[1][0] - pv[0][0], pv[1][1] - pv[0][1],
                       pv[1][2] - pv[0][2]};
        float e2[3] = {pv[2][0] - pv[0][0], pv[2][1] - pv[0][1],
                       pv[2][2] - pv[0][2]};
        float fn[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                       e1[2] * e2[0] - e1[0] * e2[2],
                       e1[0] * e2[1] - e1[1] * e2[0]};
        float len = sqrtf(fn[0] * fn[0] + fn[1] * fn[1] + fn[2] * fn[2]);
        if (len > 0) { fn[0] /= len; fn[1] /= len; fn[2] /= len; }
        else { fn[0] = 0; fn[1] = 1; fn[2] = 0; }
        for (int i = 0; i < 3; i++)
          memcpy(&out->normals[t * 9 + i * 3], fn, 3 * sizeof(float));
      }
      bool has_t = nt > 0 && c[0].t && c[1].t && c[2].t;
      for (int i = 0; i < 3; i++) {
        if (has_t) {
          memcpy(&out->uvs[t * 6 + i * 2], &vts[2 * rt(c[i].t)],
                 2 * sizeof(float));
        } else {
          out->uvs[t * 6 + i * 2] = 0.f;
          out->uvs[t * 6 + i * 2 + 1] = 0.f;
        }
      }
      t++;
    }
    corner_base += s;
  }
  return out;
}

void pt_free_obj(ObjResult* r) {
  if (!r) return;
  free(r->verts);
  free(r->normals);
  free(r->uvs);
  free(r);
}

// ---------------------------------------------------------------------------
// BVH build — binned SAH, skip-pointer flattening (mirror of scene/bvh.py)
// ---------------------------------------------------------------------------

struct BvhResult {
  int64_t node_count;
  int64_t* perm;       // [T] triangle reorder
  float* node_lo;      // [B,3]
  float* node_hi;      // [B,3]
  int32_t* node_start; // [B]
  int32_t* node_count_arr;  // [B]
  int32_t* node_skip;  // [B]
  int32_t* node_right; // [B]
};

namespace {

constexpr int SAH_BINS = 16;

struct Builder {
  const float* tri_lo;
  const float* tri_hi;
  std::vector<float> centroid;
  int leaf_k;
  std::vector<int64_t> perm;
  std::vector<float> lo, hi;
  std::vector<int32_t> start, count, skip, right;
  static constexpr int32_t EXIT = -2;

  void bounds(const std::vector<int64_t>& order, float* blo, float* bhi) {
    for (int c = 0; c < 3; c++) { blo[c] = 1e30f; bhi[c] = -1e30f; }
    for (int64_t idx : order) {
      for (int c = 0; c < 3; c++) {
        blo[c] = std::min(blo[c], tri_lo[idx * 3 + c]);
        bhi[c] = std::max(bhi[c], tri_hi[idx * 3 + c]);
      }
    }
  }

  static float surface(const float* lo_, const float* hi_) {
    float d[3] = {std::max(hi_[0] - lo_[0], 0.f),
                  std::max(hi_[1] - lo_[1], 0.f),
                  std::max(hi_[2] - lo_[2], 0.f)};
    return 2.f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
  }

  void partition(const std::vector<int64_t>& order,
                 std::vector<int64_t>& l, std::vector<int64_t>& r) {
    const int64_t n = order.size();
    float clo[3] = {1e30f, 1e30f, 1e30f}, chi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t idx : order) {
      for (int c = 0; c < 3; c++) {
        clo[c] = std::min(clo[c], centroid[idx * 3 + c]);
        chi[c] = std::max(chi[c], centroid[idx * 3 + c]);
      }
    }
    int axis = 0;
    float extent = chi[0] - clo[0];
    for (int c = 1; c < 3; c++) {
      if (chi[c] - clo[c] > extent) { extent = chi[c] - clo[c]; axis = c; }
    }

    double best_cost = 1e300;
    int best_b = -1;
    std::vector<int> bins(n);
    if (extent > 1e-12f) {
      for (int64_t i = 0; i < n; i++) {
        float rel = (centroid[order[i] * 3 + axis] - clo[axis]) / extent;
        bins[i] = std::min((int)(rel * SAH_BINS), SAH_BINS - 1);
      }
      // prefix/suffix bounds over bins
      float blo[SAH_BINS][3], bhi[SAH_BINS][3];
      int64_t bcount[SAH_BINS] = {0};
      for (int b = 0; b < SAH_BINS; b++)
        for (int c = 0; c < 3; c++) { blo[b][c] = 1e30f; bhi[b][c] = -1e30f; }
      for (int64_t i = 0; i < n; i++) {
        int b = bins[i];
        bcount[b]++;
        for (int c = 0; c < 3; c++) {
          blo[b][c] = std::min(blo[b][c], tri_lo[order[i] * 3 + c]);
          bhi[b][c] = std::max(bhi[b][c], tri_hi[order[i] * 3 + c]);
        }
      }
      float plo[3], phi[3];
      float suf_sa[SAH_BINS + 1];
      int64_t suf_n[SAH_BINS + 1];
      // suffix pass
      for (int c = 0; c < 3; c++) { plo[c] = 1e30f; phi[c] = -1e30f; }
      suf_sa[SAH_BINS] = 0; suf_n[SAH_BINS] = 0;
      for (int b = SAH_BINS - 1; b >= 0; b--) {
        for (int c = 0; c < 3; c++) {
          plo[c] = std::min(plo[c], blo[b][c]);
          phi[c] = std::max(phi[c], bhi[b][c]);
        }
        suf_sa[b] = surface(plo, phi);
        suf_n[b] = suf_n[b + 1] + bcount[b];
      }
      // prefix pass + cost
      for (int c = 0; c < 3; c++) { plo[c] = 1e30f; phi[c] = -1e30f; }
      int64_t pre_n = 0;
      for (int b = 0; b < SAH_BINS - 1; b++) {
        for (int c = 0; c < 3; c++) {
          plo[c] = std::min(plo[c], blo[b][c]);
          phi[c] = std::max(phi[c], bhi[b][c]);
        }
        pre_n += bcount[b];
        if (pre_n == 0 || pre_n == n) continue;
        double cost = (double)surface(plo, phi) * pre_n
                      + (double)suf_sa[b + 1] * (n - pre_n);
        if (cost < best_cost) { best_cost = cost; best_b = b; }
      }
    }

    l.clear(); r.clear();
    if (best_b >= 0) {
      for (int64_t i = 0; i < n; i++) {
        (bins[i] <= best_b ? l : r).push_back(order[i]);
      }
    } else {
      std::vector<int64_t> srt = order;
      std::stable_sort(srt.begin(), srt.end(), [&](int64_t a, int64_t b2) {
        return centroid[a * 3 + axis] < centroid[b2 * 3 + axis];
      });
      l.assign(srt.begin(), srt.begin() + n / 2);
      r.assign(srt.begin() + n / 2, srt.end());
    }
  }

  void patch_skip(int32_t sub_root, int32_t skip_to) {
    std::vector<int32_t> stack = {sub_root};
    while (!stack.empty()) {
      int32_t i = stack.back();
      stack.pop_back();
      if (skip[i] == -1) skip[i] = skip_to;
      if (count[i] == 0 && right[i] >= 0) {
        stack.push_back(i + 1);
        stack.push_back(right[i]);
      }
    }
  }

  int32_t flatten(std::vector<int64_t>& order, int32_t skip_to) {
    int32_t idx = (int32_t)lo.size() / 3;
    float blo[3], bhi[3];
    bounds(order, blo, bhi);
    lo.insert(lo.end(), blo, blo + 3);
    hi.insert(hi.end(), bhi, bhi + 3);
    start.push_back(-1);
    count.push_back(0);
    skip.push_back(skip_to);
    right.push_back(-1);
    if ((int64_t)order.size() <= leaf_k) {
      start[idx] = (int32_t)perm.size();
      count[idx] = (int32_t)order.size();
      perm.insert(perm.end(), order.begin(), order.end());
      return idx;
    }
    std::vector<int64_t> l, r;
    partition(order, l, r);
    order.clear();
    order.shrink_to_fit();
    int32_t left_idx = flatten(l, -1);
    int32_t right_idx = flatten(r, skip_to);
    right[idx] = right_idx;
    patch_skip(left_idx, right_idx);
    return idx;
  }
};

}  // namespace

BvhResult* pt_build_bvh(const float* verts /*[T,3,3]*/, int64_t tri_count,
                        int32_t leaf_k) {
  Builder b;
  std::vector<float> tlo(tri_count * 3), thi(tri_count * 3);
  b.centroid.resize(tri_count * 3);
  for (int64_t t = 0; t < tri_count; t++) {
    for (int c = 0; c < 3; c++) {
      float v0 = verts[t * 9 + 0 + c];
      float v1 = verts[t * 9 + 3 + c];
      float v2 = verts[t * 9 + 6 + c];
      float lo_ = std::min(v0, std::min(v1, v2));
      float hi_ = std::max(v0, std::max(v1, v2));
      tlo[t * 3 + c] = lo_;
      thi[t * 3 + c] = hi_;
      b.centroid[t * 3 + c] = 0.5f * (lo_ + hi_);
    }
  }
  b.tri_lo = tlo.data();
  b.tri_hi = thi.data();
  b.leaf_k = leaf_k;

  std::vector<int64_t> order(tri_count);
  for (int64_t i = 0; i < tri_count; i++) order[i] = i;
  b.flatten(order, Builder::EXIT);

  BvhResult* out = (BvhResult*)malloc(sizeof(BvhResult));
  const int64_t nb = (int64_t)b.count.size();
  out->node_count = nb;
  out->perm = (int64_t*)malloc(tri_count * sizeof(int64_t));
  memcpy(out->perm, b.perm.data(), tri_count * sizeof(int64_t));
  out->node_lo = (float*)malloc(nb * 3 * sizeof(float));
  memcpy(out->node_lo, b.lo.data(), nb * 3 * sizeof(float));
  out->node_hi = (float*)malloc(nb * 3 * sizeof(float));
  memcpy(out->node_hi, b.hi.data(), nb * 3 * sizeof(float));
  out->node_start = (int32_t*)malloc(nb * sizeof(int32_t));
  memcpy(out->node_start, b.start.data(), nb * sizeof(int32_t));
  out->node_count_arr = (int32_t*)malloc(nb * sizeof(int32_t));
  memcpy(out->node_count_arr, b.count.data(), nb * sizeof(int32_t));
  out->node_skip = (int32_t*)malloc(nb * sizeof(int32_t));
  for (int64_t i = 0; i < nb; i++) {
    out->node_skip[i] = b.skip[i] == Builder::EXIT ? -1 : b.skip[i];
  }
  out->node_right = (int32_t*)malloc(nb * sizeof(int32_t));
  memcpy(out->node_right, b.right.data(), nb * sizeof(int32_t));
  return out;
}

void pt_free_bvh(BvhResult* r) {
  if (!r) return;
  free(r->perm);
  free(r->node_lo);
  free(r->node_hi);
  free(r->node_start);
  free(r->node_count_arr);
  free(r->node_skip);
  free(r->node_right);
  free(r);
}

// ---------------------------------------------------------------------------
// PNG writer (8-bit RGB, zlib-compressed, no gamma — reference
// src/image.cpp:22-39 semantics are applied by the caller)
// ---------------------------------------------------------------------------

static void put32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24); v.push_back(x >> 16); v.push_back(x >> 8);
  v.push_back(x);
}

static void chunk(std::vector<uint8_t>& out, const char* tag,
                  const uint8_t* data, size_t len) {
  put32(out, (uint32_t)len);
  size_t tag_at = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0, out.data() + tag_at, (uInt)(4 + len));
  put32(out, crc);
}

int pt_write_png(const char* path, int32_t w, int32_t h,
                 const uint8_t* rgb) {
  std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * 3));
  for (int y = 0; y < h; y++) {
    raw[(size_t)y * (1 + (size_t)w * 3)] = 0;
    memcpy(&raw[(size_t)y * (1 + (size_t)w * 3) + 1],
           &rgb[(size_t)y * w * 3], (size_t)w * 3);
  }
  uLongf comp_cap = compressBound((uLong)raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), (uLong)raw.size(), 6)
      != Z_OK) {
    return -1;
  }

  std::vector<uint8_t> out;
  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = w >> 24; ihdr[1] = w >> 16; ihdr[2] = w >> 8; ihdr[3] = w;
  ihdr[4] = h >> 24; ihdr[5] = h >> 16; ihdr[6] = h >> 8; ihdr[7] = h;
  ihdr[8] = 8; ihdr[9] = 2; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  chunk(out, "IHDR", ihdr, 13);
  chunk(out, "IDAT", comp.data(), comp_cap);
  chunk(out, "IEND", nullptr, 0);

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size() ? 0 : -1;
}

}  // extern "C"
