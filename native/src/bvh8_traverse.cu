// 8-wide BVH traversal for NVIDIA Hopper, called from JAX through the XLA
// foreign function interface (ops/bvh8.py registers and calls it).
//
// One thread per ray, each with a private short stack. The tables are the
// host-packed 8-wide layout of ops/bvh8.pack_mesh8, read unchanged:
//
//   nodes_f [B8, 72] f32  child c box in cols [6c, 6c+6): lo.xyz, hi.xyz
//                         (NaN boxes in empty slots)
//   nodes_i [B8, 24] i32  col c: child c's stack entry (node row if
//                         interior, -(start*32+count)-2 if leaf, 0 empty);
//                         col 16: the axis the children are sorted along
//   tris    [T+8, 24] f32 v0, e1, e2, n0, n1, n2 (xyz each), uv0, uv1, uv2
//
// Two handlers: nearest hit, and any hit (NEE shadow rays: a ray stops at
// the first triangle closer than its bound). Outputs per ray: t (the bound
// itself on a miss), the interpolated smooth normal, the interpolated uv,
// and the local triangle index (-1 on a miss). A ray whose bound is <= 0
// is dead: it is not traversed and reports a miss.
//
// Built with full-precision float (no --use_fast_math) so the results
// agree with the plain XLA walk (ops/intersect.bvh_traverse).
//
//   make -C native cuda     -> native/build/libpt_cuda.so

#include <cstdint>
#include <initializer_list>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWidth = 8;
constexpr int kNodeF = 72;
constexpr int kNodeI = 24;
constexpr int kAxisCol = 16;
constexpr int kTriRow = 24;
// Must match ops/bvh8.STACK: the packer asserts every tree fits.
constexpr int kStack = 128;
// Pop cap: a malformed table can never spin a thread forever.
constexpr int kMaxPops = 1 << 20;
constexpr int kBlock = 128;

template <bool kAnyHit>
__global__ void Bvh8Kernel(int64_t n, const float* __restrict__ ox,
                           const float* __restrict__ oy,
                           const float* __restrict__ oz,
                           const float* __restrict__ dx,
                           const float* __restrict__ dy,
                           const float* __restrict__ dz,
                           const float* __restrict__ t_bound,
                           const float* __restrict__ nodes_f,
                           const int32_t* __restrict__ nodes_i,
                           const float* __restrict__ tris,
                           float* __restrict__ t_out,
                           float* __restrict__ nx_out,
                           float* __restrict__ ny_out,
                           float* __restrict__ nz_out,
                           float* __restrict__ u_out,
                           float* __restrict__ v_out,
                           int32_t* __restrict__ tri_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const float o[3] = {ox[i], oy[i], oz[i]};
  const float d[3] = {dx[i], dy[i], dz[i]};
  const float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
  float t_best = t_bound[i];
  float bu = 0.0f, bv = 0.0f;
  int32_t tri = -1;

  if (t_best > 0.0f) {
    int32_t stack[kStack];
    int sp = 0;
    stack[sp++] = 0;  // root row
    for (int pops = 0; sp > 0 && pops < kMaxPops; ++pops) {
      const int32_t e = stack[--sp];
      if (e >= 0) {
        const float* box = nodes_f + static_cast<int64_t>(e) * kNodeF;
        const int32_t* enc = nodes_i + static_cast<int64_t>(e) * kNodeI;
        // Children are sorted ascending along `axis`; the stack is LIFO,
        // so push far-first: descending slots when the ray runs toward
        // +axis, ascending when it runs toward -axis.
        const int32_t axis = enc[kAxisCol];
        const bool fwd = (axis == 0 ? d[0] : axis == 1 ? d[1] : d[2]) >= 0.0f;
#pragma unroll
        for (int k = 0; k < kWidth; ++k) {
          const int c = fwd ? kWidth - 1 - k : k;
          const int32_t child = enc[c];
          if (child == 0) continue;  // empty slot
          const float* b = box + 6 * c;
          const float t1x = (b[0] - o[0]) * inv[0];
          const float t2x = (b[3] - o[0]) * inv[0];
          const float t1y = (b[1] - o[1]) * inv[1];
          const float t2y = (b[4] - o[1]) * inv[1];
          const float t1z = (b[2] - o[2]) * inv[2];
          const float t2z = (b[5] - o[2]) * inv[2];
          const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                   fminf(t1z, t2z));
          const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                   fmaxf(t1z, t2z));
          if (tmax >= tmin && tmax > 0.0f && tmin < t_best && sp < kStack) {
            stack[sp++] = child;
          }
        }
      } else {
        const int32_t meta = -e - 2;
        const int32_t start = meta >> 5;
        const int32_t count = meta & 31;
        for (int k = 0; k < count; ++k) {
          const float* r = tris + static_cast<int64_t>(start + k) * kTriRow;
          const float e1x = r[3], e1y = r[4], e1z = r[5];
          const float e2x = r[6], e2y = r[7], e2z = r[8];
          const float pvx = d[1] * e2z - d[2] * e2y;
          const float pvy = d[2] * e2x - d[0] * e2z;
          const float pvz = d[0] * e2y - d[1] * e2x;
          const float det = e1x * pvx + e1y * pvy + e1z * pvz;
          if (!(fabsf(det) > 1e-12f)) continue;
          const float inv_det = 1.0f / det;
          const float tvx = o[0] - r[0];
          const float tvy = o[1] - r[1];
          const float tvz = o[2] - r[2];
          const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
          const float qvx = tvy * e1z - tvz * e1y;
          const float qvy = tvz * e1x - tvx * e1z;
          const float qvz = tvx * e1y - tvy * e1x;
          const float v = (d[0] * qvx + d[1] * qvy + d[2] * qvz) * inv_det;
          const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
          if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 1e-6f &&
              t < t_best) {
            t_best = t;
            bu = u;
            bv = v;
            tri = start + k;
          }
        }
        if (kAnyHit && tri >= 0) break;
      }
    }
  }

  float nx = 0.0f, ny = 0.0f, nz = 0.0f, uu = 0.0f, vv = 0.0f;
  if (tri >= 0) {
    const float* r = tris + static_cast<int64_t>(tri) * kTriRow;
    const float bw = 1.0f - bu - bv;
    nx = bw * r[9] + bu * r[12] + bv * r[15];
    ny = bw * r[10] + bu * r[13] + bv * r[16];
    nz = bw * r[11] + bu * r[14] + bv * r[17];
    uu = bw * r[18] + bu * r[20] + bv * r[22];
    vv = bw * r[19] + bu * r[21] + bv * r[23];
  }
  t_out[i] = t_best;
  nx_out[i] = nx;
  ny_out[i] = ny;
  nz_out[i] = nz;
  u_out[i] = uu;
  v_out[i] = vv;
  tri_out[i] = tri;
}

using F32 = ffi::Buffer<ffi::F32>;
using S32 = ffi::Buffer<ffi::S32>;
using F32Out = ffi::ResultBuffer<ffi::F32>;
using S32Out = ffi::ResultBuffer<ffi::S32>;

template <typename B>
bool HasCols(const B& buf, int64_t cols) {
  auto dims = buf.dimensions();
  return dims.size() == 2 && dims[1] == cols;
}

template <bool kAnyHit>
ffi::Error Bvh8Impl(cudaStream_t stream, F32 ox, F32 oy, F32 oz, F32 dx,
                    F32 dy, F32 dz, F32 t_bound, F32 nodes_f, S32 nodes_i,
                    F32 tris, F32Out t, F32Out nx, F32Out ny, F32Out nz,
                    F32Out u, F32Out v, S32Out tri) {
  const int64_t n = static_cast<int64_t>(ox.element_count());
  for (const F32* p : {&oy, &oz, &dx, &dy, &dz, &t_bound}) {
    if (static_cast<int64_t>(p->element_count()) != n) {
      return ffi::Error::InvalidArgument("ray planes differ in length");
    }
  }
  if (!HasCols(nodes_f, kNodeF) || !HasCols(nodes_i, kNodeI) ||
      !HasCols(tris, kTriRow) ||
      nodes_f.dimensions()[0] != nodes_i.dimensions()[0]) {
    return ffi::Error::InvalidArgument(
        "expected nodes_f [B,72], nodes_i [B,24], tris [T,24]");
  }
  if (n == 0) return ffi::Error::Success();
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  Bvh8Kernel<kAnyHit><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      n, ox.typed_data(), oy.typed_data(), oz.typed_data(), dx.typed_data(),
      dy.typed_data(), dz.typed_data(), t_bound.typed_data(),
      nodes_f.typed_data(), nodes_i.typed_data(), tris.typed_data(),
      t->typed_data(), nx->typed_data(), ny->typed_data(), nz->typed_data(),
      u->typed_data(), v->typed_data(), tri->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("bvh8 launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

#define PT_BVH8_BINDING                                                  \
  ffi::Ffi::Bind()                                                       \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()                          \
      .Arg<F32>() /* ox */                                               \
      .Arg<F32>() /* oy */                                               \
      .Arg<F32>() /* oz */                                               \
      .Arg<F32>() /* dx */                                               \
      .Arg<F32>() /* dy */                                               \
      .Arg<F32>() /* dz */                                               \
      .Arg<F32>() /* t_bound */                                          \
      .Arg<F32>() /* nodes_f */                                          \
      .Arg<S32>() /* nodes_i */                                          \
      .Arg<F32>() /* tris */                                             \
      .Ret<F32>() /* t */                                                \
      .Ret<F32>() /* nx */                                               \
      .Ret<F32>() /* ny */                                               \
      .Ret<F32>() /* nz */                                               \
      .Ret<F32>() /* u */                                                \
      .Ret<F32>() /* v */                                                \
      .Ret<S32>() /* tri */

XLA_FFI_DEFINE_HANDLER_SYMBOL(PtBvh8Nearest, Bvh8Impl<false>,
                              PT_BVH8_BINDING);
XLA_FFI_DEFINE_HANDLER_SYMBOL(PtBvh8AnyHit, Bvh8Impl<true>, PT_BVH8_BINDING);
