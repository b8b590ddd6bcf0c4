// Kernel A: trilinear density lookup at N world points from a table of
// corner-packed cells.
//
// Replaces mitsubaer_tpu/models/medium.py::DensityBricks.lookup as a whole:
// the gather of 8x4x4 apron bricks plus the Pallas _trilinear_brick_kernel
// (medium.py:118, launched at :167). That design served the TPU's fixed
// per-row gather cost and its VPU.
//
// What bounds it on an H100. The function's own bytes (12 B of point in, 4 B
// out, the grid once) set a bound of ~5 us at 10^6 points. Read from the
// dense (nz, ny, nx) grid, the 8 corners of a point lie in 4 to 8 different
// 32-byte sectors (y-neighbours 4 nx bytes apart, z-neighbours 4 nx ny), and
// at 64^3 the grid is larger than an SM's L1, so those sectors come from L2:
// the gather traffic, not the function's bytes, sets the time.
//
// Design. models/medium.py::cell_table packs, once per grid, each cell's 8
// corner values into one record in the order the lerp reads them ((dz, dy,
// dx) = 000, 001, 010, 011, 100, 101, 110, 111; corner indices clamped to
// res - 1). An f32 record is 32 B, one aligned sector, read with two 16-byte
// loads; a bf16 record (for grids already rounded to bf16, so exact) is 16 B,
// one 16-byte load. A point then costs one sector of L2 traffic. Points
// outside the AABB return 0 without a load. The table holds
// max(nz-1,1) max(ny-1,1) max(nx-1,1) records: about 8x the grid's f32 bytes
// (8.0 MB at 64^3), 4x in bf16 (4.0 MB), both well inside the 50 MB L2.
//
// Arithmetic follows models/medium.py::trilinear_lookup_plain operation for
// operation (cell = clip(floor(x), 0, res-2), t = x - cell, zero outside the
// AABB); it is compiled without fused multiply-add so it rounds the same way,
// and the bf16 values widen to f32 exactly.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load_record(const float* cells, long long rec,
                                            float r[8]) {
  const float4* q = reinterpret_cast<const float4*>(cells) + 2 * rec;
  float4 a = __ldg(q), b = __ldg(q + 1);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void load_record(const uint16_t* cells,
                                            long long rec, float r[8]) {
  uint4 q = __ldg(reinterpret_cast<const uint4*>(cells) + rec);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  for (int k = 0; k < 4; ++k) {  // little-endian: the lower half comes first
    r[2 * k] = __uint_as_float(w[k] << 16);
    r[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <typename Cell>
__global__ void __launch_bounds__(kThreads)
    trilinear_kernel(const float* __restrict__ p,
                     const Cell* __restrict__ cells,
                     const float* __restrict__ aabb6, float* __restrict__ out,
                     int n, int nx, int ny, int nz) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int res_i[3] = {nx, ny, nz};
  float t[3];
  int c[3];
  bool inside = true;
  for (int k = 0; k < 3; ++k) {
    float res = (float)res_i[k];
    float lo = __ldg(aabb6 + k);
    float h = (__ldg(aabb6 + 3 + k) - lo) / fmaxf(res - 1.0f, 1.0f);
    float v = (p[3 * i + k] - lo) / h;
    inside = inside && (v >= 0.0f) && (v <= res - 1.0f);
    v = fminf(fmaxf(v, 0.0f), res - 1.0f);
    float cell = fminf(fmaxf(floorf(v), 0.0f), fmaxf(res - 2.0f, 0.0f));
    c[k] = (int)cell;
    t[k] = v - cell;
  }
  if (!inside) {
    out[i] = 0.0f;
    return;
  }
  const int cx = max(nx - 1, 1), cy = max(ny - 1, 1);
  float r[8];
  load_record(cells, ((long long)c[2] * cy + c[1]) * cx + c[0], r);
  float tx = t[0], ty = t[1], tz = t[2];
  float c00 = r[0] * (1.0f - tx) + r[1] * tx;
  float c01 = r[2] * (1.0f - tx) + r[3] * tx;
  float c10 = r[4] * (1.0f - tx) + r[5] * tx;
  float c11 = r[6] * (1.0f - tx) + r[7] * tx;
  float c0 = c00 * (1.0f - ty) + c01 * ty;
  float c1 = c10 * (1.0f - ty) + c11 * ty;
  out[i] = c0 * (1.0f - tz) + c1 * tz;
}

}  // namespace

// cells: (max(nz-1,1), max(ny-1,1), max(nx-1,1), 8) records, float32 or
// (bf16 != 0) bfloat16, 16-byte aligned.
extern "C" int mk_trilinear_lookup(const float* p, const void* cells,
                                   const float* aabb6, float* out, int n,
                                   int nx, int ny, int nz, int bf16,
                                   void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (bf16)
    trilinear_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        p, (const uint16_t*)cells, aabb6, out, n, nx, ny, nz);
  else
    trilinear_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        p, (const float*)cells, aabb6, out, n, nx, ny, nz);
  return (int)cudaGetLastError();
}

extern "C" const char* mk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
