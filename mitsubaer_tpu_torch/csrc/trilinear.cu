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
//
// Kernel A': the gradient of kernel A's lookups with respect to the
// (nz, ny, nx) grid, for the training path (models/medium.py::
// TrilinearLookup). The JAX package has no backward Pallas kernel: it
// differentiates its unfused lookup with XLA (medium.py:206-252,
// fused=False). Each point inside the AABB adds grad_out * w_k to its 8
// corner voxels of the zeroed f32 grid with atomicAdd; the cell, t, the
// clamps and the zero outside the AABB are kernel A's, and the corner
// indices are clamped to res - 1, so on a one-voxel axis two coinciding
// corners add both weights to one voxel. The weights are formed in the order
// autograd forms them through the lerps ((g (1-tz)) (1-ty)) (1-tx), so each
// term equals models/medium.py::trilinear_lookup_backward_plain's; the sums'
// order, and so their last bits, vary with the atomics' order.
//
// What bounds it: 12 B of point and 4 B of gradient a point plus the grid
// read and written once (the zeroing, by the wrapper) at 3.35 TB/s. Eight
// atomics a point go to L2; points that cluster in a few cells contend on
// the same addresses and serialise there. One thread a point, global
// atomics: the simple design first. A warp-aggregated or shared-memory
// privatised scatter is the next step if the clustered times show
// contention.
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

// Kernel A's cell arithmetic for point i: returns false outside the AABB,
// else the cell c (x, y, z) and its fractions t.
__device__ __forceinline__ bool cell_of(const float* __restrict__ p,
                                        const float* __restrict__ aabb6,
                                        int i, const int res_i[3], int c[3],
                                        float t[3]) {
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
  return inside;
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
  if (!cell_of(p, aabb6, i, res_i, c, t)) {
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

__global__ void __launch_bounds__(kThreads)
    trilinear_backward_kernel(const float* __restrict__ p,
                              const float* __restrict__ grad_out,
                              const float* __restrict__ aabb6,
                              float* __restrict__ grad_grid, int n, int nx,
                              int ny, int nz) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int res_i[3] = {nx, ny, nz};
  float t[3];
  int c[3];
  if (!cell_of(p, aabb6, i, res_i, c, t)) return;
  const float g = grad_out[i];
  if (g == 0.0f) return;  // adds nothing (a NaN or inf still adds)
  const long long x[2] = {c[0], min(c[0] + 1, nx - 1)};
  const long long y[2] = {c[1], min(c[1] + 1, ny - 1)};
  const long long z[2] = {c[2], min(c[2] + 1, nz - 1)};
  const float tx = t[0], ty = t[1], tz = t[2];
  const float gz[2] = {g * (1.0f - tz), g * tz};
  for (int dz = 0; dz < 2; ++dz) {
    const float gzy[2] = {gz[dz] * (1.0f - ty), gz[dz] * ty};
    for (int dy = 0; dy < 2; ++dy) {
      float* row = grad_grid + (z[dz] * ny + y[dy]) * nx;
      atomicAdd(row + x[0], gzy[dy] * (1.0f - tx));
      atomicAdd(row + x[1], gzy[dy] * tx);
    }
  }
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

// grad_grid: the zeroed (nz, ny, nx) float32 gradient of the grid; each point
// inside the AABB adds grad_out[i] times its 8 trilinear weights.
extern "C" int mk_trilinear_lookup_backward(const float* p,
                                            const float* grad_out,
                                            const float* aabb6,
                                            float* grad_grid, int n, int nx,
                                            int ny, int nz, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  trilinear_backward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, grad_out, aabb6, grad_grid, n, nx, ny, nz);
  return (int)cudaGetLastError();
}

extern "C" const char* mk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
