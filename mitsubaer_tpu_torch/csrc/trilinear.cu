// Kernel A: trilinear density lookup at N world points from a dense grid.
//
// Replaces mitsubaer_tpu/models/medium.py::DensityBricks.lookup as a whole:
// the gather of 8x4x4 apron bricks plus the Pallas _trilinear_brick_kernel
// (medium.py:118, launched at :167). That design served the TPU's fixed
// per-row gather cost and its VPU; here each thread makes the 8 corner loads
// of its point straight from the (nz, ny, nx) float32 grid. A 64^3 grid is
// 1 MB and stays in the 50 MB L2, so the kernel is bound by the latency of
// those scattered loads; consecutive points of a ray batch are near each
// other, which keeps the loads mostly in cache.
//
// Arithmetic follows models/medium.py::trilinear_lookup_plain operation for
// operation (cell = clip(floor(x), 0, res-2), t = x - cell, zero outside the
// AABB); it is compiled without fused multiply-add so it rounds the same way.
#include <cuda_runtime.h>

namespace {

__global__ void trilinear_kernel(const float* __restrict__ p,
                                 const float* __restrict__ grid,
                                 const float* __restrict__ aabb6,
                                 float* __restrict__ out, int n, int nx,
                                 int ny, int nz) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int res_i[3] = {nx, ny, nz};
  float t[3];
  int c[3];
  bool inside = true;
  for (int k = 0; k < 3; ++k) {
    float res = (float)res_i[k];
    float h = (aabb6[3 + k] - aabb6[k]) / fmaxf(res - 1.0f, 1.0f);
    float v = (p[3 * i + k] - aabb6[k]) / h;
    inside = inside && (v >= 0.0f) && (v <= res - 1.0f);
    v = fminf(fmaxf(v, 0.0f), res - 1.0f);
    float cell = fminf(fmaxf(floorf(v), 0.0f), fmaxf(res - 2.0f, 0.0f));
    c[k] = (int)cell;
    t[k] = v - cell;
  }
  auto at = [&](int dz, int dy, int dx) {
    int iz = min(max(c[2] + dz, 0), nz - 1);
    int iy = min(max(c[1] + dy, 0), ny - 1);
    int ix = min(max(c[0] + dx, 0), nx - 1);
    return __ldg(grid + ((long long)iz * ny + iy) * nx + ix);
  };
  float tx = t[0], ty = t[1], tz = t[2];
  float c00 = at(0, 0, 0) * (1.0f - tx) + at(0, 0, 1) * tx;
  float c01 = at(0, 1, 0) * (1.0f - tx) + at(0, 1, 1) * tx;
  float c10 = at(1, 0, 0) * (1.0f - tx) + at(1, 0, 1) * tx;
  float c11 = at(1, 1, 0) * (1.0f - tx) + at(1, 1, 1) * tx;
  float c0 = c00 * (1.0f - ty) + c01 * ty;
  float c1 = c10 * (1.0f - ty) + c11 * ty;
  float val = c0 * (1.0f - tz) + c1 * tz;
  out[i] = inside ? val : 0.0f;
}

}  // namespace

extern "C" int mk_trilinear_lookup(const float* p, const float* grid,
                                   const float* aabb6, float* out, int n,
                                   int nx, int ny, int nz, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  trilinear_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p, grid, aabb6, out, n, nx, ny, nz);
  return (int)cudaGetLastError();
}

extern "C" const char* mk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
