// Fused bracketed secant for the no-grad sphere trace, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mvsdf_tpu/tracing/pallas/secant_kernel.py:137
// (pallas_secant, body _make_secant_kernel): all n_steps secant steps of a
// ray in one launch. Each step evaluates the SDF at org + z_pred dirs,
// moves the bracket end whose SDF has the same sign, and proposes
// z_pred = -s_lo (z_hi - z_lo) / (s_hi - s_lo) + z_lo, the denominator kept
// at least 1e-12 in magnitude, as tracing/sphere_trace._secant does.
//
// What bounds it: operations. Each step is one full SDF-MLP evaluation per
// ray (~3.67 MFLOP at full width) against 36 bytes of input and 4 of
// output per ray, far above the card's ridge point.
//
// Design: a block of 256 threads owns 32 rays, keeps their brackets in
// shared memory, and runs the steps as a loop in the block: a prologue
// writes the positional encoding of the 32 points into the MLP tile
// (mlp_tile.cuh), the tile evaluates their SDF, and 32 threads update the
// brackets. The whole refinement is one launch instead of one per step.
// Rows past n are zero and never written.
#include "mlp_tile.cuh"

namespace {

using mlp::THREADS;
using mlp::TM;

__device__ __forceinline__ float z_of(float sl, float sh, float zl,
                                      float zh) {
  float denom = sh - sl;
  if (fabsf(denom) < 1e-12f) denom = denom < 0.f ? -1e-12f : 1e-12f;
  return __fadd_rn(__fdiv_rn(__fmul_rn(-sl, zh - zl), denom), zl);
}

__global__ void __launch_bounds__(THREADS)
secant_kernel(const float* __restrict__ org, const float* __restrict__ dirs,
              const float* __restrict__ z_lo, const float* __restrict__ z_hi,
              const float* __restrict__ s_lo, const float* __restrict__ s_hi,
              int n, int multires, int n_steps, mlp::Weights w,
              float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const mlp::Tile t = mlp::make_tile(smem, w.H, w.d_pe);
  __shared__ float o[TM * 3], d[TM * 3], xyz[TM * 3];
  __shared__ float zl[TM], zh[TM], sl[TM], sh[TM], zp[TM];
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * TM;
  if (tid < TM * 3) {
    const long long i = row0 * 3 + tid;
    const bool ok = i < 3LL * n;
    o[tid] = ok ? org[i] : 0.f;
    d[tid] = ok ? dirs[i] : 0.f;
  }
  if (tid < TM) {
    const long long row = row0 + tid;
    const bool ok = row < n;
    zl[tid] = ok ? z_lo[row] : 0.f;
    zh[tid] = ok ? z_hi[row] : 0.f;
    sl[tid] = ok ? s_lo[row] : 0.f;
    sh[tid] = ok ? s_hi[row] : 0.f;
    zp[tid] = z_of(sl[tid], sh[tid], zl[tid], zh[tid]);
  }
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    if (tid < TM * 3)  // org + z_pred dirs, rounded as the plain version
      xyz[tid] = __fadd_rn(o[tid], __fmul_rn(zp[tid / 3], d[tid]));
    __syncthreads();
    mlp::pe_tile(xyz, multires, t);
    mlp::eval_tile(w, t);
    if (tid < TM) {
      const float v = t.sdf[tid];
      if (v > 0.f) {
        zl[tid] = zp[tid];
        sl[tid] = v;
      }
      if (v < 0.f) {
        zh[tid] = zp[tid];
        sh[tid] = v;
      }
      zp[tid] = z_of(sl[tid], sh[tid], zl[tid], zh[tid]);
    }
    __syncthreads();
  }
  const long long row = row0 + tid;
  if (tid < TM && row < n) out[row] = zp[tid];
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Device pointers to contiguous f32 arrays: org, dirs (n, 3);
// z_lo, z_hi, s_lo, s_hi (n); the weights as mlp::Weights lists them
// (d_pe must be 3 (1 + 2 multires)); out (n) receives z_pred.
int secant_forward(const float* org, const float* dirs, const float* z_lo,
                   const float* z_hi, const float* s_lo, const float* s_hi,
                   int n, int multires, int n_steps, int d_pe,
                   const float* w_in, const float* b_in, const float* w_hid,
                   const float* b_hid, int n_hid, unsigned skip_mask,
                   const float* w_skip_pe, const float* w_out,
                   const float* b_out, int H, float* out, void* stream) {
  if (n <= 0) return 0;
  const mlp::Weights w{w_in,  b_in, w_hid, b_hid, w_skip_pe, w_out,
                       b_out, d_pe, H,     n_hid, skip_mask};
  if (!mlp::weights_ok(w) || multires < 0 || n_steps < 0 ||
      d_pe != 3 * (1 + 2 * multires))
    return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = mlp::allow_tile_smem(secant_kernel, w, &smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((n + TM - 1) / TM);
  secant_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      org, dirs, z_lo, z_hi, s_lo, s_hi, n, multires, n_steps, w, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
