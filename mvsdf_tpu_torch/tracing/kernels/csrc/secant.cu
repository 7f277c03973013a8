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
// What bounds it: operations, and below a few thousand rays the chain. Each
// step is one full SDF-MLP evaluation per ray (~3.67 MFLOP at full width)
// against 36 bytes of input and 4 of output per ray, far above the card's
// ridge point; but the steps of a ray depend on each other, so a launch
// takes at least n_steps evaluations of one tile, however few rays it has.
//
// Design: a block owns 64 rays, the rows of one tensor-core SDF-MLP tile
// (mlp_tile_tc.cuh), keeps their brackets in shared memory, and runs the
// steps as a loop in the block: thread r < 64 writes ray r's point, the
// consumers write the points' positional encoding and evaluate the tile,
// and thread r updates its bracket. The producer thread streams the
// weights n_steps times without waiting to be told: the count is known, so
// the next step's first tiles arrive while the brackets are updated. The
// whole refinement is one launch instead of one per step. Rows past n are
// zero and never written.
//
// Count entry (secant_count_forward): the grid covers a fixed capacity of
// rays and the kernel reads the number of rays to refine from device
// memory, so a CUDA graph can replay the launch for whatever count the
// step's compaction left there. Blocks past the count exit at once; the
// rays below it are refined as by the plain entry, bit for bit.
#include "mlp_tile_tc.cuh"

namespace {

using tc::CONSUMERS;
using tc::TM;

__device__ __forceinline__ float z_of(float sl, float sh, float zl,
                                      float zh) {
  float denom = sh - sl;
  if (fabsf(denom) < 1e-12f) denom = denom < 0.f ? -1e-12f : 1e-12f;
  return __fadd_rn(__fdiv_rn(__fmul_rn(-sl, zh - zl), denom), zl);
}

template <int NWG>
__global__ void __launch_bounds__(tc::THREADS, 1)
secant_kernel(const float* __restrict__ org, const float* __restrict__ dirs,
              const float* __restrict__ z_lo, const float* __restrict__ z_hi,
              const float* __restrict__ s_lo, const float* __restrict__ s_hi,
              int cap, const int* __restrict__ count, int multires,
              int n_steps, float* __restrict__ out, tc::Weights w,
              int stages) {
  int n = cap;
  if (count != nullptr) {
    const int c = *count;
    n = c < 0 ? 0 : (c < cap ? c : cap);
  }
  if ((long long)blockIdx.x * TM >= n) return;
  __shared__ float o[TM * 3], d[TM * 3];
  __shared__ float zl[TM], zh[TM], sl[TM], sh[TM], zp[TM];
  const tc::Tile tile = tc::tile_init<NWG>(w, stages);
  const int tid = threadIdx.x;
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      tc::RingPos pos = tc::producer_start();
      for (int s = 0; s < n_steps; ++s) tc::produce_pass<NWG>(tile, w, pos);
    }
    return;
  }
  const long long row0 = (long long)blockIdx.x * TM;
  const long long row = row0 + tid;
  // org + z_pred dirs of ray tid, rounded as the plain version
  auto point = [&]() {
    for (int k = 0; k < 3; ++k)
      tile.xyz[3 * tid + k] =
          __fadd_rn(o[3 * tid + k], __fmul_rn(zp[tid], d[3 * tid + k]));
  };
  if (tid < TM) {
    const bool ok = row < n;
    for (int k = 0; k < 3; ++k) {
      o[3 * tid + k] = ok ? org[3 * row + k] : 0.f;
      d[3 * tid + k] = ok ? dirs[3 * row + k] : 0.f;
    }
    zl[tid] = ok ? z_lo[row] : 0.f;
    zh[tid] = ok ? z_hi[row] : 0.f;
    sl[tid] = ok ? s_lo[row] : 0.f;
    sh[tid] = ok ? s_hi[row] : 0.f;
    zp[tid] = z_of(sl[tid], sh[tid], zl[tid], zh[tid]);
    point();
  }
  tc::RingPos pos = tc::consumer_start();
  for (int s = 0; s < n_steps; ++s) {
    tc::consume_eval<NWG>(tile, w, pos, [&](const tc::PeTile& t) {
      tc::consumer_sync();  // the points are written
      tc::pe_from_points(t.xyz, multires, w.d_pe, t);
    });
    if (tid < TM) {
      const float v = tc::tile_sdf(tile, w, tid);
      if (v > 0.f) {
        zl[tid] = zp[tid];
        sl[tid] = v;
      }
      if (v < 0.f) {
        zh[tid] = zp[tid];
        sh[tid] = v;
      }
      zp[tid] = z_of(sl[tid], sh[tid], zl[tid], zh[tid]);
      point();
    }
  }
  if (tid < TM && row < n) out[row] = zp[tid];
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Device pointers to contiguous f32 arrays: org, dirs (n, 3);
// z_lo, z_hi, s_lo, s_hi (n); the weights as sdf_mlp_forward takes them
// (d_pe must be 3 (1 + 2 multires)); out (n) receives z_pred. `count` is
// null, or a device int: then only the first *count rays (at most n) are
// refined and written.
int secant_count_forward(const float* org, const float* dirs,
                         const float* z_lo, const float* z_hi,
                         const float* s_lo, const float* s_hi, int n,
                         const int* count, int multires, int n_steps,
                         int d_pe, int HP, int n_hid, unsigned skip_mask,
                         const void* w_stream, const float* w_vec,
                         const float* b_out, float* out, void* stream) {
  if (n <= 0) return 0;
  const tc::Weights w{(const __nv_bfloat16*)w_stream, w_vec, b_out, d_pe,
                      n_hid, skip_mask};
  if (!tc::weights_ok(w) || multires < 0 || n_steps < 0 ||
      d_pe != 3 * (1 + 2 * multires))
    return (int)cudaErrorInvalidValue;
  return tc::dispatch_width(HP, [&](auto nwg) {
    return tc::launch(secant_kernel<decltype(nwg)::value>, HP, w,
                      (n + TM - 1) / TM, stream, org, dirs, z_lo, z_hi, s_lo,
                      s_hi, n, count, multires, n_steps, out);
  });
}

int secant_forward(const float* org, const float* dirs, const float* z_lo,
                   const float* z_hi, const float* s_lo, const float* s_hi,
                   int n, int multires, int n_steps, int d_pe, int HP,
                   int n_hid, unsigned skip_mask, const void* w_stream,
                   const float* w_vec, const float* b_out, float* out,
                   void* stream) {
  return secant_count_forward(org, dirs, z_lo, z_hi, s_lo, s_hi, n, nullptr,
                              multires, n_steps, d_pe, HP, n_hid, skip_mask,
                              w_stream, w_vec, b_out, out, stream);
}

}  // extern "C"
