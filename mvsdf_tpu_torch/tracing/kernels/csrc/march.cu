// Fused bidirectional sphere-trace march for the no-grad trace,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mvsdf_tpu/tracing/pallas/march_kernel.py:258
// (pallas_sphere_trace, body _make_march_kernel): the whole march of a
// block of rays in one launch. A drop-in for tracing/sphere_trace.
// _sphere_trace: per iteration (sphere_tracing_iters of them) a mask update
// (lanes with |next| <= sdf_threshold stop), a step of the start march
// forward and the end march backward by the clipped SDF, and up to
// line_step_iters back-steps of (1 - line_step) 2^-j curr on the lanes that
// overshot (SDF < 0); a ray stops when its start passes its end; a final
// bookkeeping-only mask update. Outputs t_s, t_e and the start march's
// unfinished mask.
//
// What bounds it: operations. Every evaluation is one full SDF-MLP row
// (~3.67 MFLOP at full width) against 36 bytes of input and 9 of output per
// ray. How many rows a ray needs depends on the field, so the kernel adds
// the rows it evaluated and the rows whose value the march used to an
// optional int64 counter; the bound is reckoned from the latter.
//
// Design: a block of 256 threads owns 16 rays; their start and end points
// are the 32 rows of one MLP tile (mlp_tile.cuh), evaluated together as
// the TPU kernel stacked them. The march state (t2, unfin2, next2, curr2)
// lives in shared memory. The gates are those of the TPU kernel, each a
// block-wide vote (__syncthreads_or / __syncthreads_count): any unfinished
// ray before the mask update and again before the march evaluation, any
// overshot row before each line step. A block stops evaluating as soon as
// its gate fails, and a block with no ray inside the bounding sphere
// leaves at once. The grid covers every ray, so the march needs no
// gather and no host sync.
#include "mlp_tile.cuh"

namespace {

using mlp::THREADS;
using mlp::TM;
constexpr int RAYS = TM / 2;  // rays per block: rows r and r + RAYS

struct MarchParams {
  int iters;         // sphere_tracing_iters
  int line_iters;    // line_step_iters
  float line_scale;  // 1 - line_search_step
  float thr;         // sdf_threshold
  float clip;        // dist_clip
};

__global__ void __launch_bounds__(THREADS)
march_kernel(const float* __restrict__ org, const float* __restrict__ dirs,
             const unsigned char* __restrict__ mask,
             const float* __restrict__ t_near,
             const float* __restrict__ t_far, int n, int multires,
             MarchParams p, mlp::Weights w, float* __restrict__ t_s,
             float* __restrict__ t_e, unsigned char* __restrict__ unfin_s,
             unsigned long long* __restrict__ rows) {
  extern __shared__ __align__(16) float smem[];
  const mlp::Tile tile = mlp::make_tile(smem, w.H, w.d_pe);
  __shared__ float o[RAYS * 3], d[RAYS * 3], xyz[TM * 3];
  __shared__ float t2[TM], next2[TM], curr2[TM];
  __shared__ int unfin2[TM];

  const int tid = threadIdx.x;
  const bool mine = tid < TM;        // this thread keeps row tid's state
  const bool end = tid >= RAYS;      // row tid is an end-march row
  const int r = tid & (RAYS - 1);
  const long long ray = (long long)blockIdx.x * RAYS + r;
  if (tid < RAYS * 3) {
    const long long i = (long long)blockIdx.x * RAYS * 3 + tid;
    const bool ok = i < 3LL * n;
    o[tid] = ok ? org[i] : 0.f;
    d[tid] = ok ? dirs[i] : 0.f;
  }
  if (mine) {
    const bool mi = ray < n && mask[ray] != 0;
    unfin2[tid] = mi;
    t2[tid] = mi ? (end ? t_far[ray] : t_near[ray]) : 0.f;
    next2[tid] = 0.f;
    curr2[tid] = 0.f;
  }
  unsigned long long evaluated = 0, used = 0;

  // SDF of the 32 rows at org + t2 dirs into tile.sdf (all threads)
  auto eval_rows = [&]() {
    if (tid < TM * 3) {
      const int row = tid / 3, k = tid - 3 * (tid / 3);
      const int q = (row & (RAYS - 1)) * 3 + k;
      xyz[tid] = __fadd_rn(o[q], __fmul_rn(t2[row], d[q]));
    }
    __syncthreads();
    mlp::pe_tile(xyz, multires, tile);
    mlp::eval_tile(w, tile);
    evaluated += TM;
  };
  auto clipped = [&](float v) { return fminf(fmaxf(v, -p.clip), p.clip); };
  auto mask_update = [&]() {
    const bool u = unfin2[tid] != 0;
    float c = u ? next2[tid] : 0.f;
    if (c <= p.thr) c = 0.f;
    unfin2[tid] = u && c > p.thr;
    curr2[tid] = c;
  };

  int active = __syncthreads_count(mine && unfin2[tid]);
  if (active > 0) {
    eval_rows();
    used += active;
    if (mine) next2[tid] = unfin2[tid] ? clipped(tile.sdf[tid]) : 0.f;
    for (int it = 0; it < p.iters; ++it) {
      if (!__syncthreads_or(mine && unfin2[tid])) break;
      if (mine) mask_update();
      // the reference breaks between the mask update and the step
      active = __syncthreads_count(mine && unfin2[tid]);
      if (active == 0) break;
      if (mine) t2[tid] = end ? t2[tid] - curr2[tid] : t2[tid] + curr2[tid];
      __syncthreads();
      eval_rows();
      used += active;
      if (mine) next2[tid] = unfin2[tid] ? clipped(tile.sdf[tid]) : 0.f;
      // line search: halve the overshoot back, start down and end up
      for (int j = 0; j < p.line_iters; ++j) {
        const bool not_proj = mine && next2[tid] < 0.f;
        const int n_proj = __syncthreads_count(not_proj);
        if (n_proj == 0) break;
        if (not_proj) {
          const float step = ldexpf(p.line_scale, -j) * curr2[tid];
          t2[tid] = end ? t2[tid] + step : t2[tid] - step;
        }
        __syncthreads();
        eval_rows();
        used += n_proj;
        if (not_proj) next2[tid] = clipped(tile.sdf[tid]);
      }
      __syncthreads();
      if (mine && !(t2[r] < t2[r + RAYS])) unfin2[tid] = 0;
    }
    // final bookkeeping-only pass
    __syncthreads();
    if (mine) mask_update();
  }
  __syncthreads();
  if (tid < RAYS && ray < n) {
    t_s[ray] = t2[tid];
    t_e[ray] = t2[tid + RAYS];
    unfin_s[ray] = (unsigned char)(unfin2[tid] != 0);
  }
  if (tid == 0 && rows != nullptr) {
    atomicAdd(rows, evaluated);
    atomicAdd(rows + 1, used);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Device pointers to contiguous arrays: org, dirs (n, 3) f32;
// mask (n) bool as bytes; t_near, t_far (n) f32; the weights as
// mlp::Weights lists them (d_pe must be 3 (1 + 2 multires)); outputs t_s,
// t_e (n) f32 and unfin_s (n) bool as bytes. `rows`, when not null, is an
// int64 pair to which the kernel adds [rows evaluated, rows used].
int march_forward(const float* org, const float* dirs,
                  const unsigned char* mask, const float* t_near,
                  const float* t_far, int n, int multires, int iters,
                  int line_iters, float line_scale, float thr, float clip,
                  int d_pe, const float* w_in, const float* b_in,
                  const float* w_hid, const float* b_hid, int n_hid,
                  unsigned skip_mask, const float* w_skip_pe,
                  const float* w_out, const float* b_out, int H, float* t_s,
                  float* t_e, unsigned char* unfin_s, long long* rows,
                  void* stream) {
  if (n <= 0) return 0;
  const mlp::Weights w{w_in,  b_in, w_hid, b_hid, w_skip_pe, w_out,
                       b_out, d_pe, H,     n_hid, skip_mask};
  if (!mlp::weights_ok(w) || multires < 0 || iters < 0 || line_iters < 0 ||
      d_pe != 3 * (1 + 2 * multires))
    return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = mlp::allow_tile_smem(march_kernel, w, &smem);
  if (err != cudaSuccess) return (int)err;
  const MarchParams p{iters, line_iters, line_scale, thr, clip};
  const int blocks = (int)((n + RAYS - 1) / RAYS);
  march_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      org, dirs, mask, t_near, t_far, n, multires, p, w, t_s, t_e, unfin_s,
      reinterpret_cast<unsigned long long*>(rows));
  return (int)cudaGetLastError();
}

}  // extern "C"
