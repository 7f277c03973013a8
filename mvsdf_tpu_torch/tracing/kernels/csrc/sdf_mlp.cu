// Fused SDF-MLP evaluation for the no-grad sphere trace, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mvsdf_tpu/tracing/pallas/sdf_kernel.py
// (pallas_sdf_apply, body _make_kernel): sdf = MLP(pe)[:, 0] for the
// 9-layer weight-normalized geometry MLP, from the precomputed positional
// encoding pe (N, d_pe) f32, with effective weights folded once per step by
// pack_sdf_weights (sdf_mlp.py). Activations never leave the chip; only the
// SDF value of each point is written.
//
// What bounds it: operations. The full-size net is 39 -> 512 x 8 (473
// before the skip) -> the SDF column, ~1.84 M multiply-adds = ~3.67 MFLOP
// per point against 39 x 4 bytes of input and 4 of output, so the kernel
// sits far above the card's ridge point; its 7.5 MB of packed weights are
// read from L2 (50 MB) by every block.
//
// Design (first version: simple and right, f32 on the CUDA cores):
//  - a block of 256 threads owns a tile of TM = 32 rows and keeps the tile's
//    activation in shared memory, stored k-major (hT[k][row]) so that one
//    float4 broadcast load feeds four rows of every thread's FMAs;
//  - each thread owns two output columns (c, c + 256) for all 32 rows: 64
//    f32 accumulators in registers, and each layer's weight row k is read
//    once per block from L2, coalesced across the threads;
//  - the skip layer is two products into the same accumulators,
//    (h @ W_h + pe @ W_pe) / sqrt(2), with no concat;
//  - layers narrower than H are zero-padded by pack_sdf_weights: their
//    padded lanes hold softplus(0) != 0, which the zero rows of the next
//    weight matrix annihilate;
//  - the ragged last tile loads zero rows and writes nothing for them;
//  - the last layer (SDF column only) is a per-row dot product reduced
//    across the 8 warps in shared memory.
// Later work: bf16 wgmma with TMA-fed weight tiles and a persistent grid.
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;           // rows per block
constexpr int THREADS = 256;     // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_H = 2 * THREADS;

__device__ __forceinline__ float softplus100(float x) {
  // log(1 + exp(100 x)) / 100 in the stable logaddexp(0, z) form
  const float z = 100.f * x;
  return (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)))) * 0.01f;
}

// acc[j][r] += sum_k srcT[k][r] * W[k][c_j], W row-major (K, H).
__device__ __forceinline__ void accumulate(float (&acc)[2][TM],
                                           const float* __restrict__ srcT,
                                           int K,
                                           const float* __restrict__ W,
                                           int H, int c0, int c1) {
  const bool ok0 = c0 < H, ok1 = c1 < H;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float* wk = W + (size_t)k * H;
    const float w0 = ok0 ? __ldg(wk + c0) : 0.f;
    const float w1 = ok1 ? __ldg(wk + c1) : 0.f;
    const float4* s = reinterpret_cast<const float4*>(srcT + k * TM);
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      const float4 v = s[q];
      acc[0][4 * q + 0] = fmaf(v.x, w0, acc[0][4 * q + 0]);
      acc[0][4 * q + 1] = fmaf(v.y, w0, acc[0][4 * q + 1]);
      acc[0][4 * q + 2] = fmaf(v.z, w0, acc[0][4 * q + 2]);
      acc[0][4 * q + 3] = fmaf(v.w, w0, acc[0][4 * q + 3]);
      acc[1][4 * q + 0] = fmaf(v.x, w1, acc[1][4 * q + 0]);
      acc[1][4 * q + 1] = fmaf(v.y, w1, acc[1][4 * q + 1]);
      acc[1][4 * q + 2] = fmaf(v.z, w1, acc[1][4 * q + 2]);
      acc[1][4 * q + 3] = fmaf(v.w, w1, acc[1][4 * q + 3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][TM]) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    acc[0][r] = 0.f;
    acc[1][r] = 0.f;
  }
}

// hT[c][r] = softplus100(acc * scale + b[c]) for this thread's columns.
__device__ __forceinline__ void store_softplus(const float (&acc)[2][TM],
                                               float* __restrict__ hT,
                                               const float* __restrict__ b,
                                               int H, int c0, int c1,
                                               float scale) {
  const int cols[2] = {c0, c1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = cols[j];
    if (c >= H) continue;
    const float bc = __ldg(b + c);
    float4* dst = reinterpret_cast<float4*>(hT + c * TM);
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      float4 v;
      v.x = softplus100(fmaf(acc[j][4 * q + 0], scale, bc));
      v.y = softplus100(fmaf(acc[j][4 * q + 1], scale, bc));
      v.z = softplus100(fmaf(acc[j][4 * q + 2], scale, bc));
      v.w = softplus100(fmaf(acc[j][4 * q + 3], scale, bc));
      dst[q] = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
sdf_mlp_kernel(const float* __restrict__ pe, int n, int d_pe,
               const float* __restrict__ w_in, const float* __restrict__ b_in,
               const float* __restrict__ w_hid,
               const float* __restrict__ b_hid, int n_hid,
               unsigned skip_mask, const float* __restrict__ w_skip_pe,
               const float* __restrict__ w_out,
               const float* __restrict__ b_out, int H,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* hT = smem;                     // [H][TM]
  float* peT = hT + H * TM;             // [d_pe][TM]
  float* part = peT + d_pe * TM;        // [WARPS][TM]

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * TM;

  for (int i = tid; i < TM * d_pe; i += THREADS) {
    const int r = i / d_pe;
    const int k = i - r * d_pe;
    const long long row = row0 + r;
    peT[k * TM + r] = row < n ? pe[row * d_pe + k] : 0.f;
  }
  __syncthreads();

  const int c0 = tid, c1 = tid + THREADS;
  float acc[2][TM];

  zero(acc);
  accumulate(acc, peT, d_pe, w_in, H, c0, c1);
  store_softplus(acc, hT, b_in, H, c0, c1, 1.f);
  __syncthreads();

  const float inv_sqrt2 = 0.70710678118654752f;
  int skip_i = 0;
  for (int l = 0; l < n_hid; ++l) {
    zero(acc);
    accumulate(acc, hT, H, w_hid + (size_t)l * H * H, H, c0, c1);
    float scale = 1.f;
    if ((skip_mask >> l) & 1u) {
      accumulate(acc, peT, d_pe, w_skip_pe + (size_t)skip_i * d_pe * H, H,
                 c0, c1);
      ++skip_i;
      scale = inv_sqrt2;
    }
    __syncthreads();  // every thread has read hT before it is overwritten
    store_softplus(acc, hT, b_hid + (size_t)l * H, H, c0, c1, scale);
    __syncthreads();
  }

  // SDF column: lane = row, each warp sums a slice of the H columns.
  const int warp = tid >> 5, lane = tid & 31;
  const int per = (H + WARPS - 1) / WARPS;
  const int c_lo = warp * per;
  const int c_hi = min(H, c_lo + per);
  float s = 0.f;
  for (int c = c_lo; c < c_hi; ++c)
    s = fmaf(hT[c * TM + lane], __ldg(w_out + c), s);
  part[warp * TM + lane] = s;
  __syncthreads();
  if (tid < TM) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += part[w * TM + tid];
    const long long row = row0 + tid;
    if (row < n) out[row] = t + __ldg(b_out);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers to contiguous f32 arrays:
// pe (n, d_pe); w_in (d_pe, H); b_in (H); w_hid (n_hid, H, H); b_hid
// (n_hid, H); w_skip_pe (popcount(skip_mask), d_pe, H); w_out (H); b_out
// (1); out (n). Bit l of skip_mask marks hidden layer l as a skip layer.
int sdf_mlp_forward(const float* pe, int n, int d_pe, const float* w_in,
                    const float* b_in, const float* w_hid,
                    const float* b_hid, int n_hid, unsigned skip_mask,
                    const float* w_skip_pe, const float* w_out,
                    const float* b_out, int H, float* out, void* stream) {
  if (n <= 0) return 0;
  if (H <= 0 || H > MAX_H || d_pe <= 0 || n_hid < 0 || n_hid > 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(H + d_pe + WARPS) * TM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((n + TM - 1) / TM);
  sdf_mlp_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      pe, n, d_pe, w_in, b_in, w_hid, b_hid, n_hid, skip_mask, w_skip_pe,
      w_out, b_out, H, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
