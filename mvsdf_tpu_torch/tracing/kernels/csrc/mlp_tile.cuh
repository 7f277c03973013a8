// The SDF-MLP tile shared by every kernel of the trace (sdf_mlp.cu,
// secant.cu, march.cu), hand-written for Hopper (sm_90a).
//
// One block of THREADS threads evaluates the SDF column of the packed
// weight-normalized MLP (pack_sdf_weights in sdf_mlp.py) for a tile of TM
// rows whose positional encoding already sits in shared memory:
//  - the tile's activation stays in shared memory, stored k-major
//    (hT[k][row]) so that one float4 broadcast load feeds four rows of every
//    thread's FMAs;
//  - each thread owns two output columns (c, c + THREADS) for all TM rows:
//    64 f32 accumulators in registers; each layer's weight row k is read
//    once per tile from L2, coalesced across the threads;
//  - the skip layer is two products into the same accumulators,
//    (h @ W_h + pe @ W_pe) / sqrt(2), with no concat;
//  - layers narrower than H are zero-padded by pack_sdf_weights: their
//    padded lanes hold softplus(0) != 0, which the zero rows of the next
//    weight matrix annihilate;
//  - the last layer (SDF column only) is a per-row dot product reduced
//    across the warps in shared memory.
// pe_tile writes the positional encoding of TM points into the tile, with
// sinf/cosf (not the fast intrinsics: the argument reaches ~32 at
// multires 6, where __sinf loses digits).
//
// Every function here is called by all THREADS threads of the block with
// the same arguments, and synchronizes the block before it returns.
#pragma once
#include <cuda_runtime.h>

namespace mlp {

constexpr int TM = 32;            // rows per tile
constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_H = 2 * THREADS;
constexpr int MAX_HIDDEN = 32;    // skip layers are a 32-bit mask

// Effective weights in the layout of PackedSDF (sdf_mlp.py), device
// pointers to contiguous f32 arrays: w_in (d_pe, H); b_in (H); w_hid
// (n_hid, H, H); b_hid (n_hid, H); w_skip_pe (popcount(skip_mask), d_pe, H);
// w_out (H); b_out (1). Bit l of skip_mask marks hidden layer l.
struct Weights {
  const float* w_in;
  const float* b_in;
  const float* w_hid;
  const float* b_hid;
  const float* w_skip_pe;
  const float* w_out;
  const float* b_out;
  int d_pe;
  int H;
  int n_hid;
  unsigned skip_mask;
};

// Shared memory of one tile: hT [H][TM], peT [d_pe][TM], the warps'
// partial sums [WARPS][TM] and the tile's SDF values [TM].
struct Tile {
  float* hT;
  float* peT;
  float* part;
  float* sdf;
};

__host__ __device__ inline size_t tile_floats(int H, int d_pe) {
  return (size_t)(H + d_pe + WARPS + 1) * TM;
}

// Carves a Tile out of `smem` (16-byte aligned, tile_floats(H, d_pe)
// floats).
__device__ inline Tile make_tile(float* smem, int H, int d_pe) {
  Tile t;
  t.hT = smem;
  t.peT = t.hT + H * TM;
  t.part = t.peT + d_pe * TM;
  t.sdf = t.part + WARPS * TM;
  return t;
}

// Host-side argument checks shared by the C entry points.
inline bool weights_ok(const Weights& w) {
  return w.H > 0 && w.H <= MAX_H && w.d_pe > 0 && w.n_hid >= 0 &&
         w.n_hid <= MAX_HIDDEN;
}

// Host side: lets `kernel` take one tile's dynamic shared memory (above
// the default 48 KB at full width) and stores its size in *bytes.
template <typename Kernel>
inline cudaError_t allow_tile_smem(Kernel kernel, const Weights& w,
                                   size_t* bytes) {
  *bytes = tile_floats(w.H, w.d_pe) * sizeof(float);
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

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

// tile.sdf[r] = SDF of row r, from the PE rows in tile.peT. Not inlined:
// the march calls it from three places, and one copy keeps its register
// allocation and compile time those of a single tile. Static: every
// kernel source keeps its own copy.
static __device__ __noinline__ void eval_tile(const Weights w,
                                              const Tile t) {
  const int tid = threadIdx.x;
  const int H = w.H;
  const int c0 = tid, c1 = tid + THREADS;
  float acc[2][TM];

  zero(acc);
  accumulate(acc, t.peT, w.d_pe, w.w_in, H, c0, c1);
  store_softplus(acc, t.hT, w.b_in, H, c0, c1, 1.f);
  __syncthreads();

  const float inv_sqrt2 = 0.70710678118654752f;
  int skip_i = 0;
  for (int l = 0; l < w.n_hid; ++l) {
    zero(acc);
    accumulate(acc, t.hT, H, w.w_hid + (size_t)l * H * H, H, c0, c1);
    float scale = 1.f;
    if ((w.skip_mask >> l) & 1u) {
      accumulate(acc, t.peT, w.d_pe,
                 w.w_skip_pe + (size_t)skip_i * w.d_pe * H, H, c0, c1);
      ++skip_i;
      scale = inv_sqrt2;
    }
    __syncthreads();  // every thread has read hT before it is overwritten
    store_softplus(acc, t.hT, w.b_hid + (size_t)l * H, H, c0, c1, scale);
    __syncthreads();
  }

  // SDF column: lane = row, each warp sums a slice of the H columns.
  const int warp = tid >> 5, lane = tid & 31;
  const int per = (H + WARPS - 1) / WARPS;
  const int c_lo = warp * per;
  const int c_hi = min(H, c_lo + per);
  float s = 0.f;
  for (int c = c_lo; c < c_hi; ++c)
    s = fmaf(t.hT[c * TM + lane], __ldg(w.w_out + c), s);
  t.part[warp * TM + lane] = s;
  __syncthreads();
  if (tid < TM) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) v += t.part[k * TM + tid];
    t.sdf[tid] = v + __ldg(w.b_out);
  }
  __syncthreads();
}

// tile.peT = positional encoding of the points xyz[r][0..2] (shared
// memory, TM rows), lanes as fields/embedder.positional_encoding orders
// them: x, then for i < multires sin(2^i x) and cos(2^i x), 3 lanes each.
__device__ __forceinline__ void pe_tile(const float* xyz, int multires,
                                        const Tile& t) {
  const int n = TM * 3 * (1 + multires);
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int r = e % TM;
    const int rest = e / TM;
    const int d = rest % 3;
    const int i = rest / 3;   // 0: identity, i >= 1: frequency 2^(i-1)
    const float x = xyz[r * 3 + d];
    if (i == 0) {
      t.peT[d * TM + r] = x;
    } else {
      // 2^(i-1) x is exact, as in the plain version's x * 2.0 ** i
      const float xf = ldexpf(x, i - 1);
      const int lane = 3 + 6 * (i - 1) + d;
      t.peT[lane * TM + r] = sinf(xf);
      t.peT[(lane + 3) * TM + r] = cosf(xf);
    }
  }
  __syncthreads();
}

}  // namespace mlp
