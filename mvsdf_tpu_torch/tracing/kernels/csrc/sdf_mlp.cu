// Fused SDF-MLP evaluation for the no-grad sphere trace, hand-written for
// Hopper (sm_90a). Two entry points:
//  - sdf_mlp_forward: sdf = MLP(pe)[:, 0] from the precomputed positional
//    encoding pe (N, d_pe) f32. Replaces the TPU kernel
//    mvsdf_tpu/tracing/pallas/sdf_kernel.py:205 (pallas_sdf_apply, body
//    _make_kernel).
//  - sdf_mlp_xyz_forward: the same MLP from the points x (N, 3) f32, with
//    the positional encoding computed in the kernel. Replaces the same
//    pallas_call with in_kernel_pe=True (body _make_pe_kernel,
//    sdf_kernel.py:137-157). The TPU kernel scattered frequency-scaled
//    copies of xyz across lanes with an (8, 128) matmul; here a prologue
//    writes each PE lane of the tile straight into shared memory.
// Effective weights are folded once per step by pack_sdf_weights
// (sdf_mlp.py). Activations never leave the chip; only the SDF value of
// each point is written.
//
// What bounds it: operations. The full-size net is 39 -> 512 x 8 (473
// before the skip) -> the SDF column, ~1.84 M multiply-adds = ~3.67 MFLOP
// per point against 12 to 156 bytes of input and 4 of output, so the
// kernel sits far above the card's ridge point; its 7.5 MB of packed
// weights are read from L2 (50 MB) by every block.
//
// Design (first version: simple and right, f32 on the CUDA cores): one
// block of 256 threads per tile of 32 rows (mlp_tile.cuh); the ragged last
// tile loads zero rows and writes nothing for them.
// Later work: bf16 wgmma with TMA-fed weight tiles and a persistent grid.
#include "mlp_tile.cuh"

namespace {

using mlp::THREADS;
using mlp::TM;

__global__ void __launch_bounds__(THREADS)
sdf_mlp_kernel(const float* __restrict__ pe, int n, mlp::Weights w,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const mlp::Tile t = mlp::make_tile(smem, w.H, w.d_pe);
  const long long row0 = (long long)blockIdx.x * TM;
  for (int i = threadIdx.x; i < TM * w.d_pe; i += THREADS) {
    const int r = i / w.d_pe;
    const int k = i - r * w.d_pe;
    const long long row = row0 + r;
    t.peT[k * TM + r] = row < n ? pe[row * w.d_pe + k] : 0.f;
  }
  __syncthreads();
  mlp::eval_tile(w, t);
  const long long row = row0 + threadIdx.x;
  if (threadIdx.x < TM && row < n) out[row] = t.sdf[threadIdx.x];
}

__global__ void __launch_bounds__(THREADS)
sdf_mlp_xyz_kernel(const float* __restrict__ x, int n, int multires,
                   mlp::Weights w, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const mlp::Tile t = mlp::make_tile(smem, w.H, w.d_pe);
  __shared__ float xyz[TM * 3];
  const long long row0 = (long long)blockIdx.x * TM;
  if (threadIdx.x < TM * 3) {
    const long long i = row0 * 3 + threadIdx.x;
    xyz[threadIdx.x] = i < 3LL * n ? x[i] : 0.f;
  }
  __syncthreads();
  mlp::pe_tile(xyz, multires, t);
  mlp::eval_tile(w, t);
  const long long row = row0 + threadIdx.x;
  if (threadIdx.x < TM && row < n) out[row] = t.sdf[threadIdx.x];
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers to contiguous f32 arrays:
// pe (n, d_pe); the weights as mlp::Weights lists them; out (n).
int sdf_mlp_forward(const float* pe, int n, int d_pe, const float* w_in,
                    const float* b_in, const float* w_hid,
                    const float* b_hid, int n_hid, unsigned skip_mask,
                    const float* w_skip_pe, const float* w_out,
                    const float* b_out, int H, float* out, void* stream) {
  if (n <= 0) return 0;
  const mlp::Weights w{w_in,  b_in, w_hid, b_hid, w_skip_pe, w_out,
                       b_out, d_pe, H,     n_hid, skip_mask};
  if (!mlp::weights_ok(w)) return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = mlp::allow_tile_smem(sdf_mlp_kernel, w, &smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((n + TM - 1) / TM);
  sdf_mlp_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(pe, n, w,
                                                                   out);
  return (int)cudaGetLastError();
}

// As sdf_mlp_forward, from the points x (n, 3) and the PE's multires
// (d_pe must be 3 (1 + 2 multires)).
int sdf_mlp_xyz_forward(const float* x, int n, int multires, int d_pe,
                        const float* w_in, const float* b_in,
                        const float* w_hid, const float* b_hid, int n_hid,
                        unsigned skip_mask, const float* w_skip_pe,
                        const float* w_out, const float* b_out, int H,
                        float* out, void* stream) {
  if (n <= 0) return 0;
  const mlp::Weights w{w_in,  b_in, w_hid, b_hid, w_skip_pe, w_out,
                       b_out, d_pe, H,     n_hid, skip_mask};
  if (!mlp::weights_ok(w) || multires < 0 || d_pe != 3 * (1 + 2 * multires))
    return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = mlp::allow_tile_smem(sdf_mlp_xyz_kernel, w, &smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((n + TM - 1) / TM);
  sdf_mlp_xyz_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, n, multires, w, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
