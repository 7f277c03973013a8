// One `wgmma` k-step of the SDF-MLP tile, alone: d = c + a b for an
// m64n32k16 product, a (64, 16) and b (16, 32) bf16, c and d (64, 32) f32,
// with the tile's operand layouts and descriptors (mlp_tile_tc.cuh). It
// replaces no TPU kernel and is no part of the port's kernel library:
// tests/test_torch_cuda.py builds it alone, beside a copy of the tile's
// header, and reads from it how the tensor cores round a k-step's sum (the
// products are exact; the sum of the 16 products and c may need more than
// f32's 24 bits), which the plain version of the tile's arithmetic,
// sdf_mlp_split_reference, has to model.
#include "mlp_tile_tc.cuh"

namespace {

constexpr int N = 32;

__global__ void __launch_bounds__(128, 1)
wgmma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b,
                   const float* __restrict__ c, float* __restrict__ d) {
  __shared__ __align__(128) unsigned char sa[64 * 16 * 2];
  __shared__ __align__(128) unsigned char sb[16 * N * 2];
  const int tid = threadIdx.x;
  // a[r][k]: core matrix (r / 8, k / 8) at (k / 8 * 8 + r / 8) * 128 bytes
  for (int i = tid; i < 64 * 16; i += 128) {
    const int r = i / 16, k = i % 16;
    const int off = (((k >> 3) * 8 + (r >> 3)) << 7) + ((r & 7) << 4) +
                    ((k & 7) << 1);
    *reinterpret_cast<__nv_bfloat16*>(sa + off) = a[i];
  }
  // b[k][n]: ((k / 8) (N / 8) + n / 8) * 128 + (n % 8) * 16 + (k % 8) * 2
  for (int i = tid; i < 16 * N; i += 128) {
    const int k = i / N, n = i % N;
    const int off = (((k >> 3) * (N / 8) + (n >> 3)) << 7) + ((n & 7) << 4) +
                    ((k & 7) << 1);
    *reinterpret_cast<__nv_bfloat16*>(sb + off) = b[i];
  }
  tc::fence_async_smem();
  __syncthreads();
  // this thread's fragment: rows 16 warp + lane / 4 (+ 8), columns
  // 8 j + 2 (lane % 4) (+ 1)
  const int warp = tid >> 5, lane = tid & 31;
  const int row = 16 * warp + (lane >> 2), col = 2 * (lane & 3);
  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    acc[4 * j + 0] = c[row * N + col + 8 * j];
    acc[4 * j + 1] = c[row * N + col + 8 * j + 1];
    acc[4 * j + 2] = c[(row + 8) * N + col + 8 * j];
    acc[4 * j + 3] = c[(row + 8) * N + col + 8 * j + 1];
  }
  tc::wgmma_fence();
  tc::wgmma<N>(acc, tc::make_desc(tc::smem_addr(sa), 1024, 128),
               tc::make_desc(tc::smem_addr(sb), N * 16, 128), 1);
  tc::wgmma_commit();
  tc::wgmma_wait_all();
  tc::fence_accumulator(acc);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    d[row * N + col + 8 * j] = acc[4 * j + 0];
    d[row * N + col + 8 * j + 1] = acc[4 * j + 1];
    d[(row + 8) * N + col + 8 * j] = acc[4 * j + 2];
    d[(row + 8) * N + col + 8 * j + 1] = acc[4 * j + 3];
  }
}

}  // namespace

extern "C" {

// d (64, 32) = c (64, 32) + a (64, 16) b (16, 32) by one wgmma, on `stream`;
// device pointers to contiguous row-major arrays. Returns cudaGetLastError().
int wgmma_probe(const void* a, const void* b, const float* c, float* d,
                void* stream) {
  wgmma_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, c, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
