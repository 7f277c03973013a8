// Bias + Softplus(beta=100) of the SDF network's hidden layers, and the
// two derivatives that the value + spatial gradient and its backward take
// of it, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it into the products around it. Run as PyTorch's ops it is a
// dozen-odd elementwise kernels a layer, each a pass over an (N, 512) f32
// tensor (fields/sdf.py: Softplus100Bias, Softplus100Grad).
//
// Three entries, f32 in and f32 out, on (rows, cols) operands whose inner
// stride is 1 (inputs may have any row stride; outputs are contiguous):
//   softplus100_forward:   z = y + b (b broadcast over rows),
//                          h = logaddexp(0, 100 z) * 0.01; z optional
//   softplus100_grad:      out = g * s(z) [+ a], s(z) = sigmoid(100 z)
//   softplus100_grad_grad: out_g = gg * s(z),
//                          out_z = gg * g * (1 - s(z)) * s(z) * 100
// with torch's own formulas for logaddexp and sigmoid, and the products
// and sums in the order PyTorch's ops take them, each rounded to f32
// (no fused multiply-add where an add follows a product), so a result is
// the plain chain's to within the last bits of expf and log1pf.
//
// What bounds it: bytes. Per element a few dozen f32 instructions against
// 8-20 bytes moved, far below the card's ridge point (about 20 f32
// operations a byte at 67 TFLOP/s and 3.35 TB/s), so the least time is
// the bytes read and written over 3.35 TB/s.
//
// With the SDF network's bf16 activations (fields/sdf.py: the JAX
// package's bf16_activations) the same entries take a flag that stores
// the activation h in bf16 (round to nearest even, as torch's
// .to(bfloat16) rounds), reads the cotangent g in bf16, and writes g's
// cotangent out_g in bf16; z, a, gg and out_z stay f32, and the
// arithmetic is the f32 entries' own, on the bf16 values widened to f32.
// Each such launch replaces an f32 launch and the cast kernel beside it:
// the bf16 operand moves 2 bytes an element, not 4 + a cast's 6.
//
// Design: one read of each operand and one write of each output, in one
// launch per autograd node: 4-value vector loads and stores (16 bytes in
// f32, 8 in bf16) where the width and every row stride are multiples of
// 4 values and every pointer is aligned to its vector, scalar ones
// otherwise (the layer that feeds the skip is 473 wide). A block is 8
// warps, a warp walks a row at a time, neighbouring lanes on neighbouring
// columns, and the grid strides over the rows: no index division, and
// one resident wave of blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int LANES = 32;        // threads along a row
constexpr int ROWS_PER_BLOCK = 8;
constexpr int BLOCKS_PER_SM = 8;  // 2,048 threads: one resident wave

template <int W>
struct Vec {
  float v[W];
};

template <int W>
__device__ __forceinline__ Vec<W> load(const float* p) {
  Vec<W> r;
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store(float* p, const Vec<W>& r) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// W bf16 values as f32 (8-byte vectors where W is 4)
template <int W>
__device__ __forceinline__ Vec<W> load(const __nv_bfloat16* p) {
  Vec<W> r;
  if constexpr (W == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    r.v[0] = a.x;
    r.v[1] = a.y;
    r.v[2] = b.x;
    r.v[3] = b.y;
  } else {
    r.v[0] = __bfloat162float(*p);
  }
  return r;
}

// W f32 values rounded to nearest even bf16
template <int W>
__device__ __forceinline__ void store(__nv_bfloat16* p, const Vec<W>& r) {
  if constexpr (W == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(r.v[0], r.v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(r.v[2], r.v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&a);
    t.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    *p = __float2bfloat16_rn(r.v[0]);
  }
}

// torch's logaddexp(a, b) with a = 0, b = 100 z (a is never infinite, so
// its first branch is never taken), times 0.01 as the plain chain's
// `* 0.01`
__device__ __forceinline__ float softplus100(float z) {
  const float t = z * 100.0f;
  const float m = fmaxf(0.0f, t);
  return (m + log1pf(expf(-fabsf(0.0f - t)))) * 0.01f;
}

// torch's sigmoid of 100 z
__device__ __forceinline__ float sigmoid100(float z) {
  return 1.0f / (1.0f + expf(-(z * 100.0f)));
}

// f(row, vector index) for every W-float vector of a (rows, cols) tensor:
// a warp a row, the grid striding over the rows
template <int W, class F>
__device__ __forceinline__ void for_each_vector(long long rows, int cols,
                                                F f) {
  const int nvec = cols / W;
  const long long step = (long long)gridDim.x * ROWS_PER_BLOCK;
  for (long long r = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.y;
       r < rows; r += step) {
    for (int c = threadIdx.x; c < nvec; c += LANES) f(r, c * W);
  }
}

// H: the type of h (f32 or bf16)
template <int W, class H>
__global__ void __launch_bounds__(LANES * ROWS_PER_BLOCK)
forward_kernel(const float* __restrict__ y, long long ldy,
               const float* __restrict__ b, float* __restrict__ z,
               H* __restrict__ h, long long rows, int cols) {
  for_each_vector<W>(rows, cols, [&](long long r, int col) {
    const Vec<W> yv = load<W>(y + r * ldy + col), bv = load<W>(b + col);
    Vec<W> zv, hv;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      zv.v[k] = yv.v[k] + bv.v[k];
      hv.v[k] = softplus100(zv.v[k]);
    }
    if (z != nullptr) store<W>(z + r * cols + col, zv);
    store<W>(h + r * cols + col, hv);
  });
}

// G: the type of g (f32 or bf16)
template <int W, class G>
__global__ void __launch_bounds__(LANES * ROWS_PER_BLOCK)
grad_kernel(const G* __restrict__ g, long long ldg,
            const float* __restrict__ z, long long ldz,
            const float* __restrict__ a, long long lda,
            float* __restrict__ out, long long rows, int cols) {
  for_each_vector<W>(rows, cols, [&](long long r, int col) {
    const Vec<W> gv = load<W>(g + r * ldg + col),
                 zv = load<W>(z + r * ldz + col);
    Vec<W> o;
#pragma unroll
    for (int k = 0; k < W; ++k) o.v[k] = __fmul_rn(gv.v[k],
                                                   sigmoid100(zv.v[k]));
    if (a != nullptr) {
      const Vec<W> av = load<W>(a + r * lda + col);
#pragma unroll
      for (int k = 0; k < W; ++k) o.v[k] = __fadd_rn(o.v[k], av.v[k]);
    }
    store<W>(out + r * cols + col, o);
  });
}

// G: the type of g and of its cotangent out_g (f32 or bf16)
template <int W, class G>
__global__ void __launch_bounds__(LANES * ROWS_PER_BLOCK)
grad_grad_kernel(const float* __restrict__ gg, long long ldgg,
                 const G* __restrict__ g, long long ldg,
                 const float* __restrict__ z, long long ldz,
                 G* __restrict__ out_g, float* __restrict__ out_z,
                 long long rows, int cols) {
  for_each_vector<W>(rows, cols, [&](long long r, int col) {
    const Vec<W> ggv = load<W>(gg + r * ldgg + col),
                 gv = load<W>(g + r * ldg + col),
                 zv = load<W>(z + r * ldz + col);
    Vec<W> og, oz;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float s = sigmoid100(zv.v[k]);
      og.v[k] = ggv.v[k] * s;
      // torch's sigmoid_backward(gg * g, s) = (gg g)(1 - s) s, then the
      // chain rule's factor 100 of the scaled input
      oz.v[k] = ((ggv.v[k] * gv.v[k]) * (1.0f - s)) * s * 100.0f;
    }
    if (out_g != nullptr) store<W>(out_g + r * cols + col, og);
    if (out_z != nullptr) store<W>(out_z + r * cols + col, oz);
  });
}

// whether p is aligned to a vector of 4 values of `bytes` bytes each
bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) & (4 * bytes - 1)) == 0;
}

// 4-value vectors when the width, every row stride and every pointer
// allow them: `f32` the f32 operands, `narrow` those of T
template <class T>
bool vectors(int cols, std::initializer_list<long long> lds,
             std::initializer_list<const void*> f32,
             std::initializer_list<const void*> narrow) {
  if (cols % 4 != 0) return false;
  for (long long ld : lds)
    if (ld % 4 != 0) return false;
  for (const void* p : f32)
    if (p != nullptr && !aligned(p, 4)) return false;
  for (const void* p : narrow)
    if (p != nullptr && !aligned(p, sizeof(T))) return false;
  return true;
}

dim3 grid_of(long long rows) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < 64 ? sms[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev < 64) sms[dev] = n;
  }
  const long long want = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const long long most = (long long)n * BLOCKS_PER_SM;
  return dim3((unsigned)(want < most ? want : most));
}

const dim3 BLOCK(LANES, ROWS_PER_BLOCK);

template <class H>
void forward(const float* y, long long ldy, const float* b, float* z, H* h,
             long long rows, int cols, cudaStream_t stream) {
  const dim3 grid = grid_of(rows);
  if (vectors<H>(cols, {ldy}, {y, b, z}, {h}))
    forward_kernel<4, H><<<grid, BLOCK, 0, stream>>>(y, ldy, b, z, h, rows,
                                                     cols);
  else
    forward_kernel<1, H><<<grid, BLOCK, 0, stream>>>(y, ldy, b, z, h, rows,
                                                     cols);
}

template <class G>
void grad(const G* g, long long ldg, const float* z, long long ldz,
          const float* a, long long lda, float* out, long long rows,
          int cols, cudaStream_t stream) {
  const dim3 grid = grid_of(rows);
  if (vectors<G>(cols, {ldg, ldz, a != nullptr ? lda : 0}, {z, a, out},
                 {g}))
    grad_kernel<4, G><<<grid, BLOCK, 0, stream>>>(g, ldg, z, ldz, a, lda,
                                                  out, rows, cols);
  else
    grad_kernel<1, G><<<grid, BLOCK, 0, stream>>>(g, ldg, z, ldz, a, lda,
                                                  out, rows, cols);
}

template <class G>
void grad_grad(const float* gg, long long ldgg, const G* g, long long ldg,
               const float* z, long long ldz, G* out_g, float* out_z,
               long long rows, int cols, cudaStream_t stream) {
  const dim3 grid = grid_of(rows);
  if (vectors<G>(cols, {ldgg, ldg, ldz}, {gg, z, out_z}, {g, out_g}))
    grad_grad_kernel<4, G><<<grid, BLOCK, 0, stream>>>(
        gg, ldgg, g, ldg, z, ldz, out_g, out_z, rows, cols);
  else
    grad_grad_kernel<1, G><<<grid, BLOCK, 0, stream>>>(
        gg, ldgg, g, ldg, z, ldz, out_g, out_z, rows, cols);
}

}  // namespace

// each entry: `bf16` nonzero where h (forward), g and out_g (grad,
// grad_grad) are bf16, zero where they are f32 as every other operand
extern "C" {

int softplus100_forward(const float* y, long long ldy, const float* b,
                        float* z, void* h, int bf16, long long rows,
                        int cols, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (bf16)
    forward(y, ldy, b, z, static_cast<__nv_bfloat16*>(h), rows, cols,
            stream);
  else
    forward(y, ldy, b, z, static_cast<float*>(h), rows, cols, stream);
  return cudaGetLastError();
}

int softplus100_grad(const void* g, long long ldg, const float* z,
                     long long ldz, const float* a, long long lda,
                     float* out, int bf16, long long rows, int cols,
                     cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (bf16)
    grad(static_cast<const __nv_bfloat16*>(g), ldg, z, ldz, a, lda, out,
         rows, cols, stream);
  else
    grad(static_cast<const float*>(g), ldg, z, ldz, a, lda, out, rows,
         cols, stream);
  return cudaGetLastError();
}

int softplus100_grad_grad(const float* gg, long long ldgg, const void* g,
                          long long ldg, const float* z, long long ldz,
                          void* out_g, float* out_z, int bf16,
                          long long rows, int cols, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (bf16)
    grad_grad(gg, ldgg, static_cast<const __nv_bfloat16*>(g), ldg, z, ldz,
              static_cast<__nv_bfloat16*>(out_g), out_z, rows, cols,
              stream);
  else
    grad_grad(gg, ldgg, static_cast<const float*>(g), ldg, z, ldz,
              static_cast<float*>(out_g), out_z, rows, cols, stream);
  return cudaGetLastError();
}

}  // extern "C"
