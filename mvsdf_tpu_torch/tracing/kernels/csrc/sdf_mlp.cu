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
// Effective weights are folded, split into bf16 hi/lo and tiled once per
// step by pack_sdf_weights (sdf_mlp.py). Activations never leave the chip;
// only the SDF value of each point is written. f32 in, f32 out.
//
// What bounds it: operations. The full-size net is 39 -> 512 x 8 (473
// before the skip) -> the SDF column, ~1.84 M multiply-adds = ~3.67 MFLOP
// per point against 12 to 156 bytes of input and 4 of output, so the
// kernel sits far above the card's ridge point. The products run on the
// tensor cores in three bf16 passes (mlp_tile_tc.cuh says why and how); the
// next limit is L2: every 64-row block streams all ~8 MB of split weights
// through its shared-memory ring.
//
// One block of 288 threads per tile of 64 rows; the ragged last tile loads
// zero rows and writes nothing for them. The padded width HP (64, 128, 256
// or 512) selects the instantiation: each consumer warpgroup's `wgmma` is
// m64 x n(HP / 2) x k16.
//
// Count entries (sdf_mlp_count_forward, sdf_mlp_xyz_count_forward): the
// grid covers a fixed capacity of rows and the kernel reads the number of
// rows to compute from device memory, so a CUDA graph can replay the
// launch for whatever count the step's compaction left there. Blocks past
// the count exit at once; the rows below it are computed as by the plain
// entries, bit for bit.
#include "mlp_tile_tc.cuh"

namespace {

using tc::CONSUMERS;
using tc::TM;

// One evaluation of the block's tile: out[row0 + r] = SDF of row r for
// row0 + r < n, the encoding written by fill_pe (see tc::consume_eval).
template <int NWG, typename FillPe>
__device__ __forceinline__ void eval_block(const tc::Weights& w, int stages,
                                           long long row0, int n,
                                           float* __restrict__ out,
                                           FillPe fill_pe) {
  const tc::Tile tile = tc::tile_init<NWG>(w, stages);
  const int tid = threadIdx.x;
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      tc::RingPos pos = tc::producer_start();
      tc::produce_pass<NWG>(tile, w, pos);
    }
    return;
  }
  tc::RingPos pos = tc::consumer_start();
  tc::consume_eval<NWG>(tile, w, pos, fill_pe);
  if (tid < TM && row0 + tid < n) out[row0 + tid] = tc::tile_sdf(tile, w, tid);
}

// The rows to compute: all `cap` of them, or the first *count (capped at
// `cap`) when the launch is a count entry's.
__device__ __forceinline__ int live_rows(int cap,
                                         const int* __restrict__ count) {
  if (count == nullptr) return cap;
  const int c = *count;
  return c < 0 ? 0 : (c < cap ? c : cap);
}

template <int NWG>
__global__ void __launch_bounds__(tc::THREADS, 1)
sdf_mlp_kernel(const float* __restrict__ pe, int cap,
               const int* __restrict__ count, float* __restrict__ out,
               tc::Weights w, int stages) {
  const int n = live_rows(cap, count);
  const long long row0 = (long long)blockIdx.x * TM;
  if (row0 >= n) return;
  eval_block<NWG>(w, stages, row0, n, out, [&](const tc::PeTile& t) {
    for (int i = threadIdx.x; i < TM * t.KP; i += CONSUMERS) {
      const int r = i / t.KP;
      const int k = i - r * t.KP;
      const long long row = row0 + r;
      t.put(k, r, k < w.d_pe && row < n ? pe[row * w.d_pe + k] : 0.f);
    }
  });
}

template <int NWG>
__global__ void __launch_bounds__(tc::THREADS, 1)
sdf_mlp_xyz_kernel(const float* __restrict__ x, int cap,
                   const int* __restrict__ count, int multires,
                   float* __restrict__ out, tc::Weights w, int stages) {
  const int n = live_rows(cap, count);
  const long long row0 = (long long)blockIdx.x * TM;
  if (row0 >= n) return;
  eval_block<NWG>(w, stages, row0, n, out, [&](const tc::PeTile& t) {
    if (threadIdx.x < TM * 3) {
      const long long i = row0 * 3 + threadIdx.x;
      t.xyz[threadIdx.x] = i < 3LL * n ? x[i] : 0.f;
    }
    tc::consumer_sync();
    tc::pe_from_points(t.xyz, multires, w.d_pe, t);
  });
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). All pointers are device pointers to contiguous arrays: pe
// (n, d_pe) f32; w_stream the bf16 weight tiles and w_vec the f32 biases
// and output column at the padded width HP, as tc::Weights describes them;
// b_out (1) f32; out (n) f32. `count` is null, or a device int: then only
// the first *count rows (at most n) are computed and written.
int sdf_mlp_count_forward(const float* pe, int n, const int* count, int d_pe,
                          int HP, int n_hid, unsigned skip_mask,
                          const void* w_stream, const float* w_vec,
                          const float* b_out, float* out, void* stream) {
  if (n <= 0) return 0;
  const tc::Weights w{(const __nv_bfloat16*)w_stream, w_vec, b_out, d_pe,
                      n_hid, skip_mask};
  if (!tc::weights_ok(w)) return (int)cudaErrorInvalidValue;
  return tc::dispatch_width(HP, [&](auto nwg) {
    return tc::launch(sdf_mlp_kernel<decltype(nwg)::value>, HP, w,
                      (n + TM - 1) / TM, stream, pe, n, count, out);
  });
}

int sdf_mlp_forward(const float* pe, int n, int d_pe, int HP, int n_hid,
                    unsigned skip_mask, const void* w_stream,
                    const float* w_vec, const float* b_out, float* out,
                    void* stream) {
  return sdf_mlp_count_forward(pe, n, nullptr, d_pe, HP, n_hid, skip_mask,
                               w_stream, w_vec, b_out, out, stream);
}

// As sdf_mlp_count_forward, from the points x (n, 3) and the PE's multires
// (d_pe must be 3 (1 + 2 multires)).
int sdf_mlp_xyz_count_forward(const float* x, int n, const int* count,
                              int multires, int d_pe, int HP, int n_hid,
                              unsigned skip_mask, const void* w_stream,
                              const float* w_vec, const float* b_out,
                              float* out, void* stream) {
  if (n <= 0) return 0;
  const tc::Weights w{(const __nv_bfloat16*)w_stream, w_vec, b_out, d_pe,
                      n_hid, skip_mask};
  if (!tc::weights_ok(w) || multires < 0 || d_pe != 3 * (1 + 2 * multires))
    return (int)cudaErrorInvalidValue;
  return tc::dispatch_width(HP, [&](auto nwg) {
    return tc::launch(sdf_mlp_xyz_kernel<decltype(nwg)::value>, HP, w,
                      (n + TM - 1) / TM, stream, x, n, count, multires, out);
  });
}

int sdf_mlp_xyz_forward(const float* x, int n, int multires, int d_pe, int HP,
                        int n_hid, unsigned skip_mask, const void* w_stream,
                        const float* w_vec, const float* b_out, float* out,
                        void* stream) {
  return sdf_mlp_xyz_count_forward(x, n, nullptr, multires, d_pe, HP, n_hid,
                                   skip_mask, w_stream, w_vec, b_out, out,
                                   stream);
}

}  // extern "C"
