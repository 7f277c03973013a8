// Fused bidirectional sphere-trace march for the no-grad trace,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mvsdf_tpu/tracing/pallas/march_kernel.py:258
// (pallas_sphere_trace, body _make_march_kernel): the whole march in one
// launch. A drop-in for tracing/sphere_trace._sphere_trace: per iteration
// (sphere_tracing_iters of them) a mask update (rows with |next| <=
// sdf_threshold stop), a step of the start march forward and the end march
// backward by the clipped SDF, and up to line_step_iters back-steps of
// (1 - line_step) 2^-j curr on the rows that overshot (SDF < 0); a ray
// stops when its start passes its end; a final bookkeeping-only mask
// update. Outputs t_s, t_e and the start march's unfinished mask.
//
// What bounds it: operations. Every evaluation is one full SDF-MLP row
// (~3.67 MFLOP at full width) against 36 bytes of input and 9 of output per
// ray. How many rows a ray needs depends on the field (2 to 82), so the
// kernel adds the rows it evaluated and the rows whose value the march used
// to an optional int64 counter; the bound is reckoned from the latter.
//
// Design. Every decision of the march is per ray, so rays may advance at
// different paces, in any tile, in any order, with the same result. The TPU
// kernel gave a block fixed rays and evaluated them all while any marched;
// here a block keeps its tile full of rays that still need values:
//  - persistent blocks, at most one an SM (the tensor-core tile of
//    mlp_tile_tc.cuh takes an SM's shared memory), each with 32 ray slots:
//    slot l's start point is row l of the block's 64-row tile, its end
//    point row l + 32;
//  - a global cursor over ray indices is the queue. A block with f free
//    slots claims the next f indices (one atomicAdd), writes t = 0 for the
//    rays that miss the bounding sphere, packs the others into its free
//    slots (ballot and popcount), and claims again until its slots are full
//    or the queue is empty;
//  - a ray's state (iteration; per row t, next, curr, unfinished, whether
//    the row waits for a value, its line-search index) lives in shared
//    memory and is advanced by lane l of warp 0 after each evaluation: a row
//    that overshot steps back and waits again; when no row of the ray
//    waits, the iteration is over, the ray applies t_s < t_e and the mask
//    update and takes the next step, or ends, writes its outputs and frees
//    its slot. One tile evaluation thus serves first evaluations, steps and
//    back-steps of different rays at once;
//  - the weights' producer thread cannot know whether another evaluation
//    follows: lane 0 tells it through a flag and an mbarrier as soon as the
//    bookkeeping is done, so the ring fills while the consumers write the
//    points' encoding, and the producer never starts a copy that no
//    evaluation awaits;
//  - the block leaves when the queue is empty and no slot is live.
// A live ray's row that waits for no value (its partner is in a line
// search, or it has converged) is still evaluated: the counter shows the
// price.
#include "mlp_tile_tc.cuh"

namespace {

using tc::CONSUMERS;
using tc::TM;
constexpr int SLOTS = TM / 2;  // rays per block: rows l and l + SLOTS
constexpr unsigned FULL = 0xffffffffu;

struct MarchParams {
  int iters;         // sphere_tracing_iters
  int line_iters;    // line_step_iters
  float line_scale;  // 1 - line_search_step
  float thr;         // sdf_threshold
  float clip;        // dist_clip
};

// The rays of a block's slots. Row r = l (start) or l + SLOTS (end).
struct Slots {
  float o[SLOTS][3], d[SLOTS][3];
  float t[TM], next[TM], curr[TM];
  int ray[SLOTS];  // the ray's index, -1: the slot is free
  int it[SLOTS];   // the iteration its rows are in, -1: before the first
  unsigned char unfin[TM], waits[TM], back[TM];
};

// Position of the k-th (from 0) set bit of m.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  for (int i = 0; i < k; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

template <int NWG>
__global__ void __launch_bounds__(tc::THREADS, 1)
march_kernel(const float* __restrict__ org, const float* __restrict__ dirs,
             const unsigned char* __restrict__ mask,
             const float* __restrict__ t_near,
             const float* __restrict__ t_far, int n, int multires,
             MarchParams p, float* __restrict__ t_s, float* __restrict__ t_e,
             unsigned char* __restrict__ unfin_s,
             unsigned long long* __restrict__ rows, int* __restrict__ queue,
             tc::Weights w, int stages) {
  __shared__ Slots s;
  __shared__ __align__(8) unsigned long long go_bar;
  __shared__ int go;  // whether another evaluation follows
  const int tid = threadIdx.x;
  const uint32_t go_addr = tc::smem_addr(&go_bar);
  if (tid == 0) tc::mbar_init(go_addr, 1);
  const tc::Tile tile = tc::tile_init<NWG>(w, stages);  // fences, syncs

  if (tid >= CONSUMERS) {
    // producer: one pass over the weights for every evaluation announced
    if (tid == CONSUMERS) {
      tc::RingPos pos = tc::producer_start();
      for (uint32_t parity = 0;; parity ^= 1u) {
        tc::mbar_wait(go_addr, parity);
        if (!*(volatile int*)&go) break;
        tc::produce_pass<NWG>(tile, w, pos);
      }
    }
    return;
  }

  const int l = tid;  // in warp 0: this lane's slot
  if (tid < SLOTS) s.ray[l] = -1;
  bool queue_empty = false;
  unsigned evals = 0, used = 0;
  tc::RingPos pos = tc::consumer_start();
  for (;;) {
    if (tid < SLOTS) {
      // 1. this lane's ray takes the values it waited for and moves on
      if (s.ray[l] >= 0) {
        bool stepping = false;
        for (int h = 0; h < 2; ++h) {
          const int r = l + h * SLOTS;
          if (s.waits[r]) {
            const float v = tc::tile_sdf(tile, w, r);
            s.next[r] = fminf(fmaxf(v, -p.clip), p.clip);
            s.waits[r] = 0;
            ++used;
          }
          // line search: halve the overshoot back, start down and end up
          if (s.it[l] >= 0 && s.next[r] < 0.f && s.back[r] < p.line_iters) {
            const float step = ldexpf(p.line_scale, -(int)s.back[r]) *
                               s.curr[r];
            s.t[r] = h ? s.t[r] + step : s.t[r] - step;
            ++s.back[r];
            s.waits[r] = 1;
            stepping = true;
          }
        }
        if (!stepping) {
          // the iteration is over for both rows
          bool u[2] = {s.unfin[l] != 0, s.unfin[l + SLOTS] != 0};
          if (s.it[l] >= 0 && !(s.t[l] < s.t[l + SLOTS])) u[0] = u[1] = false;
          const int it = ++s.it[l];
          // the mask update: of the next iteration, or the final one
          float c[2];
          for (int h = 0; h < 2; ++h) {
            c[h] = u[h] ? s.next[l + h * SLOTS] : 0.f;
            if (c[h] <= p.thr) c[h] = 0.f;
            u[h] = u[h] && c[h] > p.thr;
          }
          if (it < p.iters && (u[0] || u[1])) {
            for (int h = 0; h < 2; ++h) {
              const int r = l + h * SLOTS;
              s.unfin[r] = u[h];
              s.curr[r] = c[h];
              s.back[r] = 0;
              s.waits[r] = u[h];
              if (u[h])
                s.t[r] = h ? s.t[r] - c[h] : s.t[r] + c[h];
              else
                s.next[r] = 0.f;
            }
          } else {
            const int ray = s.ray[l];
            t_s[ray] = s.t[l];
            t_e[ray] = s.t[l + SLOTS];
            unfin_s[ray] = (unsigned char)u[0];
            s.ray[l] = -1;
          }
        }
      }
      __syncwarp();
      // 2. free slots take rays from the queue
      unsigned free = __ballot_sync(FULL, s.ray[l] < 0);
      while (free != 0 && !queue_empty) {
        const int want = __popc(free);
        int base = 0;
        if (l == 0) base = atomicAdd(queue, want);
        base = __shfl_sync(FULL, base, 0);
        queue_empty = base + want >= n;
        const int ray = base + l;
        const bool mine = l < want && ray < n;
        const bool hit = mine && mask[ray] != 0;
        if (mine && !hit) {
          t_s[ray] = 0.f;
          t_e[ray] = 0.f;
          unfin_s[ray] = 0;
        }
        const unsigned hits = __ballot_sync(FULL, hit);
        if (hit) {
          const int q = nth_set_bit(free, __popc(hits & ((1u << l) - 1u)));
          for (int k = 0; k < 3; ++k) {
            s.o[q][k] = org[3LL * ray + k];
            s.d[q][k] = dirs[3LL * ray + k];
          }
          s.t[q] = t_near[ray];
          s.t[q + SLOTS] = t_far[ray];
          for (int h = 0; h < 2; ++h) {
            const int r = q + h * SLOTS;
            s.next[r] = 0.f;
            s.curr[r] = 0.f;
            s.unfin[r] = 1;
            s.waits[r] = 1;
            s.back[r] = 0;
          }
          s.it[q] = -1;
          s.ray[q] = ray;
        }
        __syncwarp();
        free = __ballot_sync(FULL, s.ray[l] < 0);
      }
      // 3. the tile's points, and whether any ray needs them: a live ray
      // always waits for a value
      const bool live = s.ray[l] >= 0;
      for (int h = 0; h < 2; ++h) {
        const int r = l + h * SLOTS;
        for (int k = 0; k < 3; ++k)
          tile.xyz[3 * r + k] =
              live ? __fadd_rn(s.o[l][k], __fmul_rn(s.t[r], s.d[l][k])) : 0.f;
      }
      const unsigned any_live = __ballot_sync(FULL, live);
      if (l == 0) {
        go = any_live != 0;
        tc::mbar_arrive(go_addr);  // releases the flag to the producer
      }
    }
    tc::consumer_sync();
    if (!go) break;
    tc::consume_eval<NWG>(tile, w, pos, [&](const tc::PeTile& t) {
      tc::pe_from_points(t.xyz, multires, w.d_pe, t);
    });
    ++evals;
  }
  if (rows != nullptr && tid < SLOTS) {
    for (int off = 16; off > 0; off >>= 1)
      used += __shfl_xor_sync(FULL, used, off);
    if (l == 0) {
      atomicAdd(rows, (unsigned long long)evals * TM);
      atomicAdd(rows + 1, (unsigned long long)used);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Device pointers to contiguous arrays: org, dirs (n, 3) f32;
// mask (n) bool as bytes; t_near, t_far (n) f32; the weights as
// sdf_mlp_forward takes them (d_pe must be 3 (1 + 2 multires)); outputs
// t_s, t_e (n) f32 and unfin_s (n) bool as bytes. `rows`, when not null, is
// an int64 pair to which the kernel adds [rows evaluated, rows used].
// `queue` is one int32 that must be 0 when the kernel starts: the cursor
// over ray indices.
int march_forward(const float* org, const float* dirs,
                  const unsigned char* mask, const float* t_near,
                  const float* t_far, int n, int multires, int iters,
                  int line_iters, float line_scale, float thr, float clip,
                  int d_pe, int HP, int n_hid, unsigned skip_mask,
                  const void* w_stream, const float* w_vec,
                  const float* b_out, float* t_s, float* t_e,
                  unsigned char* unfin_s, long long* rows, int* queue,
                  void* stream) {
  if (n <= 0) return 0;
  const tc::Weights w{(const __nv_bfloat16*)w_stream, w_vec, b_out, d_pe,
                      n_hid, skip_mask};
  // every block's last claim may pass n by its 32 slots: the cursor must
  // not wrap; the line-search index is a byte
  if (!tc::weights_ok(w) || multires < 0 || iters < 0 || line_iters < 0 ||
      line_iters > 255 || n > (1 << 30) || d_pe != 3 * (1 + 2 * multires))
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = min(sms, (n + SLOTS - 1) / SLOTS);
  const MarchParams p{iters, line_iters, line_scale, thr, clip};
  return tc::dispatch_width(HP, [&](auto nwg) {
    return tc::launch(march_kernel<decltype(nwg)::value>, HP, w, blocks,
                      stream, org, dirs, mask, t_near, t_far, n, multires, p,
                      t_s, t_e, unfin_s,
                      reinterpret_cast<unsigned long long*>(rows), queue);
  });
}

}  // extern "C"
