// The SDF-MLP tile on Hopper's tensor cores (sm_90a), used by sdf_mlp.cu
// (one evaluation a block), secant.cu and march.cu (a loop of evaluations
// in a block).
//
// One block evaluates the SDF column of the packed weight-normalized MLP
// (pack_sdf_weights in sdf_mlp.py) for a tile of 64 rows. Every layer's
// product h @ W runs on `wgmma` (m64nNk16, bf16 operands, f32 accumulator)
// and stays f32-accurate by a bf16 hi/lo split of both operands:
//     h @ W ~= h_hi W_hi + h_lo W_hi + h_hi W_lo,
//     v_hi = bf16(v), v_lo = bf16(v - v_hi)
// (the dropped h_lo W_lo term is ~2^-18 relative). Design:
//  - 288 threads: two consumer warpgroups, each owning half of the HP
//    output columns of every layer (its accumulator is NWG / 2 registers a
//    thread), and one producer warp of which one thread streams weights;
//  - the weights are split once per step at packing and stored as the
//    sequence of k-step tiles the block consumes (16 rows of K x HP columns,
//    hi tile then lo tile), each tile already in the layout `wgmma` reads,
//    so feeding them is one contiguous `cp.async.bulk` per tile into a ring
//    of shared-memory stages, with full/empty `mbarrier`s;
//  - the tile's activation stays in shared memory as hi and lo bf16 copies
//    (4 bytes an element, what f32 would take); a layer's epilogue (bias,
//    the skip's 1/sqrt(2), softplus100, the split) runs in f32 on the
//    accumulator fragment and overwrites the activation in place once both
//    warpgroups have retired the layer's `wgmma`s;
//  - the skip layer is two K-ranges into one accumulator (h, then pe);
//  - the last layer (SDF column only) is an f32 dot product on the
//    accumulator fragment of the last hidden layer, reduced across the
//    quad by shuffles and across the two warpgroups in shared memory.
// Operand layout: both operands are K-major without swizzle, in `wgmma`'s
// core matrices of 8 rows x 8 bf16 (128 contiguous bytes); a warp's
// epilogue store of one accumulator column block is one such 128-byte
// line. Activation and PE: core matrix (row group rg, k group kg) at
// (kg * 8 + rg) * 128 bytes. Weight tile: W[k][n] at
// ((k / 8) * (HP / 8) + n / 8) * 128 + (n % 8) * 16 + (k % 8) * 2 bytes.
// Layers narrower than HP are zero-padded by the packing: a padded lane
// holds softplus(0) != 0, which the zero rows of the next matrix
// annihilate; the PE is padded from d_pe to KP lanes with zeros.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

constexpr int TM = 64;                   // rows per tile: wgmma's M
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 3;            // a k-step's two tiles and one ahead
constexpr int MAX_HIDDEN = 32;           // skip layers are a 32-bit mask
constexpr int SMEM_LIMIT = 232448;       // 227 KB a block on sm_90
// barriers, the warpgroups' partial sums, the tile's points
constexpr int OFF_FULL = 0;
constexpr int OFF_EMPTY = MAX_STAGES * 8;
constexpr int OFF_PART = 2 * MAX_STAGES * 8;
constexpr int OFF_XYZ = OFF_PART + 2 * TM * 4;
constexpr int OFF_ACT = OFF_XYZ + 3 * TM * 4;

// The packed weights (sdf_mlp.py): `stream` holds the k-step tiles in the
// order the block consumes them (input layer: KP / 16 k-steps; each hidden
// layer: HP / 16 over h, then KP / 16 over pe if it is a skip layer), hi
// tile then lo tile; `vec` is (n_hid + 2, HP) f32: b_in, b_hid..., w_out.
// Bit l of skip_mask marks hidden layer l.
struct Weights {
  const __nv_bfloat16* stream;
  const float* vec;
  const float* b_out;
  int d_pe;
  int n_hid;
  unsigned skip_mask;
};

__host__ __device__ inline int pe_lanes(int d_pe) { return (d_pe + 15) & ~15; }

inline bool weights_ok(const Weights& w) {
  return w.d_pe > 0 && w.n_hid >= 0 && w.n_hid <= MAX_HIDDEN &&
         (w.n_hid == 32 || (w.skip_mask >> w.n_hid) == 0);
}

// Host side: the ring's depth for the padded width HP, or 0 if the tile
// does not fit a block's shared memory; *bytes is the dynamic size.
// `static_bytes` is the static shared memory of the kernel around the
// tile: both count against the block's limit.
inline int plan_stages(int HP, int d_pe, size_t* bytes, int static_bytes) {
  const int fixed = OFF_ACT + 2 * TM * (HP + pe_lanes(d_pe)) * 2;
  const int stage = 16 * HP * 2;
  const int room = SMEM_LIMIT - static_bytes - fixed;
  int stages = room / stage;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (room < 0 || stages < MIN_STAGES) return 0;
  *bytes = (size_t)fixed + (size_t)stages * stage;
  return stages;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// --- mbarrier, bulk copy, named barrier ------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A wait
// that outlasts ~17 s of clocks can only be a lost stage: it traps, so a
// fault ends the launch with an error and not a hung device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long t = clock64();
    if (t0 == 0)
      t0 = t;
    else if (t - t0 > (1LL << 35))
      __trap();
  }
}

// One contiguous copy global -> shared that reports its bytes to `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Barrier of the 256 consumer threads (the producer warp takes no part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Makes this thread's shared-memory stores visible to `wgmma`'s reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, K-major, no swizzle: `lbo` is the byte
// distance between the two core matrices along K, `sbo` between 8-row
// groups along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define TC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TC_D16(i) TC_D4(i), TC_D4(i + 4), TC_D4(i + 8), TC_D4(i + 12)
#define TC_D64(i) TC_D16(i), TC_D16(i + 16), TC_D16(i + 32), TC_D16(i + 48)
#define TC_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TC_R16 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TC_R32                                                              \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63"
#define TC_R64                                                              \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, " \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "     \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
// d (+)= A B for one m64nNk16 step, A and B bf16 from shared memory (both
// K-major), d the warpgroup's f32 accumulator fragment; accumulate == 0
// overwrites d.
#define TC_WGMMA(N, REGS, A, B, P)                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                      \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS  \
  "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(TC_WGMMA(32, TC_R0, "%16", "%17", "%18")
               : TC_D16(0)
               : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(TC_WGMMA(64, TC_R0 ", " TC_R16, "%32", "%33", "%34")
               : TC_D16(0), TC_D16(16)
               : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(TC_WGMMA(128, TC_R0 ", " TC_R16 ", " TC_R32, "%64", "%65",
                        "%66")
               : TC_D64(0)
               : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(TC_WGMMA(256, TC_R0 ", " TC_R16 ", " TC_R32 ", " TC_R64,
                        "%128", "%129", "%130")
               : TC_D64(0), TC_D64(64)
               : "l"(a), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving uses of d across the point where the
// `wgmma`s that write it have retired.
template <int R>
__device__ __forceinline__ void fence_accumulator(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// --- arithmetic -------------------------------------------------------------

// softplus(beta = 100): log(1 + exp(100 x)) / 100 in the stable form
// max(x, 0) + log2(1 + 2^(-100 |x| log2 e)) ln 2 / 100. The second term is
// at most ln 2 / 100, so the hardware's ex2 / lg2 approximations (absolute
// error ~2^-22 on a log2 in [0, 1]) leave ~2e-9 absolute on h: below the
// f32 rounding of any h >= 0.03 and far below the bf16 split's 2^-17 h. The
// epilogue is serial with the tile's `wgmma`s, so its length is the tile's.
__device__ __forceinline__ float softplus100(float x) {
  const float t = -fabsf(x) * 144.26950408889634f;  // 100 log2(e)
  float e, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.f + e));
  return fmaf(l, 0.0069314718055994531f, fmaxf(x, 0.f));
}

// (a, b) -> packed bf16 pairs hi = bf16(v), lo = bf16(v - hi), a in the low
// half (the lower address).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The tile's positional encoding in shared memory, as hi and lo bf16
// copies of KP lanes in the activation's core-matrix layout; xyz is room
// for the tile's 3 * TM point coordinates.
struct PeTile {
  unsigned char* hi;
  unsigned char* lo;
  int KP;
  float* xyz;
  // lane k of row r
  __device__ __forceinline__ void put(int k, int r, float v) const {
    const int off = (((k >> 3) * 8 + (r >> 3)) << 7) + ((r & 7) << 4) +
                    ((k & 7) << 1);
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    *reinterpret_cast<__nv_bfloat16*>(hi + off) = h;
    *reinterpret_cast<__nv_bfloat16*>(lo + off) =
        __float2bfloat16_rn(v - __bfloat162float(h));
  }
};

// Writes the positional encoding of the points xyz[r][0..2] (shared
// memory, TM rows) into the tile, lanes as
// fields/embedder.positional_encoding orders them: x, then for i <
// multires sin(2^i x) and cos(2^i x), 3 lanes each; zeros above d_pe.
// sinf/cosf, not the fast intrinsics: the argument reaches ~32 at
// multires 6, where __sinf loses digits. Called by the consumer threads.
__device__ __forceinline__ void pe_from_points(const float* xyz, int multires,
                                               int d_pe, const PeTile& t) {
  const int n = TM * 3 * (1 + multires);
  for (int e = threadIdx.x; e < n; e += CONSUMERS) {
    const int r = e % TM;
    const int rest = e / TM;
    const int d = rest % 3;
    const int i = rest / 3;  // 0: identity, i >= 1: frequency 2^(i-1)
    const float x = xyz[r * 3 + d];
    if (i == 0) {
      t.put(d, r, x);
    } else {
      // 2^(i-1) x is exact, as in the plain version's x * 2.0 ** i
      const float xf = ldexpf(x, i - 1);
      const int lane = 3 + 6 * (i - 1) + d;
      t.put(lane, r, sinf(xf));
      t.put(lane + 3, r, cosf(xf));
    }
  }
  for (int e = threadIdx.x; e < TM * (t.KP - d_pe); e += CONSUMERS)
    t.put(d_pe + e / TM, e % TM, 0.f);
}

// --- the tile ---------------------------------------------------------------

// Number of weight tiles (ring stages) one block consumes.
__device__ __forceinline__ int stream_tiles(const Weights& w, int HP, int KP) {
  const int skips = __popc(w.skip_mask);
  return 2 * ((1 + skips) * (KP / 16) + w.n_hid * (HP / 16));
}

// The ring's read position of a consumer thread.
struct RingPos {
  int slot;
  uint32_t parity;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// acc (+)= A W over `ksteps` k-steps of the weight stream, A the hi/lo
// activation (or PE) at a_hi / a_lo (shared-memory addresses). Returns with
// every `wgmma` retired and the tiles released.
template <int NWG>
__device__ __forceinline__ void accumulate(float (&acc)[NWG / 2],
                                           uint32_t a_hi, uint32_t a_lo,
                                           int ksteps, bool overwrite,
                                           uint32_t smem, uint32_t ring,
                                           int stages, RingPos& pos) {
  constexpr int HP = 2 * NWG;
  constexpr uint32_t STAGE = 16 * HP * 2;
  const int wg = threadIdx.x >> 7;
  const bool elected = (threadIdx.x & 31) == 0;
  // this warpgroup's NWG columns of a weight tile
  const uint32_t b_off = wg * (NWG / 8) * 128;
  for (int k = 0; k < ksteps; ++k) {
    const uint64_t da_hi = make_desc(a_hi + k * 2048, 1024, 128);
    const uint64_t da_lo = make_desc(a_lo + k * 2048, 1024, 128);
    const int slot_hi = pos.slot;
    mbar_wait(smem + OFF_FULL + 8 * slot_hi, pos.parity);
    pos.advance(stages);
    const int slot_lo = pos.slot;
    mbar_wait(smem + OFF_FULL + 8 * slot_lo, pos.parity);
    pos.advance(stages);
    const uint64_t db_hi =
        make_desc(ring + slot_hi * STAGE + b_off, HP * 16, 128);
    const uint64_t db_lo =
        make_desc(ring + slot_lo * STAGE + b_off, HP * 16, 128);
    wgmma_fence();
    wgmma<NWG>(acc, da_hi, db_hi, !(overwrite && k == 0));
    wgmma<NWG>(acc, da_lo, db_hi, 1);
    wgmma<NWG>(acc, da_hi, db_lo, 1);
    wgmma_commit();
    wgmma_wait_all();
    if (elected) {
      mbar_arrive(smem + OFF_EMPTY + 8 * slot_hi);
      mbar_arrive(smem + OFF_EMPTY + 8 * slot_lo);
    }
  }
  fence_accumulator(acc);
}

// One block's tile in its dynamic shared memory (`stages` from plan_stages
// and that many bytes): the barriers, the warpgroups' partial sums, the
// points' scratch, the hi and lo activation, the hi and lo encoding, the
// ring. A kernel evaluates the tile any number of times: tile_init once,
// then for every evaluation one produce_pass by the producer thread and
// one consume_eval by the consumers, each side keeping its ring position
// from one evaluation to the next.
struct Tile {
  unsigned char* act_hi;
  unsigned char* act_lo;
  unsigned char* pe_hi;
  unsigned char* pe_lo;
  float* part;    // [2][TM]: each warpgroup's share of the rows' SDF
  float* xyz;     // [TM][3]: room for the tile's points
  uint32_t smem;  // shared-memory address of the barriers
  uint32_t ring;
  int KP;
  int stages;
};

// The ring positions before the first evaluation: the producer finds every
// stage empty, the consumers wait for the first fill.
__device__ __forceinline__ RingPos producer_start() { return {0, 1u}; }
__device__ __forceinline__ RingPos consumer_start() { return {0, 0u}; }

// Lays the tile out, initialises the ring's barriers and synchronizes the
// block. Called once by all THREADS threads.
template <int NWG>
__device__ __forceinline__ Tile tile_init(const Weights& w, int stages) {
  constexpr int HP = 2 * NWG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Tile t;
  t.KP = pe_lanes(w.d_pe);
  t.stages = stages;
  t.act_hi = smem_raw + OFF_ACT;
  t.act_lo = t.act_hi + TM * HP * 2;
  t.pe_hi = t.act_lo + TM * HP * 2;
  t.pe_lo = t.pe_hi + TM * t.KP * 2;
  t.part = reinterpret_cast<float*>(smem_raw + OFF_PART);
  t.xyz = reinterpret_cast<float*>(smem_raw + OFF_XYZ);
  t.smem = smem_addr(smem_raw);
  t.ring = smem_addr(t.pe_lo + TM * t.KP * 2);
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(t.smem + OFF_FULL + 8 * i, 1);               // the producer
      mbar_init(t.smem + OFF_EMPTY + 8 * i, CONSUMERS / 32);  // each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return t;
}

// Streams the weights through the ring once: one evaluation's worth.
// Called by the producer thread (threadIdx.x == CONSUMERS) alone. Every
// copy it starts is awaited by that evaluation's consume_eval, so a block
// whose evaluations all ran leaves with no copy in flight.
template <int NWG>
__device__ __forceinline__ void produce_pass(const Tile& t, const Weights& w,
                                             RingPos& pos) {
  constexpr int HP = 2 * NWG;
  constexpr uint32_t STAGE = 16 * HP * 2;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(w.stream);
  const int tiles = stream_tiles(w, HP, t.KP);
  for (int s = 0; s < tiles; ++s) {
    mbar_wait(t.smem + OFF_EMPTY + 8 * pos.slot, pos.parity);
    bulk_load(t.ring + pos.slot * STAGE, src + (size_t)s * STAGE, STAGE,
              t.smem + OFF_FULL + 8 * pos.slot);
    pos.advance(t.stages);
  }
}

// SDF of the tile's row r after consume_eval.
__device__ __forceinline__ float tile_sdf(const Tile& t, const Weights& w,
                                          int r) {
  return t.part[r] + t.part[TM + r] + __ldg(w.b_out);
}

// Evaluates the tile once: tile_sdf(t, w, r) is the SDF of row r when it
// returns. Called by the 256 consumer threads (threadIdx.x < CONSUMERS).
// `fill_pe(PeTile)` runs first and writes all TM x KP lanes of the tile's
// encoding; it may use consumer_sync() (it must, between another thread's
// writes of the points and its own reads) and the tile's xyz scratch. Ends
// with a consumer barrier: the caller may read every row's SDF and
// overwrite t.xyz when it returns.
template <int NWG, typename FillPe>
__device__ __forceinline__ void consume_eval(const Tile& t, const Weights& w,
                                             RingPos& pos, FillPe fill_pe) {
  constexpr int HP = 2 * NWG;
  const int tid = threadIdx.x;
  unsigned char* act_hi = t.act_hi;
  unsigned char* act_lo = t.act_lo;
  const uint32_t smem = t.smem, ring = t.ring;
  const int KP = t.KP, stages = t.stages;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  fill_pe(PeTile{t.pe_hi, t.pe_lo, KP, t.xyz});
  fence_async_smem();
  consumer_sync();

  float acc[NWG / 2];
  const float inv_sqrt2 = 0.70710678118654752f;
  // this thread's accumulator: rows 16 warp + lane / 4 (+ 8), columns
  // wg NWG + 8 j + 2 (lane % 4) (+ 1), j < NWG / 8
  const int col0 = wg * NWG + 2 * (lane & 3);
  const int store0 = (((wg * (NWG / 8)) * 8 + 2 * warp) << 7) +
                     ((lane >> 2) << 4) + ((lane & 3) << 2);
  for (int L = 0; L <= w.n_hid; ++L) {
    const bool skip = L > 0 && ((w.skip_mask >> (L - 1)) & 1u);
    if (L == 0) {
      accumulate<NWG>(acc, smem_addr(t.pe_hi), smem_addr(t.pe_lo), KP / 16,
                      true, smem, ring, stages, pos);
    } else {
      accumulate<NWG>(acc, smem_addr(act_hi), smem_addr(act_lo), HP / 16,
                      true, smem, ring, stages, pos);
      if (skip)
        accumulate<NWG>(acc, smem_addr(t.pe_hi), smem_addr(t.pe_lo), KP / 16,
                        false, smem, ring, stages, pos);
    }
    const float scale = skip ? inv_sqrt2 : 1.f;
    const float* __restrict__ b = w.vec + (size_t)L * HP + col0;
    if (L < w.n_hid) {
      // h = softplus100(acc * scale + b), split and stored in place once
      // both warpgroups have read the old h
      consumer_sync();
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        const float2 bj = __ldg(reinterpret_cast<const float2*>(b + 8 * j));
        uint32_t hi, lo;
        split2(softplus100(fmaf(acc[4 * j + 0], scale, bj.x)),
               softplus100(fmaf(acc[4 * j + 1], scale, bj.y)), hi, lo);
        *reinterpret_cast<uint32_t*>(act_hi + store0 + j * 1024) = hi;
        *reinterpret_cast<uint32_t*>(act_lo + store0 + j * 1024) = lo;
        split2(softplus100(fmaf(acc[4 * j + 2], scale, bj.x)),
               softplus100(fmaf(acc[4 * j + 3], scale, bj.y)), hi, lo);
        *reinterpret_cast<uint32_t*>(act_hi + store0 + j * 1024 + 128) = hi;
        *reinterpret_cast<uint32_t*>(act_lo + store0 + j * 1024 + 128) = lo;
      }
      fence_async_smem();
      consumer_sync();
    } else {
      // SDF column: f32 dot of the last activation with w_out
      const float* __restrict__ wo =
          w.vec + (size_t)(w.n_hid + 1) * HP + col0;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < NWG / 8; ++j) {
        const float2 bj = __ldg(reinterpret_cast<const float2*>(b + 8 * j));
        const float2 wj = __ldg(reinterpret_cast<const float2*>(wo + 8 * j));
        s0 = fmaf(softplus100(fmaf(acc[4 * j + 0], scale, bj.x)), wj.x, s0);
        s0 = fmaf(softplus100(fmaf(acc[4 * j + 1], scale, bj.y)), wj.y, s0);
        s1 = fmaf(softplus100(fmaf(acc[4 * j + 2], scale, bj.x)), wj.x, s1);
        s1 = fmaf(softplus100(fmaf(acc[4 * j + 3], scale, bj.y)), wj.y, s1);
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      if ((lane & 3) == 0) {
        const int r = 16 * warp + (lane >> 2);
        t.part[wg * TM + r] = s0;
        t.part[wg * TM + r + 8] = s1;
      }
      consumer_sync();
    }
  }
}

// --- launching (host side) --------------------------------------------------

// f(std::integral_constant<int, NWG>()) for the instantiation of the padded
// width HP (each consumer warpgroup's `wgmma` is m64 x n(HP / 2) x k16), or
// cudaErrorInvalidValue for a width the tile is not built for.
template <typename F>
int dispatch_width(int HP, F f) {
  switch (HP) {
    case 64:
      return f(std::integral_constant<int, 32>());
    case 128:
      return f(std::integral_constant<int, 64>());
    case 256:
      return f(std::integral_constant<int, 128>());
    case 512:
      return f(std::integral_constant<int, 256>());
  }
  return (int)cudaErrorInvalidValue;
}

// Sets the kernel's dynamic shared memory (the tile, beside whatever
// static shared memory the kernel declares) and launches `blocks` blocks on
// `stream`; the kernel takes args..., then the weights and the ring's depth.
// Returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int HP, const Weights& w, int blocks, void* stream,
           Args... args) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  const int stages = plan_stages(HP, w.d_pe, &smem, (int)attr.sharedSizeBytes);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(args..., w, stages);
  return (int)cudaGetLastError();
}

}  // namespace tc
