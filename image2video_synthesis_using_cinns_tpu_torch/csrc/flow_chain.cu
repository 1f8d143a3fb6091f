// The conditional-flow chain (reverse and forward) for Hopper, sm_90a: one
// persistent, cooperative launch per chain.
//
// Replaces the Pallas TPU kernel `_flow_fused` of the JAX package
// (image2video_synthesis_using_cinns_tpu/ops/pallas/flow_kernel.py, the
// pallas_call at :191).
//
// What bounds it. At the BAIR shape (B=6, C=64, E=64, hidden 512, 20 blocks)
// a chain reads 94.4 MB of bf16 weights (28 us at 3.35 TB/s) and does about
// 0.57 GFLOP. But its 160 MLP layers run one after the other, and each layer
// needs all of its net's outputs of the layer before. So the floor of this
// design is 160 hand-offs between CTAs in a row (stores to L2, a signal, and
// loads of them by the CTAs that need them) with a tile's math after each,
// not the bytes.
//
// Design, against the five things that held the first design (one launch per
// MLP layer, 201 per chain) back:
//  1. Launches: one launch per chain. One CTA per SM, launched with
//     cudaLaunchCooperativeKernel, so a grid that cannot be co-resident is
//     refused with an error instead of deadlocking. x (B, C), the coupling
//     input (its embedding columns written once), and every block's ActNorm,
//     shuffle and mask stay in each CTA's shared memory for the whole chain.
//  2. Idle SMs: every layer's output columns, both nets (s, t) together, are
//     cut into tiles of kTileN columns: 128 tiles for a 512-wide layer.
//     Tile g of the chain (counted in chain order) belongs to CTA
//     g % gridDim.x, so each CTA knows at launch which weight slabs it needs
//     and in which order. PackedFlow stores each tile's slab (d_in x kTileN
//     weights) contiguously.
//  3. Bytes in flight: a ring of `stages` slots in shared memory (128 KB),
//     filled by cp.async.bulk with one mbarrier per slot; a slot holds one
//     tile's weights and its kTileN biases.
//  4. Loads waiting on activations: the ring runs `stages` tiles ahead of
//     the math (16 in bf16, about five coupling passes of a CTA's tiles at
//     the BAIR shape; 7 in fp32), across layers, passes and blocks. One extra warp of the CTA only loads: it refills a slot as
//     soon as the math threads mark it used (a second mbarrier per slot), so
//     no load is issued on the chain's path.
//  5. The one-CTA glue: after a pass every CTA waits for (s, t) and, in one
//     pass over its own x in shared memory, applies the coupling update, the
//     swap, the block's tail and the next block's head, and writes the next
//     coupling input's first half. That adds no hand-off and no wait before
//     the next pass. CTA 0 writes x_out and logdet.
//
// No grid barrier. A layer's tile needs only its own net's outputs of the
// layer before, so each net has a count of finished tiles: a CTA adds its
// tiles (release) and a reader waits for the count (acquire), then loads the
// outputs. The last layer's (s, t), which every CTA needs, travel instead in
// 8-byte units: an fp32 and a 32-bit flag that names the call and the pass.
// An aligned 8-byte store is seen whole or not at all, so a CTA that loads
// the flag it expects has the value too, with no fence on the writer. (Flags
// on the hidden layers' outputs as well, polled by every reader, measured
// slower: 64 CTAs re-reading the same lines of L2 while they are written.)
// The timeline build's probe times a whole grid barrier alone, written by
// hand and as cooperative groups' grid sync, for comparison.
//
// Buffers are reused with no further wait. The hidden outputs go to two
// buffers (layers 0 and 2 share one), (s, t) to two by pass parity. A CTA
// overwrites a buffer only after it has seen, through a count or the flags,
// outputs that every reader of the old contents made after reading it:
// layer l + 2 of a net needs all of layer l + 1, whose tiles read layer l;
// layer 0 of pass q + 1 follows the glue of pass q, which needs all of
// (s, t), whose tiles read layer 2; and the (s, t) of pass q + 2 need layers
// 0-2 of pass q + 1, whose CTAs read the (s, t) of pass q in their glue
// first. The last holds because every CTA owns a tile in layers 0-2 of every
// pass: the grid has at most as many CTAs as those layers have tiles.
//
// The counts only grow during a chain; the last CTA out zeroes them, so the
// workspace is zeroed once, when made. The flags name the call (its seq), so
// units left by an earlier call never match.
//
// The tile's math: in bf16 mode on the tensor cores (mma.sync m16n8k16,
// 16 rows of which B are real), warp w taking the K steps w, w + 8, ...; in
// fp32 mode with FFMA, K strided over 64 thread slices, each holding the
// products of its rows for two columns and `rows` batch rows (B rounded up
// to a compiled size, so the row loop is unrolled and free of branches), the
// 8 slices of a warp summed by a shuffle butterfly. Then the 8 warps' partial
// sums are added in order in shared memory.
//
// Numerics are the first design's. In bf16 mode every layer's input is
// rounded to bf16, as the Pallas kernel casts `h.astype(w.dtype)`: the
// coupling input when it is built, a hidden layer's output when it is
// stored (so the next layer reads half the bytes); sums and biases are fp32,
// and (s, t) stay fp32. The fp32 mode rounds nowhere and uses FFMA only.
// Each output is summed by one CTA in a fixed order, with no atomics, so
// results repeat bitwise.
//
// Layout. Activations are fp32 row-major: x (B, C), emb (B, E). The weights
// of MLP layer l are (n_flows, 2 passes, tiles, d_in, kTileN) in the weight
// type T (float or bf16), where tiles = 2 * d_pad / kTileN, the s net's tiles
// first, and d_pad is the output width zero-padded to a multiple of kTileN;
// biases are (n_flows, 2, 2, d_pad) fp32.
//
// flow_chain returns the launch's error, and the number of kernels it
// launched (1) in *n_launched; the Python wrapper raises when the error is
// not cudaSuccess. Nothing here synchronises or allocates: the wrapper
// passes the outputs and the stream's workspace. kMaxB, kTileN,
// kBarrierWords and kFlagShift are repeated in ops/cuda/flow_kernel.py
// (MAX_BATCH, TILE_N, BARRIER_WORDS, SEQ_LIMIT); a CPU test holds them equal.
//
// Built with FLOW_CHAIN_TIMELINE defined (csrc/flow_chain_timeline.cu), the
// kernel also records clock64() at up to six points of every layer in every
// CTA, and each CTA's entry and exit on clock64() and on the global timer,
// and a grid-barrier probe is exported; chip_smoke.py reads both.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxB = 16;                    // rows per call (the wrapper checks)
constexpr int kTileN = 8;                    // output columns per tile
constexpr int kPairs = kTileN / 2;           // threads per weight row, two columns each
constexpr int kThreads = 256;               // the math's threads; one more warp loads weights
constexpr int kWarps = kThreads / 32;
constexpr int kKSlices = kThreads / kPairs;  // K is strided over 64 thread slices
constexpr int kLayers = 4;                   // the one specialised MLP depth
constexpr int kBiasBytes = kTileN * 4;       // a ring slot starts with its tile's biases
constexpr int kRingBytes = 128 * 1024;
constexpr int kMaxStages = 16;
constexpr int kStageVecs = 8;                // 16-byte loads in flight per thread when staging
constexpr int kPollUnits = 8;                // 8-byte loads in flight per thread when polling
constexpr int kFlagShift = 9;                // a flag is seq << 9 | (pass of the chain + 1)
constexpr long long kSpinLimit = 1LL << 32;  // clock cycles (about 2 s) before a wait traps
constexpr int kMaxDevices = 64;
constexpr int kLineWords = 32;               // one 128-byte line
// the counts: CTAs out of the kernel [0], then a line for each net's count
// of finished tiles
constexpr int kBarrierWords = 3 * kLineWords;
constexpr float kLreluSlope = 0.01f;
constexpr float kInvLreluAlpha = 0.9f;

#ifdef FLOW_CHAIN_TIMELINE
constexpr int kTimelineCtas = 256, kTimelineLayers = 512, kTimelinePoints = 6;
__device__ long long g_timeline[kTimelineCtas][kTimelineLayers][kTimelinePoints];
#define TIMELINE(layer, point)                                                         \
  do {                                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kTimelineCtas && (layer) < kTimelineLayers) { \
      g_timeline[blockIdx.x][layer][point] = clock64();                                \
      if ((point) == 0)                                                                \
        for (int pt = 1; pt < 4; ++pt) g_timeline[blockIdx.x][layer][pt] = 0;          \
    }                                                                                  \
  } while (0)
// the global timer (ns, one clock for all SMs) into point 2 + `point` of the last row
#define TIMELINE_GLOBAL(point)                                                      \
  do {                                                                              \
    if (threadIdx.x == 0 && blockIdx.x < kTimelineCtas) {                           \
      long long ns;                                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                         \
      g_timeline[blockIdx.x][kTimelineLayers - 1][2 + (point)] = ns;                \
    }                                                                               \
  } while (0)
#else
#define TIMELINE(layer, point) \
  do {                         \
    (void)(layer);             \
  } while (0)
#endif

template <typename T> struct WeightType;

template <> struct WeightType<float> {
  __device__ __forceinline__ static float narrow(float v) { return v; }
  __device__ __forceinline__ static float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ static float load_cg(const float* p) { return __ldcg(p); }
};

template <> struct WeightType<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 narrow(float v) { return __float2bfloat16_rn(v); }
  __device__ __forceinline__ static __nv_bfloat16 load_cg(const __nv_bfloat16* p) {
    return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
  }
};

struct Params {
  const float* x_in;
  const float* emb;
  float* x_out;
  float* logdet;
  const unsigned char* w[kLayers];
  const float* b[kLayers];
  const float* loc;
  const float* scale;
  const int* perm;
  const float* mask;
  unsigned char* hbuf[2];       // hidden layers' outputs in T, (2 nets, B, H) each
  unsigned long long* st[2];    // the last layer's (s, t) as units, (2, B, C/2), by pass parity
  unsigned* barrier;            // kBarrierWords of counts, zero at launch and at exit
  unsigned flag_base;           // this call's seq << kFlagShift
  int B, C, E, n_flows, reverse;
  int rows;                     // rows of hin: 16 in bf16 mode (the MMA's M), else B rounded
                                // up to a compiled row count
  int hs0, hs;                  // row strides in elements of hin0 and hin
  int din[kLayers], dout[kLayers];
  int tiles[kLayers];           // tiles of a layer, both nets
  int tile_off[kLayers + 1];    // first tile of each layer within a pass; [kLayers]: per pass
  int slab_bytes[kLayers];      // d_in * kTileN * sizeof(T)
  int slot_bytes, stages, n_jobs;
  // shared memory, byte offsets
  int sm_x, sm_tmp, sm_hin0, sm_hin, sm_red, sm_st, sm_const, sm_bar, sm_ring;
};

// Pointers into one CTA's shared memory. x and tmp trade places.
struct Smem {
  float* x;
  float* tmp;
  unsigned char* hin0;  // the coupling input in T, (rows, hs0): x's kept half * mask, emb
  unsigned char* hin;   // a hidden layer's input in T, (rows, hs)
  float* red;   // the warps' partial sums of a tile
  float* st;    // (s, t) of the last pass
  float* loc;   // every block's ActNorm loc, scale, shuffle and mask, and
  float* scale; // the forward's sum(log|scale|) of each block
  int* perm;
  float* mask;
  float* lsum;
};

// ---- PTX helpers: mbarriers, bulk copies, release/acquire ----------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A: the 16 x 16 bf16 tile at `row` (this lane's row address), B: the
// 16 x 8 tile of 16 rows of 16 bytes at `row`, transposed into the col layout
__device__ __forceinline__ void ldmatrix_a(uint32_t a[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_b(uint32_t b[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(row)));
}

// d (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed_u64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_u64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A barrier of the kThreads math threads only (named barrier 1): the loader
// warp never joins it.
__device__ __forceinline__ void sync_math() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// ---- the hand-offs between layers ---------------------------------------

// A layer's tile needs only one net's outputs of the layer before, so each
// net has its own count of finished tiles, which only grows during a chain:
// a CTA adds the tiles it made (release, after the CTA barrier that orders
// its threads' stores) and waits, before it stages a net's outputs, until
// that net's count reaches `target` (acquire). A CTA with no tile in the
// next layer does not wait.
__device__ __forceinline__ void net_arrive(unsigned* counter, const int made[2]) {
  if (threadIdx.x == 0) {
    for (int n = 0; n < 2; ++n)
      if (made[n] > 0) red_add_release(counter + (n + 1) * kLineWords, made[n]);
  }
}

__device__ __forceinline__ void count_wait(const unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire(count) < target) {
      if (clock64() - t0 > kSpinLimit) __trap();  // a fault, not a hang
    }
  }
  sync_math();
}

// At its end each CTA counts itself out in counter[0]; the last one out
// zeroes every count, since no CTA reads them again. So the counts start at
// zero in the next call on the stream, and the wrapper zeroes them only
// once, with the workspace.
__device__ __forceinline__ void grid_exit(unsigned* counter) {
  if (threadIdx.x == 0 && atomicAdd(counter, 1u) == gridDim.x - 1) {
    atomicExch(counter + kLineWords, 0u);
    atomicExch(counter + 2 * kLineWords, 0u);
    atomicExch(counter, 0u);
  }
}

// ---- the pieces of the chain ---------------------------------------------

__device__ __forceinline__ int block_pass(const Params& p, int q) {  // blk * 2 + pass of step q
  const int blk = p.reverse ? p.n_flows - 1 - q / 2 : q / 2;
  const int pass = p.reverse ? 1 - (q & 1) : (q & 1);
  return blk * 2 + pass;
}

// Start loading tile g of the chain (biases and weights) into `slot`.
__device__ void issue(const Params& p, int g, unsigned char* slot, uint64_t* bar) {
  const int per_pass = p.tile_off[kLayers];
  const int q = g / per_pass;
  const int r = g - q * per_pass;
  int l = 0;
  while (r >= p.tile_off[l + 1]) ++l;
  const size_t tile = static_cast<size_t>(block_pass(p, q)) * p.tiles[l] + (r - p.tile_off[l]);
  mbar_expect_tx(bar, kBiasBytes + p.slab_bytes[l]);
  bulk_load(slot, p.b[l] + tile * kTileN, kBiasBytes, bar);
  bulk_load(slot + kBiasBytes, p.w[l] + tile * p.slab_bytes[l], p.slab_bytes[l], bar);
}

// Waits until the units src[0..n) all carry `flag`, and hands each one's
// payload to put(i, payload). A thread loads kPollUnits units at once and
// loads those without the flag again together, so each round of waiting
// costs one trip to L2.
template <typename Put>
__device__ __forceinline__ void poll_units(const unsigned long long* src, int n, unsigned flag,
                                           Put put) {
  for (int base = 0; base < n; base += kPollUnits * kThreads) {
    unsigned long long v[kPollUnits];
    unsigned pending = 0;  // bit u: unit u not yet seen with the flag
#pragma unroll
    for (int u = 0; u < kPollUnits; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < n) {
        v[u] = ld_relaxed_u64(src + i);
        pending |= 1u << u;
      }
    }
    const long long t0 = clock64();
    while (true) {
#pragma unroll
      for (int u = 0; u < kPollUnits; ++u) {
        if ((pending >> u & 1u) && static_cast<unsigned>(v[u] >> 32) == flag) {
          put(base + u * kThreads + threadIdx.x, static_cast<unsigned>(v[u]));
          pending &= ~(1u << u);
        }
      }
      if (pending == 0) break;
      if (clock64() - t0 > kSpinLimit) __trap();  // a fault, not a hang
#pragma unroll
      for (int u = 0; u < kPollUnits; ++u) {
        if (pending >> u & 1u) v[u] = ld_relaxed_u64(src + base + u * kThreads + threadIdx.x);
      }
    }
  }
}

// hin[b, k] = src[b, k] for b < B, k < din: a layer's input in T, written
// by other CTAs in this launch, so read past L1. kStageVecs 16-byte loads
// per thread are in flight before any is stored; hin's rows are hs apart.
template <typename T>
__device__ void stage(T* hin, int hs, const T* src, int B, int din) {
  constexpr int kVec = 16 / sizeof(T);
  if (din % kVec != 0) {
    for (int i = threadIdx.x; i < B * din; i += kThreads)
      hin[(i / din) * hs + i % din] = WeightType<T>::load_cg(src + i);
    return;
  }
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  const int per_row = din / kVec, nv = B * per_row;
  for (int base = 0; base < nv; base += kStageVecs * kThreads) {
    uint4 v[kStageVecs];
#pragma unroll
    for (int u = 0; u < kStageVecs; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < nv) v[u] = __ldcg(s4 + i);
    }
#pragma unroll
    for (int u = 0; u < kStageVecs; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < nv) *reinterpret_cast<uint4*>(hin + (i / per_row) * hs + (i % per_row) * kVec) = v[u];
    }
  }
}

// The end of a tile: out[b, col0 + c] = act(the warps' partial sums
// red[warp, b, c] added in order, + bias[c]) for b < B. A hidden layer's
// output is stored in T; the last layer's (s, t) stay fp32, stored as 8-byte
// units carrying `flag`.
template <typename T>
__device__ __forceinline__ void tile_out(const float* red, int red_rows, const float* bias,
                                         void* out, int col0, int dout, int B, bool last,
                                         unsigned flag) {
  if (threadIdx.x < B * kTileN) {
    const int b = threadIdx.x / kTileN, c = threadIdx.x % kTileN, col = col0 + c;
    float part[kWarps];
#pragma unroll
    for (int j = 0; j < kWarps; ++j) part[j] = red[(j * red_rows + b) * kTileN + c];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) s += part[j];
    s += bias[c];
    if (col < dout) {
      if (last) {
        st_relaxed_u64(static_cast<unsigned long long*>(out) + b * dout + col,
                       static_cast<unsigned long long>(flag) << 32 | __float_as_uint(s));
      } else {
        s = s >= 0.f ? s : kLreluSlope * s;
        static_cast<T*>(out)[b * dout + col] = WeightType<T>::narrow(s);
      }
    }
  }
}

// One tile in bf16 mode on the tensor cores: out (B x kTileN) = hin (16 rows,
// B of them real) x w (din x kTileN), fp32 sums. Warp w takes the K steps
// w, w + kWarps, ... of 16 rows each (mma.sync m16n8k16); a step past din
// (din = C/2 + E need not be a multiple of 16) reads zeros: the input's
// columns from din are zeroed at the kernel's start and never written, and
// the weights' rows from din are masked here.
__device__ __forceinline__ void tile_mma(const __nv_bfloat16* hin, int hs, int din,
                                         const unsigned char* slot, float* red, void* out,
                                         int col0, int dout, int B, bool last, unsigned flag) {
  const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(slot + kBiasBytes);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  const __nv_bfloat16* arow = hin + (((lane >> 3) & 1) * 8 + (lane & 7)) * hs + (lane >> 4) * 8;
  const __nv_bfloat16* brow = w + (lane & 15) * kTileN;
  for (int k0 = warp * 16; k0 < din; k0 += kWarps * 16) {
    uint32_t a[4], b[2];
    ldmatrix_a(a, arow + k0);
    ldmatrix_b(b, brow + k0 * kTileN);
    if (k0 + 16 > din) {
      if (k0 + 2 * t >= din) b[0] = 0u;
      if (k0 + 8 + 2 * t >= din) b[1] = 0u;
    }
    mma_bf16(d, a, b);
  }
  red[(warp * 16 + g) * kTileN + 2 * t] = d[0];
  red[(warp * 16 + g) * kTileN + 2 * t + 1] = d[1];
  red[(warp * 16 + g + 8) * kTileN + 2 * t] = d[2];
  red[(warp * 16 + g + 8) * kTileN + 2 * t + 1] = d[3];
  sync_math();
  tile_out<__nv_bfloat16>(red, 16, reinterpret_cast<const float*>(slot), out, col0, dout, B, last,
                          flag);
}

// One tile in fp32 mode with FFMA: out[b, col0 + c] = act(sum_k hin[b, k] *
// w[k, c] + bias[c]), w and bias from a ring slot. kRows >= B rows are
// computed; rows past B are never stored. K is strided over kKSlices thread
// slices; the 8 slices of a warp are summed by a shuffle butterfly (over lane
// bits 2..4, the same sum in every lane), the warps in order.
template <int kRows>
__device__ __forceinline__ void tile_ffma(const float* hin, int hs, int din,
                                          const unsigned char* slot, float* red, void* out,
                                          int col0, int dout, int B, bool last, unsigned flag) {
  const float* w = reinterpret_cast<const float*>(slot + kBiasBytes);
  const int cp = threadIdx.x % kPairs;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float acc0[kRows], acc1[kRows];
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    acc0[b] = 0.f;
    acc1[b] = 0.f;
  }
#pragma unroll 4
  for (int k = threadIdx.x / kPairs; k < din; k += kKSlices) {
    const float2 wv = WeightType<float>::pair(w + k * kTileN + 2 * cp);
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const float hv = hin[b * hs + k];
      acc0[b] = fmaf(hv, wv.x, acc0[b]);
      acc1[b] = fmaf(hv, wv.y, acc1[b]);
    }
  }
#pragma unroll
  for (int off = kPairs; off < 32; off *= 2) {
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      acc0[b] += __shfl_xor_sync(0xffffffffu, acc0[b], off);
      acc1[b] += __shfl_xor_sync(0xffffffffu, acc1[b], off);
    }
  }
  if (lane < kPairs) {
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      red[(warp * kRows + b) * kTileN + 2 * cp] = acc0[b];
      red[(warp * kRows + b) * kTileN + 2 * cp + 1] = acc1[b];
    }
  }
  sync_math();
  tile_out<float>(red, kRows, reinterpret_cast<const float*>(slot), out, col0, dout, B, last, flag);
}

// Every CTA, on its own copy of x in shared memory, in one pass: output
// x'[b, j] comes from x[b, src] with src = j, (j + C/2) % C (swap) or a
// shuffle, and each step below applies only where asked, in this order:
//   update:  on the kept half, x = (x - t) * exp(-s)  (reverse)  or
//            x * exp(s) + t, logdet += sum(s)  (forward); (s, t) = sm.st,
//            (2, B, C/2);
//   swap:    exchange the halves;
//   tail:    block `tail` ends: InvLeakyReLU^-1 and ActNorm^-1 (reverse)
//            or the shuffle x = x[:, perm[tail]] (forward);
//   head:    block `head` starts: x = x[:, perm[head]] (reverse) or ActNorm
//            with logdet += sum(log|scale|) and InvLeakyReLU (forward);
//   cin_blk: the coupling input's first C/2 columns, hin0[:, :C/2] =
//            x'[:, :C/2] * mask[cin_blk] in T (its embedding columns are
//            written once, at the kernel's start).
// Thread b < B keeps row b's logdet in `ld` (forward).
template <typename T>
__device__ void glue(const Params& p, Smem& sm, float& ld, bool update, bool swap, int tail,
                     int head, int cin_blk) {
  const int B = p.B, C = p.C, half = C / 2;
  const int tid = threadIdx.x;
  const int shuffle = swap ? -1 : p.reverse ? head : tail;  // the block whose perm gathers
  T* hin0 = reinterpret_cast<T*>(sm.hin0);
  const float m = cin_blk >= 0 ? sm.mask[cin_blk] : 0.f;
  for (int i = tid; i < B * C; i += kThreads) {
    const int b = i / C, j = i % C;
    const int src = swap ? (j + half) % C : shuffle >= 0 ? sm.perm[shuffle * C + j] : j;
    float v = sm.x[b * C + src];
    if (update && src >= half) {
      const float s = sm.st[b * half + src - half], t = sm.st[(B + b) * half + src - half];
      v = p.reverse ? (v - t) * expf(-s) : v * expf(s) + t;
    }
    if (p.reverse && tail >= 0) {
      v = v >= 0.f ? v : v / kInvLreluAlpha;
      v = v / sm.scale[tail * C + src] - sm.loc[tail * C + src];
    }
    if (!p.reverse && head >= 0) {
      v = (v + sm.loc[head * C + j]) * sm.scale[head * C + j];
      v = v >= 0.f ? v : kInvLreluAlpha * v;
    }
    sm.tmp[i] = v;
    if (cin_blk >= 0 && j < half) hin0[b * p.hs0 + j] = WeightType<T>::narrow(v * m);
  }
  sync_math();
  float* t = sm.x; sm.x = sm.tmp; sm.tmp = t;
  if (!p.reverse && tid < B) {
    if (update) {
      float a = 0.f;
      for (int j = 0; j < half; ++j) a += sm.st[tid * half + j];
      ld += a;
    }
    if (head >= 0) ld += sm.lsum[head];
  }
}

// One tile of the layer input at hin_b (row stride hs): tensor cores in bf16
// mode, FFMA over a compiled row count in fp32 mode.
template <typename T>
__device__ __forceinline__ void tile(const Params& p, const Smem& sm, const unsigned char* hin_b,
                                     int hs, int din,
                                     const unsigned char* slot, void* out, int col0, int dout,
                                     bool last, unsigned flag) {
  if constexpr (sizeof(T) == 2) {
    tile_mma(reinterpret_cast<const T*>(hin_b), hs, din, slot, sm.red, out, col0, dout, p.B,
             last, flag);
  } else {
    const float* hin = reinterpret_cast<const float*>(hin_b);
    switch (p.rows) {
#define FLOW_CHAIN_ROWS(R)                                                            \
  case R:                                                                             \
    tile_ffma<R>(hin, hs, din, slot, sm.red, out, col0, dout, p.B, last, flag);       \
    break;
      FLOW_CHAIN_ROWS(2)
      FLOW_CHAIN_ROWS(4)
      FLOW_CHAIN_ROWS(6)
      FLOW_CHAIN_ROWS(8)
      FLOW_CHAIN_ROWS(12)
      FLOW_CHAIN_ROWS(16)
#undef FLOW_CHAIN_ROWS
    }
  }
}

constexpr int kRowCounts[] = {2, 4, 6, 8, 12, 16};  // the cases of tile's FFMA path

template <typename T>
__global__ void __launch_bounds__(kThreads + 32, 1) chain_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nc = p.n_flows * p.C;
  Smem sm;
  sm.x = reinterpret_cast<float*>(smem + p.sm_x);
  sm.tmp = reinterpret_cast<float*>(smem + p.sm_tmp);
  sm.hin = smem + p.sm_hin;
  sm.hin0 = smem + p.sm_hin0;
  sm.red = reinterpret_cast<float*>(smem + p.sm_red);
  sm.st = reinterpret_cast<float*>(smem + p.sm_st);
  sm.loc = reinterpret_cast<float*>(smem + p.sm_const);
  sm.scale = sm.loc + nc;
  sm.perm = reinterpret_cast<int*>(sm.scale + nc);
  sm.mask = reinterpret_cast<float*>(sm.perm + nc);
  sm.lsum = sm.mask + p.n_flows;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.sm_bar);  // a slot's tile has landed
  uint64_t* empty = full + p.stages;                               // a slot's tile is used
  unsigned char* ring = smem + p.sm_ring;
  const int tid = threadIdx.x;
  const int grid = gridDim.x;
#ifdef FLOW_CHAIN_TIMELINE
  TIMELINE(kTimelineLayers - 1, 0);  // the kernel's entry, and below (point 1) its exit
  TIMELINE_GLOBAL(0);
#endif

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= kThreads) {  // the loader warp: this CTA's tiles in order, `stages` ahead
    if (tid == kThreads) {
      for (int j = 0;; ++j) {
        const int g = blockIdx.x + j * grid;
        if (g >= p.n_jobs) break;
        const int s = j % p.stages;
        if (j >= p.stages) mbar_wait(&empty[s], (j / p.stages - 1) & 1);
        issue(p, g, ring + s * p.slot_bytes, &full[s]);
      }
    }
    return;
  }

  // hin0 and hin start at zero, so every column that an MMA's K step may
  // read past d_in is 0; then the embedding goes into the coupling input's
  // columns C/2 .. C/2 + E for the whole chain
  const int words0 = p.rows * p.hs0 * static_cast<int>(sizeof(T)) / 4;
  const int words = p.rows * p.hs * static_cast<int>(sizeof(T)) / 4;
  for (int i = tid; i < words0; i += kThreads) reinterpret_cast<uint32_t*>(sm.hin0)[i] = 0u;
  for (int i = tid; i < words; i += kThreads) reinterpret_cast<uint32_t*>(sm.hin)[i] = 0u;
  sync_math();
  for (int i = tid; i < p.B * p.E; i += kThreads)
    reinterpret_cast<T*>(sm.hin0)[(i / p.E) * p.hs0 + p.C / 2 + i % p.E] =
        WeightType<T>::narrow(p.emb[i]);
  for (int i = tid; i < nc; i += kThreads) {
    sm.loc[i] = p.loc[i];
    sm.scale[i] = p.scale[i];
    sm.perm[i] = p.perm[i];
  }
  for (int i = tid; i < p.n_flows; i += kThreads) sm.mask[i] = p.mask[i];
  for (int i = tid; i < p.B * p.C; i += kThreads) sm.x[i] = p.x_in[i];
  sync_math();
  for (int blk = tid; blk < p.n_flows && !p.reverse; blk += kThreads) {  // the forward's logdet
    float a = 0.f;
    for (int c = 0; c < p.C; ++c) a += logf(fabsf(sm.scale[blk * p.C + c]));
    sm.lsum[blk] = a;
  }
  sync_math();
  float ld = 0.f;
  const int first = p.reverse ? p.n_flows - 1 : 0;
  glue<T>(p, sm, ld, false, false, -1, first, first);

  int g = blockIdx.x;  // this CTA's next tile
  int slot_i = 0;      // its ring slot, and the parity of that slot's fill to wait for
  unsigned parity = 0;
  const int per_pass = p.tile_off[kLayers];
  // the tiles of one net in layers 0..l of a pass, and in the three hidden layers
  const unsigned net_done[3] = {static_cast<unsigned>(p.tiles[0] / 2),
                                static_cast<unsigned>((p.tiles[0] + p.tiles[1]) / 2),
                                static_cast<unsigned>((p.tiles[0] + p.tiles[1] + p.tiles[2]) / 2)};
  const unsigned per_net = net_done[2];
  for (int q = 0; q < 2 * p.n_flows; ++q) {
    const unsigned flag = p.flag_base + q + 1;  // of this pass's (s, t)
    for (int l = 0; l < kLayers; ++l) {
      const int li = q * kLayers + l;
      TIMELINE(li, 0);
      const int base = q * per_pass + p.tile_off[l];
      const int din = p.din[l], dout = p.dout[l], net_tiles = p.tiles[l] / 2;
      const bool last = l == kLayers - 1;
      const T* in = reinterpret_cast<const T*>(p.hbuf[(l + 1) & 1]);  // layer l - 1's, l > 0
      unsigned char* out = last ? reinterpret_cast<unsigned char*>(p.st[q & 1]) : p.hbuf[l & 1];
      const size_t out_item = last ? sizeof(unsigned long long) : sizeof(T);
      int staged = -1;  // the net whose input hin holds (layer 0: the shared coupling input)
      int made[2] = {0, 0};
      for (; g < base + p.tiles[l]; g += grid) {
        const int t = g - base;
        const int net = t / net_tiles;
        ++made[net];
        if (l > 0 && staged != net) {  // the net's tiles of layer l - 1, this pass and before
          count_wait(p.barrier + (net + 1) * kLineWords, q * per_net + net_done[l - 1]);
          stage<T>(reinterpret_cast<T*>(sm.hin), p.hs, in + static_cast<size_t>(net) * p.B * din,
                   p.B, din);
          sync_math();
          staged = net;
        }
        TIMELINE(li, 1);
        mbar_wait(&full[slot_i], parity);
        TIMELINE(li, 2);
        unsigned char* slot = ring + slot_i * p.slot_bytes;
        tile<T>(p, sm, l == 0 ? sm.hin0 : sm.hin, l == 0 ? p.hs0 : p.hs, din,
                slot, out + static_cast<size_t>(net) * p.B * dout * out_item,
                (t % net_tiles) * kTileN, dout, last, flag);
        sync_math();  // the slot, hin and red are free again
        if (tid == 0) mbar_arrive(&empty[slot_i]);
        if (++slot_i == p.stages) {
          slot_i = 0;
          parity ^= 1u;
        }
        TIMELINE(li, 3);
      }
      if (!last) {  // (s, t) carry their flag instead
        net_arrive(p.barrier, made);
        TIMELINE(li, 4);
      }
    }
    const int li = q * kLayers + kLayers - 1;
    poll_units(p.st[q & 1], 2 * p.B * (p.C / 2), flag,
               [&](int i, uint32_t v) { sm.st[i] = __uint_as_float(v); });
    sync_math();
    TIMELINE(li, 4);
    const int blk = block_pass(p, q) / 2;
    if ((q & 1) == 0) {  // the block's first pass: update, swap, the other pass's input
      glue<T>(p, sm, ld, true, true, -1, -1, blk);
    } else {             // its second: update, the block's tail, the next block's head
      const int next = p.reverse ? blk - 1 : blk + 1;
      const int more = next >= 0 && next < p.n_flows ? next : -1;
      glue<T>(p, sm, ld, true, false, blk, more, more);
    }
    TIMELINE(li, 5);
  }
  grid_exit(p.barrier);
  if (blockIdx.x == 0) {
    for (int i = tid; i < p.B * p.C; i += kThreads) p.x_out[i] = sm.x[i];
    if (!p.reverse && tid < p.B) p.logdet[tid] = ld;
  }
#ifdef FLOW_CHAIN_TIMELINE
  TIMELINE(kTimelineLayers - 1, 1);
  TIMELINE_GLOBAL(1);
#endif
}

long long round128(long long bytes) { return (bytes + 127) / 128 * 128; }

struct Device {
  int sms, cooperative, smem_optin;
};

// The card's SM count, cooperative-launch support and shared-memory limit,
// read once per device.
cudaError_t device_of_call(Device* d) {
  static Device cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev].sms == 0) {
    Device got;
    if ((err = cudaDeviceGetAttribute(&got.cooperative, cudaDevAttrCooperativeLaunch, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&got.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&got.sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return err;
    cache[dev] = got;
  }
  *d = cache[dev];
  return cudaSuccess;
}

template <typename T>
cudaError_t run_chain(Params& p, int H, cudaStream_t stream, int* launched) {
  Device dev;
  cudaError_t err = device_of_call(&dev);
  if (err != cudaSuccess) return err;
  if (!dev.cooperative) return cudaErrorNotSupported;

  const int half = p.C / 2;
  const int din[kLayers] = {half + p.E, H, H, H};
  const int dout[kLayers] = {H, H, H, half};
  int max_slab = 0;
  p.tile_off[0] = 0;
  for (int l = 0; l < kLayers; ++l) {
    p.din[l] = din[l];
    p.dout[l] = dout[l];
    p.tiles[l] = 2 * ((dout[l] + kTileN - 1) / kTileN);
    p.tile_off[l + 1] = p.tile_off[l] + p.tiles[l];
    p.slab_bytes[l] = din[l] * kTileN * static_cast<int>(sizeof(T));
    if (p.slab_bytes[l] > max_slab) max_slab = p.slab_bytes[l];
  }
  // one CTA per SM, but no more than the tiles of layers 0-2 of a pass, so
  // that every CTA owns a tile there in every pass (see the buffers' reuse)
  const int grid = dev.sms < p.tile_off[kLayers - 1] ? dev.sms : p.tile_off[kLayers - 1];
  const long long n_jobs = 2LL * p.n_flows * p.tile_off[kLayers];
  if (n_jobs + static_cast<long long>(kMaxStages) * grid > INT_MAX) return cudaErrorInvalidValue;
  p.n_jobs = static_cast<int>(n_jobs);
  p.rows = kMaxB;
  for (int r : kRowCounts) {
    if (sizeof(T) == sizeof(float) && r >= p.B) {
      p.rows = r;
      break;
    }
  }
  // rows reach the MMA's last K step, plus 8 elements against bank conflicts
  p.hs0 = (din[0] + 15) / 16 * 16 + 8;
  p.hs = (H + 15) / 16 * 16 + 8;
  p.slot_bytes = (kBiasBytes + max_slab + 127) / 128 * 128;
  p.stages = kRingBytes / p.slot_bytes < kMaxStages ? kRingBytes / p.slot_bytes : kMaxStages;
  if (p.stages < 2) return cudaErrorInvalidValue;  // a slab above 64 KB: hidden width too large

  long long off = 0;
  auto carve = [&off](long long bytes) {
    const long long at = off;
    off = (off + bytes + 127) / 128 * 128;
    return static_cast<int>(at);
  };
  const long long f = sizeof(float);
  p.sm_x = carve(p.B * p.C * f);
  p.sm_tmp = carve(p.B * p.C * f);
  p.sm_hin0 = carve(static_cast<long long>(p.rows) * p.hs0 * static_cast<long long>(sizeof(T)));
  p.sm_hin = carve(static_cast<long long>(p.rows) * p.hs * static_cast<long long>(sizeof(T)));
  p.sm_red = carve(kWarps * kMaxB * kTileN * f);
  p.sm_st = carve(2 * p.B * half * f);
  p.sm_const = carve((3LL * p.C + 2) * p.n_flows * f);  // loc, scale, perm, mask, lsum
  p.sm_bar = carve(2LL * p.stages * static_cast<long long>(sizeof(uint64_t)));
  p.sm_ring = carve(static_cast<long long>(p.stages) * p.slot_bytes);
  if (off > dev.smem_optin) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(off);

  if ((err = cudaFuncSetAttribute(chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<T>,
                                                           kThreads + 32, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chain_kernel<T>), dim3(grid),
                                    dim3(kThreads + 32), args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the refused launch, which is reported here
    return err;
  }
  *launched = 1;
  return cudaSuccess;
}

#ifdef FLOW_CHAIN_TIMELINE
// A grid barrier written by hand, for the probe below (the chain needs
// none). counter[0] counts arrivals, and `epoch` counts this CTA's barriers
// from 1, so the barrier is passed when counter[0] reaches epoch *
// gridDim.x. The release covers the CTA's writes, which the CTA barrier
// orders before it.
__device__ __forceinline__ void grid_sync(unsigned* counter, unsigned epoch) {
  sync_math();
  if (threadIdx.x == 0) {
    red_add_release(counter, 1u);
    const unsigned target = epoch * gridDim.x;
    const long long t0 = clock64();
    while (ld_acquire(counter) < target) {
      if (clock64() - t0 > kSpinLimit) __trap();  // a fault, not a hang
    }
  }
  sync_math();
}

__global__ void __launch_bounds__(kThreads, 1) barrier_probe(unsigned* counter, int n) {
  for (int i = 1; i <= n; ++i) {
    if (counter == nullptr) {
      cg::this_grid().sync();
    } else {
      grid_sync(counter, i);
    }
  }
}
#endif

}  // namespace

extern "C" {

const char* flow_chain_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// perm is the inverse shuffle in reverse mode and the forward shuffle in
// forward mode; logdet (B,) is written in forward mode only. work is the
// stream's workspace, work_bytes long: zeroed before its first call, then
// left to the kernel, which keeps the counts at zero between calls. seq
// numbers the calls on it from 1, below 2^(32 - kFlagShift): the flags of the
// (s, t) units name the call, so a workspace is zeroed again before seq
// repeats. *n_launched gets the number
// of kernels launched: 1, or 0 when the launch was refused.
int flow_chain(const void* x_in, const void* emb, void* x_out, void* logdet,
               const void* w0, const void* w1, const void* w2, const void* w3,
               const void* b0, const void* b1, const void* b2, const void* b3,
               const void* loc, const void* scale, const void* perm, const void* mask,
               void* work, long long work_bytes, unsigned seq, int B, int C, int E, int H,
               int n_flows, int reverse, int bf16, void* stream, int* n_launched) {
  *n_launched = 0;
  if (B < 1 || B > kMaxB || C < 2 || C % 2 || E < 0 || H < 1 || n_flows < 1 ||
      2LL * n_flows >= (1 << kFlagShift) || seq == 0 ||
      seq >= (1u << (32 - kFlagShift)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x_in = static_cast<const float*>(x_in);
  p.emb = static_cast<const float*>(emb);
  p.x_out = static_cast<float*>(x_out);
  p.logdet = static_cast<float*>(logdet);
  p.w[0] = static_cast<const unsigned char*>(w0);
  p.w[1] = static_cast<const unsigned char*>(w1);
  p.w[2] = static_cast<const unsigned char*>(w2);
  p.w[3] = static_cast<const unsigned char*>(w3);
  p.b[0] = static_cast<const float*>(b0);
  p.b[1] = static_cast<const float*>(b1);
  p.b[2] = static_cast<const float*>(b2);
  p.b[3] = static_cast<const float*>(b3);
  p.loc = static_cast<const float*>(loc);
  p.scale = static_cast<const float*>(scale);
  p.perm = static_cast<const int*>(perm);
  p.mask = static_cast<const float*>(mask);
  // the workspace: the counts, two (s, t) buffers of 8-byte units, two
  // hidden buffers, all sized for kMaxB rows (the hidden ones in fp32)
  const long long bar_bytes = round128(kBarrierWords * sizeof(unsigned));
  const long long st_bytes = round128(2LL * kMaxB * (C / 2) * sizeof(unsigned long long));
  const long long h_bytes = round128(2LL * kMaxB * H * sizeof(float));
  if (work_bytes < bar_bytes + 2 * st_bytes + 2 * h_bytes) return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(work);
  p.barrier = reinterpret_cast<unsigned*>(w);
  p.st[0] = reinterpret_cast<unsigned long long*>(w + bar_bytes);
  p.st[1] = reinterpret_cast<unsigned long long*>(w + bar_bytes + st_bytes);
  p.hbuf[0] = w + bar_bytes + 2 * st_bytes;
  p.hbuf[1] = w + bar_bytes + 2 * st_bytes + h_bytes;
  p.flag_base = seq << kFlagShift;
  p.B = B; p.C = C; p.E = E; p.n_flows = n_flows; p.reverse = reverse;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? run_chain<__nv_bfloat16>(p, H, st, n_launched)
                               : run_chain<float>(p, H, st, n_launched);
  return (int)err;
}

#ifdef FLOW_CHAIN_TIMELINE
// The last chain's timeline, (kTimelineCtas, kTimelineLayers, kTimelinePoints)
// int64 clock64() readings; dims gets the three sizes, and a null host gets
// nothing else. The last row holds each CTA's entry (0) and exit (1), and
// the same on the global timer in ns (2 and 3). Points per CTA and layer of the chain: 0 start, 1 input
// staged, 2 weights ready, 3 tile done (1-3 are 0 where the CTA had no tile),
// 4 the layer's count released (layers 0-2 of a pass) or (s, t) arrived (a
// pass's last layer), and on the last layer 5 glue done.
int flow_chain_timeline(void* host, int* dims) {
  dims[0] = kTimelineCtas;
  dims[1] = kTimelineLayers;
  dims[2] = kTimelinePoints;
  if (host == nullptr) return 0;
  return (int)cudaMemcpyFromSymbol(host, g_timeline, sizeof(g_timeline));
}

// n grid barriers in a row on one CTA per SM: cooperative groups' grid sync
// (counter null) or the one written by hand (counter: one zeroed unsigned).
int flow_chain_barrier_probe(void* counter, int n, void* stream) {
  Device dev;
  cudaError_t err = device_of_call(&dev);
  if (err != cudaSuccess) return (int)err;
  unsigned* c = static_cast<unsigned*>(counter);
  void* args[] = {&c, &n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_probe), dim3(dev.sms),
                                    dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
#endif

}  // extern "C"
