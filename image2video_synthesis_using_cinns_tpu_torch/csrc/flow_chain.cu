// The conditional-flow chain (reverse and forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_flow_fused` of the JAX package
// (image2video_synthesis_using_cinns_tpu/ops/pallas/flow_kernel.py, the
// pallas_call at :191). See ops/cuda/flow_kernel.py for what bounds it on the
// H100 (weight streaming: 94.4 MB of bf16 weights per BAIR chain, above the
// 50 MB L2) and what this first design does about it.
//
// Layout. Activations are fp32 row-major: x (B, C), emb (B, E). The weights
// of MLP layer l are packed as (n_flows, 2 passes, 2 nets (s, t), d_in, d_pad)
// in the weight type T (float or bf16), (in, out) order, the output width
// zero-padded to a multiple of kTileN; biases (n_flows, 2, 2, d_pad) fp32.
//
// Work per coupling pass: four mlp_layer launches, grid (d_pad / kTileN, 2):
// blockIdx.y picks the net (s or t), blockIdx.x a tile of kTileN output
// columns for all B rows. The CTA stages the layer input in shared memory
// (rounded to T, as the Pallas kernel casts `h.astype(w.dtype)`), streams its
// weight slab once, accumulates in fp32 and reduces its K slices in a fixed
// order. A one-CTA `glue` launch between passes applies the coupling update,
// the swap, the block's tail and the next block's head, and writes the next
// coupling input `concat(x_half * mask, emb)`.
//
// flow_chain returns cudaGetLastError() after each launch, and the number
// of kernels it launched in *n_launched (1 + 10 * n_flows); the Python
// wrapper raises when the error is not cudaSuccess. Nothing here synchronises
// or allocates: the wrapper passes the outputs and a scratch buffer of
// B*(C/2+E) + 4*B*H + 2*B*(C/2) floats. kMaxB and kTileN are repeated in
// ops/cuda/flow_kernel.py (MAX_BATCH, TILE_N); a CPU test holds them equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 16;                    // rows per call (the wrapper checks)
constexpr int kTileN = 16;                   // output columns per CTA
constexpr int kPairs = kTileN / 2;           // threads per weight row, two columns each
constexpr int kThreads = 256;
constexpr int kKSlices = kThreads / kPairs;  // K is strided over 32 thread slices
constexpr int kLoadsInFlight = 16;           // weight loads a thread issues at once
constexpr int kGlueThreads = 256;
constexpr float kLreluSlope = 0.01f;
constexpr float kInvLreluAlpha = 0.9f;

template <typename T> struct WeightType;

template <> struct WeightType<float> {
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <> struct WeightType<__nv_bfloat16> {
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// out[net, b, col] = act(sum_k round(in[net, b, k]) * w[net, k, col] + bias[net, col])
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_layer(const float* __restrict__ in, long long in_net_stride,
          const T* __restrict__ w, const float* __restrict__ bias,
          float* __restrict__ out, int B, int din, int dout, int dpad, int leaky) {
  extern __shared__ float smem[];
  float* h = smem;                // B * din
  float* red = smem + B * din;    // kKSlices * B * kTileN
  const int net = blockIdx.y;
  const int col0 = blockIdx.x * kTileN;
  const float* hin = in + net * in_net_stride;
  for (int i = threadIdx.x; i < B * din; i += kThreads) h[i] = WeightType<T>::round(hin[i]);
  __syncthreads();

  const int cp = threadIdx.x % kPairs;
  const int ks = threadIdx.x / kPairs;
  const T* wn = w + (size_t)net * din * dpad + col0 + 2 * cp;
  float acc0[kMaxB], acc1[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    acc0[b] = 0.f;
    acc1[b] = 0.f;
  }
  // kLoadsInFlight weight loads are issued before any is used: at a batch of
  // a few rows the layer is bound by load latency, not by arithmetic
  for (int k0 = ks; k0 < din; k0 += kKSlices * kLoadsInFlight) {
    float2 wv[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int k = k0 + u * kKSlices;
      wv[u] = k < din ? WeightType<T>::pair(wn + (size_t)k * dpad) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int k = k0 + u * kKSlices;
      if (k >= din) break;
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B) {
          const float hv = h[b * din + k];
          acc0[b] = fmaf(hv, wv[u].x, acc0[b]);
          acc1[b] = fmaf(hv, wv[u].y, acc1[b]);
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    if (b < B) {
      red[(ks * B + b) * kTileN + 2 * cp] = acc0[b];
      red[(ks * B + b) * kTileN + 2 * cp + 1] = acc1[b];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B * kTileN; i += kThreads) {
    const int b = i / kTileN, c = i % kTileN, col = col0 + c;
    if (col >= dout) continue;
    float s = 0.f;
    for (int j = 0; j < kKSlices; ++j) s += red[(j * B + b) * kTileN + c];
    s += bias[net * dpad + col];
    if (leaky) s = s >= 0.f ? s : kLreluSlope * s;
    out[((size_t)net * B + b) * dout + col] = s;
  }
}

// One CTA. In order, each step only where asked:
//   update:  x_keep = (x_keep - t) * exp(-s)  (reverse)  or  x_keep * exp(s) + t,
//            logdet += sum(s)  (forward), with (s, t) = st (2, B, C/2);
//   swap:    exchange the halves;
//   tail:    block `tail` ends: InvLeakyReLU^-1 and ActNorm^-1 (reverse)
//            or the shuffle x = x[:, perm[tail]] (forward);
//   head:    block `head` starts: x = x[:, perm[head]] (reverse) or ActNorm
//            with logdet += sum(log|scale|) and InvLeakyReLU (forward);
//   cin_blk: cin = concat(x[:, :C/2] * mask[cin_blk], emb).
// xsrc and xdst may alias: x is staged in shared memory first.
__global__ void __launch_bounds__(kGlueThreads)
glue(const float* xsrc, float* xdst, const float* __restrict__ st,
     const float* __restrict__ emb, float* __restrict__ cin, float* __restrict__ logdet,
     const float* __restrict__ loc, const float* __restrict__ scale,
     const int* __restrict__ perm, const float* __restrict__ mask,
     int B, int C, int E, int reverse, int update, int swap, int tail, int head,
     int cin_blk, int ld_init) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ts = smem + B * C;
  const int half = C / 2, n = B * C;
  for (int i = threadIdx.x; i < n; i += kGlueThreads) xs[i] = xsrc[i];
  const bool row_owner = !reverse && threadIdx.x < B;
  float ld = 0.f;
  if (row_owner && !ld_init) ld = logdet[threadIdx.x];
  __syncthreads();

  if (update) {
    for (int i = threadIdx.x; i < B * half; i += kGlueThreads) {
      const int b = i / half, j = i % half;
      const float s = st[i], t = st[B * half + i];
      float& xk = xs[b * C + half + j];
      xk = reverse ? (xk - t) * expf(-s) : xk * expf(s) + t;
    }
    if (row_owner) {
      float a = 0.f;
      for (int j = 0; j < half; ++j) a += st[threadIdx.x * half + j];
      ld += a;
    }
    __syncthreads();
  }
  if (swap) {
    for (int i = threadIdx.x; i < n; i += kGlueThreads) {
      const int b = i / C, j = i % C;
      ts[i] = xs[b * C + (j + half) % C];
    }
    __syncthreads();
    float* tmp = xs; xs = ts; ts = tmp;
  }
  if (tail >= 0) {
    if (reverse) {
      for (int i = threadIdx.x; i < n; i += kGlueThreads) {
        const int c = i % C;
        float v = xs[i];
        v = v >= 0.f ? v : v / kInvLreluAlpha;
        xs[i] = v / scale[tail * C + c] - loc[tail * C + c];
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kGlueThreads) {
        const int b = i / C, j = i % C;
        ts[i] = xs[b * C + perm[tail * C + j]];
      }
      __syncthreads();
      float* tmp = xs; xs = ts; ts = tmp;
    }
    __syncthreads();
  }
  if (head >= 0) {
    if (reverse) {
      for (int i = threadIdx.x; i < n; i += kGlueThreads) {
        const int b = i / C, j = i % C;
        ts[i] = xs[b * C + perm[head * C + j]];
      }
      __syncthreads();
      float* tmp = xs; xs = ts; ts = tmp;
    } else {
      for (int i = threadIdx.x; i < n; i += kGlueThreads) {
        const int c = i % C;
        const float v = (xs[i] + loc[head * C + c]) * scale[head * C + c];
        xs[i] = v >= 0.f ? v : kInvLreluAlpha * v;
      }
      if (row_owner) {
        float a = 0.f;
        for (int c = 0; c < C; ++c) a += logf(fabsf(scale[head * C + c]));
        ld += a;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += kGlueThreads) xdst[i] = xs[i];
  if (cin_blk >= 0) {
    const int din0 = half + E;
    const float m = mask[cin_blk];
    for (int i = threadIdx.x; i < B * din0; i += kGlueThreads) {
      const int b = i / din0, j = i % din0;
      cin[i] = j < half ? xs[b * C + j] * m : emb[b * E + j - half];
    }
  }
  if (row_owner) logdet[threadIdx.x] = ld;
}

struct Chain {
  const float* x_in;
  const float* emb;
  float* x_out;
  float* logdet;
  const void* w[4];
  const float* b[4];
  const float* loc;
  const float* scale;
  const int* perm;
  const float* mask;
  float* scratch;
  int B, C, E, H, n_flows, reverse;
  cudaStream_t stream;
};

template <typename T>
cudaError_t run_chain(const Chain& a, int* launched) {
  const int half = a.C / 2;
  const int din[4] = {half + a.E, a.H, a.H, a.H};
  const int dout[4] = {a.H, a.H, a.H, half};
  int dpad[4];
  size_t max_smem = 0;
  for (int l = 0; l < 4; ++l) {
    dpad[l] = (dout[l] + kTileN - 1) / kTileN * kTileN;
    const size_t smem = (size_t)(a.B * din[l] + kKSlices * a.B * kTileN) * sizeof(float);
    if (smem > max_smem) max_smem = smem;
  }
  cudaError_t err = cudaFuncSetAttribute(mlp_layer<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)max_smem);
  if (err != cudaSuccess) return err;

  float* cin = a.scratch;
  float* hbuf[2] = {cin + a.B * din[0], cin + a.B * din[0] + 2 * a.B * a.H};
  float* st = hbuf[1] + 2 * a.B * a.H;

  auto layers = [&](int blk, int pass) -> cudaError_t {
    const float* in = cin;
    long long stride = 0;  // both nets read the shared coupling input
    for (int l = 0; l < 4; ++l) {
      float* out = l == 3 ? st : hbuf[l % 2];
      const size_t slab = (size_t)(blk * 2 + pass) * 2;
      const T* wl = static_cast<const T*>(a.w[l]) + slab * din[l] * dpad[l];
      const float* bl = a.b[l] + slab * dpad[l];
      const size_t smem = (size_t)(a.B * din[l] + kKSlices * a.B * kTileN) * sizeof(float);
      mlp_layer<T><<<dim3(dpad[l] / kTileN, 2), kThreads, smem, a.stream>>>(
          in, stride, wl, bl, out, a.B, din[l], dout[l], dpad[l], l < 3);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      ++*launched;
      in = out;
      stride = (long long)a.B * dout[l];
    }
    return cudaSuccess;
  };
  const size_t glue_smem = (size_t)2 * a.B * a.C * sizeof(float);
  auto step = [&](const float* src, int update, int swap, int tail, int head, int cin_blk,
                  int ld_init) -> cudaError_t {
    glue<<<1, kGlueThreads, glue_smem, a.stream>>>(
        src, a.x_out, st, a.emb, cin, a.logdet, a.loc, a.scale, a.perm, a.mask,
        a.B, a.C, a.E, a.reverse, update, swap, tail, head, cin_blk, ld_init);
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
    return e;
  };

  const int n = a.n_flows;
  if (a.reverse) {
    // blocks n-1 .. 0: gather^-1, pass 1, swap, pass 0, InvLeakyReLU^-1, ActNorm^-1
    if ((err = step(a.x_in, 0, 0, -1, n - 1, n - 1, 0)) != cudaSuccess) return err;
    for (int i = n - 1; i >= 0; --i) {
      if ((err = layers(i, 1)) != cudaSuccess) return err;
      if ((err = step(a.x_out, 1, 1, -1, -1, i, 0)) != cudaSuccess) return err;
      if ((err = layers(i, 0)) != cudaSuccess) return err;
      const int next = i > 0 ? i - 1 : -1;
      if ((err = step(a.x_out, 1, 0, i, next, next, 0)) != cudaSuccess) return err;
    }
  } else {
    // blocks 0 .. n-1: ActNorm, InvLeakyReLU, pass 0, swap, pass 1, shuffle
    if ((err = step(a.x_in, 0, 0, -1, 0, 0, 1)) != cudaSuccess) return err;
    for (int i = 0; i < n; ++i) {
      if ((err = layers(i, 0)) != cudaSuccess) return err;
      if ((err = step(a.x_out, 1, 1, -1, -1, i, 0)) != cudaSuccess) return err;
      if ((err = layers(i, 1)) != cudaSuccess) return err;
      const int next = i + 1 < n ? i + 1 : -1;
      if ((err = step(a.x_out, 1, 0, i, next, next, 0)) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* flow_chain_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// perm is the inverse shuffle in reverse mode and the forward shuffle in
// forward mode; logdet (B,) is written in forward mode only. *n_launched gets
// the number of kernels launched, also when an error stops the chain early.
int flow_chain(const void* x_in, const void* emb, void* x_out, void* logdet,
               const void* w0, const void* w1, const void* w2, const void* w3,
               const void* b0, const void* b1, const void* b2, const void* b3,
               const void* loc, const void* scale, const void* perm, const void* mask,
               void* scratch, int B, int C, int E, int H, int n_flows, int reverse,
               int bf16, void* stream, int* n_launched) {
  *n_launched = 0;
  if (B < 1 || B > kMaxB || C < 2 || C % 2 || n_flows < 1) return (int)cudaErrorInvalidValue;
  Chain a;
  a.x_in = static_cast<const float*>(x_in);
  a.emb = static_cast<const float*>(emb);
  a.x_out = static_cast<float*>(x_out);
  a.logdet = static_cast<float*>(logdet);
  a.w[0] = w0; a.w[1] = w1; a.w[2] = w2; a.w[3] = w3;
  a.b[0] = static_cast<const float*>(b0);
  a.b[1] = static_cast<const float*>(b1);
  a.b[2] = static_cast<const float*>(b2);
  a.b[3] = static_cast<const float*>(b3);
  a.loc = static_cast<const float*>(loc);
  a.scale = static_cast<const float*>(scale);
  a.perm = static_cast<const int*>(perm);
  a.mask = static_cast<const float*>(mask);
  a.scratch = static_cast<float*>(scratch);
  a.B = B; a.C = C; a.E = E; a.H = H; a.n_flows = n_flows; a.reverse = reverse;
  a.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? run_chain<__nv_bfloat16>(a, n_launched) : run_chain<float>(a, n_launched);
  return (int)err;
}

}  // extern "C"
