// Split-KV single-token GQA decode attention over a dense KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::
// decode_attention_kernel (Pallas body `_kernel`): one new query token per
// lane attends keys [0, length) of the lane's cache k/v (B, T, Hkv, D).
// Same function: scale 1/sqrt(D), float32 online softmax, output in q's
// dtype, keys at or past `length` never read, a length-0 lane gives zeros
// (the Pallas finalize acc / max(l, 1e-30) with acc = l = 0).
//
// What bounds it on the H100: device-memory bytes.  For every key a kv head
// does 4*G*D flops (QK and PV for the G query heads of its group) against
// 2*D*sizeof(T) bytes of K and V: with G = 4 in bf16 that is 4 flops per
// byte, far below the ~295 the card needs before the tensor cores are the
// limit.  The least time is the valid K/V rows (plus q and out) over
// 3.35 TB/s.
//
// What the design does about it:
// * the Pallas kernel walks T in blocks of `bk` on a sequential grid axis
//   with its softmax state in VMEM scratch.  Blocks on the card run in
//   parallel and in no order, so the key axis is split across blocks
//   instead (flash-decoding): grid (splits, Hkv, B), each block reduces
//   its `split` keys to a partial (max, sum, acc) per query head in
//   float32 scratch, and a second kernel combines the partials of each
//   (lane, kv head).  At B 1 that is still Hkv * T / split blocks, where
//   one block per (lane, kv head) would give 8 blocks for 132 SMs;
// * a block whose first key is at or past `length` returns at once and
//   the combine ignores it, so a short lane in a long cache reads only its
//   valid rows, and any T works (no `bk | T` requirement);
// * the G query heads of a group share every K and V row the block reads:
//   one warp per key computes the G scores (lanes split D, shuffles
//   reduce), one thread per output column accumulates G sums over V;
// * only keys below `length` enter the softmax, so no score is -inf
//   inside a block; the combine guards exp(-inf - -inf) for lanes with no
//   keys and divides by max(l, 1e-30).
// Left for later: 16-byte vector loads, K/V staged through shared memory
// with cp.async, the combine folded into the last block of each group.
//
// C interface for ctypes: returns cudaGetLastError() after the launches, or
// a negative code for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;      // head dims up to 256: D / 32 <= 8 per lane
constexpr int kMaxSplit = 128;  // keys per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int clamp_len(int len, int t) {
  return len < 0 ? 0 : (len > t ? t : len);
}

// Partial pass: block (sp, h, b) reduces keys [sp*split, min((sp+1)*split,
// len)) for the G query heads of kv head h.  Writes, per query head g,
// pm = max score, pl = sum exp(s - pm), pacc[c] = sum exp(s - pm) v[c].
template <typename T, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lengths,
                      float* __restrict__ pm, float* __restrict__ pl,
                      float* __restrict__ pacc, int t_len, int hq, int hkv, int d,
                      int split, int n_split, float scale) {
  __shared__ float qs[MAXG * kMaxD];     // G x D, pre-scaled by 1/sqrt(D)
  __shared__ float sc[MAXG * kMaxSplit];  // G x split: scores, then exp

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int g = hq / hkv;
  const int len = clamp_len(lengths[b], t_len);
  const int t0 = sp * split;
  if (t0 >= len) return;  // no valid key here: the combine skips this split
  const int n = min(split, len - t0);

  const long long qoff = ((long long)b * hq + (long long)h * g) * d;
  for (int i = tid; i < g * d; i += kThreads) qs[i] = to_f32(q[qoff + i]) * scale;
  __syncthreads();

  // Scores: one warp per key, lanes over D, shuffles sum the G dots.
  const int warp = tid / 32, lane = tid % 32;
  const long long row = (long long)hkv * d;  // elements per token of the cache
  const T* kb = k + ((long long)b * t_len + t0) * row + (long long)h * d;
  for (int t = warp; t < n; t += kWarps) {
    const T* kr = kb + t * row;
    float s[MAXG];
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) s[gi] = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float kc = to_f32(kr[c]);
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
        if (gi < g) s[gi] = fmaf(qs[gi * d + c], kc, s[gi]);
    }
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      if (gi < g) {
        float x = s[gi];
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        if (lane == 0) sc[gi * kMaxSplit + t] = x;
      }
    }
  }
  __syncthreads();

  // Softmax statistics of this split: one warp per query head.
  const long long pbase = (((long long)b * hkv + h) * n_split + sp) * g;
  for (int gi = warp; gi < g; gi += kWarps) {
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sc[gi * kMaxSplit + t]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sc[gi * kMaxSplit + t] - mx);  // n >= 1: mx is finite
      sc[gi * kMaxSplit + t] = p;
      sum += p;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      pm[pbase + gi] = mx;
      pl[pbase + gi] = sum;
    }
  }
  __syncthreads();

  // PV: one thread per output column, G sums each; V rows read once.
  const T* vb = v + ((long long)b * t_len + t0) * row + (long long)h * d;
  for (int c = tid; c < d; c += kThreads) {
    float a[MAXG];
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) a[gi] = 0.f;
    for (int t = 0; t < n; ++t) {
      const float vc = to_f32(vb[t * row + c]);
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
        if (gi < g) a[gi] = fmaf(sc[gi * kMaxSplit + t], vc, a[gi]);
    }
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi)
      if (gi < g) pacc[(pbase + gi) * d + c] = a[gi];
  }
}

// Combine pass: block (h, b) merges the partials of the splits that hold
// valid keys into out[b, h*G + g, :].
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const int* __restrict__ lengths, const float* __restrict__ pm,
                      const float* __restrict__ pl, const float* __restrict__ pacc,
                      T* __restrict__ out, int t_len, int hq, int hkv, int d, int split,
                      int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g = hq / hkv;
  const int len = clamp_len(lengths[b], t_len);
  const int n_act = (len + split - 1) / split;  // 0 for a length-0 lane
  const long long pbase = ((long long)b * hkv + h) * n_split * g;
  const long long obase = ((long long)b * hq + (long long)h * g) * d;
  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d, c = i - gi * d;
    float mx = -INFINITY;
    for (int s = 0; s < n_act; ++s) mx = fmaxf(mx, pm[pbase + (long long)s * g + gi]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < n_act; ++s) {
      const long long p = pbase + (long long)s * g + gi;
      const float w = expf(pm[p] - mx);  // n_act >= 1 here, so mx is finite
      l = fmaf(pl[p], w, l);
      acc = fmaf(pacc[p * d + c], w, acc);
    }
    out[obase + i] = from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int MAXG>
void launch_partial(const void* q, const void* k, const void* v, const int* lengths,
                    float* pm, float* pl, float* pacc, int b, int t_len, int hq, int hkv,
                    int d, int split, int n_split, float scale, cudaStream_t s) {
  const dim3 grid(n_split, hkv, b);
  decode_partial_kernel<T, MAXG><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      pm, pl, pacc, t_len, hq, hkv, d, split, n_split, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths, float* pm,
           float* pl, float* pacc, void* out, int b, int t_len, int hq, int hkv, int d,
           int split, int n_split, cudaStream_t s) {
  const int g = hq / hkv;
  const float scale = 1.0f / sqrtf((float)d);
  if (g <= 4)
    launch_partial<T, 4>(q, k, v, lengths, pm, pl, pacc, b, t_len, hq, hkv, d, split, n_split,
                         scale, s);
  else if (g <= 8)
    launch_partial<T, 8>(q, k, v, lengths, pm, pl, pacc, b, t_len, hq, hkv, d, split, n_split,
                         scale, s);
  else
    launch_partial<T, 16>(q, k, v, lengths, pm, pl, pacc, b, t_len, hq, hkv, d, split,
                          n_split, scale, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(hkv, b), kThreads, 0, s>>>(
      lengths, pm, pl, pacc, static_cast<T*>(out), t_len, hq, hkv, d, split, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, D); k/v: (B, T, Hkv, D); lengths: (B,) int32; out: (B, Hq, D),
// all contiguous, q/k/v/out of one dtype (0 = float32, 1 = bfloat16).
// pm/pl: float32 scratch of B*Hkv*n_split*G; pacc: of B*Hkv*n_split*G*D,
// n_split = ceil(T / split).  Attends positions [0, lengths).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, float* pm, float* pl, float* pacc,
                                void* out, int b, int t_len, int hq, int hkv, int d,
                                int split, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || t_len <= 0 || hkv <= 0 || hkv > 65535 || hq <= 0 ||
      hq % hkv != 0 || hq / hkv > 16 || d <= 0 || d > kMaxD || split <= 0 ||
      split > kMaxSplit)
    return -1;
  const int n_split = (t_len + split - 1) / split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, pm, pl, pacc, out, b, t_len, hq, hkv, d, split,
                         n_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, pm, pl, pacc, out, b, t_len, hq, hkv, d,
                                 split, n_split, s);
  return -3;
}
