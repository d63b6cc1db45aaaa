// Paged single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py::
// paged_decode_attention_kernel (Pallas body `_kernel`): one new query token
// per lane attends the lane's KV, which lives in a global page pool
// (P, page_size, Hkv, D) addressed through a per-lane block table.
//
// What bounds it on the H100: device-memory bytes.  For every key a kv head
// does 4*G*D flops (QK and PV for the G query heads of its group) against
// 2*D*sizeof(T) bytes of K and V read: with G = 4 in bf16 that is 4 flops
// per byte, far below the ~295 the card needs before the tensor cores are
// the limit.  The least time is the lane's valid K/V rows over 3.35 TB/s.
//
// What the design does about it:
// * one block per (lane, kv head); the block reads its own table entries
//   (there is no scalar prefetch on the card) and walks pages
//   [0, ceil(length / page_size)) in table order, so no page past the
//   lane's length is read and no dense copy of the cache is ever made;
// * the G query heads of the group share every K/V page the block stages
//   in shared memory, so each K/V byte is read from device memory once;
// * online softmax in float32, with the -inf guards that keep a lane of
//   length 0 at zeros (acc / max(l, 1e-30) with acc = l = 0) and never let
//   exp(-inf - -inf) produce NaN.
// Left for later: split-KV across blocks (B * Hkv blocks is below the 132
// SMs at small batch), 16-byte vector loads, double-buffered pages.
//
// C interface for ctypes: returns cudaGetLastError() after the launch, or
// a negative code for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStaticSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hq, int hkv, int d, int ps, int np, float scale) {
  extern __shared__ float smem[];
  const int g = hq / hkv;
  const int dp = d + 1;            // padded K rows: column reads hit distinct banks
  float* qs = smem;                // g x d, pre-scaled by 1/sqrt(d)
  float* ks = qs + g * d;          // ps x dp
  float* vs = ks + ps * dp;        // ps x d
  float* sc = vs + ps * d;         // g x ps: scores, then probabilities
  float* acc = sc + g * ps;        // g x d
  float* m = acc + g * d;          // g running maxima
  float* l = m + g;                // g running sums
  float* alpha = l + g;            // g rescale factors of the current page

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int len = lengths[b];
  const long long row = (long long)hkv * d;  // elements per token row of a page
  const long long qoff = ((long long)b * hq + (long long)h * g) * d;
  for (int i = tid; i < g * d; i += kThreads) {
    qs[i] = to_f32(q[qoff + i]) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  int n_pages = (len + ps - 1) / ps;
  if (n_pages > np) n_pages = np;
  if (len <= 0) n_pages = 0;
  const int warp = tid / 32, lane = tid % 32;
  for (int j = 0; j < n_pages; ++j) {
    const long long page = tables[(long long)b * np + j];
    const T* kp = k_pages + page * ps * row + (long long)h * d;
    const T* vp = v_pages + page * ps * row + (long long)h * d;
    __syncthreads();  // the previous page's readers are done with ks/vs/sc
    for (int i = tid; i < ps * d; i += kThreads) {
      const int t = i / d, c = i - t * d;
      ks[t * dp + c] = to_f32(kp[t * row + c]);
      vs[t * d + c] = to_f32(vp[t * row + c]);
    }
    __syncthreads();
    const int base = j * ps;
    for (int i = tid; i < g * ps; i += kThreads) {
      const int gi = i / ps, t = i - gi * ps;
      float s = -INFINITY;
      if (base + t < len) {
        const float* qr = qs + gi * d;
        const float* kr = ks + t * dp;
        s = 0.f;
        for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
      }
      sc[i] = s;
    }
    __syncthreads();
    // Online-softmax statistics: one warp per query head of the group.
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      float mx = -INFINITY;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, sc[gi * ps + t]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float s = sc[gi * ps + t];
        const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
        sc[gi * ps + t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float a = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        alpha[gi] = a;
        l[gi] = l[gi] * a + sum;
        m[gi] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < g * d; i += kThreads) {
      const int gi = i / d, c = i - gi * d;
      const float* pr = sc + gi * ps;
      float a = acc[i] * alpha[gi];
      for (int t = 0; t < ps; ++t) a = fmaf(pr[t], vs[t * d + c], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < g * d; i += kThreads) {
    out[qoff + i] = from_f32<T>(acc[i] / fmaxf(l[i / d], 1e-30f));
  }
}

size_t smem_bytes(int g, int d, int ps) {
  return sizeof(float) * (size_t)(2 * g * d + ps * (d + 1) + ps * d + g * ps + 3 * g);
}

}  // namespace

// q: (B, Hq, D); k_pages/v_pages: (P, ps, Hkv, D); tables: (B, NP) int32;
// lengths: (B,) int32; out: (B, Hq, D).  All contiguous, q/pages/out of one
// dtype (0 = float32, 1 = bfloat16).  Attends positions [0, lengths).
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const int* tables,
                                      const int* lengths, void* out, int b, int hq,
                                      int hkv, int d, int ps, int np, int dtype,
                                      void* stream) {
  if (b <= 0 || hkv <= 0 || hq <= 0 || hq % hkv != 0 || d <= 0 || ps <= 0 || np <= 0 ||
      hkv > 65535)
    return -1;
  const size_t smem = smem_bytes(hq / hkv, d, ps);
  if (smem > (size_t)kMaxStaticSmem) return -2;
  const dim3 grid(b, hkv);
  const float scale = 1.0f / sqrtf((float)d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    paged_decode_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), tables, lengths, static_cast<float*>(out), hq,
        hkv, d, ps, np, scale);
  } else if (dtype == 1) {
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), tables, lengths,
        static_cast<__nv_bfloat16*>(out), hq, hkv, d, ps, np, scale);
  } else {
    return -3;
  }
  return static_cast<int>(cudaGetLastError());
}
