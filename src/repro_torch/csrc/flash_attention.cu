// Causal GQA flash attention (FlashAttention-2 schedule) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (Pallas body `_kernel`).  In the port it is the prefill
// attention of every layer.
//
// What bounds it on the H100: causal attention over S tokens does about
// 2 * S^2 * D flops per query head (QK and PV, half the square) against
// about 5 * S * D bytes in bf16 (q and out per query head, k and v shared by
// the 4 heads of a GQA group), i.e. about 0.4 * S flops per byte.  The card
// needs ~295 flops per byte before the tensor cores are the limit, so at the
// serving path's prompt buckets (S <= 256) the least time is the bytes over
// 3.35 TB/s, and from S of about 740 on it is the flops over the 989 TFLOP/s
// bf16 peak.  This first kernel computes on the CUDA cores in float32 (no
// wgmma yet), so it sits far above either bound.
//
// What the design does about it:
// * one block per (q tile of 64 rows, batch * q head); the q tile stays in
//   shared memory while the block loops over K/V tiles of 32 keys, so each
//   K/V byte is read once per q tile rather than once per query row;
// * tiles entirely above the diagonal are skipped (the loop stops at the
//   block's last row), and the diagonal tile is masked elementwise;
// * GQA: q head h reads kv head h / (Hq / Hkv), no K/V duplication;
// * any S and T: rows and keys past the end are masked, so the Pallas
//   kernel's S % bq == 0 requirement does not carry over;
// * strided operands: the model's (B, S, H, D) buffers are passed as
//   (B, H, S, D) views without a transpose copy;
// * online softmax in float32 with -inf guards (no NaN from
//   exp(-inf - -inf)); output acc / max(l, 1e-30) as in the reference.
// Four threads share a query row: each owns 8 of the tile's 32 scores and a
// quarter of the row's D output columns, and the row's max and sum are
// combined with two warp shuffles.
// Left for later: wgmma/TMA tiles in bf16, 16-byte loads, double buffering.
//
// C interface for ctypes: returns cudaGetLastError() after the launch, or a
// negative code for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // keys per K/V tile
constexpr int kThreads = 256; // 4 threads per query row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int hq, int hkv, int s_len, int t_len, long long qb,
             long long qh, long long qs, long long kb, long long kh, long long ks,
             long long vb, long long vh, long long vs, long long ob, long long oh,
             long long os, int causal, float scale) {
  constexpr int DP = D + 1;        // padded rows: column reads hit distinct banks
  constexpr int CPT = D / 4;       // output columns per thread
  constexpr int KPT = kBK / 4;     // scores per thread per tile
  extern __shared__ float smem[];
  float* qsm = smem;               // kBQ x DP, pre-scaled by 1/sqrt(D)
  float* ksm = qsm + kBQ * DP;     // kBK x DP
  float* vsm = ksm + kBK * DP;     // kBK x D
  float* psm = vsm + kBK * D;      // kBQ x (kBK + 1) probabilities

  const int tid = threadIdx.x;
  const int r = tid >> 2, cg = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int qrow = q0 + r;
  const T* qp = q + b * qb + h * qh;
  const T* kp = k + b * kb + hk * kh;
  const T* vp = v + b * vb + hk * vh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, c = i - rr * D;
    qsm[rr * DP + c] = (q0 + rr < s_len) ? to_f32(qp[(q0 + rr) * qs + c]) * scale : 0.f;
  }
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;
  float m_i = -INFINITY, l_i = 0.f;
  float* prow = psm + r * (kBK + 1);
  const float* qr = qsm + r * DP;

  // Keys past the block's last row are masked for every row: stop there.
  const int k_end = causal ? min(t_len, q0 + kBQ) : t_len;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with ksm/vsm
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, c = i - rr * D;
      const bool ok = k0 + rr < t_len;
      ksm[rr * DP + c] = ok ? to_f32(kp[(k0 + rr) * ks + c]) : 0.f;
      vsm[rr * D + c] = ok ? to_f32(vp[(k0 + rr) * vs + c]) : 0.f;
    }
    __syncthreads();
    float sreg[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) sreg[jj] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = qr[c];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) sreg[jj] = fmaf(qv, ksm[(cg + 4 * jj) * DP + c], sreg[jj]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int key = k0 + cg + 4 * jj;
      const bool ok = key < t_len && (!causal || key <= qrow);
      sreg[jj] = ok ? sreg[jj] : -INFINITY;
      mx = fmaxf(mx, sreg[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = (m_i == -INFINITY) ? 0.f : expf(m_i - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = (sreg[jj] == -INFINITY) ? 0.f : expf(sreg[jj] - m_new);
      prow[cg + 4 * jj] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    __syncwarp();  // the row's four threads see each other's probabilities
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = prow[j];
      const float* vr = vsm + j * D + cg;
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[i] = fmaf(p, vr[4 * i], acc[i]);
    }
    __syncwarp();  // reads of prow finish before the next tile rewrites it
  }
  if (qrow < s_len) {
    const float lsafe = fmaxf(l_i, 1e-30f);
    T* orow = o + b * ob + h * oh + qrow * os + cg;
#pragma unroll
    for (int i = 0; i < CPT; ++i) orow[4 * i] = from_f32<T>(acc[i] / lsafe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
           int s_len, int t_len, const long long* st, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((s_len + kBQ - 1) / kBQ, b * hq);
  const float scale = 1.0f / sqrtf((float)D);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, s_len, t_len, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o, int b, int hq,
             int hkv, int s_len, int t_len, const long long* st, int causal,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
    default: return -2;
  }
}

}  // namespace

// q: (B, Hq, S, D), k/v: (B, Hkv, T, D), o: (B, Hq, S, D), each given by
// its (batch, head, sequence) element strides in `strides` (12 values:
// q, k, v, o); the D axis must be contiguous.  dtype 0 = float32,
// 1 = bfloat16; D in {16, 32, 64, 128}.  causal masks key > query index.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                               int hq, int hkv, int s_len, int t_len, int d,
                               const long long* strides, int causal, int dtype,
                               void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 || t_len <= 0 ||
      (long long)b * hq > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, b, hq, hkv, s_len, t_len, strides, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, s_len, t_len, strides, causal,
                                   s);
  return -3;
}
