// Single-token GQA decode attention over a dense KV cache, for Hopper
// (sm_90a): one launch, copies in flight, a combine across a thread-block
// cluster.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::
// decode_attention_kernel (Pallas body `_kernel`): one new query token per
// lane attends keys [0, length) of the lane's cache k/v (B, T, Hkv, D).
// Same function: scale 1/sqrt(D), float32 online softmax, output in q's
// dtype, keys at or past `length` never used (and read only up to the end
// of a 16-key copy box), a length-0 lane gives zeros (the Pallas finalize
// acc / max(l, 1e-30) with acc = l = 0).
//
// What bounds it on the H100, and what the design does about it: see
// decode_common.cuh, whose body this kernel shares with the paged one
// (paged_decode_attention.cu); here the keys' source is the dense cache,
// a TMA map over (B, T, Hkv, D) with boxes of 16 keys at (0, h, key, b).
// The least time is the valid K/V rows (plus q and out) over 3.35 TB/s:
// 1.6 us at 8 lanes of 512 keys.
//
// C interface for ctypes: returns cudaGetLastError() after the launch, or
// a negative code for arguments it refuses.

#include "decode_common.cuh"

namespace {

using namespace repro::decode;

template <typename T, int MAXG, int W>
__global__ void __launch_bounds__(kThreads)
decode_cluster_kernel(const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, const T* __restrict__ q,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const int* __restrict__ lengths, T* __restrict__ out, int t_len, int hq,
                      int hkv, int d, int kpb, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z;
  const DenseKeys<T> keys{&mk, &mv, k, v, (long long)b * t_len, b};
  decode_body<T, MAXG, W>(smem, keys, q, lengths, out, t_len, hq, hkv, d, kpb, scale);
}

// Map a (B, T, Hkv, D) cache for boxes of 16 keys of one kv head.
bool make_map(CUtensorMap* map, const void* base, int esize, int b, int t_len, int hkv, int d) {
  const cuuint64_t row = (cuuint64_t)d * esize;
  return repro::decode::encode_4d(
      map, base, esize, {(cuuint64_t)d, (cuuint64_t)hkv, (cuuint64_t)t_len, (cuuint64_t)b},
      {row, row * hkv, row * hkv * t_len}, {(cuuint32_t)d, 1, kBoxKeys, 1});
}

template <typename T, int MAXG, int W>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out, int b,
           int t_len, int hq, int hkv, int d, int c, int kpb, cudaStream_t s) {
  CUtensorMap mk = {}, mv = {};
  if (W > 1 && (!make_map(&mk, k, sizeof(T), b, t_len, hkv, d) ||
                !make_map(&mv, v, sizeof(T), b, t_len, hkv, d)))
    return -5;
  const Layout L = make_layout(d, hq / hkv, sizeof(T), W > 1);
  return launch_clusters<decode_cluster_kernel<T, MAXG, W>>(
      L, c, hkv, b, s, mk, mv, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), t_len, hq, hkv, d, kpb,
      1.0f / sqrtf((float)d));
}

template <typename T, int W>
int launch_g(const void* q, const void* k, const void* v, const int* lengths, void* out, int b,
             int t_len, int hq, int hkv, int d, int c, int kpb, cudaStream_t s) {
  const int g = hq / hkv;
  if (g <= 4) return launch<T, 4, W>(q, k, v, lengths, out, b, t_len, hq, hkv, d, c, kpb, s);
  if (g <= 8) return launch<T, 8, W>(q, k, v, lengths, out, b, t_len, hq, hkv, d, c, kpb, s);
  return launch<T, 16, W>(q, k, v, lengths, out, b, t_len, hq, hkv, d, c, kpb, s);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const int* lengths, void* out, int b,
             int t_len, int hq, int hkv, int d, int c, int kpb, cudaStream_t s) {
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  if (vec)
    return launch_g<T, 16 / sizeof(T)>(q, k, v, lengths, out, b, t_len, hq, hkv, d, c, kpb, s);
  return launch_g<T, 1>(q, k, v, lengths, out, b, t_len, hq, hkv, d, c, kpb, s);
}

}  // namespace

// q: (B, Hq, D); k/v: (B, T, Hkv, D); lengths: (B,) int32; out: (B, Hq, D),
// all contiguous, q/k/v/out of one dtype (0 = float32, 1 = bfloat16).
// Each (lane, kv head) is a cluster of `cluster` blocks (1, 2, 4 or 8)
// of `kpb` keys each, cluster * kpb >= T.  Attends positions [0, lengths).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, int b, int t_len, int hq,
                                int hkv, int d, int cluster, int kpb, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || t_len <= 0 || hkv <= 0 || hkv > 65535 || hq <= 0 ||
      hq % hkv != 0 || hq / hkv > kMaxG || d <= 0 || d > kMaxD || kpb <= 0 ||
      (cluster & (cluster - 1)) != 0 || cluster < 1 || cluster > kMaxCluster ||
      (long long)cluster * kpb < t_len)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(q, k, v, lengths, out, b, t_len, hq, hkv, d, cluster, kpb, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, lengths, out, b, t_len, hq, hkv, d, cluster, kpb,
                                   s);
  return -3;
}
