// Paged single-token GQA decode attention for Hopper (sm_90a): one
// launch, a thread-block cluster per (lane, kv head) that splits the
// lane's pages, TMA copies of page rows two stages deep.
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py::
// paged_decode_attention_kernel (Pallas body `_kernel`): one new query token
// per lane attends the lane's KV, which lives in a global page pool
// (P, page_size, Hkv, D) addressed through a per-lane block table.  Same
// function: scale 1/sqrt(D), float32 online softmax, output in q's dtype,
// keys [0, length) in table order, a length-0 lane gives zeros.
//
// It is the dense decode kernel (decode_attention.cu) with another key
// source: the body, the cluster split and the combine are
// decode_common.cuh's, and only the address of key t changes, to row
// t % ps of page tables[b, t / ps].  What bounds it on the H100 is the
// same, device-memory bytes: the least time is the lane's valid K/V rows
// (plus q, out and the tables) over 3.35 TB/s.  What this file adds:
// * a 4-d TMA map over the (P, ps, Hkv, D) pool, boxes of bx keys (a power
//   of two dividing ps, at most 16) at (0, h, t % ps, page); every block's
//   key range is a whole number of pages (the wrapper's kpb is a multiple
//   of ps) and tiles are multiples of bx, so a box never crosses a page;
//   a pool whose boxes are not 128-byte multiples is copied element by
//   element instead;
// * the block reads its own block-table entries (there is no scalar
//   prefetch on the card), four boxes' at a time, and only those of keys
//   below `length`: an entry at or past ceil(length / ps) (the trash page,
//   padding) is never read, and no dense copy of the cache is ever made;
// * the G query heads of the group share every K/V row the block stages,
//   so each K/V byte is read from device memory once.
//
// Two instances of the body, picked by the caller (`instance`; the Python
// wrapper's ops._instance): decode_common.cuh's on the CUDA cores, for
// small groups, float32 and rows that are not 16-byte aligned; and at
// groups of 8 to 16 in bf16 (D a multiple of 16, pages a multiple of 8
// keys) decode_mma.cuh's on the tensor cores, `paged_cluster_kernel_mma`,
// whose TMA boxes are 64 columns wide and 128-byte swizzled.  The grid,
// the clusters, the key source and the combine are the same.
//
// C interface for ctypes: returns cudaGetLastError() after the launch, or
// a negative code for arguments it refuses.

#include "decode_mma.cuh"

namespace {

using namespace repro::decode;

template <typename T, int MAXG, int W>
__global__ void __launch_bounds__(kThreads)
paged_cluster_kernel(const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, const T* __restrict__ q,
                     const T* __restrict__ k_pages, const T* __restrict__ v_pages,
                     const int* __restrict__ tables, const int* __restrict__ lengths,
                     T* __restrict__ out, int hq, int hkv, int d, int ps, int np, int bx,
                     int kpb, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PagedKeys<T> keys{&mk, &mv, k_pages, v_pages, tables + (long long)blockIdx.z * np, ps,
                          bx};
  decode_body<T, MAXG, W>(smem, keys, q, lengths, out, np * ps, hq, hkv, d, kpb, scale);
}

// The tensor-core instance (bf16, D a multiple of 16 up to DMAX).  Three
// blocks share an SM at D 128 (71 KB of shared memory each); at D 256 one
// block takes 140 KB, so its registers need not leave room for another.
template <int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX <= 128 ? 3 : 1)
paged_cluster_kernel_mma(const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_pages,
                         const __nv_bfloat16* __restrict__ v_pages,
                         const int* __restrict__ tables, const int* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ out, int hq, int hkv, int d, int ps, int np,
                         int bx, int kpb, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_mma[];
  const PagedKeys<__nv_bfloat16> keys{&mk, &mv, k_pages, v_pages,
                                      tables + (long long)blockIdx.z * np, ps, bx};
  decode_body_mma<DMAX>(smem_mma, keys, q, lengths, out, np * ps, hq, hkv, d, kpb, scale);
}

// Map a (P, ps, Hkv, D) pool for boxes of bx keys of one kv head.
bool make_map(CUtensorMap* map, const void* base, int esize, int n_pages, int ps, int hkv,
              int d, int bx) {
  const cuuint64_t row = (cuuint64_t)d * esize;
  return repro::decode::encode_4d(
      map, base, esize, {(cuuint64_t)d, (cuuint64_t)hkv, (cuuint64_t)ps, (cuuint64_t)n_pages},
      {row, row * hkv, row * hkv * ps}, {(cuuint32_t)d, 1, (cuuint32_t)bx, 1});
}

struct Args {
  const void *q, *k, *v;
  const int *tables, *lengths;
  void* out;
  int b, hq, hkv, d, n_pages, ps, np, c, kpb;
  int bx;  // keys per TMA box: the largest power of two <= 16 that divides ps
  cudaStream_t s;
};

template <typename T, int MAXG, int W>
int launch(const Args& a) {
  CUtensorMap mk = {}, mv = {};
  if (W > 1 && (!make_map(&mk, a.k, sizeof(T), a.n_pages, a.ps, a.hkv, a.d, a.bx) ||
                !make_map(&mv, a.v, sizeof(T), a.n_pages, a.ps, a.hkv, a.d, a.bx)))
    return -5;
  const Layout L = make_layout(a.d, a.hq / a.hkv, sizeof(T), W > 1);
  return launch_clusters<paged_cluster_kernel<T, MAXG, W>>(
      L, a.c, a.hkv, a.b, a.s, mk, mv, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.tables, a.lengths, static_cast<T*>(a.out), a.hq, a.hkv,
      a.d, a.ps, a.np, a.bx, a.kpb, 1.0f / sqrtf((float)a.d));
}

// The tensor-core instance's maps: bf16 boxes of 64 columns (128 bytes,
// swizzled; columns past D read as zeros) by bx keys.
template <int DMAX>
int launch_mma(const Args& a) {
  CUtensorMap mk = {}, mv = {};
  const cuuint64_t row = (cuuint64_t)a.d * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)a.d, (cuuint64_t)a.hkv, (cuuint64_t)a.ps,
                              (cuuint64_t)a.n_pages};
  const cuuint64_t strides[3] = {row, row * a.hkv, row * a.hkv * a.ps};
  const cuuint32_t box[4] = {kMmaCols, 1, (cuuint32_t)a.bx, 1};
  if (!encode_4d(&mk, a.k, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_4d(&mv, a.v, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return -5;
  return launch_clusters<paged_cluster_kernel_mma<DMAX>>(
      make_mma_layout(a.d), a.c, a.hkv, a.b, a.s, mk, mv,
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.tables, a.lengths,
      static_cast<__nv_bfloat16*>(a.out), a.hq, a.hkv, a.d, a.ps, a.np, a.bx, a.kpb,
      1.0f / sqrtf((float)a.d));
}

template <typename T, int W>
int launch_g(const Args& a) {
  const int g = a.hq / a.hkv;
  if (g <= 4) return launch<T, 4, W>(a);
  if (g <= 8) return launch<T, 8, W>(a);
  return launch<T, 16, W>(a);
}

// TMA boxes land in shared memory bx rows apart, and a tensor copy's
// destination must be 128-byte aligned: a row that is a 16-byte multiple
// but whose boxes are not 128-byte multiples (ps 12 gives bx 4, and 4
// rows of D 40 in bf16 are 320 bytes) takes the element-wise copy.
template <typename T>
int launch_t(const Args& a) {
  const int row_bytes = a.d * sizeof(T);
  const bool vec = row_bytes % 16 == 0 && (a.bx * row_bytes) % 128 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                    reinterpret_cast<uintptr_t>(a.v)) % 16 == 0;
  return vec ? launch_g<T, 16 / sizeof(T)>(a) : launch_g<T, 1>(a);
}

}  // namespace

// q: (B, Hq, D); k_pages/v_pages: (P, ps, Hkv, D); tables: (B, NP) int32;
// lengths: (B,) int32; out: (B, Hq, D).  All contiguous, q/pages/out of one
// dtype (0 = float32, 1 = bfloat16).  Each (lane, kv head) is a cluster of
// `cluster` blocks (1, 2, 4 or 8) of `kpb` keys each, kpb a multiple of ps
// and cluster * kpb >= NP * ps.  Attends positions [0, lengths) (clipped
// to [0, NP * ps]); table entries below ceil(length / ps) must be page ids
// in [0, P).  instance 0 = CUDA cores (any of these operands); 1 = tensor
// cores (bf16, D a multiple of 16, ps a multiple of 8, q and the pages
// 16-byte aligned).
extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const int* tables, const int* lengths, void* out, int b,
                                      int hq, int hkv, int d, int n_pages, int ps, int np,
                                      int cluster, int kpb, int dtype, int instance,
                                      void* stream) {
  if (b <= 0 || b > 65535 || hkv <= 0 || hkv > 65535 || hq <= 0 || hq % hkv != 0 ||
      hq / hkv > kMaxG || d <= 0 || d > kMaxD || n_pages <= 0 || ps <= 0 || np <= 0 ||
      (long long)np * ps > 0x7fffffffLL || kpb <= 0 || kpb % ps != 0 ||
      (cluster & (cluster - 1)) != 0 || cluster < 1 || cluster > kMaxCluster ||
      (long long)cluster * kpb < (long long)np * ps)
    return -1;
  int bx = 1;
  while (bx < kBoxKeys && ps % (2 * bx) == 0) bx *= 2;
  const Args a{q, k_pages, v_pages, tables, lengths, out, b, hq, hkv, d, n_pages, ps, np,
               cluster, kpb, bx, static_cast<cudaStream_t>(stream)};
  if (instance == 1) {
    if (dtype != 1 || d % 16 != 0 || bx < 8 ||
        (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
         reinterpret_cast<uintptr_t>(v_pages)) % 16 != 0)
      return -4;
    return d <= 128 ? launch_mma<128>(a) : launch_mma<256>(a);
  }
  if (instance != 0) return -4;
  if (dtype == 0) return launch_t<float>(a);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a);
  return -3;
}
