// Causal GQA flash attention for Hopper (sm_90a): a bf16 instance on the
// tensor cores (wgmma) and a float32 / small-D instance on the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (Pallas body `_kernel`), which widens q, k and v to
// float32 and takes both products in float32.  In the port it is the
// prefill attention of every layer and the trainer's attention forward.
//
// What bounds it on the H100: causal attention over S tokens does about
// 2 * S^2 * D flops per query head (QK and PV, half the square) against
// about 5 * S * D bytes in bf16 (q and out per query head, k and v shared by
// the 4 heads of a GQA group), i.e. about 0.4 * S flops per byte.  The card
// needs ~295 bf16 flops per byte before the tensor cores are the limit, so
// at the serving path's prompts (S <= 256) and the trainer's (S 512) the
// least time is the bytes over 3.35 TB/s.  On the CUDA cores in float32
// the serving shape's 4.3 GFLOP alone need 64 us, 5x that bound: the
// bf16 products belong on the tensor cores.
//
// What the bf16 instance (D 64 or 128, `flash_wgmma_kernel`) does about it:
// * one warpgroup (128 threads) owns 64 query rows of one (batch, q head);
//   the grid walks the heaviest causal tiles first;
// * TMA copies every tile: q stays in shared memory; one K and one V tile
//   of 64 keys, each next tile requested as soon as its product is done
//   (K's runs under the softmax and P V, V's under the next S and
//   softmax).  With 48 KB of shared memory and at most 128 registers a
//   thread, four blocks share an SM, and the other blocks' math covers a
//   block's waits better than a second buffer did.  Boxes are 128 bytes
//   wide: copies of 16 bytes a row hold the issuing threads for
//   thousands of cycles.
// * S = Q K^T by wgmma m64n64k16 from shared memory (D / 16 k-steps),
//   float32 accumulators in registers: a bf16 x bf16 product is exact in
//   float32, so S is the TPU kernel's float32 dot up to summation order;
// * masks (causal diagonal, ragged S and T edges) and the online softmax
//   run on the accumulator fragments: row max and sum over the four
//   threads of a quad, -inf guards, acc / max(l, 1e-30) at the end;
// * O += P V by wgmma m64n{D}k16 with P from registers (the S fragment is
//   already the A operand's layout) and V from shared memory in its
//   MN-major form, so V needs no transpose;
// * P is split into two bf16 terms, P_hi + P_lo, and both products are
//   issued: P keeps about 2^-16 of its float32 value, as the TPU kernel's
//   float32 PV does (max_abs_err at the serving shape halves);
// * tiles wholly above the diagonal are skipped; the output is staged in
//   shared memory and written by TMA through the caller's strides.
// Every tile lies in shared memory in wgmma's 128-byte swizzled layout,
// which TMA writes: 64-column halves of 64 rows x 128 bytes, the 16-byte
// chunk c of row r at chunk c ^ (r % 8).  One copy of a K or V tile serves
// both products: read K-major (SBO 1024 B between 8-row groups) it is
// K^T's operand, read MN-major (LBO 8192 B between column halves, SBO
// 1024 B between 8-key groups) it is V's.
// What still bounds it (PERF.md): each block's first copies (q and the
// first tiles from device memory) and the softmax's dependent chains,
// which 16 warps an SM do not hide; it is above
// scaled_dot_product_attention's time.
//
// The CUDA-core instance (`flash_kernel`) takes float32 at any of D 16, 32,
// 64, 128, bf16 at D 16 or 32, and bf16 operands whose rows are not 16-byte
// aligned: tensor cores would round float32 operands to TF32 (about 1e-3),
// outside the float32 tolerance.  One block per (q tile of 64 rows, batch *
// q head), K/V tiles of 32 keys widened to float32 in shared memory, four
// threads a query row, the same masks and guards.  The Python wrapper
// (`ops._instance`) picks the instance.
//
// C interface for ctypes: returns cudaGetLastError() after the launch, or a
// negative code for arguments it refuses.

#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using repro::from_f32;
using repro::to_f32;

// ----------------------------------------------------------- CUDA cores

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // keys per K/V tile
constexpr int kThreads = 256; // 4 threads per query row

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
int launch_cores(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
           int s_len, int t_len, const long long* st, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_kernel<T, D>;
  const cudaError_t e = repro::configure_kernel<flash_kernel<T, D>>((int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s_len + kBQ - 1) / kBQ, b * hq);
  const float scale = 1.0f / sqrtf((float)D);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, s_len, t_len, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- tensor cores

constexpr int kRows = 64;          // query rows per block = keys per tile
constexpr int kWgThreads = 128;    // one warpgroup

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Matrix descriptor of a bf16 operand in shared memory in the 128-byte
// swizzled layout (layout type 1): start address, leading and stride byte
// offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Make this thread's writes to shared memory visible to the async proxy
// (the output tile's bulk copy reads through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// ---- TMA: tensor maps, mbarriers, bulk copies.
//
// A tensor map describes one operand (B, H, S, D) by its strides, with
// the dims after D ordered by stride, and a box of 64 elements (128 bytes)
// by 64 rows, 128-byte swizzled: one copy fills one 8 KB half of a
// [64][128] tile (all of a [64][64] one).  Rows past the operand's end
// read as zeros and are never written.

struct MapPos {
  int s, h, b;  // which coordinate of the map is the sequence, head, batch
};

// Copy the [64][D] tile at rows row0.. of (batch b, head h) into `dst`:
// columns [64 * i, 64 * i + 64) land at dst + 8192 * i.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, MapPos pos,
                                         int row0, int h, int b, uint32_t bar) {
  int c[4] = {0, 0, 0, 0};
  c[pos.s] = row0;
  c[pos.h] = h;
  c[pos.b] = b;
#pragma unroll
  for (int i = 0; i < D / 64; ++i) repro::tma_load(dst + i * 8192, map, i * 64, c[1], c[2], c[3], bar);
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Issue S = Q K^T for the key tile at `ka` (not waited on).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {  // 16 columns = 32 bytes of a swizzled row
    const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
    wgmma_ss_n64(s, gmma_desc(qa + off, 16, 1024), gmma_desc(ka + off, 16, 1024), 1);
  }
  wgmma_commit();
}

// Issue O += P V for the value tile at `va`: P from registers as two
// bf16 terms, P_hi + P_lo, one product each.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&phi)[16],
                                         const uint32_t (&plo)[16], uint32_t va) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kj = 0; kj < kRows / 16; ++kj) {
    const uint64_t dv = gmma_desc(va + kj * 2048, 8192, 1024);  // 16 keys = 2 KB
    const uint32_t ah[4] = {phi[4 * kj], phi[4 * kj + 1], phi[4 * kj + 2], phi[4 * kj + 3]};
    const uint32_t al[4] = {plo[4 * kj], plo[4 * kj + 1], plo[4 * kj + 2], plo[4 * kj + 3]};
    wgmma_pv<D>(acc, ah, dv);
    wgmma_pv<D>(acc, al, dv);
  }
  wgmma_commit();
}

// 2^x by the special-function unit (ex2.approx: about 2 ulp; results
// below 2^-126 flush to zero, which a probability in bf16 does anyway).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one thread's two rows (row0 and row0 + 8) over the
// key tiles: masks, running max m and this thread's share of the sum l,
// and the rescale (al0, al1) that the last tile applied to earlier sums.
struct Softmax {
  int row0, causal, t_len, q0, lane;
  float scale_log2;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0 = 1.f, al1 = 1.f;

  __device__ Softmax(int row0_, int causal_, int t_len_, int q0_, float scale_log2_, int lane_)
      : row0(row0_), causal(causal_), t_len(t_len_), q0(q0_), lane(lane_),
        scale_log2(scale_log2_) {}

  // s[i]: row row0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
  // P leaves as bf16 pairs in the wgmma A-operand layout.  The scale folds
  // into the exponent's FMA (it is positive, so the max commutes with it).
  __device__ __forceinline__ void tile(float (&s)[32], uint32_t (&phi)[16], uint32_t (&plo)[16],
                                       int k0) {
    if (k0 + kRows > t_len || (causal && k0 + kRows > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int row = row0 + ((i & 2) ? 8 : 0);
        if (key >= t_len || (causal && key > row)) s[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    // exp2(-inf - finite) = 0; a row with nothing valid yet keeps zeros.
    const float base0 = mn0 == -INFINITY ? 0.f : mn0, base1 = mn1 == -INFINITY ? 0.f : mn1;
    al0 = ex2(m0 - base0);
    al1 = ex2(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float base = (i & 2) ? base1 : base0;
      const float p0 = ex2(fmaf(s[i], scale_log2, -base));
      const float p1 = ex2(fmaf(s[i + 1], scale_log2, -base));
      if (i & 2) sum1 += p0 + p1;
      else sum0 += p0 + p1;
      phi[i / 2] = pack_bf16(p0, p1);
      const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&phi[i / 2]));
      plo[i / 2] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
  }
};

template <int D>
__host__ __device__ constexpr int wg_tile_bytes() { return kRows * D * 2; }
template <int D>
__host__ __device__ constexpr size_t wg_smem_bytes() {  // q, K, V tiles; 4 mbarriers
  return 3 * wg_tile_bytes<D>() + 24;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 4)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                   MapPos pq, MapPos pk, MapPos pv, MapPos po, int hq, int hkv, int s_len,
                   int t_len, int causal, float scale_log2) {
  constexpr int kTile = wg_tile_bytes<D>();
  extern __shared__ __align__(1024) unsigned char wsmem[];
  // q tile (then the output tile), K tile, V tile; mbarriers: q, K, V.
  const uint32_t qa = repro::smem_addr(wsmem);
  const uint32_t ka = qa + kTile, va = qa + 2 * kTile;
  const uint32_t bars = qa + 3 * kTile, bar_k = bars + 8, bar_v = bars + 16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int k_end = causal ? min(t_len, q0 + kRows) : t_len;
  const int n_tiles = (k_end + kRows - 1) / kRows;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) repro::mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](uint32_t dst, const CUtensorMap* map, MapPos pos, int j, uint32_t bar) {
    repro::mbar_expect(bar, kTile);
    tma_tile<D>(dst, map, pos, j * kRows, hk, b, bar);
  };
  if (tid == 0) {  // q and the first K and V tiles go out together
    repro::mbar_expect(bars, kTile);
    tma_tile<D>(qa, &mq, pq, q0, h, b, bars);
    load(ka, &mk, pk, 0, bar_k);
    load(va, &mv, pv, 0, bar_v);
  }

  // This thread's rows of the 64-row tile: r0 and r0 + 8.
  const int r0 = warp * 16 + (lane >> 2);
  Softmax sm(q0 + r0, causal, t_len, q0, scale_log2, lane);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  repro::mbar_wait(bars, 0);

  for (int j = 0; j < n_tiles; ++j) {
    repro::mbar_wait(bar_k, j & 1);  // K tile j has landed
    float s[32];
    uint32_t phi[16], plo[16];
    issue_qk<D>(s, qa, ka);
    wgmma_wait();
    fence_regs(s);
    __syncthreads();  // every warp is done with K tile j: K tile j + 1 may land
    if (tid == 0 && j + 1 < n_tiles) load(ka, &mk, pk, j + 1, bar_k);
    sm.tile(s, phi, plo, j * kRows);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? sm.al1 : sm.al0;
    repro::mbar_wait(bar_v, j & 1);  // V tile j has landed
    issue_pv<D>(acc, phi, plo, va);
    wgmma_wait();
    fence_regs(acc);
    __syncthreads();  // every warp is done with V tile j
    if (tid == 0 && j + 1 < n_tiles) load(va, &mv, pv, j + 1, bar_v);
  }

  float l0 = sm.l0, l1 = sm.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // Stage the output in the q tile's place, in the swizzled layout the
  // output's tensor map writes from: the 16-byte chunk c of row r sits at
  // chunk c ^ (r % 8), so a warp's writes hit 32 distinct banks.
  unsigned char* stage = wsmem;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int half = (i / 8) * 8192, ch = i % 8, r1 = r0 + 8;
    const int off0 = half + r0 * 128 + ((ch ^ (r0 & 7)) * 16) + (lane & 3) * 4;
    const int off1 = half + r1 * 128 + ((ch ^ (r1 & 7)) * 16) + (lane & 3) * 4;
    *reinterpret_cast<__nv_bfloat162*>(stage + off0) =
        __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(stage + off1) =
        __floats2bfloat162_rn(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
  }
  fence_proxy_async();  // the writes above are read by the bulk copy
  __syncthreads();
  if (tid == 0) {
    int c[4] = {0, 0, 0, 0};
    c[po.s] = q0;
    c[po.h] = h;
    c[po.b] = b;
#pragma unroll
    for (int i = 0; i < D / 64; ++i) repro::tma_store(&mo, i * 64, c[1], c[2], c[3], qa + i * 8192);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- host side: tensor maps

// Map a (B, H, S, D) bf16 operand given by its (batch, head, sequence)
// element strides, for 128-byte swizzled boxes of 64 x 64 rows.  Returns false if
// cuTensorMapEncodeTiled refuses it.
bool make_map(CUtensorMap* map, MapPos* pos, const void* base, int b, int h, int s, int d,
              const long long* st) {
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (!encode) return false;
  // The dims after D in order of stride; a dim of size 1 goes last, with
  // the stride of a packed layout, since its own stride is arbitrary.
  int order[3] = {2, 1, 0};  // sequence, head, batch
  const long long size[3] = {b, h, s};
  long long key[3];
  for (int i = 0; i < 3; ++i) key[i] = size[i] == 1 ? (1LL << 62) + i : st[i];
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key[order[j]] < key[order[i]]) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  cuuint64_t dims[4] = {(cuuint64_t)d, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estr[4] = {1, 1, 1, 1};
  cuuint64_t prev = (cuuint64_t)d * 2;
  for (int i = 0; i < 3; ++i) {
    const int a = order[i];
    dims[i + 1] = (cuuint64_t)size[a];
    strides[i] = size[a] == 1 ? prev : (cuuint64_t)st[a] * 2;
    prev = strides[i] * dims[i + 1];
    if (a == 2) box[i + 1] = kRows;
    (a == 0 ? pos->b : a == 1 ? pos->h : pos->s) = i + 1;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
                 int s_len, int t_len, const long long* st, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  MapPos pq, pk, pv, po;
  if (!make_map(&mq, &pq, q, b, hq, s_len, D, st) ||
      !make_map(&mk, &pk, k, b, hkv, t_len, D, st + 3) ||
      !make_map(&mv, &pv, v, b, hkv, t_len, D, st + 6) ||
      !make_map(&mo, &po, o, b, hq, s_len, D, st + 9))
    return -5;
  constexpr size_t smem = wg_smem_bytes<D>();
  const cudaError_t e = repro::configure_kernel<flash_wgmma_kernel<D>>((int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s_len + kRows - 1) / kRows, b * hq);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, mo, pq, pk, pv, po, hq, hkv, s_len, t_len, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma_d(int d, const void* q, const void* k, const void* v, void* o, int b, int hq,
                   int hkv, int s_len, int t_len, const long long* st, int causal,
                   cudaStream_t stream) {
  if (d == 64) return launch_wgmma<64>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
  if (d == 128) return launch_wgmma<128>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
  return -4;
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o, int b, int hq,
             int hkv, int s_len, int t_len, const long long* st, int causal,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch_cores<T, 16>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
    case 32: return launch_cores<T, 32>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
    case 64: return launch_cores<T, 64>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
    case 128: return launch_cores<T, 128>(q, k, v, o, b, hq, hkv, s_len, t_len, st, causal, stream);
    default: return -2;
  }
}

}  // namespace

// q: (B, Hq, S, D), k/v: (B, Hkv, T, D), o: (B, Hq, S, D), each given by
// its (batch, head, sequence) element strides in `strides` (12 values:
// q, k, v, o); the D axis must be contiguous.  dtype 0 = float32,
// 1 = bfloat16; D in {16, 32, 64, 128}.  causal masks key > query index.
// instance 0 = CUDA cores (any of those); 1 = tensor cores (bf16, D 64 or
// 128, 16-byte aligned pointers and strides that are multiples of 8).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                               int hq, int hkv, int s_len, int t_len, int d,
                               const long long* strides, int causal, int dtype, int instance,
                               void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 || t_len <= 0 ||
      (long long)b * hq > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 1) {
    if (dtype != 1) return -4;
    for (int i = 0; i < 12; ++i)
      if (strides[i] % 8 != 0) return -4;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
      return -4;
    return launch_wgmma_d(d, q, k, v, o, b, hq, hkv, s_len, t_len, strides, causal, s);
  }
  if (instance != 0) return -4;
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, b, hq, hkv, s_len, t_len, strides, causal, s);
  if (dtype == 1)
    return launch_d<bf16>(d, q, k, v, o, b, hq, hkv, s_len, t_len, strides, causal, s);
  return -3;
}
