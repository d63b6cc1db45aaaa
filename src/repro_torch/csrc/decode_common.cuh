// The body of the port's single-token GQA decode kernels, shared by the
// dense cache (decode_attention.cu) and the page pool
// (paged_decode_attention.cu).  Both compute one function: one new query
// token per lane attends keys [0, length) of its lane, scale 1/sqrt(D),
// float32 online softmax, output in q's dtype, a length-0 lane gives zeros.
// They differ only in where key t of lane b lives, which a key-source
// policy says (DenseKeys, PagedKeys below): the TMA box that holds it and
// its row in the cache.
//
// What bounds both on the H100: device-memory bytes.  For every key a kv
// head does 4*G*D flops (QK and PV for the G query heads of its group)
// against 2*D*sizeof(T) bytes of K and V: with G = 4 in bf16 that is 4
// flops per byte, far below the ~295 the card needs before the tensor
// cores are the limit.  The least time is the valid K/V rows (plus q and
// out) over 3.35 TB/s, a microsecond or two at 8 lanes of 512 keys, so
// what costs time is the latency of the loads and of the launches, not the
// arithmetic: what counts is bytes in flight early, threads that never
// wait on a copy, chains of dependent instructions short, and one launch.
// That holds for small groups only: at G 16 the CUDA cores need 16 float32
// FMA flops per byte, 80 % of their 67 TFLOP/s at the byte rate, so the
// paged kernel takes the tensor-core body of decode_mma.cuh at G >= 8 in
// bf16; the body below serves the other groups, float32 and unaligned rows.
//
// What the design does about it:
// * each (lane, kv head) gets a cluster of C blocks (C up to 8, the
//   portable limit, chosen by the wrapper); block r of the cluster takes
//   keys [r * kpb, (r + 1) * kpb) and walks them in tiles of up to 64 keys;
// * tiles are staged in shared memory two stages deep, by TMA boxes of up
//   to 16 keys (a row of K or V per key, at its row stride Hkv * D) that
//   one thread issues and an mbarrier counts: both stages' copies go out
//   before anything waits, up to 64 KB a block, and no thread is held by
//   them.  A cache whose rows are not 16-byte multiples is copied element
//   by element into the same layout;
// * scores: a group of L lanes per key (L = the row's 16-byte chunks, up
//   to 32), each lane a chunk of D against the G query heads' values for
//   it, held in registers in float32; each thread takes several keys a
//   pass, and their G dots are reduced together (log2(L) shuffles each,
//   independent chains);
// * PV: a thread per (16-byte column chunk, key slice); the G heads'
//   sums of a chunk stay in its registers across the whole walk, and the
//   slices are summed in shared memory in a fixed order at the end;
// * combine: each block keeps its online-softmax state (max, sum,
//   unnormalised output) in shared memory; after `cluster.sync()` every
//   block gathers all C blocks' maxima and sums through distributed shared
//   memory, weighs them in rank order 0..C-1, and writes its share of the
//   outputs from the C blocks' partial outputs, so the result is the same
//   bits on every call.  No second kernel, no float32 partials in device
//   memory, no allocation in the wrapper;
// * a block with no valid key (past `length`) stages nothing and reads no
//   key source (no block-table entry), but still takes part in both
//   cluster barriers; its max is -inf and weighs 0, and a lane with no
//   keys at all divides 0 by max(0, 1e-30): zeros.
#pragma once

#include "common.cuh"

#include <cooperative_groups.h>
#include <math.h>

namespace repro {
namespace decode {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kMaxD = 256;
constexpr int kMaxG = 16;             // query heads per kv head
constexpr int kMaxTile = 64;          // keys per tile
constexpr int kStageBytes = 16384;    // one K or V tile, before row padding
constexpr int kBoxKeys = 16;          // keys per TMA box, at most
constexpr int kMaxCluster = 8;        // blocks per cluster (the portable limit)

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}
__host__ __device__ inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// Shared-memory layout of one block, computed alike on host and device.
struct Layout {
  int w;      // elements per chunk: 16 bytes, or 1 for the element-wise copy
  int nch;    // chunks per row
  int dp;     // padded row length in elements (nch * w)
  int rsb;    // bytes between two rows of a staged tile: the row's own for TMA,
              // else its 16-byte multiple + 16
  int tk;     // keys per tile (a power of two, >= 16)
  int lanes;  // lanes per key in the score pass (power of two <= 32)
  int nc;     // column chunks in the PV pass, slices = kThreads / nc
  int q_off, sc_off, o_off, st_off, bar_off, bytes;  // the stages start at 0
};

__host__ __device__ inline Layout make_layout(int d, int g, int esize, bool vec) {
  Layout L;
  L.w = vec ? 16 / esize : 1;
  L.nch = (d + L.w - 1) / L.w;
  L.dp = L.nch * L.w;
  L.rsb = vec ? d * esize : (L.dp * esize + 15) / 16 * 16 + 16;
  L.tk = imin(kMaxTile, pow2_floor(kStageBytes / (d * esize)));
  L.lanes = imin(32, pow2_ceil(L.nch));
  L.nc = imin(L.nch, kThreads);
  const int stage = 4 * L.tk * L.rsb;                       // 2 stages of K and V
  const int red = (kThreads / L.nc) * g * L.dp * 4;          // PV slices' sums
  L.q_off = imax(stage, red);
  L.sc_off = L.q_off + (g * d * esize + 15) / 16 * 16;  // q as given
  L.o_off = L.sc_off + g * L.tk * 4;
  L.st_off = L.o_off + g * L.dp * 4;
  L.bar_off = (L.st_off + 3 * g * 4 + 7) / 8 * 8;
  L.bytes = L.bar_off + 16;
  return L;
}

// Keys of lane b in a dense (B, T, Hkv, D) cache: the TMA map's box at
// (0, h, key, b); key t's row is b * T + t.
template <typename T>
struct DenseKeys {
  const CUtensorMap* mk;
  const CUtensorMap* mv;
  const T* k;
  const T* v;
  long long row0;  // b * T
  int b;
  __device__ int box() const { return kBoxKeys; }
  __device__ void coords(int key, int& c2, int& c3) const {
    c2 = key;
    c3 = b;
  }
  __device__ long long row(int key) const { return row0 + key; }
};

// Keys of one lane in a (P, ps, Hkv, D) page pool through its block-table
// row: key t is row t % ps of page table[t / ps], the TMA map's box at
// (0, h, t % ps, table[t / ps]).  Boxes are `bx` keys, a power of two
// that divides ps (at most 16), and start at multiples of bx inside a
// page, so no box crosses a page.  They land bx rows apart in shared
// memory, so the TMA copy needs bx rows to be a 128-byte multiple; the
// entry point copies element by element otherwise.
template <typename T>
struct PagedKeys {
  const CUtensorMap* mk;
  const CUtensorMap* mv;
  const T* k;
  const T* v;
  const int* table;  // this lane's block-table row
  int ps, bx;
  __device__ int box() const { return bx; }
  __device__ void coords(int key, int& c2, int& c3) const {
    c2 = key % ps;
    c3 = table[key / ps];
  }
  __device__ long long row(int key) const { return (long long)table[key / ps] * ps + key % ps; }
};

// W elements of one chunk of a staged row, widened to float32.
template <typename T, int W>
__device__ __forceinline__ void read_chunk(const unsigned char* p, float (&x)[W]) {
  if constexpr (W == 1) {
    x[0] = to_f32(*reinterpret_cast<const T*>(p));
  } else if constexpr (W == 4) {  // float32
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else {  // 8 bf16
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t r[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// Stage keys [key0, key0 + n) of kv head h at `dst`, K then V.  With
// 16-byte rows (W > 1), thread 0 looks up the boxes' coordinates four at a
// time (independent loads of the block table, for a paged source) and
// issues TMA boxes that complete on `bar`; keys past n up to the box's end
// are read too.  Else every thread copies elements.  `row` is the
// elements per token of the cache (Hkv * D).
template <typename T, int W, typename Keys>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const Keys& keys, uint32_t bar,
                                           int key0, int n, int h, const Layout& L, int d,
                                           long long row, int tid) {
  unsigned char* vdst = dst + L.tk * L.rsb;
  if constexpr (W > 1) {
    if (tid == 0) {
      const int bx = keys.box(), boxes = (n + bx - 1) / bx, box_bytes = bx * L.rsb;
      mbar_expect(bar, 2 * boxes * box_bytes);
      for (int i0 = 0; i0 < boxes; i0 += 4) {
        int c2[4] = {0, 0, 0, 0}, c3[4] = {0, 0, 0, 0};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u < boxes) keys.coords(key0 + (i0 + u) * bx, c2[u], c3[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (i0 + u < boxes) {
            const uint32_t off = (i0 + u) * box_bytes;
            tma_load(smem_addr(dst) + off, keys.mk, 0, h, c2[u], c3[u], bar);
            tma_load(smem_addr(vdst) + off, keys.mv, 0, h, c2[u], c3[u], bar);
          }
        }
      }
    }
  } else {
    for (int c = tid; c < n * d; c += kThreads) {
      const int r = c / d, e = c - r * d;
      const long long off = keys.row(key0 + r) * row + (long long)h * d + e;
      reinterpret_cast<T*>(dst + r * L.rsb)[e] = keys.k[off];
      reinterpret_cast<T*>(vdst + r * L.rsb)[e] = keys.v[off];
    }
  }
}

// Combine the cluster's blocks through distributed shared memory, in
// rank order; each block writes its share of the (g, d) outputs.  Each
// block holds its max and sum of every query head in st_m, st_l (natural
// log units of the scaled scores) and its unnormalised output, row gi at
// osm + gi * ostride; `scratch` is shared memory no remote block reads.
// First every block's max and sum (the remote reads spread over the
// threads), then each block's weight exp(m_r - m) and the total sum, then
// the outputs.
template <typename T, bool LSE>
__device__ __forceinline__ void cluster_combine(float* scratch, const float* st_m,
                                                const float* st_l, const float* osm, int ostride,
                                                T* __restrict__ out, float* __restrict__ lse,
                                                int b, int h, int hq, int g, int d, int rank,
                                                int n_rank, int tid) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float* cm = scratch;                 // n_rank x g maxima
  float* cl = cm + kMaxCluster * g;    // n_rank x g sums
  float* cw = cl + kMaxCluster * g;    // n_rank x g weights
  float* ctot = cw + kMaxCluster * g;  // g total sums
  for (int i = tid; i < n_rank * g; i += kThreads) {
    const int r = i / g, gi = i - r * g;
    cm[i] = cluster.map_shared_rank(st_m, r)[gi];
    cl[i] = cluster.map_shared_rank(st_l, r)[gi];
  }
  __syncthreads();
  if (tid < g) {
    float mx = -INFINITY;
    for (int r = 0; r < n_rank; ++r) mx = fmaxf(mx, cm[r * g + tid]);
    float l = 0.f;
    for (int r = 0; r < n_rank; ++r) {
      const float m_r = cm[r * g + tid];
      const float w = m_r == -INFINITY ? 0.f : expf(m_r - mx);
      cw[r * g + tid] = w;
      l = fmaf(cl[r * g + tid], w, l);
    }
    ctot[tid] = fmaxf(l, 1e-30f);
    if constexpr (LSE) {
      if (rank == 0) lse[(long long)b * hq + (long long)h * g + tid] = mx + logf(l);
    }
  }
  __syncthreads();
  const long long obase = ((long long)b * hq + (long long)h * g) * d;
  for (int i = rank * kThreads + tid; i < g * d; i += n_rank * kThreads) {
    const int gi = i / d, e = i - gi * d;
    float part_o[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      part_o[r] = r < n_rank ? cluster.map_shared_rank(osm, r)[gi * ostride + e] : 0.f;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_rank) o = fmaf(part_o[r], cw[r * g + gi], o);
    out[obase + i] = from_f32<T>(o / ctot[gi]);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// One block of a (lane b = blockIdx.z, kv head h = blockIdx.y) cluster:
// keys [rank * kpb, (rank + 1) * kpb) of the lane's first min(length, t_len),
// then the cluster's combine.  `smem` is the block's dynamic shared memory
// (make_layout's bytes).  With LSE, block 0 of the cluster also writes each
// query head's log-sum-exp of its scaled scores, m + log(l) from the
// combine's max and total sum (-inf for a lane with no keys), to
// lse[b * hq + h * g + gi]; without it (the paged kernel, the plain decode)
// the instance is the same code as before the option existed.
template <typename T, int MAXG, int W, bool LSE = false, typename Keys>
__device__ __forceinline__ void decode_body(unsigned char* smem, const Keys& keys,
                                            const T* __restrict__ q,
                                            const int* __restrict__ lengths,
                                            T* __restrict__ out, int t_len, int hq, int hkv,
                                            int d, int kpb, float scale,
                                            float* __restrict__ lse = nullptr) {
  constexpr int CPT = W == 1 ? 2 : 1;  // PV column chunks per thread (D <= 256)
  cg::cluster_group cluster = cg::this_cluster();
  const int g = hq / hkv;
  const Layout L = make_layout(d, g, sizeof(T), W > 1);
  unsigned char* qraw = smem + L.q_off;                    // g x d of q, as given
  float* sc = reinterpret_cast<float*>(smem + L.sc_off);   // g x tk scores, then p
  float* osm = reinterpret_cast<float*>(smem + L.o_off);   // g x dp block output
  float* st_m = reinterpret_cast<float*>(smem + L.st_off); // g running max
  float* st_l = st_m + g;                                  // g running sum
  float* st_a = st_l + g;                                  // g rescale of this tile
  const uint32_t bars = smem_addr(smem + L.bar_off);       // stage 0, stage 1 (TMA)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = cluster.block_rank(), n_rank = cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), t_len);
  const int k_lo = rank * kpb;
  const int n_keys = max(0, min(len, k_lo + kpb) - k_lo);
  const int n_tiles = (n_keys + L.tk - 1) / L.tk;
  const long long row = (long long)hkv * d;  // elements per token of the cache
  const int tile_bytes = 2 * L.tk * L.rsb;

  if (W > 1 && tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // q and both stages' copies go out before anything waits on them.
  const T* qp = q + ((long long)b * hq + (long long)h * g) * d;
  if constexpr (W > 1) {
    for (int c = tid; c < g * d / W; c += kThreads) cp_async16(smem_addr(qraw) + c * 16, qp + c * W);
  } else {
    for (int i = tid; i < g * d; i += kThreads) reinterpret_cast<T*>(qraw)[i] = qp[i];
  }
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  for (int j = 0; j < min(n_tiles, 2); ++j)
    stage_tile<T, W>(smem + j * tile_bytes, keys, bars + 8 * j, k_lo + j * L.tk,
                     min(L.tk, n_keys - j * L.tk), h, L, d, row, tid);

  if (tid < g) {
    st_m[tid] = -INFINITY;
    st_l[tid] = 0.f;
  }

  // PV role: chunk pc (and pc + kThreads) of D, keys slice, slice + ns, ...
  const int ns = kThreads / L.nc;
  const int slice = tid / L.nc, pc = tid - slice * L.nc;
  const bool pv_on = slice < ns;
  float acc[CPT][MAXG][W];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[c][gi][e] = 0.f;

  // Score role: key group of `lanes` threads; this thread's chunks of D
  // are part, part + lanes, ... (at most 8 elements), and its q values for
  // them, scaled by 1/sqrt(D), stay in registers.
  constexpr int QC = 8 / W;
  constexpr int KPT = MAXG >= 16 ? 1 : 16 / MAXG;  // keys a thread per pass
  const int kpp = kThreads / L.lanes;  // keys per pass
  const int part = tid % L.lanes, kslot = tid / L.lanes;
  float qreg[MAXG][QC * W];

  for (int j = 0; j < n_tiles; ++j) {
    if constexpr (W > 1) mbar_wait(bars + 8 * (j & 1), (j >> 1) & 1);
    if (j == 0) cp_async_wait_all();  // q
    __syncthreads();  // tile j is visible to every thread; q and stats too
    const unsigned char* ks = smem + (j & 1) * tile_bytes;
    const unsigned char* vs = ks + L.tk * L.rsb;
    const int n = min(L.tk, n_keys - j * L.tk);
    if (j == 0) {
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
        for (int ci = 0; ci < QC; ++ci)
#pragma unroll
          for (int e = 0; e < W; ++e) {
            const int c = part + ci * L.lanes;
            qreg[gi][ci * W + e] =
                gi < g && c < L.nch
                    ? to_f32(reinterpret_cast<const T*>(qraw)[gi * d + c * W + e]) * scale
                    : 0.f;
          }
    }

    // KPT keys a thread per pass, their KPT x G dots reduced together:
    // independent chains of FMAs and shuffles.
    for (int p0 = 0; p0 < L.tk; p0 += KPT * kpp) {
      float s[KPT][MAXG];
#pragma unroll
      for (int kj = 0; kj < KPT; ++kj) {
        const int key = p0 + kj * kpp + kslot;
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi) s[kj][gi] = 0.f;
        if (key < n) {
#pragma unroll
          for (int ci = 0; ci < QC; ++ci) {
            const int c = part + ci * L.lanes;
            if (c < L.nch) {
              float x[W];
              read_chunk<T, W>(ks + key * L.rsb + c * (W * (int)sizeof(T)), x);
#pragma unroll
              for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
                for (int e = 0; e < W; ++e)
                  s[kj][gi] = fmaf(qreg[gi][ci * W + e], x[e], s[kj][gi]);
            }
          }
        }
      }
      for (int o = L.lanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int kj = 0; kj < KPT; ++kj)
#pragma unroll
          for (int gi = 0; gi < MAXG; ++gi)
            s[kj][gi] += __shfl_xor_sync(0xffffffffu, s[kj][gi], o);
      }
      if (part == 0) {
#pragma unroll
        for (int kj = 0; kj < KPT; ++kj) {
          const int key = p0 + kj * kpp + kslot;
#pragma unroll
          for (int gi = 0; gi < MAXG; ++gi)
            if (gi < g && key < n) sc[gi * L.tk + key] = s[kj][gi];
        }
      }
    }
    __syncthreads();

    // Softmax statistics of this tile: a warp per query head.
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sc[gi * L.tk + t]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = st_m[gi];
      const float m_new = fmaxf(m_old, mx);  // n >= 1: finite
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(sc[gi * L.tk + t] - m_new);
        sc[gi * L.tk + t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // m_old -inf: 0
        st_a[gi] = alpha;
        st_l[gi] = st_l[gi] * alpha + sum;
        st_m[gi] = m_new;
      }
    }
    __syncthreads();

    if (pv_on) {
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        if (gi < g) {
          const float a = st_a[gi];
#pragma unroll
          for (int c = 0; c < CPT; ++c)
#pragma unroll
            for (int e = 0; e < W; ++e) acc[c][gi][e] *= a;
        }
      }
#pragma unroll 2
      for (int t = slice; t < n; t += ns) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int ch = pc + c * kThreads;
          if (ch < L.nch) {
            float x[W];
            read_chunk<T, W>(vs + t * L.rsb + ch * (W * (int)sizeof(T)), x);
#pragma unroll
            for (int gi = 0; gi < MAXG; ++gi) {
              if (gi < g) {
                const float p = sc[gi * L.tk + t];
#pragma unroll
                for (int e = 0; e < W; ++e) acc[c][gi][e] = fmaf(p, x[e], acc[c][gi][e]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with stage j & 1 before it is refilled
    if (j + 2 < n_tiles)
      stage_tile<T, W>(smem + (j & 1) * tile_bytes, keys, bars + 8 * (j & 1),
                       k_lo + (j + 2) * L.tk, min(L.tk, n_keys - (j + 2) * L.tk), h, L, d,
                       row, tid);
  }
  cp_async_wait_all();
  __syncthreads();

  // Sum the PV slices in order 0..ns-1 (the stage buffers are free now).
  float* red = reinterpret_cast<float*>(smem);
  if (pv_on) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int ch = pc + c * kThreads;
      if (ch < L.nch) {
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi)
          if (gi < g)
#pragma unroll
            for (int e = 0; e < W; ++e) red[(slice * g + gi) * L.dp + ch * W + e] = acc[c][gi][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < g * L.dp; i += kThreads) {
    float sum = 0.f;
    for (int sl = 0; sl < ns; ++sl) sum += red[sl * g * L.dp + i];
    osm[i] = sum;
  }

  cluster_combine<T, LSE>(red, st_m, st_l, osm, L.dp, out, lse, b, h, hq, g, d, rank, n_rank,
                          tid);
}

// Encode a 4-d tensor map over `base` (float32 or bf16 by `esize`), with
// dims innermost first, the byte strides of dims 1..3, the box and the
// shared-memory swizzle (none: rows land as they are).
inline bool encode_4d(CUtensorMap* map, const void* base, int esize, const cuuint64_t (&dims)[4],
                      const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const CUtensorMapDataType type =
      esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch K on a grid of (c, hkv, b) blocks in clusters of c along x, with
// L.bytes of dynamic shared memory (a Layout, or decode_mma.cuh's
// MmaLayout); returns the launch's error.
template <auto K, typename Lay, typename... Args>
inline int launch_clusters(const Lay& L, int c, int hkv, int b, cudaStream_t s,
                           Args... args) {
  cudaError_t e = configure_kernel<K>(L.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, hkv, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, K, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
}  // namespace repro
