// The tensor-core body of the paged decode kernel at large GQA groups
// (bf16, G >= 8: chatglm3-6b's 32 query heads over 2 kv heads are G 16).
// It computes decode_common.cuh's function (one new query token per lane
// attends keys [0, length) of its lane, scale 1/sqrt(D), float32 online
// softmax, output in q's dtype, a length-0 lane gives zeros) with the
// same grid, cluster split, key source and combine, and another body.
//
// Why another body: for every key a kv head does 4*G*D flops against
// 2*D*2 bytes of K and V, G flops a byte.  At G 16 the CUDA cores would
// need 53.6 TFLOP/s of float32 FMAs to keep up with 3.35 TB/s, 80 % of
// their 67, before any shuffle or exponential, and the CUDA-core body's
// registers (q and the output of 16 heads a thread) spill.  On the tensor
// cores the same products are a few percent of the card's rate.
//
// What the design does:
// * the G query heads of the group are the 16 rows of an
//   mma.sync.m16n8k16 bf16 tile (rows past G are zeros); q is read once
//   into A fragments by ldmatrix (kept in registers at D <= 128);
// * tiles of 64 keys are staged two deep by TMA as before, but in boxes 64
//   columns (128 bytes) wide with the 128-byte swizzle: column panel p of
//   key row r lands at p * 8 KB + r * 128, its 16-byte chunk c at
//   c ^ (r % 8), so ldmatrix reads eight rows of one chunk from eight bank
//   groups.  Boxes are bx keys, 8 or 16 (pages a multiple of 8 keys), so
//   every box starts 1024 bytes into the swizzle's period;
// * each of the 4 warps takes 16 keys of every tile: S = Q K^T by mma with
//   K's rows as the col-major B operand (ldmatrix, no transpose), the
//   online softmax on the accumulator fragments (a running max and sum per
//   head row, the scale folded into exp2's argument), then O += P V with P
//   taken straight from S's fragments as the A operand and V by
//   ldmatrix.trans.  P is split into two bf16 terms, P_hi + P_lo, one
//   product each, so P keeps about 2^-16 of its float32 value, as the
//   CUDA-core body's float32 PV does; a bf16 x bf16 product is exact in
//   the float32 accumulators.  The output, 16 x D float32 a warp, stays in
//   registers (64 a thread at D 128);
// * keys past `length` in a tile's last slice read -inf scores and their
//   V rows are zeroed in the fragments (their rows may hold anything);
// * at the end the 4 warps' (max, sum, output) are combined in shared
//   memory in warp order, then the cluster's blocks in rank order
//   (cluster_combine), so the result is the same bits on every call.
#pragma once

#include "decode_common.cuh"

namespace repro {
namespace decode {

constexpr int kMmaRows = 16;       // query heads a warp's tile holds: mma's M
constexpr int kMmaTile = 64;       // keys per staged tile
constexpr int kMmaWarpKeys = 16;   // keys of a tile a warp takes: mma's K for P V
constexpr int kMmaCols = 64;       // columns of a TMA box: one 128-byte swizzled row
constexpr int kPanel = kMmaTile * 128;  // bytes of one column panel of a tile
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one block, computed alike on host and device.
// The walk uses 2 stages of a K and a V tile, each `tile` bytes; after it
// the same bytes hold the warps' partial outputs (wo), their maxima, sums
// and weights (wst) and the block's output (o).  `bytes` includes 1 KB of
// slack to start the stages on a 1024-byte boundary.
struct MmaLayout {
  int nh;     // 64-column panels of a row: ceil(d / 64)
  int tile;   // bytes of one staged K or V tile
  int qs;     // bytes between two rows of q (d * 2 + 16: ldmatrix hits 8 bank groups)
  int wdp;    // floats between two rows of a warp's partial output
  int q_off, st_off, bar_off, wst_off, o_off, bytes;
};

__host__ __device__ inline MmaLayout make_mma_layout(int d) {
  MmaLayout L;
  L.nh = (d + kMmaCols - 1) / kMmaCols;
  L.tile = L.nh * kPanel;
  L.qs = d * 2 + 16;
  L.wdp = d + 4;
  L.q_off = 4 * L.tile;
  L.st_off = L.q_off + kMmaRows * L.qs;
  L.bar_off = (L.st_off + 2 * kMmaRows * 4 + 7) / 8 * 8;
  L.bytes = L.bar_off + 16 + 1024;
  L.wst_off = 4 * kMmaRows * L.wdp * 4;       // after wo, at 0
  L.o_off = L.wst_off + 3 * 4 * kMmaRows * 4;  // g x d floats, below 4 * tile for d >= 16
  return L;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a b: a 16 x 16 (row-major bf16 pairs), b 16 x 8 (col-major), c 16 x 8 float32.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 2^x by the special-function unit (ex2.approx: about 2 ulp; results
// below 2^-126 flush to zero, which a probability in bf16 does anyway).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset in a staged tile of the 16-byte chunk cc (of D) of key row r.
__device__ __forceinline__ uint32_t swz(int r, int cc) {
  return (cc >> 3) * kPanel + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
}

// Thread 0: stage keys [key0, key0 + n) of kv head h at `dst`, K then V
// (`tile` bytes apart), in boxes of bx keys by 64 columns that complete on
// `bar`; block-table entries four boxes at a time; keys past n up to the
// box's end are read too, columns past D read as zeros.
template <typename Keys>
__device__ __forceinline__ void stage_tile_mma(uint32_t dst, const Keys& keys, uint32_t bar,
                                               int key0, int n, int h, const MmaLayout& L) {
  const int bx = keys.box(), boxes = (n + bx - 1) / bx;
  mbar_expect(bar, 2 * boxes * L.nh * bx * 128);
  for (int i0 = 0; i0 < boxes; i0 += 4) {
    int c2[4] = {0, 0, 0, 0}, c3[4] = {0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u < boxes) keys.coords(key0 + (i0 + u) * bx, c2[u], c3[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u < boxes) {
        for (int p = 0; p < L.nh; ++p) {
          const uint32_t off = p * kPanel + (i0 + u) * bx * 128;
          tma_load(dst + off, keys.mk, p * kMmaCols, h, c2[u], c3[u], bar);
          tma_load(dst + L.tile + off, keys.mv, p * kMmaCols, h, c2[u], c3[u], bar);
        }
      }
    }
  }
}

// One block of a (lane b = blockIdx.z, kv head h = blockIdx.y) cluster,
// as decode_body: keys [rank * kpb, (rank + 1) * kpb) of the lane's first
// min(length, t_len), then the cluster's combine.  D is a multiple of 16
// up to DMAX (128 or 256), G at most 16; `keys` maps boxes of 64 columns
// by bx (8 or 16) keys, 128-byte swizzled.
template <int DMAX, typename Keys>
__device__ __forceinline__ void decode_body_mma(unsigned char* smem_raw, const Keys& keys,
                                                const __nv_bfloat16* __restrict__ q,
                                                const int* __restrict__ lengths,
                                                __nv_bfloat16* __restrict__ out, int t_len, int hq,
                                                int hkv, int d, int kpb, float scale) {
  constexpr int NT = DMAX / 8;      // 8-column tiles of the output
  constexpr int KS = DMAX / 16;     // 16-column steps of Q K^T (and 16-column pairs of P V)
  constexpr bool QREG = DMAX <= 128;  // q's A fragments held in registers
  cg::cluster_group cluster = cg::this_cluster();
  const int g = hq / hkv, nk = d / 16;
  const MmaLayout L = make_mma_layout(d);
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(smem);
  unsigned char* qsm = smem + L.q_off;                       // 16 x d of q, rows past g zero
  float* st_m = reinterpret_cast<float*>(smem + L.st_off);   // 16 block maxima (natural log)
  float* st_l = st_m + kMmaRows;                             // 16 block sums
  const uint32_t bars = smem_addr(smem + L.bar_off);         // stage 0, stage 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = cluster.block_rank(), n_rank = cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), t_len);
  const int k_lo = rank * kpb;
  const int n_keys = max(0, min(len, k_lo + kpb) - k_lo);
  const int n_tiles = (n_keys + kMmaTile - 1) / kMmaTile;

  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const __nv_bfloat16* qp = q + ((long long)b * hq + (long long)h * g) * d;
  for (int c = tid; c < kMmaRows * (d / 8); c += kThreads) {
    const int r = c / (d / 8), e = c - r * (d / 8);
    if (r < g) cp_async16(smem_addr(qsm + r * L.qs + e * 16), qp + r * d + e * 8);
    else *reinterpret_cast<uint4*>(qsm + r * L.qs + e * 16) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  if (tid == 0)
    for (int j = 0; j < min(n_tiles, 2); ++j)
      stage_tile_mma(sbase + j * 2 * L.tile, keys, bars + 8 * j, k_lo + j * kMmaTile,
                     min(kMmaTile, n_keys - j * kMmaTile), h, L);
  cp_async_wait_all();
  __syncthreads();  // q is visible

  // ldmatrix: lane gives the address of row lane % 8 of matrix lane / 8.
  // q (A): matrices rows 0-7 | 8-15 by columns 0-7 | 8-15 of a step;
  // K (B of S): keys 0-7 | 8-15 of the warp's slice by columns 0-7 | 8-15;
  // V (B of O, transposed): keys 0-7 | 8-15 by columns 0-7 | 8-15 of a pair.
  const int mat = lane >> 3, r8 = lane & 7;
  const uint32_t qaddr = smem_addr(qsm) + (r8 + (mat & 1) * 8) * L.qs + (mat >> 1) * 16;
  const int ws = warp * kMmaWarpKeys;
  const int krow = ws + (mat >> 1) * 8 + r8, kcol = mat & 1;
  const int vrow = ws + (mat & 1) * 8 + r8, vcol = mat >> 1;
  // Fragments of S and O: this thread's rows g4 and g4 + 8, columns 2 * t4, + 1.
  const int g4 = lane >> 2, t4 = lane & 3;

  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < nk) ldsm_x4(qaddr + kk * 32, qf[kk]);
      else qf[kk][0] = qf[kk][1] = qf[kk][2] = qf[kk][3] = 0u;
    }
  }
  const float sl2 = scale * kLog2e;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // log2 units of the scaled scores
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(bars + 8 * (j & 1), (j >> 1) & 1);
    const int n = min(kMmaTile, n_keys - j * kMmaTile);
    const uint32_t ka = sbase + (j & 1) * 2 * L.tile, va = ka + L.tile;
    if (ws < n) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk < nk) {
          uint32_t kb[4];
          ldsm_x4(ka + swz(krow, 2 * kk + kcol), kb);
          if constexpr (QREG) {
            mma16816(s[0], qf[kk], kb[0], kb[1]);
            mma16816(s[1], qf[kk], kb[2], kb[3]);
          } else {
            uint32_t a[4];
            ldsm_x4(qaddr + kk * 32, a);
            mma16816(s[0], a, kb[0], kb[1]);
            mma16816(s[1], a, kb[2], kb[3]);
          }
        }
      }
      // The tile's last slice: keys at or past n score -inf, and their V
      // rows (which may hold anything) are zeroed in the fragments.
      const bool ragged = ws + kMmaWarpKeys > n;
      uint32_t vlo = 0xffffffffu, vhi = 0xffffffffu;
      if (ragged) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (ws + nt * 8 + 2 * t4 + (e & 1) >= n) s[nt][e] = -INFINITY;
        const int k0 = ws + 2 * t4;  // V^T fragments: keys k0, k0 + 1 (+ 8)
        vlo = (k0 < n ? 0x0000ffffu : 0u) | (k0 + 1 < n ? 0xffff0000u : 0u);
        vhi = (k0 + 8 < n ? 0x0000ffffu : 0u) | (k0 + 9 < n ? 0xffff0000u : 0u);
      }
      float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
      float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // Key ws < n is valid, so both maxima are finite; a first tile's
      // rescale exp2(-inf) is 0.  The scale is positive: it commutes with max.
      const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // P as A operands: (row g4, keys 2 t4..) of keys 0-7, (row g4 + 8) of
      // keys 0-7, then the same of keys 8-15; P_hi and the residual P_lo.
      uint32_t ph[4], pl[4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float p0 = ex2(fmaf(s[nt][0], sl2, -mn0)), p1 = ex2(fmaf(s[nt][1], sl2, -mn0));
        const float p2 = ex2(fmaf(s[nt][2], sl2, -mn1)), p3 = ex2(fmaf(s[nt][3], sl2, -mn1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        ph[2 * nt] = pack_bf16(p0, p1);
        ph[2 * nt + 1] = pack_bf16(p2, p3);
        const float2 h01 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ph[2 * nt]));
        const float2 h23 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ph[2 * nt + 1]));
        pl[2 * nt] = pack_bf16(p0 - h01.x, p1 - h01.y);
        pl[2 * nt + 1] = pack_bf16(p2 - h23.x, p3 - h23.y);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] *= al0;
        acc[nt][1] *= al0;
        acc[nt][2] *= al1;
        acc[nt][3] *= al1;
      }
#pragma unroll
      for (int nn = 0; nn < KS; ++nn) {
        if (nn < nk) {
          uint32_t vb[4];
          ldsm_x4_t(va + swz(vrow, 2 * nn + vcol), vb);
          vb[0] &= vlo;
          vb[1] &= vhi;
          vb[2] &= vlo;
          vb[3] &= vhi;
          mma16816(acc[2 * nn], ph, vb[0], vb[1]);
          mma16816(acc[2 * nn], pl, vb[0], vb[1]);
          mma16816(acc[2 * nn + 1], ph, vb[2], vb[3]);
          mma16816(acc[2 * nn + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage j & 1 before it is refilled
    if (tid == 0 && j + 2 < n_tiles)
      stage_tile_mma(ka, keys, bars + 8 * (j & 1), k_lo + (j + 2) * kMmaTile,
                     min(kMmaTile, n_keys - (j + 2) * kMmaTile), h, L);
  }

  // Combine the 4 warps in warp order (the stage buffers are free: every
  // copy issued has been waited on).  Each quad holds a row's sum in parts.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* wo = reinterpret_cast<float*>(smem);                  // 4 x 16 x wdp partial outputs
  float* wst = reinterpret_cast<float*>(smem + L.wst_off);     // [max, sum, weight][warp][row]
  float* osm = reinterpret_cast<float*>(smem + L.o_off);       // g x d block output
  float* mine = wo + warp * kMmaRows * L.wdp;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < d / 8) {
      const int col = nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(mine + g4 * L.wdp + col) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(mine + (g4 + 8) * L.wdp + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  if (t4 == 0) {
    wst[warp * kMmaRows + g4] = m0;
    wst[warp * kMmaRows + g4 + 8] = m1;
    wst[64 + warp * kMmaRows + g4] = l0;
    wst[64 + warp * kMmaRows + g4 + 8] = l1;
  }
  __syncthreads();
  if (tid < kMmaRows) {
    float mx = -INFINITY;
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wst[w * kMmaRows + tid]);
    float l = 0.f;
    for (int w = 0; w < 4; ++w) {
      const float m_w = wst[w * kMmaRows + tid];
      const float wt = m_w == -INFINITY ? 0.f : ex2(m_w - mx);
      wst[128 + w * kMmaRows + tid] = wt;
      l = fmaf(wst[64 + w * kMmaRows + tid], wt, l);
    }
    st_m[tid] = mx * kLn2;  // the cluster's combine weighs in natural log units
    st_l[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < g * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      o = fmaf(wo[(w * kMmaRows + r) * L.wdp + c], wst[128 + w * kMmaRows + r], o);
    osm[i] = o;
  }
  cluster_combine<__nv_bfloat16, false>(reinterpret_cast<float*>(smem), st_m, st_l, osm, d, out,
                                        nullptr, b, h, hq, g, d, rank, n_rank, tid);
}

}  // namespace decode
}  // namespace repro
