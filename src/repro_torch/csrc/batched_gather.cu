// Batched row gather `out[r] = table[ids[r]]` for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/batched_gather/kernel.py::batched_gather
// (Pallas body `_kernel`): the set-oriented execution of the `table_gather`
// query.  Fission hands the kernel every loop iteration's ids at once and it
// copies all their rows in one launch.  table (V, D) float32 or bf16,
// ids (N,) int32 or int64, out (N, D) in the table's dtype, all contiguous.
// Any N >= 1: the TPU kernel's `N % bn == 0` tiling does not apply.  An id
// outside [0, V) is the caller's contract, as in the reference: nothing is
// checked on the device or read back to the host.
//
// What bounds it on the H100: device-memory bytes.  It does no arithmetic;
// it writes N rows and reads each distinct row once (a repeated id's row
// comes from L2), so the least time is ((distinct + N) * D * elt +
// N * id_bytes) over 3.35 TB/s: at the training shape (N 4096 tokens of
// one SyntheticLMStream step, 348 of them distinct, D 4096, bf16) 36.4 MB,
// 0.01087 ms.  What it costs in practice is writing the output: every
// output line takes an L2 line whose dirty victim goes back to device
// memory, and a launch of any size pays a few microseconds before its
// first store.
//
// What the design does about it.  A 16-byte-aligned row (D * elt % 16 == 0
// and both base pointers aligned: D a multiple of 4 in float32, of 8 in
// bf16) is cut into slices of up to 8 KB, and a block copies one (row,
// slice): each of its threads loads two 16-byte units, then stores them
// with streaming stores (st.global.cs: the output's lines are the L2's
// first to leave) and exits.  Blocks start and retire in row order, so the
// grid writes a compact window that moves through the output.  On the
// H100 this beat a warp a row (four or sixteen loads in flight a lane, with
// or without streaming stores, on a grid of whole waves) and a TMA bulk
// copy through shared memory, at N 4096 and at N 65536 (PERF.md).  Any
// other row takes the element-wise copy: one warp a row, one element per
// lane and load (4 or 2 bytes), four loads in flight before their stores.
// In both, the copy moves bytes and never converts, so the result is
// bit-exact, and row offsets are 64-bit: 128256 x 4096 elements exceed 2^31.
//
// C interface for ctypes: returns cudaGetLastError() after the launch, or
// a negative code for arguments it refuses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // loads a lane has in flight (element-wise copy)
constexpr long long kMaxBlocks = 1 << 20;
constexpr int kSliceUnits = 2;     // 16-byte units a slices thread moves

// The element-wise copy.  V: one element (uint32_t or uint16_t); Idx:
// int32_t or int64_t.  row_units = D.
template <typename V, typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows(const V* __restrict__ table, const Idx* __restrict__ ids, V* __restrict__ out,
            long long n, long long row_units) {
  const int lane = threadIdx.x & 31;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = first; r < n; r += stride) {
    const V* src = table + static_cast<long long>(ids[r]) * row_units;
    V* dst = out + r * row_units;
    long long j = lane;
    for (; j + (kUnroll - 1) * 32 < row_units; j += kUnroll * 32) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = src[j + u * 32];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dst[j + u * 32] = v[u];
    }
    for (; j < row_units; j += 32) dst[j] = src[j];
  }
}

// Block bi copies slice bi % slices of row bi / slices: blockDim.x threads,
// each kSliceUnits 16-byte units a blockDim.x apart, all loaded before any
// is stored (streaming stores).  A grid-stride loop covers grids larger
// than the launch's.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_slices(const uint4* __restrict__ table, const Idx* __restrict__ ids,
              uint4* __restrict__ out, long long n_blocks, int slices, long long row_units) {
  const int t = blockDim.x;
  for (long long bi = blockIdx.x; bi < n_blocks; bi += gridDim.x) {
    const long long r = bi / slices;
    const long long u0 = (bi - r * slices) * (static_cast<long long>(t) * kSliceUnits) +
                         threadIdx.x;
    const uint4* src = table + static_cast<long long>(ids[r]) * row_units;
    uint4* dst = out + r * row_units;
    uint4 v[kSliceUnits];
#pragma unroll
    for (int k = 0; k < kSliceUnits; ++k)
      if (u0 + k * t < row_units) v[k] = src[u0 + k * t];
#pragma unroll
    for (int k = 0; k < kSliceUnits; ++k)
      if (u0 + k * t < row_units) __stcs(dst + u0 + k * t, v[k]);
  }
}

template <typename V, typename Idx>
int launch_rows(const void* table, const void* ids, void* out, long long n,
                long long row_units, cudaStream_t s) {
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows<V, Idx><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const V*>(table), static_cast<const Idx*>(ids), static_cast<V*>(out), n,
      row_units);
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int launch_slices(const void* table, const void* ids, void* out, long long n,
                  long long row_units, cudaStream_t s) {
  // Threads a block: enough warps for the row's units, at most kThreads.
  const long long per_thread = (row_units + kSliceUnits - 1) / kSliceUnits;
  const int threads = static_cast<int>(per_thread >= kThreads ? kThreads
                                                              : (per_thread + 31) / 32 * 32);
  const long long slices = (row_units + threads * kSliceUnits - 1) / (threads * kSliceUnits);
  if (slices > 0x7fffffffLL) return -1;
  const long long n_blocks = n * slices;
  const long long blocks = n_blocks < 0x7fffffffLL ? n_blocks : 0x7fffffffLL;
  gather_slices<Idx><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const uint4*>(table), static_cast<const Idx*>(ids), static_cast<uint4*>(out),
      n_blocks, static_cast<int>(slices), row_units);
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int launch_unit(const void* table, const void* ids, void* out, long long n,
                long long row_bytes, int unit, cudaStream_t s) {
  switch (unit) {
    case 16: return launch_slices<Idx>(table, ids, out, n, row_bytes / 16, s);
    case 4: return launch_rows<uint32_t, Idx>(table, ids, out, n, row_bytes / 4, s);
    case 2: return launch_rows<uint16_t, Idx>(table, ids, out, n, row_bytes / 2, s);
    default: return -3;
  }
}

}  // namespace

// table: (V, row_bytes) bytes, ids: (n,) of id_bytes (4 or 8), out: (n,
// row_bytes); `unit` is the bytes one lane moves per load (16, 4 or 2):
// row_bytes and both base addresses must be multiples of it.
extern "C" int batched_gather(const void* table, const void* ids, void* out, long long n,
                              long long row_bytes, int id_bytes, int unit, void* stream) {
  if (n <= 0 || row_bytes <= 0 || unit <= 0 || row_bytes % unit != 0) return -1;
  if (reinterpret_cast<uintptr_t>(table) % unit != 0 ||
      reinterpret_cast<uintptr_t>(out) % unit != 0)
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4) return launch_unit<int32_t>(table, ids, out, n, row_bytes, unit, s);
  if (id_bytes == 8) return launch_unit<int64_t>(table, ids, out, n, row_bytes, unit, s);
  return -4;
}
