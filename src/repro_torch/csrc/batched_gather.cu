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
// it reads N rows and the ids once and writes N rows, so the least time is
// (2 * N * D * elt + N * id_bytes) over 3.35 TB/s: at the training shape
// (N 4096 tokens, D 4096, bf16) 67.1 MB + 16 KB, 0.0200 ms.
//
// What the design does about it:
// * the Pallas kernel keeps 8 row DMAs in flight from scalar-prefetched ids;
//   here one warp copies one row at a time (grid-stride over rows), and
//   each lane issues four independent 16-byte loads before its four stores,
//   so a block of 8 warps keeps 8 rows x 2 KB in flight and the launch puts
//   every row of N = 4096 in flight at once;
// * 16-byte vectors when the row's byte length and both base pointers
//   allow it (D * elt % 16 == 0: D a multiple of 4 in float32, of 8 in
//   bf16); otherwise one element per lane and load (4 or 2 bytes);
// * the copy moves bytes and never converts, so the result is bit-exact;
// * row offsets are 64-bit: 128256 x 4096 elements exceed 2^31.
// Left for later: a TMA or cp.async.bulk row copy.
//
// C interface for ctypes: returns cudaGetLastError() after the launch, or
// a negative code for arguments it refuses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr long long kMaxBlocks = 1 << 20;

// V: the unit one lane moves per load (uint4 = 16 bytes, or one element);
// Idx: int32_t or int64_t.  row_units = D * elt / sizeof(V).
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

template <typename V, typename Idx>
int launch(const void* table, const void* ids, void* out, long long n, long long row_units,
           cudaStream_t s) {
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows<V, Idx><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const V*>(table), static_cast<const Idx*>(ids), static_cast<V*>(out), n,
      row_units);
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int launch_unit(const void* table, const void* ids, void* out, long long n,
                long long row_bytes, int unit, cudaStream_t s) {
  switch (unit) {
    case 16: return launch<uint4, Idx>(table, ids, out, n, row_bytes / 16, s);
    case 4: return launch<uint32_t, Idx>(table, ids, out, n, row_bytes / 4, s);
    case 2: return launch<uint16_t, Idx>(table, ids, out, n, row_bytes / 2, s);
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
