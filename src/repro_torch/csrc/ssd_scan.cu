// SSD inter-chunk state scan (Mamba-2) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py::ssd_scan
// (Pallas body `_kernel`): per (batch, head), the first-order recurrence
// over the C chunks of a sequence
//
//     s_0 = 0;  prev_c = s_c;  s_{c+1} = s_c * decay_c + states_c
//
// on states (B, C, H, P, N) float32 or bf16 and decay (B, C, H) float32,
// giving prev (B, C, H, P, N) in the states' dtype (the state ENTERING each
// chunk) and final = s_C (B, H, P, N) in float32.  The carry is float32
// whatever the states' dtype, as in the Pallas kernel's VMEM scratch.
//
// What bounds it on the H100: device-memory bytes.  Each element of the
// state does one multiply-add per chunk against reading its contribution
// and writing its prev, so the least time is (states read + prev written
// + final written) over 3.35 TB/s: at mamba2-1.3b's prefill shape (B 8,
// C 8, H 64, P 64, N 128, float32) that is 134.2 + 134.2 + 16.8 MB =
// 285 MB, 0.085 ms.  The flops (2 per element per chunk, 67 MFLOP there)
// take about 0.001 ms at the card's 67 TFLOP/s float32 rate.
//
// What the design does about it:
// * the Pallas kernel walks C on a sequential grid axis with the carry in
//   VMEM scratch.  On the card blocks run in parallel and in no order, so
//   the chunk axis becomes a loop inside each thread, and nothing crosses
//   between blocks: one thread per (b, h, p*N + n) element, its carry in
//   a register;
// * grid (ceil(P*N / 256), H, B): at step c the threads of a block read a
//   contiguous run of states[b, c, h] and write the same run of prev, so
//   neighbouring threads touch neighbouring addresses; the one decay
//   value of (b, c, h) is the same address for the whole block;
// * the loads of states[b, c, h] for every c do not depend on the carry,
//   so the unrolled loop keeps several in flight per thread;
// * the multiply and the add are rounded separately (__fmul_rn,
//   __fadd_rn), as the plain PyTorch version's two elementwise ops are, so
//   the two agree exactly and the comparison on the card needs no
//   allowance for FMA contraction.
// Left for later: 16-byte vector loads (four float32 or eight bf16 values
// a thread).
//
// C interface for ctypes: returns cudaGetLastError() after the launch, or
// a negative code for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ states, const float* __restrict__ decay,
                T* __restrict__ prev, float* __restrict__ final_state, int n_chunks,
                int n_heads, int pn) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= pn) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long step = static_cast<long long>(n_heads) * pn;  // one chunk
  long long off = (static_cast<long long>(b) * n_chunks * n_heads + h) * pn + e;
  const float* dec = decay + static_cast<long long>(b) * n_chunks * n_heads + h;
  float carry = 0.0f;
#pragma unroll 4
  for (int c = 0; c < n_chunks; ++c) {
    prev[off] = from_f32<T>(carry);
    // Rounded multiply, then rounded add: no FMA contraction, so the carry
    // is bit for bit the plain version's (carry * decay, then + states).
    carry = __fadd_rn(__fmul_rn(carry, dec[static_cast<long long>(c) * n_heads]),
                      to_f32(states[off]));
    off += step;
  }
  final_state[(static_cast<long long>(b) * n_heads + h) * pn + e] = carry;
}

template <typename T>
int launch(const void* states, const float* decay, void* prev, float* final_state, int b,
           int c, int h, int pn, cudaStream_t s) {
  const dim3 grid((pn + kThreads - 1) / kThreads, h, b);
  ssd_scan_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(states), decay,
                                               static_cast<T*>(prev), final_state, c, h, pn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// states/prev: (B, C, H, P*N) of one dtype (0 = float32, 1 = bfloat16);
// decay: (B, C, H) float32; final_state: (B, H, P*N) float32; all
// contiguous.
extern "C" int ssd_scan(const void* states, const float* decay, void* prev,
                        float* final_state, int b, int c, int h, int pn, int dtype,
                        void* stream) {
  if (b <= 0 || b > 65535 || c <= 0 || h <= 0 || h > 65535 || pn <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(states, decay, prev, final_state, b, c, h, pn, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(states, decay, prev, final_state, b, c, h, pn, s);
  return -3;
}
