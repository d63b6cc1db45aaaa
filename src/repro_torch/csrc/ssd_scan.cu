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
// The second entry, ssd_scan_bwd, is the recurrence's adjoint: the
// gradient a training step takes through the scan.  It has no Pallas
// counterpart; the JAX package gets it from XLA's autodiff of the
// lax.scan in repro/models/ssm.py::ssd_chunked.  From the cotangents
// g_prev of prev and g_final of final (zeros when absent), run backwards:
//
//     G_C = g_final;  d_states_c = G_{c+1};  G_c = g_prev_c + G_{c+1} * decay_c;
//     d_decay_c = sum over (p, n) of G_{c+1} * prev_c;  d_initial = G_0
//
// What bounds it: bytes again.  g_prev and prev are read once, d_states
// and d_initial written once: at mamba2-1.3b's training shape (the
// prefill's, float32, g_final absent as in the model, whose final state
// no loss reads) 134.2 + 134.2 + 134.2 + 16.8 MB = 419 MB, 0.125 ms at
// 3.35 TB/s (a given g_final adds 16.8 MB).  Its flops (4 per element per
// chunk) take about 0.002 ms.
//
// What the design does about it: the forward's layout and loop, walked
// from the last chunk down, one thread per (b, h, p*N + n) with G in a
// float32 register, multiply and add rounded separately as in the plain
// version (d_states and d_initial are its bits).  d_decay is a sum over
// P*N elements that span blocks; it is taken without float atomics, so two
// calls give the same bits: each block sums its 256 products per chunk in
// a fixed order (a warp shuffle tree, then the eight warps in turn) into a
// partial (B, C, H, blocks) buffer the wrapper allocates, and a second
// launch adds each (b, c, h)'s partials in block order.
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// launches, or a negative code for arguments it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// The adjoint, one thread per (b, h, e), chunks from the last down.  Every
// thread of the block takes part in each chunk's sum, live or not.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_kernel(const T* __restrict__ g_prev, const float* __restrict__ g_final,
                    const T* __restrict__ prev, const float* __restrict__ decay,
                    T* __restrict__ d_states, float* __restrict__ d_initial,
                    float* __restrict__ partial, int n_chunks, int n_heads, int pn) {
  __shared__ float warp_sums[2][kWarps];  // two buffers: one barrier a chunk
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const bool live = e < pn;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long step = static_cast<long long>(n_heads) * pn;  // one chunk
  const long long bh = static_cast<long long>(b) * n_heads + h;
  long long off = ((static_cast<long long>(b) * n_chunks + n_chunks - 1) * n_heads + h) * pn + e;
  const float* dec = decay + static_cast<long long>(b) * n_chunks * n_heads + h;
  float carry = (live && g_final != nullptr) ? g_final[bh * pn + e] : 0.0f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    float prod = 0.0f;
    if (live) {
      d_states[off] = from_f32<T>(carry);
      prod = __fmul_rn(carry, to_f32(prev[off]));
      carry = __fadd_rn(__fmul_rn(carry, dec[static_cast<long long>(c) * n_heads]),
                        to_f32(g_prev[off]));
    }
    off -= step;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) prod += __shfl_down_sync(0xffffffffu, prod, o);
    if (lane == 0) warp_sums[c & 1][warp] = prod;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += warp_sums[c & 1][w];
      partial[((static_cast<long long>(b) * n_chunks + c) * n_heads + h) * gridDim.x +
              blockIdx.x] = sum;
    }
  }
  if (live) d_initial[bh * pn + e] = carry;
}

// d_decay[r] = the sum of row r's partials, in block order.
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_decay_kernel(const float* __restrict__ partial, float* __restrict__ d_decay,
                          long long rows, int n_blocks) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const float* p = partial + r * n_blocks;
  float sum = 0.0f;
  for (int j = 0; j < n_blocks; ++j) sum += p[j];
  d_decay[r] = sum;
}

template <typename T>
int launch_bwd(const void* g_prev, const float* g_final, const void* prev, const float* decay,
               void* d_states, float* d_decay, float* d_initial, float* partial, int b, int c,
               int h, int pn, int n_blocks, cudaStream_t s) {
  ssd_scan_bwd_kernel<T><<<dim3(n_blocks, h, b), kThreads, 0, s>>>(
      static_cast<const T*>(g_prev), g_final, static_cast<const T*>(prev), decay,
      static_cast<T*>(d_states), d_initial, partial, c, h, pn);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * c * h;
  ssd_scan_bwd_decay_kernel<<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads,
                              0, s>>>(partial, d_decay, rows, n_blocks);
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

// g_prev/prev/d_states: (B, C, H, P*N) of one dtype (0 = float32, 1 =
// bfloat16); g_final: (B, H, P*N) float32 or null (zeros); decay, d_decay:
// (B, C, H) float32; d_initial: (B, H, P*N) float32; partial: (B, C, H,
// n_blocks) float32 scratch, n_blocks = ceil(P*N / 256); all contiguous.
extern "C" int ssd_scan_bwd(const void* g_prev, const float* g_final, const void* prev,
                            const float* decay, void* d_states, float* d_decay,
                            float* d_initial, float* partial, int b, int c, int h, int pn,
                            int n_blocks, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || c <= 0 || h <= 0 || h > 65535 || pn <= 0) return -1;
  if (n_blocks != (pn + kThreads - 1) / kThreads) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g_prev, g_final, prev, decay, d_states, d_decay, d_initial,
                             partial, b, c, h, pn, n_blocks, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g_prev, g_final, prev, decay, d_states, d_decay,
                                     d_initial, partial, b, c, h, pn, n_blocks, s);
  return -3;
}
