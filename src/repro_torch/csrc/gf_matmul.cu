// GF(p) matrix multiply on Hopper: out = (a @ b) mod p, exact, int32.
//
// Replaces the TPU kernel `_gf_matmul_kernel` / `gf_matmul` in
// src/repro/kernels/gf_matmul.py (pl.pallas_call), which contracts on the
// MXU in fp32 chunks of <= 128 terms with a lazy int32 fold every 127
// chunks and rejects p > 4097.
//
// What bounds it on the H100: memory.  On the main path the code matrix is
// skinny — (2, k) for the fused regenerate, (n, n) = (16, 16) for an any-k
// decode at [16, 8] — against a stream of 2^26 symbols per row, so the
// kernel does m MACs per 4-byte symbol read: 2..16 integer operations per
// byte, far below both the tensor-core and the CUDA-core lines.  The
// tensor-core fp32 trick of the TPU buys nothing at that intensity.
//
// What the design does about it:
//   * integer lanes, not fp32 chunks: uint32 accumulators folded `% p`
//     every int32_lazy_terms(p) terms (32767 at p = 257, so once per output
//     for any realistic k).  Exact for every p <= 46341, where the TPU
//     schedule stops at 4097.
//   * the stream axis is read once: each thread owns 4 adjacent columns
//     (one 16-byte load per row of b when the stream is 16-byte aligned,
//     scalar loads at the ragged or unaligned edge) and keeps an MT x 4
//     register tile of accumulators for up to MT = 16 output rows.  Taller
//     `a` splits into row tiles on gridDim.y; the stream is on gridDim.x
//     (gridDim.y/z stop at 65,535).
//   * the small code matrix sits in shared memory, staged KT = 256
//     contraction terms at a time, so any k fits in 16 KB; every thread of
//     a warp reads the same entry (a broadcast, no bank conflict).
//   * a batch axis on gridDim.z with a batch stride for `a` (0 when one
//     repair matrix serves every failed node) makes a batched regenerate
//     one launch.
//   * inputs already in [0, p) pass with one unsigned compare; anything
//     else is reduced with Python's sign rule, as the reference does.
//   * offsets are 64-bit: main-path operands hold 2^30 elements.
// Barrett reduction, cp.async/TMA staging and register-resident `a` are
// left for a performance pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KT = 256;

__device__ __forceinline__ unsigned reduce_in(int x, int p) {
  if ((unsigned)x < (unsigned)p) return (unsigned)x;
  int r = x % p;
  return (unsigned)(r < 0 ? r + p : r);
}

template <int MT, int VEC>
__global__ void __launch_bounds__(THREADS)
gf_matmul_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ out, int m, int k, long long s,
                 long long a_bstride, long long b_bstride, int p, int lazy) {
  __shared__ unsigned a_s[MT * KT];
  const long long f = blockIdx.z;
  const int row0 = blockIdx.y * MT;
  const long long col =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  const bool live = col < s;
  a += f * a_bstride;
  b += f * b_bstride;
  out += f * (long long)m * s;
  const unsigned up = (unsigned)p;

  unsigned acc[MT][VEC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0u;
  int pending = 0;

  for (int k0 = 0; k0 < k; k0 += KT) {
    const int kt = min(KT, k - k0);
    __syncthreads();  // the previous chunk's readers are done with a_s
    for (int idx = threadIdx.x; idx < MT * KT; idx += THREADS) {
      const int i = idx / KT, j = idx % KT;
      unsigned v = 0u;  // rows past m and terms past k contribute zero
      if (row0 + i < m && j < kt)
        v = reduce_in(a[(long long)(row0 + i) * k + k0 + j], p);
      a_s[idx] = v;
    }
    __syncthreads();
    if (live) {
      const int* brow = b + (long long)k0 * s + col;
#pragma unroll 4
      for (int j = 0; j < kt; ++j, brow += s) {
        unsigned x[VEC];
        if constexpr (VEC == 4) {
          const int4 t = __ldg(reinterpret_cast<const int4*>(brow));
          x[0] = reduce_in(t.x, p);
          x[1] = reduce_in(t.y, p);
          x[2] = reduce_in(t.z, p);
          x[3] = reduce_in(t.w, p);
        } else {
          x[0] = reduce_in(__ldg(brow), p);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const unsigned ai = a_s[i * KT + j];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[i][v] += ai * x[v];
        }
        if (++pending == lazy) {  // int32 headroom spent: fold
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[i][v] %= up;
          pending = 0;
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (row0 + i >= m) break;
    int* orow = out + (long long)(row0 + i) * s + col;
    if constexpr (VEC == 4) {
      *reinterpret_cast<int4*>(orow) =
          make_int4((int)(acc[i][0] % up), (int)(acc[i][1] % up),
                    (int)(acc[i][2] % up), (int)(acc[i][3] % up));
    } else {
      *orow = (int)(acc[i][0] % up);
    }
  }
}

template <int MT, int VEC>
cudaError_t launch(const int* a, const int* b, int* out, int batch, int m,
                   int k, long long s, long long a_bstride,
                   long long b_bstride, int p, int lazy, cudaStream_t st) {
  const long long cols_per_block = (long long)THREADS * VEC;
  dim3 grid((unsigned)((s + cols_per_block - 1) / cols_per_block),
            (unsigned)((m + MT - 1) / MT), (unsigned)batch);
  gf_matmul_kernel<MT, VEC><<<grid, THREADS, 0, st>>>(
      a, b, out, m, k, s, a_bstride, b_bstride, p, lazy);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_rows(const int* a, const int* b, int* out, int batch,
                        int m, int k, long long s, long long a_bstride,
                        long long b_bstride, int p, int lazy,
                        cudaStream_t st) {
  if (m <= 1)
    return launch<1, VEC>(a, b, out, batch, m, k, s, a_bstride, b_bstride, p,
                          lazy, st);
  if (m <= 2)
    return launch<2, VEC>(a, b, out, batch, m, k, s, a_bstride, b_bstride, p,
                          lazy, st);
  if (m <= 4)
    return launch<4, VEC>(a, b, out, batch, m, k, s, a_bstride, b_bstride, p,
                          lazy, st);
  if (m <= 8)
    return launch<8, VEC>(a, b, out, batch, m, k, s, a_bstride, b_bstride, p,
                          lazy, st);
  return launch<16, VEC>(a, b, out, batch, m, k, s, a_bstride, b_bstride, p,
                         lazy, st);
}

}  // namespace

extern "C" {

// out[f] = (a[f] @ b[f]) mod p for f < batch.  a: (m, k) per element at
// a + f * a_bstride (a_bstride 0: one matrix for the whole batch);
// b: (k, s) at b + f * b_bstride; out: (batch, m, s), contiguous.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int gf_matmul_launch(const void* a, const void* b, void* out, int batch,
                     int m, int k, long long s, long long a_bstride,
                     long long b_bstride, int p, int lazy, void* stream) {
  if (batch <= 0 || m <= 0 || k <= 0 || s <= 0 || batch > 65535 ||
      (m + 15) / 16 > 65535 || lazy <= 0)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (s % 4 == 0) && (b_bstride % 4 == 0) &&
                       ((uintptr_t)b % 16 == 0) && ((uintptr_t)out % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  const int* ap = (const int*)a;
  const int* bp = (const int*)b;
  int* op = (int*)out;
  cudaError_t err =
      aligned ? launch_rows<4>(ap, bp, op, batch, m, k, s, a_bstride,
                               b_bstride, p, lazy, st)
              : launch_rows<1>(ap, bp, op, batch, m, k, s, a_bstride,
                               b_bstride, p, lazy, st);
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
