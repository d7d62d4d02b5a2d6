// Double-circulant MSR encode on Hopper (paper eq. (2)), exact, int32:
//   out[j] = sum_{u=1..k} c_u * data[(j - k - u + 1) mod n]  mod p,  n = 2k,
// i.e. output row j holds r_{j+1} = sum_u c_u a_{(j+1-k-u) mod n}.
//
// Replaces the TPU kernel `_circulant_encode_kernel` / `circulant_encode`
// in src/repro/kernels/circulant_encode.py (pl.pallas_call), which keeps an
// (n, 512) data tile resident in VMEM, realises the circulant as k static
// row rolls with `c` baked in as compile-time constants, and folds its
// int32 accumulator every int32_lazy_terms(p) terms.
//
// What bounds it on the H100: memory.  Each output symbol costs k MACs and
// each column of n symbols is read once and written once: at [16, 8] that
// is 8 MACs per 8 bytes moved, far below the CUDA-core line, so the floor
// is 2 * n * s * 4 bytes over the card's memory rate.
//
// What the design does about it:
//   * every column is read from device memory exactly once: a thread owns
//     4 adjacent columns (one 16-byte load per row when the stream is
//     16-byte aligned; 1 column with scalar loads otherwise), stages its
//     n symbols per column in shared memory, then computes all n outputs
//     from there.  The roll is index arithmetic on the row index; M is
//     never materialised.  A thread reads only its own slice of the tile,
//     so the kernel needs no barrier.
//   * a library built once cannot bake `c` in, so the coefficients travel
//     by value in a 256-int parameter struct (k <= 256, n <= 512); all
//     threads read the same entry, served by the constant cache.
//   * the block width adapts to n so the tile fits shared memory:
//     n * threads * VEC * 4 bytes <= 96 KB, falling back to VEC = 1 for
//     large n; above 48 KB the launch raises the dynamic shared-memory
//     limit.
//   * inputs already in [0, p) pass with one unsigned compare; anything
//     else is reduced with Python's sign rule.  Offsets are 64-bit.
//   * data and out each carry a row pitch (elements between rows), so a
//     column window of a larger tensor is read and written where it lies:
//     a shard of a stream-axis mesh on the data's own card costs no copy.
//     The load loop is unrolled by 4 so the pitched build keeps as many
//     loads in flight as the stride-s build did.
// A register-resident sliding window (no shared-memory tile) and Barrett
// reduction are left for a performance pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 256;
constexpr int SMEM_BUDGET = 96 * 1024;

struct Coefs {
  int c[MAX_K];
};

__device__ __forceinline__ unsigned reduce_in(int x, int p) {
  if ((unsigned)x < (unsigned)p) return (unsigned)x;
  int r = x % p;
  return (unsigned)(r < 0 ? r + p : r);
}

template <int VEC>
__global__ void circulant_encode_kernel(const int* __restrict__ data,
                                        int* __restrict__ out, int n,
                                        long long s, long long data_ld,
                                        long long out_ld, const Coefs coef,
                                        int p, int lazy) {
  extern __shared__ unsigned tile[];  // [n][blockDim.x][VEC]
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const long long col = ((long long)blockIdx.x * T + t) * VEC;
  if (col >= s) return;
  const int k = n / 2;
  const unsigned up = (unsigned)p;

  // four rows' loads in flight: with a row pitch apart from s, nvcc
  // otherwise issues one 16-byte load per iteration and the encode loses
  // 12% (3.29 -> 3.71 ms at (16, 2^26) on an H100)
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    const int* src = data + (long long)r * data_ld + col;
    unsigned* dst = tile + ((long long)r * T + t) * VEC;
    if constexpr (VEC == 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(src));
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(reduce_in(v.x, p), reduce_in(v.y, p), reduce_in(v.z, p),
                     reduce_in(v.w, p));
    } else {
      dst[0] = reduce_in(__ldg(src), p);
    }
  }

  for (int j = 0; j < n; ++j) {
    unsigned acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0u;
    int pending = 0;
    int r = j - k;  // u = 1 reads row (j - k) mod n; each next u one row up
    if (r < 0) r += n;
    for (int u = 0; u < k; ++u) {
      const unsigned cu = (unsigned)coef.c[u];
      const unsigned* src = tile + ((long long)r * T + t) * VEC;
      if constexpr (VEC == 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(src);
        acc[0] += cu * x.x;
        acc[1] += cu * x.y;
        acc[2] += cu * x.z;
        acc[3] += cu * x.w;
      } else {
        acc[0] += cu * src[0];
      }
      if (++pending == lazy) {  // int32 headroom spent: fold
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] %= up;
        pending = 0;
      }
      if (--r < 0) r += n;
    }
    int* dst = out + (long long)j * out_ld + col;
    if constexpr (VEC == 4) {
      *reinterpret_cast<int4*>(dst) =
          make_int4((int)(acc[0] % up), (int)(acc[1] % up),
                    (int)(acc[2] % up), (int)(acc[3] % up));
    } else {
      dst[0] = (int)(acc[0] % up);
    }
  }
}

template <int VEC>
int pick_threads(int n) {
  int threads = 256;
  while (threads > 32 && (long long)n * threads * VEC * 4 > SMEM_BUDGET)
    threads /= 2;
  return threads;
}

template <int VEC>
cudaError_t launch(const int* data, int* out, int n, long long s,
                   long long data_ld, long long out_ld, const Coefs& coef,
                   int p, int lazy, cudaStream_t st) {
  const int threads = pick_threads<VEC>(n);
  const size_t smem = (size_t)n * threads * VEC * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        circulant_encode_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long cols_per_block = (long long)threads * VEC;
  dim3 grid((unsigned)((s + cols_per_block - 1) / cols_per_block));
  circulant_encode_kernel<VEC><<<grid, threads, smem, st>>>(
      data, out, n, s, data_ld, out_ld, coef, p, lazy);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = circulant encode of data, both (n, s) int32 with adjacent symbols
// along the stream, row r at data + r * data_ld and out + r * out_ld,
// n = 2k, c: k host ints in [1, p).  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int circulant_encode_launch(const void* data, void* out, int n, long long s,
                            long long data_ld, long long out_ld,
                            const int* c, int k, int p, int lazy,
                            void* stream) {
  if (k <= 0 || k > MAX_K || n != 2 * k || s <= 0 || lazy <= 0 ||
      data_ld < s || out_ld < s)
    return (int)cudaErrorInvalidValue;
  Coefs coef;
  for (int u = 0; u < MAX_K; ++u) coef.c[u] = u < k ? c[u] : 0;
  const bool aligned = (s % 4 == 0) && ((uintptr_t)data % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0) && (data_ld % 4 == 0) &&
                       (out_ld % 4 == 0) &&
                       (long long)n * 32 * 4 * 4 <= SMEM_BUDGET;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      aligned ? launch<4>((const int*)data, (int*)out, n, s, data_ld, out_ld,
                          coef, p, lazy, st)
              : launch<1>((const int*)data, (int*)out, n, s, data_ld, out_ld,
                          coef, p, lazy, st);
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
