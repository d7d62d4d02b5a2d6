// GF(p) matrix multiply on Hopper: out = (a @ b) mod p, exact, int32.
//
// Replaces the TPU kernel `_gf_matmul_kernel` / `gf_matmul` in
// src/repro/kernels/gf_matmul.py (pl.pallas_call), which contracts on the
// MXU in fp32 chunks of <= 128 terms with a lazy int32 fold every 127
// chunks and rejects p > 4097.
//
// What bounds it on the H100: device-memory bytes.  On the main path the
// code matrix is skinny against a stream of 2^26 symbols per row: (2, k+1)
// for the fused regenerate, (n, n) = (16, 16) for an any-k decode and
// (n + F, n) for a decode that also repairs F redundancy blocks.  Each
// 4-byte column of b costs m MACs, 2..64 integer operations per byte, so
// the floor is the stream read once plus the output written once over the
// card's memory rate.  At (18, 16) the 288 MACs per column fill about 40%
// of the integer lanes (64 multiply-adds per SM per clock) while the bytes
// stream at that rate, so the inner loop does the MACs and little else.
//
// What the design does about it:
//   * one pass over the stream for every m <= 64.  A block owns a tile of
//     TS stream columns and all of its output rows: G = ceil(m / 8) row
//     groups of RT = ceil(m / G) rows, TS / 4 threads per group, each
//     thread an RT x 4 register tile (<= 32 accumulators).  Every row
//     group reads the tile from shared memory, so device memory sees each
//     column of b once.  TS is the widest of 1024, 512 and 256 whose row
//     groups fit 512 threads (1024 to m = 16, 512 to m = 32): on the H100
//     4 KB and 2 KB per row and stage streamed faster than 1 KB.
//     m > 64 splits into 64-row tiles, each reading the stream again (off
//     the main path).
//   * asynchronously staged tiles.  One producer warp keeps a ring of
//     STAGES = 3 shared-memory stages full with 1-D bulk copies
//     (cp.async.bulk, one per row of b per stage, KC = 16 rows a stage),
//     completion counted in bytes on an mbarrier (expect-tx); the consumer
//     warps release each stage on a second mbarrier.  The grid is
//     persistent (SMs x resident blocks) and walks the tiles, so one
//     tile's stores overlap the next tiles' loads.  Results leave with
//     streaming stores (__stcs): nothing here reads them back.
//   * row sources.  b arrives as up to 4 tensors (base, rows, row pitch,
//     batch stride), read as if concatenated along the contraction axis:
//     the decode's data and redundancy downloads, and the regenerate's
//     r_prev row beside its k helper rows, need no concatenated copy.
//   * row pitch.  Every stream operand and the output carry their own
//     pitch (elements between rows), so a column window of a larger
//     tensor is read and written where it lies: a shard of a stream-axis
//     mesh on the operands' own card costs no copy of its window (at the
//     main path's (16, 2^26) a .contiguous() window would move as many
//     bytes as the product itself).
//   * the code matrix `a` is reduced and staged in shared memory,
//     transposed so a row group's RT coefficients for one term are one or
//     two 16-byte loads; a stride-0 batch (one repair matrix for every
//     failed node) stages it once per block, and k too deep for 16 KB is
//     staged in chunks.
//   * uint32 lanes folded every int32_lazy_terms(p) terms (one fold per
//     output at p = 257 for any k <= 32767), exact for every p <= 46341.
//     The fold is a Barrett reduction with mu = floor(2^32 / p): for every
//     x < 2^32 the quotient estimate is off by at most one, so one
//     conditional subtract gives x mod p.  gf_fold_check_launch compares it
//     with `%` over every uint32 value on the card.
//   * alignment: bulk copies need 16-byte addresses and sizes.  When every
//     row start is 16-byte aligned (s % 4 == 0, aligned bases and batch
//     strides) each row is one bulk copy and the consumers use 16-byte
//     shared-memory loads and 16-byte stores.  Otherwise each stage row
//     keeps the source's offset mod 16 in shared memory, the aligned
//     interior goes by bulk copy, its 0-3 edge symbols at each end by
//     scalar loads, and the consumers read and store scalars, masked at
//     the ragged edge of the stream.
//   * inputs already in [0, p) pass with one unsigned compare per four
//     symbols; anything else is reduced with Python's sign rule, as the
//     reference does.  Offsets are 64-bit: main-path operands hold 2^30
//     elements.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int MAX_SOURCES = 4;
constexpr int KC = 16;             // contraction rows per stage
constexpr int STAGES = 3;
constexpr int MAX_RT = 8;          // rows per thread
constexpr int MAX_THREADS = 544;   // 512 consumers + the producer warp
constexpr int A_SMEM = 4096;       // code-matrix ints in shared memory

// Tile width: TS stream columns, CG = TS / 4 threads per row group (4
// columns each), stage rows of PITCH ints (up to 3 of them shift).
template <int TS>
struct Tile {
  static constexpr int CG = TS / 4;
  static constexpr int PITCH = TS + 4;
};

struct Sources {
  const int* ptr[MAX_SOURCES];
  long long bstride[MAX_SOURCES];  // elements between batch elements
  long long ld[MAX_SOURCES];       // elements between rows
  int rows[MAX_SOURCES];
  int n;
};

struct Args {
  Sources src;
  const int* a;
  int* out;
  long long s;
  long long a_bstride;
  long long out_ld;                // output: elements between rows
  long long out_bstride;           // and between batch elements
  long long ctiles;                // column tiles per (batch, row tile)
  long long tiles;                 // batch * row_tiles * ctiles
  long long batch;
  int m, k, p, lazy;
  unsigned mu;                     // floor(2^32 / p)
  int row_tiles;
  int G;                           // row groups per block
  int kcs;                         // rows per stage: min(k, KC)
  int ka;                          // a terms staged at once
};

// ------------------------------------------------------------ arithmetic
__device__ __forceinline__ unsigned reduce_in(int x, int p) {
  if ((unsigned)x < (unsigned)p) return (unsigned)x;
  int r = x % p;
  return (unsigned)(r < 0 ? r + p : r);
}

// x mod p for every uint32 x (see the header).
__device__ __forceinline__ unsigned fold(unsigned x, unsigned p,
                                         unsigned mu) {
  unsigned r = x - __umulhi(x, mu) * p;
  return r >= p ? r - p : r;
}

// ------------------------------------------------- mbarrier and bulk copy
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void consumers_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// Row j of the concatenated contraction operand for batch element f.
__device__ __forceinline__ const int* row_ptr(const Sources& src, int j,
                                              long long f) {
#pragma unroll
  for (int i = 0; i < MAX_SOURCES - 1; ++i) {
    if (i + 1 >= src.n || j < src.rows[i])
      return src.ptr[i] + f * src.bstride[i] + (long long)j * src.ld[i];
    j -= src.rows[i];
  }
  return src.ptr[MAX_SOURCES - 1] + f * src.bstride[MAX_SOURCES - 1] +
         (long long)j * src.ld[MAX_SOURCES - 1];
}

// Coefficients of a row group are padded to RTP so one term's RT values
// are one or two aligned vector loads from shared memory.
template <int RT>
struct Pad {
  static constexpr int value = RT <= 2 ? RT : (RT <= 4 ? 4 : 8);
};

template <int RT>
__device__ __forceinline__ void load_coefs(const unsigned* src,
                                           unsigned (&c)[RT]) {
  constexpr int RTP = Pad<RT>::value;
  if constexpr (RTP == 1) {
    c[0] = src[0];
  } else if constexpr (RTP == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    c[0] = v.x;
    c[1] = v.y;
  } else {
    unsigned tmp[RTP];
#pragma unroll
    for (int q = 0; q < RTP / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[q];
      tmp[4 * q] = v.x;
      tmp[4 * q + 1] = v.y;
      tmp[4 * q + 2] = v.z;
      tmp[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) c[r] = tmp[r];
  }
}

// -------------------------------------------------------------- producer
// Fills stage rows with one tile's chunk of b.  Row jj of a stage starts
// at a 16-byte boundary; its symbols sit `shift` ints in, shift being the
// source row's byte offset mod 16 / 4, so the aligned interior lands on a
// 16-byte boundary too and goes by bulk copy.
template <int TS, bool ALIGNED>
__device__ void produce(const Args& args, unsigned* ring, int* shifts,
                        uint64_t* full, uint64_t* empty) {
  constexpr int PITCH = Tile<TS>::PITCH;
  const int lane = threadIdx.x & 31;
  const int stage_ints = args.kcs * PITCH;
  int stage = 0;
  unsigned phase = 0;
  for (long long t = blockIdx.x; t < args.tiles; t += gridDim.x) {
    const long long c = t % args.ctiles;
    const long long f = t / args.ctiles / args.row_tiles;
    const long long col0 = c * TS;
    const int ncols = (int)min((long long)TS, args.s - col0);
    for (int k0 = 0; k0 < args.k; k0 += args.kcs) {
      const int kc = min(args.kcs, args.k - k0);
      mbar_wait(&empty[stage], phase ^ 1u);
      unsigned* buf = ring + stage * stage_ints;
      if constexpr (ALIGNED) {
        if (lane == 0)
          mbar_arrive_expect_tx(&full[stage], (unsigned)(kc * ncols * 4));
        __syncwarp();
        for (int jj = lane; jj < kc; jj += 32)
          bulk_g2s(buf + jj * PITCH, row_ptr(args.src, k0 + jj, f) + col0,
                   (unsigned)(ncols * 4), &full[stage]);
      } else {
        unsigned body_bytes = 0;
        const int* g = nullptr;
        int sh = 0, head = 0, body = 0;
        if (lane < kc) {
          g = row_ptr(args.src, k0 + lane, f) + col0;
          sh = (int)(((uintptr_t)g & 15) >> 2);
          head = min(ncols, (4 - sh) & 3);
          body = (ncols - head) & ~3;
          unsigned* row = buf + lane * PITCH + sh;
          for (int q = 0; q < head; ++q) row[q] = (unsigned)__ldg(g + q);
          for (int q = head + body; q < ncols; ++q)
            row[q] = (unsigned)__ldg(g + q);
          shifts[stage * KC + lane] = sh;
          body_bytes = (unsigned)body * 4u;
        }
        // kc <= KC = 16 < 32: one row per lane
        unsigned total = body_bytes;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          total += __shfl_xor_sync(0xffffffffu, total, o);
        __threadfence_block();
        __syncwarp();
        if (lane == 0) mbar_arrive_expect_tx(&full[stage], total);
        __syncwarp();
        if (body > 0)
          bulk_g2s(buf + lane * PITCH + sh + head, g + head,
                   (unsigned)body * 4u, &full[stage]);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }
  }
}

// -------------------------------------------------------------- consumer
template <int TS, int RT, bool ALIGNED>
__device__ void consume(const Args& args, const unsigned* ring,
                        const int* shifts, unsigned* a_s, uint64_t* full,
                        uint64_t* empty, int ncons) {
  constexpr int RTP = Pad<RT>::value;
  constexpr int CG = Tile<TS>::CG;
  constexpr int PITCH = Tile<TS>::PITCH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = tid % CG;
  const int rg = tid / CG;
  const int c4 = cg * 4;
  const int MP = args.G * RTP;     // a_s row width (padded)
  const int rows_per_tile = args.G * RT;
  const int stage_ints = args.kcs * PITCH;
  const unsigned up = (unsigned)args.p;
  const unsigned mu = args.mu;
  const int lazy = args.lazy;
  int stage = 0;
  unsigned phase = 0;
  long long a_f = -1;
  int a_rt = -1, a0 = 0, a_len = 0;

  for (long long t = blockIdx.x; t < args.tiles; t += gridDim.x) {
    const long long c = t % args.ctiles;
    const long long fr = t / args.ctiles;
    const int rt = (int)(fr % args.row_tiles);
    const long long f = fr / args.row_tiles;
    const long long col0 = c * TS;
    const int ncols = (int)min((long long)TS, args.s - col0);
    const int row0 = rt * rows_per_tile;
    const bool live = c4 < ncols;

    unsigned acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[r][v] = 0u;
    int pending = 0;

    for (int k0 = 0; k0 < args.k; k0 += args.kcs) {
      const int kc = min(args.kcs, args.k - k0);
      if (rt != a_rt || (args.a_bstride != 0 && f != a_f) || k0 < a0 ||
          k0 + kc > a0 + a_len) {
        consumers_sync(ncons);       // every reader is done with a_s
        a0 = k0;
        a_len = min(args.ka, args.k - k0);
        const int* ap = args.a + f * args.a_bstride;
        for (int idx = tid; idx < a_len * MP; idx += ncons) {
          const int jj = idx / MP, col = idx % MP;
          const int g = col / RTP, r = col % RTP;
          const int row = row0 + g * RT + r;
          unsigned v = 0u;           // padding and rows past m give zero
          if (r < RT && row < args.m)
            v = reduce_in(ap[(long long)row * args.k + a0 + jj], args.p);
          a_s[idx] = v;
        }
        consumers_sync(ncons);
        a_rt = rt;
        a_f = f;
      }

      mbar_wait(&full[stage], phase);
      if (live) {
        const unsigned* buf = ring + stage * stage_ints;
        const unsigned* ak = a_s + (k0 - a0) * MP + rg * RTP;
#pragma unroll 2
        for (int jj = 0; jj < kc; ++jj) {
          unsigned x[4];
          if constexpr (ALIGNED) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(buf + jj * PITCH + c4);
            x[0] = v.x;
            x[1] = v.y;
            x[2] = v.z;
            x[3] = v.w;
          } else {
            const unsigned* row =
                buf + jj * PITCH + shifts[stage * KC + jj] + c4;
#pragma unroll
            for (int v = 0; v < 4; ++v) x[v] = row[v];
          }
          if (max(max(x[0], x[1]), max(x[2], x[3])) >= up) {
#pragma unroll
            for (int v = 0; v < 4; ++v) x[v] = reduce_in((int)x[v], args.p);
          }
          unsigned coef[RT];
          load_coefs<RT>(ak + jj * MP, coef);
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[r][v] += coef[r] * x[v];
          if (++pending == lazy) {   // int32 headroom spent: fold
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[r][v] = fold(acc[r][v], up, mu);
            pending = 0;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }

    if (!live) continue;
    int* obase = args.out + f * args.out_bstride + col0 + c4;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = row0 + rg * RT + r;
      if (row >= args.m) break;
      int* o = obase + (long long)row * args.out_ld;
      unsigned y[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) y[v] = fold(acc[r][v], up, mu);
      if constexpr (ALIGNED) {
        __stcs(reinterpret_cast<int4*>(o),
               make_int4((int)y[0], (int)y[1], (int)y[2], (int)y[3]));
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (c4 + v < ncols) __stcs(o + v, (int)y[v]);
      }
    }
  }
}

// ---------------------------------------------------------------- kernel
// Shared memory: mbarriers and stage shifts | a_s | the stage ring.
constexpr int HEADER_BYTES = 2 * STAGES * 8 + STAGES * KC * 4;

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

template <int TS, int RT, bool ALIGNED>
__global__ void __launch_bounds__(MAX_THREADS)
gf_matmul_kernel(const __grid_constant__ Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int* shifts = reinterpret_cast<int*>(empty + STAGES);
  unsigned* a_s = reinterpret_cast<unsigned*>(smem + align128(HEADER_BYTES));
  const int a_bytes = args.ka * args.G * Pad<RT>::value * 4;
  unsigned* ring = reinterpret_cast<unsigned*>(
      smem + align128(HEADER_BYTES) + align128(a_bytes));
  const int ncons = blockDim.x - 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], (unsigned)(ncons / 32));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= ncons)
    produce<TS, ALIGNED>(args, ring, shifts, full, empty);
  else
    consume<TS, RT, ALIGNED>(args, ring, shifts, a_s, full, empty, ncons);
}

// The persistent grid's size for one kernel configuration on the current
// device: SMs x blocks resident per SM.  The first launch of a
// configuration on a device raises the kernel's dynamic shared-memory
// limit to the device's whole opt-in limit and asks for its occupancy;
// later launches find the answer in a small table, since those runtime
// calls cost tens of microseconds of host time.
struct Resident {
  const void* kernel;
  int dev, threads;
  size_t smem;
  int blocks;
};
constexpr int RESIDENT_SLOTS = 64;
std::mutex resident_mu;
Resident resident_seen[RESIDENT_SLOTS];
int resident_next = 0;   // the slot to fill next, round robin

cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                            int* resident) {
  int dev = 0, optin = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(resident_mu);
  for (const Resident& r : resident_seen)
    if (r.kernel == kernel && r.dev == dev && r.threads == threads &&
        r.smem == smem) {
      *resident = r.blocks;
      return cudaSuccess;
    }
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *resident = sms * per_sm;
  resident_seen[resident_next] =
      {kernel, dev, threads, smem, *resident};
  resident_next = (resident_next + 1) % RESIDENT_SLOTS;
  return cudaSuccess;
}

template <int TS, int RT, bool ALIGNED>
cudaError_t launch(Args& args, cudaStream_t st) {
  auto kernel = gf_matmul_kernel<TS, RT, ALIGNED>;
  args.ctiles = (args.s + TS - 1) / TS;
  args.tiles = args.batch * args.row_tiles * args.ctiles;
  args.ka = ((A_SMEM / (args.G * Pad<RT>::value)) / args.kcs) * args.kcs;
  const int k_padded = ((args.k + args.kcs - 1) / args.kcs) * args.kcs;
  args.ka = std::min(args.ka, k_padded);
  const int a_bytes = args.ka * args.G * Pad<RT>::value * 4;
  const size_t smem = (size_t)align128(HEADER_BYTES) + align128(a_bytes) +
                      (size_t)STAGES * args.kcs * Tile<TS>::PITCH * 4;
  const int threads = Tile<TS>::CG * args.G + 32;
  int resident = 0;
  cudaError_t err = resident_blocks((const void*)kernel, threads, smem,
                                    &resident);
  if (err != cudaSuccess) return err;
  const long long grid = std::min(args.tiles, (long long)resident);
  kernel<<<(unsigned)grid, threads, smem, st>>>(args);
  return cudaGetLastError();
}

// Picks the tile width and rows per thread for m: G = ceil(m / 8) row
// groups of RT = ceil(m / G) rows (64-row tiles past m = 64), and the
// widest tile whose G row groups of TS / 4 threads fit 512 consumers —
// 1024 columns (4 KB bulk copies) to m = 16, 512 to m = 32, 256 above.
template <bool ALIGNED>
cudaError_t launch_rows(Args& args, cudaStream_t st) {
  const int m = args.m;
  args.G = (std::min(m, 64) + MAX_RT - 1) / MAX_RT;
  const int rt = (std::min(m, 64) + args.G - 1) / args.G;
  args.row_tiles = (m + args.G * rt - 1) / (args.G * rt);
  if (m > 32)
    return rt <= 7 ? launch<256, 7, ALIGNED>(args, st)
                   : launch<256, 8, ALIGNED>(args, st);
  if (m > 16) {
    switch (rt) {
      case 6: return launch<512, 6, ALIGNED>(args, st);
      case 7: return launch<512, 7, ALIGNED>(args, st);
      default: return launch<512, 8, ALIGNED>(args, st);
    }
  }
  switch (rt) {
    case 1: return launch<1024, 1, ALIGNED>(args, st);
    case 2: return launch<1024, 2, ALIGNED>(args, st);
    case 3: return launch<1024, 3, ALIGNED>(args, st);
    case 4: return launch<1024, 4, ALIGNED>(args, st);
    case 5: return launch<1024, 5, ALIGNED>(args, st);
    case 6: return launch<1024, 6, ALIGNED>(args, st);
    case 7: return launch<1024, 7, ALIGNED>(args, st);
    default: return launch<1024, 8, ALIGNED>(args, st);
  }
}

__global__ void fold_check_kernel(unsigned p, unsigned mu,
                                  unsigned long long* bad) {
  unsigned long long count = 0;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long x = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       x <= 0xffffffffull; x += step)
    count += fold((unsigned)x, p, mu) != (unsigned)x % p;
  if (count) atomicAdd(bad, count);
}

unsigned barrett_mu(int p) { return (unsigned)((1ull << 32) / (unsigned)p); }

}  // namespace

extern "C" {

// out[f] = (a[f] @ b[f]) mod p for f < batch, where b[f] is the
// concatenation along the contraction axis of nsrc <= 4 sources: source i
// holds rows[i] rows of s symbols, row j at src[i] + f * bstride[i] +
// j * ld[i].  a: (m, k) contiguous at a + f * a_bstride (0: one matrix for
// the whole batch), k = sum(rows); out row r of batch element f at
// out + f * out_bstride + r * out_ld, its s symbols adjacent.  p >= 2.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int gf_matmul_launch(const void* a, void* out, const void* const* src,
                     const long long* bstride, const long long* ld,
                     const int* rows, int nsrc, int batch, int m, int k,
                     long long s, long long a_bstride, long long out_ld,
                     long long out_bstride, int p, int lazy, void* stream) {
  if (nsrc < 1 || nsrc > MAX_SOURCES || batch <= 0 || m <= 0 || k <= 0 ||
      s <= 0 || lazy <= 0 || p < 2 || (m > 1 && out_ld < s) ||
      (batch > 1 && out_bstride < (long long)m * out_ld))
    return (int)cudaErrorInvalidValue;
  Args args = {};
  int total = 0;
  bool aligned = (s % 4 == 0) && ((uintptr_t)out % 16 == 0) &&
                 (out_ld % 4 == 0) && (out_bstride % 4 == 0);
  for (int i = 0; i < nsrc; ++i) {
    if (rows[i] <= 0) return (int)cudaErrorInvalidValue;
    args.src.ptr[i] = (const int*)src[i];
    args.src.bstride[i] = bstride[i];
    args.src.ld[i] = ld[i];
    args.src.rows[i] = rows[i];
    total += rows[i];
    aligned = aligned && ((uintptr_t)src[i] % 16 == 0) &&
              (bstride[i] % 4 == 0) && (ld[i] % 4 == 0);
  }
  if (total != k) return (int)cudaErrorInvalidValue;
  args.src.n = nsrc;
  args.a = (const int*)a;
  args.out = (int*)out;
  args.s = s;
  args.a_bstride = a_bstride;
  args.out_ld = out_ld;
  args.out_bstride = out_bstride;
  args.m = m;
  args.k = k;
  args.p = p;
  args.lazy = lazy;
  args.mu = barrett_mu(p);
  args.kcs = std::min(k, KC);
  args.batch = batch;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = aligned ? launch_rows<true>(args, st)
                            : launch_rows<false>(args, st);
  return (int)err;
}

// Counts, into *bad (a zeroed device uint64), the uint32 values x for
// which the kernel's Barrett fold differs from x % p.
int gf_fold_check_launch(int p, void* bad, void* stream) {
  if (p < 2) return (int)cudaErrorInvalidValue;
  fold_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
      (unsigned)p, barrett_mu(p), (unsigned long long*)bad);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
