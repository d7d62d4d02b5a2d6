// CRC-32 of one GF(257) node share, in one pass, with the interpreter lock
// released for large shares: the host side of the store's integrity ledger.
//
// Computes exactly what the numpy formula `share_crc(a, r)` in
// src/repro_torch/store/object_store.py computes: zlib's CRC-32 (reflected
// polynomial 0xEDB88320, initial value and final XOR 0xFFFFFFFF) over
//   the low byte of every int32 symbol of the data block a,
//   then the low byte of every int32 symbol of the redundancy block r,
//   then the indexes i where r[i] == 256, as little-endian int64,
// chained as one byte stream.  Symbols of a sound share lie in [0, 256];
// every other int32 (a corrupt share) takes its low byte too, as numpy's
// truncating cast does, so the value is the formula's for every input.
//
// What bounds it: host memory bytes.  A share at the store's 1 MiB unit is
// 8 MiB of int32 read once, and the formula spent its time in zlib's table
// CRC (~1 GB/s) and two uint8 copies.  What the design does about it:
//   * one pass.  Each 16 symbols are masked to their low byte and packed
//     (two packs of 32 -> 16 -> 8 bits; the mask keeps the saturating
//     packs exact for any int32) into a 4 KiB buffer in L1, which the CRC
//     consumes whenever it fills; the same registers are compared with 256,
//     so the redundancy block's index scan costs no second pass.  The pack
//     prefetches 8 KiB ahead within the share (past the data block's end
//     into the redundancy block's head, never past the share): one
//     thread's stream from memory is bound by the misses it keeps in
//     flight.  On an 8-core Xeon host, reading shares not in cache, the
//     prefetch cut a check at 2 x 2^20 symbols from ~1.5 to ~1.0 ms (4 and
//     8 KiB ahead, to the L1 or the L2, within noise of each other); at
//     2 x 4096, running on into the redundancy block checked ~8% faster
//     than letting the prefetch run past each block's end (~7.0 against
//     ~7.6 us).
//   * a carry-less-multiply CRC where the CPU has PCLMULQDQ and SSE4.1:
//     four 128-bit lanes fold 64 bytes an iteration, then fold to 128 bits
//     and end in a Barrett reduction (Intel, "Fast CRC Computation for
//     Generic Polynomials Using PCLMULQDQ Instruction", 2009; the
//     bit-reflected constants below).  Elsewhere a slice-by-8 table CRC.
//     The path is chosen once, from cpuid, when the module loads; the
//     build takes no -march, and the folded code gets its instruction sets
//     from function target attributes, so the library runs on any x86-64.
//   * the lock.  Each entry point takes its operands through the buffer
//     protocol (no copy) and, for a share of kUnlockMinSymbols or more,
//     releases the interpreter lock for the whole CRC, so threads checking
//     shares run in parallel.  A smaller share keeps the lock: its CRC
//     takes a few microseconds, and a thread that lets the lock go must
//     win it back from any thread running Python meanwhile, which takes up
//     to the interpreter's switch interval (5 ms).  On an 8-core Xeon host
//     at 2 x 4096 symbols, four threads checked no faster releasing than
//     holding, and one thread checking beside a busy Python thread took
//     ~4.8 ms a check releasing against ~16 us holding; at 2 x 16384
//     symbols four threads checked 3x faster releasing.  CPython's zlib
//     and hashlib hold the lock below a size for the same reason.
//
// Entry points (module `share_crc`, built by kernels/_build.py):
//   share_crc(a, r)        the CRC on the CPU's best path
//   share_crc_clmul(a, r)  the folded path (RuntimeError without PCLMULQDQ)
//   share_crc_table(a, r)  the table path
//   has_clmul()            whether share_crc takes the folded path
//   counts()               (folded, table) checks since the module loaded
// Each CRC entry returns None, touching nothing, when an operand is not a
// C-contiguous buffer of int32 (the caller converts it and calls again).
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#define SHARE_CRC_X86 1
#endif

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the ledger's int64 indexes are little-endian bytes");

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;
constexpr size_t kBuf = 4096;        // packed bytes a CRC call, multiple of 64
constexpr size_t kUnlockMinSymbols = size_t{1} << 15;   // a + r, see above
constexpr size_t kPrefetchSymbols = 2048;   // 8 KiB ahead, see above

uint32_t g_table[8][256];            // slice-by-8, filled when the module loads
bool g_clmul = false;                // the CPU has PCLMULQDQ and SSE4.1
std::atomic<unsigned long long> g_counts[2];   // checks: folded, table

void init_tables() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int b = 0; b < 8; ++b) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
    g_table[0][i] = c;
  }
  for (int k = 1; k < 8; ++k)
    for (int i = 0; i < 256; ++i)
      g_table[k][i] = (g_table[k - 1][i] >> 8) ^
                      g_table[0][g_table[k - 1][i] & 0xffu];
}

// c is the running state (the public CRC inverted).
uint32_t crc_table(uint32_t c, const uint8_t* p, size_t n) {
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    const uint32_t lo = static_cast<uint32_t>(w) ^ c;
    const uint32_t hi = static_cast<uint32_t>(w >> 32);
    c = g_table[7][lo & 0xffu] ^ g_table[6][(lo >> 8) & 0xffu] ^
        g_table[5][(lo >> 16) & 0xffu] ^ g_table[4][lo >> 24] ^
        g_table[3][hi & 0xffu] ^ g_table[2][(hi >> 8) & 0xffu] ^
        g_table[1][(hi >> 16) & 0xffu] ^ g_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = g_table[0][(c ^ *p++) & 0xffu] ^ (c >> 8);
  return c;
}

#ifdef SHARE_CRC_X86
bool cpu_has_clmul() {
  unsigned a, b, c, d;
  if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
  return (c & bit_PCLMUL) && (c & bit_SSE4_1);
}

// x * x^(k1 or k3 term) folded onto the next 16 bytes.
__attribute__((target("pclmul,sse4.1")))
inline __m128i fold16(__m128i x, __m128i k, __m128i next) {
  const __m128i lo = _mm_clmulepi64_si128(x, k, 0x00);
  const __m128i hi = _mm_clmulepi64_si128(x, k, 0x11);
  return _mm_xor_si128(_mm_xor_si128(hi, lo), next);
}

// Folds n bytes, n >= 64 and a multiple of 16, into the running state.
__attribute__((target("pclmul,sse4.1")))
uint32_t crc_fold(uint32_t crc, const uint8_t* p, size_t n) {
  // x^(4*128+32) and x^(4*128-32) mod P, reflected; then the same at 128;
  // x^64 mod P; and P with its Barrett quotient mu = x^64 / P.
  const __m128i k1k2 = _mm_set_epi64x(0x01c6e41596LL, 0x0154442bd4LL);
  const __m128i k3k4 = _mm_set_epi64x(0x00ccaa009eLL, 0x01751997d0LL);
  const __m128i k5k0 = _mm_set_epi64x(0, 0x0163cd6124LL);
  const __m128i poly = _mm_set_epi64x(0x01f7011641LL, 0x01db710641LL);
  const __m128i* q = reinterpret_cast<const __m128i*>(p);

  __m128i x1 = _mm_xor_si128(_mm_loadu_si128(q), _mm_cvtsi32_si128(
      static_cast<int>(crc)));
  __m128i x2 = _mm_loadu_si128(q + 1);
  __m128i x3 = _mm_loadu_si128(q + 2);
  __m128i x4 = _mm_loadu_si128(q + 3);
  q += 4;
  n -= 64;
  for (; n >= 64; n -= 64, q += 4) {
    x1 = fold16(x1, k1k2, _mm_loadu_si128(q));
    x2 = fold16(x2, k1k2, _mm_loadu_si128(q + 1));
    x3 = fold16(x3, k1k2, _mm_loadu_si128(q + 2));
    x4 = fold16(x4, k1k2, _mm_loadu_si128(q + 3));
  }
  // four lanes into one, then the 16-byte blocks left
  x1 = fold16(x1, k3k4, x2);
  x1 = fold16(x1, k3k4, x3);
  x1 = fold16(x1, k3k4, x4);
  for (; n >= 16; n -= 16) x1 = fold16(x1, k3k4, _mm_loadu_si128(q++));

  // 128 -> 64 bits, then 64 -> 32, then Barrett
  const __m128i mask32 = _mm_setr_epi32(~0, 0, ~0, 0);
  __m128i t = _mm_clmulepi64_si128(x1, k3k4, 0x10);
  x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), t);
  t = _mm_srli_si128(x1, 4);
  x1 = _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), k5k0, 0x00);
  x1 = _mm_xor_si128(x1, t);
  t = _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), poly, 0x10);
  t = _mm_clmulepi64_si128(_mm_and_si128(t, mask32), poly, 0x00);
  x1 = _mm_xor_si128(x1, t);
  return static_cast<uint32_t>(_mm_extract_epi32(x1, 1));
}
#endif

// The symbols x[0, n) of one block, and the block read after it.
struct Block {
  const int32_t* x;
  size_t n;
  const int32_t* next;
  size_t next_n;
};

// The packed byte stream, CRC'd a buffer at a time.
struct Stream {
  bool clmul;
  uint32_t c = 0xFFFFFFFFu;
  size_t fill = 0;
  alignas(64) uint8_t buf[kBuf];

  explicit Stream(bool folded) : clmul(folded) {}

  void flush() {
    const uint8_t* p = buf;
    size_t n = fill;
#ifdef SHARE_CRC_X86
    if (clmul && n >= 64) {
      const size_t m = n & ~static_cast<size_t>(15);
      c = crc_fold(c, p, m);
      p += m;
      n -= m;
    }
#endif
    c = crc_table(c, p, n);
    fill = 0;
  }

  void put(const uint8_t* p, size_t n) {
    while (n) {
      const size_t m = n < kBuf - fill ? n : kBuf - fill;
      std::memcpy(buf + fill, p, m);
      fill += m;
      p += m;
      n -= m;
      if (fill == kBuf) flush();
    }
  }

  // Appends the low byte of every symbol of b; with hits, also the
  // indexes of the symbols equal to 256.
  void put_symbols(const Block& b, std::vector<int64_t>* hits) {
    size_t i = 0;
    while (i < b.n) {
      const size_t m = b.n - i < kBuf - fill ? b.n - i : kBuf - fill;
      pack(b, i, m, buf + fill, hits);
      fill += m;
      i += m;
      if (fill == kBuf) flush();
    }
  }

  uint32_t finish() {
    flush();
    return ~c;
  }

  // Packs b.x[i0, i0 + m) into out.
  static void pack(const Block& b, size_t i0, size_t m, uint8_t* out,
                   std::vector<int64_t>* hits) {
    const int32_t* x = b.x + i0;
    size_t i = 0;
#ifdef SHARE_CRC_X86
    const __m128i low = _mm_set1_epi32(0xff);
    const __m128i v256 = _mm_set1_epi32(256);
    for (; i + 16 <= m; i += 16) {
      prefetch(b, i0 + i + kPrefetchSymbols);
      const __m128i* q = reinterpret_cast<const __m128i*>(x + i);
      const __m128i v0 = _mm_loadu_si128(q), v1 = _mm_loadu_si128(q + 1);
      const __m128i v2 = _mm_loadu_si128(q + 2), v3 = _mm_loadu_si128(q + 3);
      const __m128i lo16a = _mm_packs_epi32(_mm_and_si128(v0, low),
                                            _mm_and_si128(v1, low));
      const __m128i lo16b = _mm_packs_epi32(_mm_and_si128(v2, low),
                                            _mm_and_si128(v3, low));
      _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i),
                       _mm_packus_epi16(lo16a, lo16b));
      if (hits) {
        const __m128i eq = _mm_or_si128(
            _mm_or_si128(_mm_cmpeq_epi32(v0, v256), _mm_cmpeq_epi32(v1, v256)),
            _mm_or_si128(_mm_cmpeq_epi32(v2, v256), _mm_cmpeq_epi32(v3, v256)));
        if (_mm_movemask_epi8(eq))
          for (size_t j = i; j < i + 16; ++j)
            if (x[j] == 256) hits->push_back(static_cast<int64_t>(i0 + j));
      }
    }
#endif
    for (; i < m; ++i) {
      out[i] = static_cast<uint8_t>(x[i]);
      if (hits && x[i] == 256) hits->push_back(static_cast<int64_t>(i0 + i));
    }
  }

#ifdef SHARE_CRC_X86
  // Prefetches symbol j of b, or of the block after it: within the share.
  static void prefetch(const Block& b, size_t j) {
    const int32_t* p = j < b.n ? b.x + j
        : j - b.n < b.next_n ? b.next + (j - b.n) : nullptr;
    if (p) _mm_prefetch(reinterpret_cast<const char*>(p), _MM_HINT_T0);
  }
#endif
};

// The share's CRC; runs without the interpreter lock.
uint32_t share_crc(const int32_t* a, size_t na, const int32_t* r, size_t nr,
                   bool clmul) {
  Stream s(clmul);
  std::vector<int64_t> hits;
  s.put_symbols(Block{a, na, r, nr}, nullptr);
  s.put_symbols(Block{r, nr, nullptr, 0}, &hits);
  s.put(reinterpret_cast<const uint8_t*>(hits.data()),
        hits.size() * sizeof(int64_t));
  return s.finish();
}

// A C-contiguous int32 buffer, or false (no error set) when o is not one.
bool get_int32(PyObject* o, Py_buffer* view) {
  if (PyObject_GetBuffer(o, view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0) {
    PyErr_Clear();
    return false;
  }
  const char* f = view->format ? view->format : "B";
  if (*f == '@' || *f == '=' || *f == '<') ++f;
  const bool int32 = view->itemsize == 4 &&
      (std::strcmp(f, "i") == 0 ||
       (sizeof(long) == 4 && std::strcmp(f, "l") == 0));
  if (!int32) PyBuffer_Release(view);
  return int32;
}

PyObject* run(PyObject* const* args, Py_ssize_t nargs, int path) {
  if (nargs != 2) {
    PyErr_SetString(PyExc_TypeError, "share_crc takes (a, r)");
    return nullptr;
  }
  Py_buffer va, vr;
  if (!get_int32(args[0], &va)) Py_RETURN_NONE;
  if (!get_int32(args[1], &vr)) {
    PyBuffer_Release(&va);
    Py_RETURN_NONE;
  }
  const size_t na = static_cast<size_t>(va.len) / 4;
  const size_t nr = static_cast<size_t>(vr.len) / 4;
  uint32_t crc = 0;
  bool oom = false;
  auto compute = [&] {
    try {
      crc = share_crc(static_cast<const int32_t*>(va.buf), na,
                      static_cast<const int32_t*>(vr.buf), nr, path == 0);
    } catch (const std::bad_alloc&) {
      oom = true;
    }
  };
  if (na + nr >= kUnlockMinSymbols) {
    Py_BEGIN_ALLOW_THREADS
    compute();
    Py_END_ALLOW_THREADS
  } else {
    compute();
  }
  PyBuffer_Release(&va);
  PyBuffer_Release(&vr);
  if (oom) return PyErr_NoMemory();
  g_counts[path].fetch_add(1, std::memory_order_relaxed);
  return PyLong_FromUnsignedLong(crc);
}

PyObject* py_share_crc(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  return run(args, nargs, g_clmul ? 0 : 1);
}

PyObject* py_share_crc_clmul(PyObject*, PyObject* const* args,
                             Py_ssize_t nargs) {
  if (!g_clmul) {
    PyErr_SetString(PyExc_RuntimeError,
                    "this CPU lacks PCLMULQDQ or SSE4.1: no folded CRC");
    return nullptr;
  }
  return run(args, nargs, 0);
}

PyObject* py_share_crc_table(PyObject*, PyObject* const* args,
                             Py_ssize_t nargs) {
  return run(args, nargs, 1);
}

PyObject* py_has_clmul(PyObject*, PyObject*) {
  return PyBool_FromLong(g_clmul);
}

PyObject* py_counts(PyObject*, PyObject*) {
  return Py_BuildValue("(KK)", g_counts[0].load(), g_counts[1].load());
}

using FastCall = PyObject* (*)(PyObject*, PyObject* const*, Py_ssize_t);

PyCFunction fastcall(FastCall f) {
  return reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(f));
}

PyMethodDef kMethods[] = {
    {"share_crc", fastcall(py_share_crc), METH_FASTCALL,
     "CRC-32 of a share (a, r) on the CPU's best path; None if an operand "
     "is not a C-contiguous int32 buffer."},
    {"share_crc_clmul", fastcall(py_share_crc_clmul), METH_FASTCALL,
     "share_crc on the PCLMULQDQ path."},
    {"share_crc_table", fastcall(py_share_crc_table), METH_FASTCALL,
     "share_crc on the slice-by-8 table path."},
    {"has_clmul", py_has_clmul, METH_NOARGS,
     "Whether share_crc takes the PCLMULQDQ path on this CPU."},
    {"counts", py_counts, METH_NOARGS,
     "(folded, table) share checks since the module loaded."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "share_crc",
                       "One-pass CRC-32 of GF(257) node shares.", -1,
                       kMethods, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_share_crc(void) {
  init_tables();
#ifdef SHARE_CRC_X86
  g_clmul = cpu_has_clmul();
#endif
  return PyModule_Create(&kModule);
}
