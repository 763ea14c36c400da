// K6a, K6b, K7a and K7b: the stable radix sort's kernels for Hopper
// (sm_90a), over one shared device routine, a stable in-tile rank by one
// digit.
//
// Replaces, in repro/kernels/radix_sort.py:
//   K7a radix_tile_sort        (body _radix_sort_kernel): in-tile stable LSD
//       sort of u32 words by bits [key_shift, key_shift + total_bits);
//   K7b radix_tile_sort_packed (body _fused_tile_sort_kernel): pack
//       key << log2(tile) | pos, sort by the key digits only, emit
//       key << idx_bits | gidx (or, with unpack, the int32 order);
//   K6a _mt_local              (body _mt_local_kernel): one multi-tile digit
//       pass, tile-local half: stable sort by the pass digit plus the
//       per-tile digit histogram (pass 0 packs key << idx_bits | gidx);
//   K6b _mt_scatter            (body _mt_scatter_kernel): the global half:
//       every (tile, digit) segment to its global base offset.
//
// What bounds them on this card: bytes.  Each kernel reads its tile once
// from device memory and writes it once (8 bytes a word, plus R counts a
// tile), a few hundred integer operations per word at most, far below the
// card's integer rate.  At 2^20 words the byte bound is 2.5 us.  The
// digit passes of K7 run inside one CTA on the tile held in shared memory,
// so their cost is shared-memory traffic and synchronisation, not device
// bytes; the design keeps every pass there.
//
// Design.  The TPU kernels rank by a masked cumsum over a (G, m, R) one-hot
// and place by a one-hot matmul, because the TPU has no 1-D gathers or
// scatters.  The card has both in shared memory: one CTA per tile keeps the
// tile (<= 2^13 words) in two shared buffers and places each word by a
// scatter to its rank, ping-ponging across the digit passes.
//
// Stability is the hazard.  A word's rank must be exactly (words of smaller
// digit in the tile) + (earlier words of the same digit).  A rank taken
// from the return value of a shared atomicAdd follows the order in which
// threads happen to run, so it is not stable.  rank_pass gives each warp a
// contiguous chunk of the tile and walks it 32 words at a time in index
// order.  __match_any_sync gives each lane the lanes with its digit; the
// popcount of those below it is its rank among equal digits in this step,
// and the lowest such lane (the leader) advances a per-(digit, warp)
// counter.  One sweep counts, an exclusive scan of the (digit, warp)
// counts in digit-major order gives each segment's first rank, and a
// second sweep ranks and scatters.  The order of ranks is then (digit,
// warp chunk, step, lane), which is (digit, index): stable.
//
// K6b: the TPU design does not carry over.  The reference revisits the
// whole output across its sequential grid steps, copying masked windows by
// read-modify-write into an output padded by one tile.  A Hopper grid runs
// in no order.  But each (tile, digit) segment has its own contiguous
// destination, disjoint from every other: one CTA per tile writes element
// j of its locally sorted tile straight to base[t, d] + j - lstart[t, d].
// No read-modify-write, no spare tile, and the order of CTAs does not
// matter; K6b fuses the last pass's & idx_mask unpack.
#include "radix_rank.cuh"

namespace {

constexpr int MAX_TILE = 1 << 13;
constexpr int MAX_RADIX = 256;
constexpr unsigned SENTINEL = 0xffffffffu;

// dynamic shared memory of the tile kernels: two word buffers of the tile,
// the (digit, warp) counts and the scan scratch
size_t tile_smem(int tile) {
  return sizeof(unsigned) * (2 * (size_t)tile + WARPS * MAX_RADIX + WARPS + 1);
}

struct Smem {
  unsigned* a;
  unsigned* b;
  int* cnt;
  int* ws;
};

__device__ __forceinline__ Smem carve(unsigned* smem, int tile) {
  Smem s;
  s.a = smem;
  s.b = smem + tile;
  s.cnt = reinterpret_cast<int*>(smem + 2 * tile);
  s.ws = s.cnt + WARPS * MAX_RADIX;
  return s;
}

// K7a: every tile sorted by bits [key_shift, key_shift + total_bits)
__global__ void __launch_bounds__(THREADS)
tile_sort_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out,
                 int tile, int key_shift, int total_bits, int digit_bits) {
  extern __shared__ unsigned smem[];
  Smem s = carve(smem, tile);
  const size_t off = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += THREADS) s.a[i] = x[off + i];
  __syncthreads();
  for (int lo = 0; lo < total_bits; lo += digit_bits) {
    rank_pass(s.a, s.b, tile, key_shift + lo, min(digit_bits, total_bits - lo),
              s.cnt, s.ws, nullptr);
    unsigned* t = s.a;
    s.a = s.b;
    s.b = t;
  }
  for (int i = threadIdx.x; i < tile; i += THREADS) out[off + i] = s.a[i];
}

// K7b: pack, sort by the key digits above log2(tile), emit packed words or
// (unpack) the int32 order; slots past n become the sentinel / idx_mask
__global__ void __launch_bounds__(THREADS)
packed_tile_sort_kernel(const unsigned* __restrict__ keys,
                        unsigned* __restrict__ out, int tile, int lb, int n,
                        int idx_bits, int sort_bits, int digit_bits,
                        int unpack) {
  extern __shared__ unsigned smem[];
  Smem s = carve(smem, tile);
  const size_t off = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += THREADS)
    s.a[i] = shl(keys[off + i], lb) | (unsigned)i;
  __syncthreads();
  for (int lo = 0; lo < sort_bits; lo += digit_bits) {
    rank_pass(s.a, s.b, tile, lb + lo, min(digit_bits, sort_bits - lo),
              s.cnt, s.ws, nullptr);
    unsigned* t = s.a;
    s.a = s.b;
    s.b = t;
  }
  const unsigned idx_mask = idx_bits >= 32 ? FULL : (1u << idx_bits) - 1u;
  const unsigned pos_mask = (unsigned)tile - 1u;
  for (int i = threadIdx.x; i < tile; i += THREADS) {
    const unsigned c = s.a[i];
    const unsigned gidx = (unsigned)off + (c & pos_mask);
    const bool real = gidx < (unsigned)n;
    out[off + i] = unpack ? (real ? gidx : idx_mask)
                          : (real ? shl(shr(c, lb), idx_bits) | gidx
                                  : SENTINEL);
  }
}

// K6a: one digit pass, tile-local half
__global__ void __launch_bounds__(THREADS)
mt_local_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ local,
                int* __restrict__ hist, int tile, int shift, int bits,
                int pack, int idx_bits) {
  extern __shared__ unsigned smem[];
  Smem s = carve(smem, tile);
  const size_t off = (size_t)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += THREADS) {
    const unsigned w = x[off + i];
    s.a[i] = pack ? shl(w, idx_bits) | (unsigned)(off + i) : w;
  }
  __syncthreads();
  rank_pass(s.a, s.b, tile, shift, bits, s.cnt, s.ws,
            hist + (size_t)blockIdx.x * (1 << bits));
  for (int i = threadIdx.x; i < tile; i += THREADS) local[off + i] = s.b[i];
}

// K6b: one digit pass, global half: segment (t, d) of the locally sorted
// tile goes to out[base[t, d], base[t, d] + hist[t, d])
__global__ void __launch_bounds__(THREADS)
mt_scatter_kernel(const unsigned* __restrict__ local,
                  const int* __restrict__ hist, const int* __restrict__ base,
                  unsigned* __restrict__ out, int tile, int radix,
                  unsigned unpack_mask, int unpack) {
  __shared__ int lstart[MAX_RADIX];
  __shared__ int gbase[MAX_RADIX];
  __shared__ int ws[WARPS + 1];
  const size_t row = (size_t)blockIdx.x * radix;
  for (int d = threadIdx.x; d < radix; d += THREADS) {
    lstart[d] = hist[row + d];
    gbase[d] = base[row + d];
  }
  __syncthreads();
  block_exclusive_scan(lstart, radix, ws);
  const size_t off = (size_t)blockIdx.x * tile;
  for (int j = threadIdx.x; j < tile; j += THREADS) {
    // the segment holding j: the last digit whose local start is <= j
    // (an empty segment shares its start with the next one)
    int lo = 0, hi = radix - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (lstart[mid] <= j) lo = mid; else hi = mid - 1;
    }
    const unsigned w = local[off + j];
    out[(size_t)(gbase[lo] + (j - lstart[lo]))] = unpack ? (w & unpack_mask)
                                                         : w;
  }
}

bool pow2_tile(int tile) {
  return tile >= 1 && tile <= MAX_TILE && (tile & (tile - 1)) == 0;
}

// above 48 KB a kernel must opt in to its dynamic shared memory
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int log2_int(int v) {
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
}

}  // namespace

extern "C" int radix_tile_sort(const void* x, void* out, int nt, int tile,
                               int key_shift, int total_bits, int digit_bits,
                               void* stream) {
  if (nt < 1 || !pow2_tile(tile) || key_shift < 0 || total_bits < 0 ||
      digit_bits < 1 || digit_bits > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem(tile);
  cudaError_t err = allow_smem(tile_sort_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tile_sort_kernel<<<nt, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), tile,
      key_shift, total_bits, digit_bits);
  return (int)cudaGetLastError();
}

extern "C" int radix_tile_sort_packed(const void* keys, void* out, int nt,
                                      int tile, int n, int idx_bits,
                                      int sort_bits, int digit_bits,
                                      int unpack, void* stream) {
  if (nt < 1 || !pow2_tile(tile) || n < 0 || idx_bits < 0 || sort_bits < 0 ||
      digit_bits < 1 || digit_bits > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem(tile);
  cudaError_t err = allow_smem(packed_tile_sort_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  packed_tile_sort_kernel<<<nt, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(keys), static_cast<unsigned*>(out), tile,
      log2_int(tile), n, idx_bits, sort_bits, digit_bits, unpack);
  return (int)cudaGetLastError();
}

extern "C" int radix_mt_local(const void* x, void* local, void* hist, int nt,
                              int tile, int shift, int bits, int pack,
                              int idx_bits, void* stream) {
  if (nt < 1 || !pow2_tile(tile) || shift < 0 || bits < 1 || bits > 8 ||
      idx_bits < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem(tile);
  cudaError_t err = allow_smem(mt_local_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mt_local_kernel<<<nt, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(local),
      static_cast<int*>(hist), tile, shift, bits, pack, idx_bits);
  return (int)cudaGetLastError();
}

extern "C" int radix_mt_scatter(const void* local, const void* hist,
                                const void* base, void* out, int nt,
                                int tile, int radix, unsigned unpack_mask,
                                int unpack, void* stream) {
  if (nt < 1 || tile < 1 || radix < 2 || radix > MAX_RADIX ||
      (radix & (radix - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  mt_scatter_kernel<<<nt, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(local), static_cast<const int*>(hist),
      static_cast<const int*>(base), static_cast<unsigned*>(out), tile, radix,
      unpack_mask, unpack);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
