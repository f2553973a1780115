// Kernel K1: per-tile triangle visibility + Gouraud shading to packed u8.
//
// Replaces the TPU kernel pallas_raster._make_kernel_flat(u8=True)
// (libnativecpurenderer_tpu/ops/pallas_raster.py:125-354, u8 epilogue
// :566-596), launched by raster_tiles_flat (:793) through
// render_binned_pallas_flat_u8 (:953).  Plain version and wrapper:
// ops/tile_raster.py (raster_tiles_flat_u8[_reference]).
//
// What it computes.  For tile t, pixel slot p at integer coordinates
// (ox + p % tile_w, oy + p / tile_w): walk the tile's run of the sorted
// pair array, slots j = 0 .. counts[t]-1, triangle
// sorted_pad[starts[t] + j] & IDX_MASK, row table[tri] (32 floats).
// e_i = (A_i x + B_i y) + C_i; covered iff e0, e1, e2 >= 0 (and
// 0 <= zz <= 1 with z_clip); zz = (e0 zsc0 + e1 zsc1) + e2 zsc2;
// key = (trunc(zz * 8191) << 18) | j; the strict running minimum keeps
// the lower slot on a tie.  The winner's channel d is
// (e0 a0d + e1 a1d) + e2 a2d, quantised clip(v * 255, 0, 255) truncated
// and packed r | g << 8 | b << 16 | a << 24 (a = 255 when opaque); slots
// no triangle covers get the packed background.
//
// Bits.  The file is built with -fmad=false, so every product and sum is
// rounded on its own, as in the plain torch version, which this kernel
// matches bit for bit.  Coverage tests compare each edge with 0 (a NaN
// row compares false), never through fminf, which would drop a NaN.
// The TPU kernel's chunk walk also read up to kcc-1 slots past the run
// (spilling into the next tile's run); those can only lose ties, since a
// triangle covering a pixel of tile t sits in t's own run at a lower
// slot, so walking exactly counts[t] slots gives the same winner.  No
// TPU block windows are needed: the run is read straight from the
// sorted array.
//
// What bounds it on an H100: not yet known (no profiler reading).  At
// the 1080p production shape (2040 tiles of 32x32, 10k triangles) the
// binning emits ~26k (tile, triangle) pairs a frame, so the walk is
// ~27M pixel-triangle tests of ~25 float and integer operations each,
// ~0.7e9 operations, against a 1.3 MB table and an 8.4 MB output.  At
// ~0.1 ms a frame that is far below both the arithmetic and the memory
// limits of the card.  The runs are skewed (the longest holds ~220-250
// triangles against a mean of ~13), so the suspected bound is the tail
// of blocks that walk the longest runs.
//
// Design.  One block of 256 threads per tile; each thread owns
// PPT = ceil(P / 256) pixels (4 at 32x32) and keeps its best key, its
// winner's edge values and triangle id in registers.  The run's rows
// (the 12 walk columns) are staged through shared memory 32 triangles
// at a time, each read by all threads as a broadcast.  Only the winner
// is shaded, after the walk: its attribute columns are read once from
// the (L2-resident) table.  No tensor cores or TMA: nothing here is a
// matrix product or a large tile copy.  A long run stays in one block;
// splitting long runs across blocks is the lever if the tail is the
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IDX_BITS = 18;
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int Z_LEVELS = (1 << (31 - IDX_BITS)) - 1;
constexpr int SKY_KEY = (Z_LEVELS << IDX_BITS) | IDX_MASK;
constexpr int ROW_W = 32;
constexpr int WALK_COLS = 12;   // 9 edge coefficients + 3 z columns
constexpr int ATTR_COL = 14;    // vertex i, channel d at ATTR_COL + 4 i + d
constexpr int THREADS = 256;
constexpr int CHUNK = 32;       // triangle rows staged per pass

__device__ __forceinline__ int quant_u8(float v) {
  return __float2int_rz(fminf(fmaxf(__fmul_rn(v, 255.0f), 0.0f), 255.0f));
}

template <int PPT, bool ZCLIP>
__global__ void __launch_bounds__(THREADS)
tile_raster_u8_kernel(const int* __restrict__ sorted_pad, int spad,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const float* __restrict__ table, int nrows,
                      const int* __restrict__ packed_bg,
                      int* __restrict__ out, int ntx, int tile_w,
                      int tile_h, bool opaque) {
  __shared__ float s_rows[CHUNK][WALK_COLS];
  __shared__ int s_tri[CHUNK];

  const int t = blockIdx.x;
  const int P = tile_w * tile_h;
  const int ox = (t % ntx) * tile_w;
  const int oy = (t / ntx) * tile_h;
  const int start = starts[t];
  const int count = counts[t];

  float px[PPT], py[PPT], be0[PPT], be1[PPT], be2[PPT];
  int best[PPT], btri[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    px[k] = (float)(ox + p % tile_w);
    py[k] = (float)(oy + p / tile_w);
    best[k] = SKY_KEY;
    btri[k] = 0;
    be0[k] = be1[k] = be2[k] = 0.0f;
  }

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int i = threadIdx.x; i < n * WALK_COLS; i += THREADS) {
      const int r = i / WALK_COLS;
      const int c = i - r * WALK_COLS;
      const int slot = min(start + base + r, spad - 1);
      const int tri = min(sorted_pad[slot] & IDX_MASK, nrows - 1);
      s_rows[r][c] = table[(size_t)tri * ROW_W + c];
      if (c == 0) s_tri[r] = tri;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* row = s_rows[j];
      const int slot = base + j;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float e0 = __fadd_rn(__fadd_rn(__fmul_rn(row[0], px[k]),
                                             __fmul_rn(row[1], py[k])),
                                   row[2]);
        const float e1 = __fadd_rn(__fadd_rn(__fmul_rn(row[3], px[k]),
                                             __fmul_rn(row[4], py[k])),
                                   row[5]);
        const float e2 = __fadd_rn(__fadd_rn(__fmul_rn(row[6], px[k]),
                                             __fmul_rn(row[7], py[k])),
                                   row[8]);
        const float zz = __fadd_rn(__fadd_rn(__fmul_rn(e0, row[9]),
                                             __fmul_rn(e1, row[10])),
                                   __fmul_rn(e2, row[11]));
        bool cov = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f);
        if (ZCLIP) cov = cov && (zz >= 0.0f) && (zz <= 1.0f);
        const unsigned zq =
            (unsigned)__float2int_rz(__fmul_rn(zz, (float)Z_LEVELS));
        const int key = (int)((zq << IDX_BITS) | (unsigned)slot);
        if (cov && key < best[k]) {
          best[k] = key;
          btri[k] = s_tri[j];
          be0[k] = e0;
          be1[k] = e1;
          be2[k] = e2;
        }
      }
    }
  }

  const int bgp = *packed_bg;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    if (p >= P) break;
    int packed = bgp;
    if (best[k] != SKY_KEY) {
      const float* a = table + (size_t)btri[k] * ROW_W + ATTR_COL;
      int q[4];
      const int nch = opaque ? 3 : 4;
      for (int d = 0; d < nch; ++d) {
        const float v = __fadd_rn(__fadd_rn(__fmul_rn(be0[k], a[d]),
                                            __fmul_rn(be1[k], a[4 + d])),
                                  __fmul_rn(be2[k], a[8 + d]));
        q[d] = quant_u8(v);
      }
      const unsigned a8 = opaque ? 255u : (unsigned)q[3];
      packed = (int)((unsigned)q[0] | ((unsigned)q[1] << 8) |
                     ((unsigned)q[2] << 16) | (a8 << 24));
    }
    out[(size_t)t * P + p] = packed;
  }
}

template <int PPT>
cudaError_t launch(dim3 grid, cudaStream_t stream, bool z_clip,
                   const int* sorted_pad, int spad, const int* starts,
                   const int* counts, const float* table, int nrows,
                   const int* packed_bg, int* out, int ntx, int tile_w,
                   int tile_h, bool opaque) {
  if (z_clip)
    tile_raster_u8_kernel<PPT, true><<<grid, THREADS, 0, stream>>>(
        sorted_pad, spad, starts, counts, table, nrows, packed_bg, out, ntx,
        tile_w, tile_h, opaque);
  else
    tile_raster_u8_kernel<PPT, false><<<grid, THREADS, 0, stream>>>(
        sorted_pad, spad, starts, counts, table, nrows, packed_bg, out, ntx,
        tile_w, tile_h, opaque);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over nt tiles of tile_w x tile_h pixels.
// Returns the cudaError_t of the launch (0 on success).  An error left
// pending by an earlier launch is returned without launching, so the
// caller raises it; an out-of-range tile size returns
// cudaErrorInvalidValue without launching.
int tile_raster_u8(const int* sorted_pad, int spad, const int* starts,
                   const int* counts, int nt, const float* table, int nrows,
                   const int* packed_bg, int* out, int ntx, int tile_w,
                   int tile_h, int opaque, int z_clip, void* stream) {
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return (int)pending;
  if (nt == 0) return 0;
  const int P = tile_w * tile_h;
  if (P <= 0 || spad <= 0 || nrows <= 0 || ntx <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nt);
  cudaStream_t s = (cudaStream_t)stream;
  const int ppt = (P + THREADS - 1) / THREADS;
#define K1_LAUNCH(N)                                                      \
  return (int)launch<N>(grid, s, z_clip != 0, sorted_pad, spad, starts,   \
                        counts, table, nrows, packed_bg, out, ntx, tile_w, \
                        tile_h, opaque != 0)
  if (ppt <= 1) K1_LAUNCH(1);
  if (ppt <= 2) K1_LAUNCH(2);
  if (ppt <= 4) K1_LAUNCH(4);
  if (ppt <= 8) K1_LAUNCH(8);
  if (ppt <= 16) K1_LAUNCH(16);
#undef K1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* tile_raster_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
