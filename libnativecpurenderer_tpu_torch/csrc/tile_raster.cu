// Kernels K1, K3, K2b, K2a, K5 and K6: per-tile triangle visibility, then
// one of four epilogues on the winner.
//
// Replaces the TPU kernels of libnativecpurenderer_tpu/ops/pallas_raster.py
// as their launchers use them:
//   _make_kernel_flat (:125-600), rows from the sorted pair array:
//     U8_GOURAUD (K1)  u8=True, raster_tiles_flat (:793), epilogue :566-596;
//     TEX_U8     (K3)  tex_resolve=True, raster_tiles_tex (:895), epilogue
//                      :375-565, with raster3d._tex_resolve_finish after it;
//     TEX_IDX    (K2b) tex_dims, raster_tiles_flat (:793), epilogue
//                      :356-374;
//     KEYS_F32   (K2a) the f32 branch, raster_tiles_flat (:805), epilogue
//                      :597-599;
//   _make_kernel (:51-122), rows from a materialised bins row:
//     KEYS_F32   (K5)  raster_tiles (:1433), the z test always on;
//   _make_kernel_dynrows (:1176-1267), rows pre-gathered in pair order:
//     U8_GOURAUD (K6)  raster_tiles_dynrows (:1294), opaque, no z test.
// Plain versions and wrappers: ops/tile_raster.py (raster_tiles_*).
//
// The walk.  For tile t, pixel slot p at integer coordinates
// (ox + p % tile_w, oy + p / tile_w): walk slots j = 0 .. n-1 of the
// tile's run, each a row of 32 floats, taken from one of three sources
// (a template parameter, so the walk is written once):
//   PAIRS  table[sorted_pad[starts[t] + j] & IDX_MASK], n = counts[t];
//   BINS   table[bins[t, j]] (NO_TRI already remapped to the NaN pad row),
//          n = min(counts[t], K): an overflowed tile's reads stay in its
//          row, and it is flagged by the binning;
//   ROWS   rows[starts[t] + j], n = counts[t]: the rows were gathered in
//          pair order by the caller, so a chunk is one contiguous load.
// Reads are clamped into their arrays.  e_i = (A_i x + B_i y) + C_i;
// covered iff e0, e1, e2 >= 0 (and 0 <= zz <= 1 with z_clip);
// zz = (e0 zsc0 + e1 zsc1) + e2 zsc2; key = (trunc(zz * 8191) << 18) | j;
// the strict running minimum keeps the lower slot on a tie.  The winner's
// attribute d is (e0 a0d + e1 a1d) + e2 a2d, its columns read from the
// winner's own row.
//
// Frames.  Every entry takes B frames in one launch: nblocks = B * nt
// blocks, block b walking tile b % nt of frame f = b / nt.  Frame f's
// pairs (PAIRS) start at f * ids_len, its table or rows at f * nrows rows;
// starts, counts and the outputs are (B * nt, ...).  B = 1 is one frame.
//
// The epilogues, for a pixel some triangle covers (else: in brackets).
//   U8_GOURAUD: channels quantised clip(v * 255, 0, 255) truncated and
//     packed r | g << 8 | b << 16 | a << 24, a = 255 when opaque
//     [packed background].
//   TEX_IDX: with attributes [u/w, v/w, 1/w] (affine [u, v, 1]),
//     safe = a2 != 0 ? a2 : 1, ui = clamp(trunc(a0 / safe * tw), 0, tw-1),
//     vi the same with a1 and th; out = vi * tw + ui [-1].  The divide is
//     made in the affine case too, as the TPU kernel makes it.
//   TEX_U8: the packed texel tex[vi * tw + ui] [packed background].  The
//     TPU kernel fetched texels through per-tile windows of a VMEM copy
//     of the texture (Mosaic's lane gather is 128 wide) and left the
//     pixels they missed to an XLA gather; both fetch this same texel,
//     which a thread here loads straight from the packed texture (256 KiB
//     at 256x256, resident in the 50 MB L2).  So no windows, no fbidx
//     output, no fallback.
//   KEYS_F32: the key [SKY_KEY] and the four attributes as float32 [0].
//
// Bits.  The file is built with -fmad=false, so every product and sum is
// rounded on its own, as in the plain torch version, which this kernel
// matches bit for bit; divisions are __fdiv_rn, IEEE as torch's tensor
// division.  Float -> int is __float2int_rz, which truncates, saturates
// and sends NaN to 0, as XLA's conversion (raster3d._to_i32) does.
// Coverage tests compare each edge with 0 (a NaN row compares false),
// never through fminf, which would drop a NaN.  The TPU kernels walked
// whole kcc chunks and so read slots past the run: K1's and K6's spill
// into the next tile's run, K5's are NO_TRI (NaN) rows.  Those can only
// lose ties, since a triangle covering a pixel of tile t sits in t's own
// run at a lower slot, so walking exactly n slots gives the same winner.
// Keys are unique within a tile, so the TPU kernels' chunk minimum, then
// "cmin < kacc", is this strict per-slot minimum.  No TPU block windows,
// operand groups or frames-per-program are needed: the run is read
// straight from its array.
//
// What bounds it on an H100.  At the 1080p production shape (2040 tiles
// of 32x32, 10k triangles) the binning emits ~26k (tile, triangle)
// pairs a frame, so the walk is ~27M pixel-triangle tests of ~26
// separate operations, ~0.7e9 operations (0.021 ms at 33.5 T/s without
// fused multiply-adds), against a 1.3 MB table and an 8.4 MB output
// (0.003 ms at 3.35 TB/s).  The epilogues add ~10 (K1) to ~20 (K3)
// operations and one output word (K2a, K5: five) a pixel.  K1 measured
// ~0.1 ms a frame, ~0.2 of the operations bound.  K5's binning culls by
// box only, so it walks more pairs at its 128x16 tiles than K2a.  The
// runs are skewed (the longest holds ~220-250 triangles against a mean
// of ~13), so the suspected bound is the tail of blocks that walk the
// longest runs.
//
// Design.  One block of 256 threads per tile; each thread owns
// PPT = ceil(P / 256) pixels (4 at 32x32) and keeps its best key, its
// winner's edge values and row in registers.  The run's rows (the 12 walk
// columns) are staged through shared memory 32 at a time, each read by
// all threads as a broadcast.  Only the winner is shaded, after the walk:
// its attribute columns are read once from the (L2-resident) table.  No
// tensor cores or TMA: nothing here is a matrix product or a large tile
// copy.  A long run stays in one block; splitting long runs across blocks
// is the lever if the tail is the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IDX_BITS = 18;
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int Z_LEVELS = (1 << (31 - IDX_BITS)) - 1;
constexpr int SKY_KEY = (Z_LEVELS << IDX_BITS) | IDX_MASK;
constexpr int ROW_W = 32;
constexpr int WALK_COLS = 12;   // 9 edge coefficients + 3 z columns
constexpr int ATTR_COL = 14;    // vertex i, attribute d at ATTR_COL + 4 i + d
constexpr int D = 4;
constexpr int THREADS = 256;
constexpr int CHUNK = 32;       // triangle rows staged per pass

enum Epilogue { U8_GOURAUD, TEX_U8, TEX_IDX, KEYS_F32 };
enum Source { PAIRS, BINS, ROWS };

// The runs and their rows: what every epilogue walks.
struct Walk {
  const int* ids;     // PAIRS: sorted pairs (B, ids_len); BINS: bins
                      // (B * nt, ids_len); ROWS: unused
  int ids_len;
  const int* starts;  // (B * nt); BINS: unused
  const int* counts;  // (B * nt)
  const float* table; // (B, nrows, 32): row tables, or ROWS' gathered rows
  int nrows;
  int nt, ntx, tile_w, tile_h;
};

// An epilogue's inputs and outputs; the fields it does not use are 0.
struct Epi {
  const int* packed_bg;
  int opaque;
  const int* tex;
  int tex_w, tex_h;
  int* out;       // packed u8, texel index or key: (B * nt, P)
  float* rgba;    // KEYS_F32: (B * nt, D, P)
};

// Row (of the whole (B * nrows, 32) array) of slot j of block b's run.
template <int SRC>
__device__ __forceinline__ int row_of(const Walk& w, int b, int f,
                                      int start, int j) {
  if constexpr (SRC == PAIRS) {
    const int slot = min(start + j, w.ids_len - 1);
    const int tri = w.ids[(size_t)f * w.ids_len + slot] & IDX_MASK;
    return f * w.nrows + min(tri, w.nrows - 1);
  } else if constexpr (SRC == BINS) {
    const int tri = w.ids[(size_t)b * w.ids_len + j];
    return f * w.nrows + min(max(tri, 0), w.nrows - 1);
  } else {
    return f * w.nrows + min(start + j, w.nrows - 1);
  }
}

__device__ __forceinline__ int quant_u8(float v) {
  return __float2int_rz(fminf(fmaxf(__fmul_rn(v, 255.0f), 0.0f), 255.0f));
}

// (e0 a[d] + e1 a[D + d]) + e2 a[2 D + d]
__device__ __forceinline__ float attr(const float* a, float e0, float e1,
                                      float e2, int d) {
  return __fadd_rn(__fadd_rn(__fmul_rn(e0, a[d]), __fmul_rn(e1, a[D + d])),
                   __fmul_rn(e2, a[2 * D + d]));
}

__device__ __forceinline__ int texel_index(const float* a, float e0,
                                           float e1, float e2, int tw,
                                           int th) {
  const float den = attr(a, e0, e1, e2, 2);
  const float safe = den != 0.0f ? den : 1.0f;   // NaN stays NaN
  const int ui = __float2int_rz(
      __fmul_rn(__fdiv_rn(attr(a, e0, e1, e2, 0), safe), (float)tw));
  const int vi = __float2int_rz(
      __fmul_rn(__fdiv_rn(attr(a, e0, e1, e2, 1), safe), (float)th));
  return min(max(vi, 0), th - 1) * tw + min(max(ui, 0), tw - 1);
}

template <int PPT, bool ZCLIP, int EPI, int SRC>
__global__ void __launch_bounds__(THREADS)
tile_raster_kernel(const Walk w, const Epi ep) {
  __shared__ float s_rows[CHUNK][WALK_COLS];
  __shared__ int s_row[CHUNK];

  const int b = blockIdx.x;
  const int f = b / w.nt;
  const int t = b - f * w.nt;
  const int P = w.tile_w * w.tile_h;
  const int ox = (t % w.ntx) * w.tile_w;
  const int oy = (t / w.ntx) * w.tile_h;
  const int start = SRC == BINS ? 0 : w.starts[b];
  const int count = SRC == BINS ? min(w.counts[b], w.ids_len) : w.counts[b];

  float px[PPT], py[PPT], be0[PPT], be1[PPT], be2[PPT];
  int best[PPT], brow[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    px[k] = (float)(ox + p % w.tile_w);
    py[k] = (float)(oy + p / w.tile_w);
    best[k] = SKY_KEY;
    brow[k] = 0;
    be0[k] = be1[k] = be2[k] = 0.0f;
  }

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int i = threadIdx.x; i < n * WALK_COLS; i += THREADS) {
      const int r = i / WALK_COLS;
      const int c = i - r * WALK_COLS;
      const int row = row_of<SRC>(w, b, f, start, base + r);
      s_rows[r][c] = w.table[(size_t)row * ROW_W + c];
      if (c == 0) s_row[r] = row;
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
          brow[k] = s_row[j];
          be0[k] = e0;
          be1[k] = e1;
          be2[k] = e2;
        }
      }
    }
  }

  const int bgp = (EPI == U8_GOURAUD || EPI == TEX_U8) ? *ep.packed_bg : 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    if (p >= P) break;
    const size_t o = (size_t)b * P + p;
    const bool hit = best[k] != SKY_KEY;
    const float* a = w.table + (size_t)brow[k] * ROW_W + ATTR_COL;
    if constexpr (EPI == U8_GOURAUD) {
      int packed = bgp;
      if (hit) {
        int q[D];
        const int nch = ep.opaque ? 3 : 4;
        for (int d = 0; d < nch; ++d)
          q[d] = quant_u8(attr(a, be0[k], be1[k], be2[k], d));
        const unsigned a8 = ep.opaque ? 255u : (unsigned)q[3];
        packed = (int)((unsigned)q[0] | ((unsigned)q[1] << 8) |
                       ((unsigned)q[2] << 16) | (a8 << 24));
      }
      ep.out[o] = packed;
    } else if constexpr (EPI == TEX_U8) {
      ep.out[o] = hit ? __ldg(ep.tex + texel_index(a, be0[k], be1[k],
                                                   be2[k], ep.tex_w,
                                                   ep.tex_h))
                      : bgp;
    } else if constexpr (EPI == TEX_IDX) {
      ep.out[o] = hit ? texel_index(a, be0[k], be1[k], be2[k], ep.tex_w,
                                    ep.tex_h)
                      : -1;
    } else {
      ep.out[o] = best[k];
      for (int d = 0; d < D; ++d)
        ep.rgba[((size_t)b * D + d) * P + p] =
            hit ? attr(a, be0[k], be1[k], be2[k], d) : 0.0f;
    }
  }
}

template <int EPI, int SRC, int PPT>
cudaError_t launch_ppt(int nblocks, bool z_clip, const Walk& w,
                       const Epi& ep, cudaStream_t s) {
  if (z_clip)
    tile_raster_kernel<PPT, true, EPI, SRC><<<nblocks, THREADS, 0, s>>>(w,
                                                                        ep);
  else
    tile_raster_kernel<PPT, false, EPI, SRC><<<nblocks, THREADS, 0, s>>>(w,
                                                                         ep);
  return cudaGetLastError();
}

// Launches epilogue EPI on source SRC over nblocks = B * nt tiles on
// `stream`; returns the cudaError_t of the launch (0 on success).  An
// error left pending by an earlier launch is returned without launching,
// so the caller raises it; an out-of-range size returns
// cudaErrorInvalidValue without launching.
template <int EPI, int SRC>
int launch(int nblocks, int z_clip, const Walk& w, const Epi& ep,
           void* stream) {
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return (int)pending;
  if (nblocks == 0) return 0;
  const int P = w.tile_w * w.tile_h;
  if (P <= 0 || w.nrows <= 0 || w.ntx <= 0 || w.nt <= 0 ||
      nblocks % w.nt != 0 || (SRC != ROWS && w.ids_len <= 0))
    return (int)cudaErrorInvalidValue;
  if ((EPI == TEX_U8 || EPI == TEX_IDX) && (ep.tex_w <= 0 || ep.tex_h <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool zc = z_clip != 0;
  const int ppt = (P + THREADS - 1) / THREADS;
  if (ppt <= 1) return (int)launch_ppt<EPI, SRC, 1>(nblocks, zc, w, ep, s);
  if (ppt <= 2) return (int)launch_ppt<EPI, SRC, 2>(nblocks, zc, w, ep, s);
  if (ppt <= 4) return (int)launch_ppt<EPI, SRC, 4>(nblocks, zc, w, ep, s);
  if (ppt <= 8) return (int)launch_ppt<EPI, SRC, 8>(nblocks, zc, w, ep, s);
  if (ppt <= 16) return (int)launch_ppt<EPI, SRC, 16>(nblocks, zc, w, ep, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every entry takes the walk's arguments first: the ids (sorted pairs or
// bins, ids_len a frame's pairs or a bins row), the runs' starts and
// counts (nblocks each), nblocks = B * nt, tiles a frame, the row table or
// rows (nrows a frame, x 32 float32), tiles a row of the frame, the tile
// size and z_clip; then its epilogue's; then the stream.
#define WALK_ARGS                                                      \
  const int *ids, int ids_len, const int *starts, const int *counts,   \
      int nblocks, int nt, const float *table, int nrows, int ntx,     \
      int tile_w, int tile_h, int z_clip
#define WALK {ids, ids_len, starts, counts, table, nrows, nt, ntx, tile_w, \
              tile_h}

extern "C" {

// K1: out (B * nt, P) packed u8 RGBA, rows from sorted pairs.
int tile_raster_u8(WALK_ARGS, const int* packed_bg, int opaque, int* out,
                   void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, opaque, nullptr, 0, 0, out, nullptr};
  return launch<U8_GOURAUD, PAIRS>(nblocks, z_clip, w, ep, stream);
}

// K3: out (B * nt, P) packed u8 texels of the (tex_h x tex_w) packed
// texture.
int tile_raster_tex_u8(WALK_ARGS, const int* tex, int tex_w, int tex_h,
                       const int* packed_bg, int* out, void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, 0, tex, tex_w, tex_h, out, nullptr};
  return launch<TEX_U8, PAIRS>(nblocks, z_clip, w, ep, stream);
}

// K2b: out (B * nt, P) texel indices, -1 for sky.
int tile_raster_tex_idx(WALK_ARGS, int tex_w, int tex_h, int* out,
                        void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, tex_w, tex_h, out, nullptr};
  return launch<TEX_IDX, PAIRS>(nblocks, z_clip, w, ep, stream);
}

// K2a: keys (B * nt, P) int32 and rgba (B * nt, 4, P) float32.
int tile_raster_keys_f32(WALK_ARGS, int* keys, float* rgba, void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, 0, 0, keys, rgba};
  return launch<KEYS_F32, PAIRS>(nblocks, z_clip, w, ep, stream);
}

// K5: K2a's outputs, rows from bins (ids (B * nt, K), starts unused).
int tile_raster_bins_f32(WALK_ARGS, int* keys, float* rgba, void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, 0, 0, keys, rgba};
  return launch<KEYS_F32, BINS>(nblocks, z_clip, w, ep, stream);
}

// K6: K1's output, rows pre-gathered in pair order (table (B, nrows, 32),
// ids unused).
int tile_raster_rows_u8(WALK_ARGS, const int* packed_bg, int opaque,
                        int* out, void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, opaque, nullptr, 0, 0, out, nullptr};
  return launch<U8_GOURAUD, ROWS>(nblocks, z_clip, w, ep, stream);
}

const char* tile_raster_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
