// Kernels K1, K3, K2b, K2a, K5, K6, K1-wf and K1-mxu: per-tile triangle
// visibility, then one of four epilogues on the winner.
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
//     U8_GOURAUD (K6)  raster_tiles_dynrows (:1294), opaque, no z test;
//   the wf branch of raster_tiles_flat (:739, kernel_wf :624-655):
//     K1-wf, K1's walk from a persistent grid (below);
//   the mxu branch of _make_kernel_flat (:242-250,285-301,326-327) over
//   build_table_mxu's affine table (:1474-1505), in the launches at :739,
//   :793 and :895: K1-mxu, the walk on the tensor cores (below), with the
//   U8_GOURAUD or TEX_U8 epilogue.
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
// longest runs: one launch of 4 frames ran K1 at ~0.054 ms a frame.
//
// The one-block-a-tile walk (fma_tile: K2b, K2a, K5, K6, K1-wf; K1-wf,
// and K2b on K3's rows, are what chip_smoke.py times the split walk
// against).  One block of 256 threads per tile; each thread owns PPT =
// ceil(P / 256) pixels (4 at 32x32) and keeps its best key, its
// winner's edge values and row in registers.  The run's rows
// (the 12 walk columns) are staged through shared memory 32 at a time,
// each read by all threads as a broadcast, two __syncthreads() a chunk.
// Only the winner is shaded, after the walk: its attribute columns are
// read once from the (L2-resident) table.  A long run stays in one block.
//
// The split walk (K1 and K3).  The tail is inside a tile, so no order of
// claims cures it (K1-wf): the long run itself is cut.
//   * Items.  A run of count <= S slots is one item; a longer one is
//     ceil(count / S) items, item s walking slots [s S, min((s + 1) S,
//     count)) with row_of's clamps (an overflowed run still reads in
//     bounds).  S is the compile-time constant SEG (64); the merge below
//     gives the same values for every S, which the plain mirror of the
//     split walk (tests/test_torch_walk_split.py) holds for S = 1..128.
//   * Merge by key, exactly.  A key is (zq << 18) | slot and slots are
//     unique within a run, so the keys of one tile are unique and the
//     minimum over the items' minima is the sequential strict minimum,
//     whichever item finishes first.  Each item of a long tile does
//     atomicMin (signed, the walk's `key < best` order) into the tile's
//     row of the output, which the plan filled with SKY_KEY (the outputs
//     are (B nt, P) int32, so no key scratch); after __threadfence() it
//     counts its arrival on the tile's counter, and the last to arrive
//     reads the merged keys (through L2) and runs the epilogue over them.
//   * Only the key a pixel during the walk.  The winner's row is
//     row_of(key & IDX_MASK) and its edges are recomputed in the
//     epilogue with the walk's own __fmul_rn/__fadd_rn order at that
//     pixel, so they are the walk's bits; brow and be0..be2 no longer
//     live through the walk.
//   * Scheduling on the device.  A plan kernel (block 0: a scan of the
//     counts) lists the items, long tiles' first, in scratch sized by
//     static shapes (B nt + B ids_len / S items) and zeroes the counters;
//     its other blocks write the background into the tiles whose run is
//     empty (most of a frame: no walk claims them).  A persistent walk,
//     its grid the blocks the card holds at once, claims items from a
//     counter.  No host sync; one wrapper call.
//   * Staging.  Each row's columns 0..27 (the 12 walk columns and the
//     attributes) are seven 16-byte cp.async (rows are 128-byte aligned)
//     into one of two shared buffers; while a block walks one item, the
//     next item's rows are in flight, so one __syncthreads() guards an
//     item, and a run staged at once finds its winners' attributes in
//     shared memory for the epilogue.
//   * Not used: TMA copies boxes, and the rows are gathered by triangle
//     id; the tensor cores do not round each sum (K1-mxu) and this walk
//     is bit-equal to its plain version.
//   * Settled by timing on an H100 (PERF.md): S = 64 and 5 blocks an SM
//     at 32x32.  At 32x32 only ~450 of 2040 runs are not empty, so one
//     frame is about one item a resident block.
//
// K1-wf.  The TPU's programs each walked wf consecutive tiles and copied
// their id blocks into SMEM themselves, so no id window bound a program.
// Here a persistent grid of at most (SMs x resident blocks a SM, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor) blocks claims wf
// consecutive tiles at a time from a counter (atomicAdd; zeroed on the
// launch's stream before each launch) and walks them one after another
// with K1's own tile body (fma_tile), so its values are K1's for any wf.
// Tiles are claimed in index order; longest-run-first is a later lever.
//
// K1-mxu.  The TPU kernel evaluated a chunk's 4 + nacc affine planes
// (a_x, a_y, c, 0) . (x, y, 1, 0) as (kcc, 4) x (4, P) products on its
// matrix unit.  Here each warp issues mma.sync.m16n8k16 (bf16 operands,
// float32 accumulators): M = 16 pixels, N = the 8 planes of one triangle
// (3 edges, depth, 4 attributes), K = 16 cross terms.  Pixel coordinates
// split exactly into bf16 parts, x = xh + xl (integers below 65536), and
// each coefficient into three, a = a0 + a1 + a2 (exact for a float32 away
// from underflow); K holds the 6 x terms, 6 y terms, c0..c2 against 1 and
// one 0.  With mxu=1 every product is exact and only the accumulation
// rounds (near float32, the TPU's HIGHEST); with mxu=2 only the hi x hi
// terms remain, the TPU's one DEFAULT pass, which rounds the coordinates
// and coefficients to bf16 themselves.  What the MMA path rounds: the
// tensor cores add the products in float32 in an order and with rounding
// that are not IEEE round-to-nearest per addition, so the planes can
// differ from the plain version's ((a_x x + a_y y) + c) by an ulp or so;
// the kernel is held to it within a tolerance (chip_smoke.py), not bit
// for bit.  -fmad=false governs the CUDA-core arithmetic only.  Pixel A
// fragments stay in registers for the walk; a chunk's split B fragments
// (32 triangles x 32 lanes x 2 words, 8 KiB) are staged in shared memory
// already in fragment order, so each lane loads its 8 bytes with one
// conflict-free uint2 read (no ldmatrix needed).  A lane of quad q holds
// planes 2q, 2q + 1 of pixels g and g + 8: lanes 0 and 1 trade their
// halves (shfl xor 1) to test coverage and form the key, lanes 2 and 3
// (the attributes) take the key from them (shfl xor 2) and keep the
// winner's attributes, and the epilogue joins their halves (shfl xor 1).
// A warp holds up to 8 groups of 16 pixels a pass; larger tiles walk the
// run again a pass at a time.  Slots past the run are not walked (K1's
// rule); pad pixels of a group past P are computed and not stored; NaN
// rows keep NaN in their first part and zero parts, so they never cover.
// Bound on an H100: 8 planes x 16 products x 2 = 256 tensor-core
// operations a (pixel, triangle) against 989 T/s dense bf16, and ~9
// CUDA-core operations (coverage, key, minimum) at 33.5 T/s.

#include <cuda_bf16.h>
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
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;       // triangle rows staged per pass
constexpr int SEG = 64;         // split walk: slots an item walks at most
constexpr int STAGE_COLS = 28;  // split walk: row columns staged (walk and
                                // attributes: 0..27)
constexpr int MAX_GROUPS = 8;   // MMA walk: 16-pixel groups a warp per pass
constexpr unsigned FULL = 0xffffffffu;

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
  int mxu;        // the MMA walk: 1 exact parts, 2 one bf16 pass
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

// vi * tw + ui of the clamped-nearest texel of attributes (u, v, den)
__device__ __forceinline__ int texel_of(float u, float v, float den, int tw,
                                        int th) {
  const float safe = den != 0.0f ? den : 1.0f;   // NaN stays NaN
  const int ui = __float2int_rz(__fmul_rn(__fdiv_rn(u, safe), (float)tw));
  const int vi = __float2int_rz(__fmul_rn(__fdiv_rn(v, safe), (float)th));
  return min(max(vi, 0), th - 1) * tw + min(max(ui, 0), tw - 1);
}

__device__ __forceinline__ int texel_index(const float* a, float e0,
                                           float e1, float e2, int tw,
                                           int th) {
  const float den = attr(a, e0, e1, e2, 2);
  return texel_of(attr(a, e0, e1, e2, 0), attr(a, e0, e1, e2, 1), den, tw,
                  th);
}

// The one-block-a-tile body of K2b, K2a, K5, K6 and K1-wf (U8_GOURAUD,
// TEX_IDX or KEYS_F32): block-wide walk of tile b's run and the
// epilogue; the grid and the persistent kernels call it, so their values
// cannot drift apart.
template <int PPT, bool ZCLIP, int EPI, int SRC>
__device__ __forceinline__ void fma_tile(const Walk& w, const Epi& ep,
                                         const int b) {
  __shared__ float s_rows[CHUNK][WALK_COLS];
  __shared__ int s_row[CHUNK];

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

  const int bgp = EPI == U8_GOURAUD ? *ep.packed_bg : 0;
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

template <int PPT, bool ZCLIP, int EPI, int SRC>
__global__ void __launch_bounds__(THREADS)
tile_raster_kernel(const Walk w, const Epi ep) {
  fma_tile<PPT, ZCLIP, EPI, SRC>(w, ep, blockIdx.x);
}

// ---- K1 and K3: the split walk ----

// The work list of one split launch, in scratch the wrapper allocates.
struct Plan {
  int2* items;    // (cap) items (tile b, segment s), long tiles' first
  int cap;        // B * nt + (B * ids_len) / SEG: enough for runs that
                  // partition each frame's pairs
  int* counters;  // [0] claims, [1] items listed, [2] split on (the list
                  // fit in cap), [3 + b] items of tile b finished
};

// items of a run of `count` slots: one up to SEG, else ceil(count / SEG)
__device__ __forceinline__ int segments(int count) {
  return count <= SEG ? 1 : count / SEG + (count % SEG != 0);
}

// Slots [lo, hi) of the run of tile b that item segment s walks, and the
// items of that tile (k); with the split off every tile is one item.
__device__ __forceinline__ void item_range(const Walk& w, bool split, int b,
                                           int s, int& lo, int& hi, int& k) {
  const int count = w.counts[b];
  k = split ? segments(count) : 1;
  lo = k > 1 ? s * SEG : 0;
  hi = s == k - 1 ? count : lo + SEG;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying columns 0..27 (the walk's and the attributes') of the
// rows of slots [lo, lo + n) of tile b's run into rows: seven 16-byte
// cp.async a row (rows are 128-byte aligned), the pair ids read once a
// row by neighbouring threads.  The caller waits (cp_async_wait_all) and
// syncs.
constexpr int STAGE_CHUNKS = STAGE_COLS / 4;
__device__ __forceinline__ void stage_rows(const Walk& w, int b, int lo,
                                           int n,
                                           float (*rows)[STAGE_COLS]) {
  const int f = b / w.nt;
  const int start = w.starts[b];
  for (int i = threadIdx.x; i < STAGE_CHUNKS * n; i += THREADS) {
    const int r = i / STAGE_CHUNKS;
    const int c = i - STAGE_CHUNKS * r;
    const int row = row_of<PAIRS>(w, b, f, start, lo + r);
    cp_async16(&rows[r][4 * c], w.table + (size_t)row * ROW_W + 4 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// e_i of a row at pixel (x, y), the walk's own expression
__device__ __forceinline__ float edge(const float* r, int i, float x,
                                      float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[3 * i], x), __fmul_rn(r[3 * i + 1], y)),
                   r[3 * i + 2]);
}

// K1's or K3's value of pixel (x, y) of tile b whose winning key is key:
// the winner's row is found again from the key's slot (in staged, the
// shared rows of the whole run, when it was staged at once; else in the
// table) and its edges recomputed in the walk's order, so they are the
// walk's bits.
template <int EPI>
__device__ __forceinline__ int split_value(const Walk& w, const Epi& ep,
                                           int b, int key, float x, float y,
                                           int bgp,
                                           const float (*staged)[STAGE_COLS]) {
  if (key == SKY_KEY) return bgp;
  const float* r;
  if (staged) {
    r = staged[key & IDX_MASK];
  } else {
    const int row = row_of<PAIRS>(w, b, b / w.nt, w.starts[b],
                                  key & IDX_MASK);
    r = w.table + (size_t)row * ROW_W;
  }
  const float e0 = edge(r, 0, x, y), e1 = edge(r, 1, x, y),
              e2 = edge(r, 2, x, y);
  const float* a = r + ATTR_COL;
  if constexpr (EPI == U8_GOURAUD) {
    // channel d in byte d; alpha 255 with opaque
    unsigned packed = ep.opaque ? 255u << 24 : 0u;
    for (int d = 0; d < (ep.opaque ? 3 : 4); ++d)
      packed |= (unsigned)quant_u8(attr(a, e0, e1, e2, d)) << (8 * d);
    return (int)packed;
  } else {
    return __ldg(ep.tex + texel_index(a, e0, e1, e2, ep.tex_w, ep.tex_h));
  }
}

// The plan: block 0 lists the items of the tiles whose run is not empty
// (long tiles' first, in tile order; with more items than cap, which runs
// that partition their frames' pairs never need, every such tile becomes
// one whole item) and zeroes the claim counter; every block zeroes the
// arrival counters of its tiles, fills the output rows of long tiles with
// SKY_KEY, the start of their atomicMin merge, and those of empty tiles
// with the background, their whole epilogue (no walk claims them).
__device__ __forceinline__ long long block_exclusive_sum(long long v,
                                                         long long* total) {
  __shared__ long long s_warp[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  long long before = 0, all = 0;
  for (int i = 0; i < WARPS; ++i) {
    if (i < warp) before += s_warp[i];
    all += s_warp[i];
  }
  __syncthreads();  // s_warp is reused by the next call
  *total = all;
  return before + x - v;
}

__global__ void __launch_bounds__(THREADS)
split_plan_kernel(const Walk w, const Plan pl, const int* packed_bg, int* out,
                  int nblocks) {
  const int P = w.tile_w * w.tile_h;
  if (blockIdx.x == 0) {
    const int per = (nblocks + THREADS - 1) / THREADS;
    const int b0 = min((int)threadIdx.x * per, nblocks);
    const int b1 = min(b0 + per, nblocks);
    // items of long tiles, long tiles, short (non-empty) tiles
    long long n_items = 0, n_long = 0, n_short = 0;
    for (int b = b0; b < b1; ++b) {
      const int c = w.counts[b];
      if (c > SEG) {
        n_items += segments(c);
        ++n_long;
      } else if (c > 0) {
        ++n_short;
      }
    }
    long long t_items, t_long, t_short;
    long long o_items = block_exclusive_sum(n_items, &t_items);
    long long o_long = block_exclusive_sum(n_long, &t_long);
    long long o_short = block_exclusive_sum(n_short, &t_short);
    const bool split = t_items + t_short <= pl.cap;
    o_short += split ? t_items : t_long;
    for (int b = b0; b < b1; ++b) {
      const int c = w.counts[b];
      if (c > SEG && split) {
        for (int s = 0, k = segments(c); s < k; ++s)
          pl.items[o_items++] = make_int2(b, s);
      } else if (c > SEG) {
        pl.items[o_long++] = make_int2(b, 0);
      } else if (c > 0) {
        pl.items[o_short++] = make_int2(b, 0);
      }
    }
    if (threadIdx.x == 0) {
      pl.counters[0] = 0;
      pl.counters[1] = (int)((split ? t_items : t_long) + t_short);
      pl.counters[2] = split;
    }
  }
  const int bgp = *packed_bg;
  for (int b = blockIdx.x; b < nblocks; b += gridDim.x) {
    if (threadIdx.x == 0) pl.counters[3 + b] = 0;
    const int c = w.counts[b];
    if (c > SEG || c <= 0)
      for (int p = threadIdx.x; p < P; p += THREADS)
        out[(size_t)b * P + p] = c > 0 ? SKY_KEY : bgp;
  }
}

// The persistent split walk: blocks claim items in list order; while a
// block walks one item, the rows of the next are in flight to the other
// shared buffer.  Each thread keeps only its pixels' best keys.  A tile
// of one item runs its epilogue at once; the items of a long tile merge
// their keys into the tile's output row with atomicMin, and the last to
// finish (its arrival counter, after __threadfence) runs the epilogue.
// Blocks an SM the register budget is cut for: 5 at up to 4 pixels a
// thread (48 registers; 6, at 40, spilled K1's epilogue and ran no
// faster on the card, 4 no faster either), 4 at 8 (64 registers).
template <int PPT>
constexpr int split_min_blocks() {
  return PPT <= 4 ? 5 : PPT <= 8 ? 4 : 2;
}

template <int PPT, bool ZCLIP, int EPI>
__global__ void __launch_bounds__(THREADS, split_min_blocks<PPT>())
tile_raster_split_kernel(const Walk w, const Epi ep, const Plan pl) {
  __shared__ __align__(16) float s_rows[2][SEG][STAGE_COLS];
  __shared__ int s_claim[2];
  __shared__ int s_last;
  const int n_items = pl.counters[1];
  const bool split = pl.counters[2] != 0;
  const int P = w.tile_w * w.tile_h;
  const int bgp = *ep.packed_bg;

  if (threadIdx.x == 0) s_claim[0] = atomicAdd(pl.counters, 1);
  __syncthreads();
  if (s_claim[0] >= n_items) return;
  int2 it = pl.items[s_claim[0]];
  {
    int lo, hi, k;
    item_range(w, split, it.x, it.y, lo, hi, k);
    stage_rows(w, it.x, lo, max(0, min(hi - lo, SEG)), s_rows[0]);
  }
  for (int turn = 1, buf = 0;; ++turn, buf ^= 1) {
    if (threadIdx.x == 0) s_claim[turn & 1] = atomicAdd(pl.counters, 1);
    cp_async_wait_all();
    __syncthreads();  // this item's rows are in; the other buffer is free
    const int nxt = s_claim[turn & 1];
    int2 nit = make_int2(0, 0);
    if (nxt < n_items) {
      nit = pl.items[nxt];
      int lo, hi, k;
      item_range(w, split, nit.x, nit.y, lo, hi, k);
      stage_rows(w, nit.x, lo, max(0, min(hi - lo, SEG)), s_rows[buf ^ 1]);
    }

    const int b = it.x;
    int lo, hi, k;
    item_range(w, split, b, it.y, lo, hi, k);
    const int t = b % w.nt;
    const int ox = (t % w.ntx) * w.tile_w;
    const int oy = (t / w.ntx) * w.tile_h;
    float px[PPT], py[PPT];
    int best[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int p = threadIdx.x + q * THREADS;
      px[q] = (float)(ox + p % w.tile_w);
      py[q] = (float)(oy + p / w.tile_w);
      best[q] = SKY_KEY;
    }
    // an item holds at most SEG slots unless the split is off
    for (int base = lo, n = max(0, min(hi - lo, SEG)); n > 0;) {
      for (int j = 0; j < n; ++j) {
        // the 12 walk columns as three 16-byte shared loads
        const float4* v = reinterpret_cast<const float4*>(s_rows[buf][j]);
        const float4 v0 = v[0], v1 = v[1], v2 = v[2];
        const float row[WALK_COLS] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                                      v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
        const int slot = base + j;
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          const float e0 = edge(row, 0, px[q], py[q]);
          const float e1 = edge(row, 1, px[q], py[q]);
          const float e2 = edge(row, 2, px[q], py[q]);
          const float zz = __fadd_rn(__fadd_rn(__fmul_rn(e0, row[9]),
                                               __fmul_rn(e1, row[10])),
                                     __fmul_rn(e2, row[11]));
          bool cov = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f);
          if (ZCLIP) cov = cov && (zz >= 0.0f) && (zz <= 1.0f);
          const unsigned zq =
              (unsigned)__float2int_rz(__fmul_rn(zz, (float)Z_LEVELS));
          const int key = (int)((zq << IDX_BITS) | (unsigned)slot);
          if (cov && key < best[q]) best[q] = key;
        }
      }
      base += n;
      if (base >= hi) break;
      n = min(hi - base, SEG);
      __syncthreads();  // the buffer is no longer read
      stage_rows(w, b, base, n, s_rows[buf]);
      cp_async_wait_all();
      __syncthreads();
    }

    bool last = k == 1;
    if (!last) {
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int p = threadIdx.x + q * THREADS;
        if (p < P && best[q] != SKY_KEY)
          atomicMin(ep.out + (size_t)b * P + p, best[q]);
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        s_last = atomicAdd(pl.counters + 3 + b, 1) == k - 1;
      __syncthreads();
      last = s_last;
      if (last) {
        __threadfence();
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          const int p = threadIdx.x + q * THREADS;
          if (p < P) best[q] = __ldcg(ep.out + (size_t)b * P + p);
        }
      }
    }
    if (last) {
      // a run walked in one stage has every winner's row in s_rows
      const bool staged = k == 1 && hi <= SEG;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int p = threadIdx.x + q * THREADS;
        if (p < P)
          ep.out[(size_t)b * P + p] = split_value<EPI>(
              w, ep, b, best[q], px[q], py[q], bgp,
              staged ? s_rows[buf] : nullptr);
      }
    }
    if (nxt >= n_items) return;
    it = nit;
  }
}

// ---- K1-mxu: the walk on the tensor cores ----

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two bf16 values in one register, lo in the low half
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// a = p[0] + p[1] + p[2] in bf16 parts (8 significant bits each cover
// float32's 24); mxu=2 keeps p[0] alone.  A non-finite p[0] keeps zero
// parts, so a NaN row stays NaN (and never covers).
__device__ __forceinline__ void split3(float a, int mxu, float p[3]) {
  p[0] = bf16_round(a);
  p[1] = p[2] = 0.0f;
  if (mxu == 1 && isfinite(p[0])) {
    const float r = __fsub_rn(a, p[0]);
    p[1] = bf16_round(r);
    p[2] = bf16_round(__fsub_rn(r, p[1]));
  }
}

// Row k of B (K = 16) for a plane with coefficient parts ax, ay, c:
// ax0 ax0 ax1 ax1 ax2 ax2 | ay0 ay0 ay1 ay1 ay2 ay2 | c0 c1 c2 | 0
__device__ __forceinline__ float b_row(int k, const float ax[3],
                                       const float ay[3], const float c[3]) {
  if (k < 6) return ax[k >> 1];
  if (k < 12) return ay[(k - 6) >> 1];
  return k < 15 ? c[k - 12] : 0.0f;
}

// Column k of A for the pixel x = xh + xl, y = yh + yl:
// xh xl xh xl xh xl | yh yl yh yl yh yl | 1 1 1 | 0
__device__ __forceinline__ float a_col(int k, float xh, float xl, float yh,
                                       float yl) {
  if (k < 6) return (k & 1) ? xl : xh;
  if (k < 12) return (k & 1) ? yl : yh;
  return k < 15 ? 1.0f : 0.0f;
}

// D (16 pixels x 8 planes) = A (16 x 16) B (16 x 8), float32 accumulators
// from zero.  Thread (g = lane / 4, q = lane % 4) holds d[0..1] = planes
// 2q, 2q + 1 of pixel g and d[2..3] those of pixel g + 8.
__device__ __forceinline__ void mma_16x8x16(const unsigned a[4], unsigned b0,
                                            unsigned b1, float d[4]) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(z), "f"(z), "f"(z), "f"(z));
}

// K1's coverage test and key on a slot's planes; SKY_KEY when not covered
template <bool ZCLIP>
__device__ __forceinline__ int slot_key(float e0, float e1, float e2,
                                        float zz, int slot) {
  bool cov = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f);
  if (ZCLIP) cov = cov && (zz >= 0.0f) && (zz <= 1.0f);
  const unsigned zq = (unsigned)__float2int_rz(__fmul_rn(zz, (float)Z_LEVELS));
  return cov ? (int)((zq << IDX_BITS) | (unsigned)slot) : SKY_KEY;
}

// The matrix-unit walk of tile b's run over an affine table (PAIRS
// source), with the U8_GOURAUD or TEX_U8 epilogue; G groups of 16 pixels
// a warp per pass.
template <int G, bool ZCLIP, int EPI>
__device__ __forceinline__ void mma_tile(const Walk& w, const Epi& ep,
                                         const int b) {
  __shared__ __align__(16) unsigned s_frag[CHUNK][64];

  const int f = b / w.nt;
  const int t = b - f * w.nt;
  const int P = w.tile_w * w.tile_h;
  const int ox = (t % w.ntx) * w.tile_w;
  const int oy = (t / w.ntx) * w.tile_h;
  const int start = w.starts[b];
  const int count = w.counts[b];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int bgp = *ep.packed_bg;

  for (int pass = 0; pass < P; pass += WARPS * G * 16) {
    unsigned afr[G][4];
    int best[G][2];
    float at[G][2][2];   // lanes q = 2, 3: the winner's planes 2q, 2q + 1
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int p0 = pass + (warp * G + gi) * 16 + g;
      float xh[2], xl[2], yh[2], yl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h;
        const float x = (float)(ox + p % w.tile_w);
        const float y = (float)(oy + p / w.tile_w);
        // one pass (mxu=2) multiplies the rounded coordinates alone
        xh[h] = bf16_round(x);
        xl[h] = ep.mxu == 1 ? __fsub_rn(x, xh[h]) : 0.0f;
        yh[h] = bf16_round(y);
        yl[h] = ep.mxu == 1 ? __fsub_rn(y, yh[h]) : 0.0f;
        best[gi][h] = SKY_KEY;
        at[gi][h][0] = at[gi][h][1] = 0.0f;
      }
      const int k = 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        afr[gi][h] = bf16_pair(a_col(k, xh[h], xl[h], yh[h], yl[h]),
                               a_col(k + 1, xh[h], xl[h], yh[h], yl[h]));
        afr[gi][2 + h] = bf16_pair(a_col(k + 8, xh[h], xl[h], yh[h], yl[h]),
                                   a_col(k + 9, xh[h], xl[h], yh[h], yl[h]));
      }
    }

    for (int base = 0; base < count; base += CHUNK) {
      const int n = min(CHUNK, count - base);
      __syncthreads();  // the previous chunk's fragments are no longer read
      // word 2 * l + hf of a slot: lane l's B register hf, rows
      // 2 (l % 4) + 8 hf and + 1 of plane l / 4
      for (int i = threadIdx.x; i < n * 64; i += THREADS) {
        const int j = i >> 6;
        const int word = i & 63;
        const int fl = word >> 1;
        const int k0 = 2 * (fl & 3) + 8 * (word & 1);
        const int row = row_of<PAIRS>(w, b, f, start, base + j);
        const float* pl = w.table + (size_t)row * ROW_W + 4 * (fl >> 2);
        float ax[3], ay[3], c[3];
        split3(pl[0], ep.mxu, ax);
        split3(pl[1], ep.mxu, ay);
        split3(pl[2], ep.mxu, c);
        s_frag[j][word] = bf16_pair(b_row(k0, ax, ay, c),
                                    b_row(k0 + 1, ax, ay, c));
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const uint2 bf = reinterpret_cast<const uint2*>(s_frag[j])[lane];
        const int slot = base + j;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float d[4], o[4];
          mma_16x8x16(afr[gi], bf.x, bf.y, d);
#pragma unroll
          for (int m = 0; m < 4; ++m) o[m] = __shfl_xor_sync(FULL, d[m], 1);
          const bool first = (q & 1) == 0;   // q = 0 holds e0 e1, q = 1 e2 z
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float a0 = d[2 * h], a1 = d[2 * h + 1];
            const float b0 = o[2 * h], b1 = o[2 * h + 1];
            int key = slot_key<ZCLIP>(first ? a0 : b0, first ? a1 : b1,
                                      first ? b0 : a0, first ? b1 : a1, slot);
            const int from_edges = __shfl_xor_sync(FULL, key, 2);
            if (q >= 2) key = from_edges;
            if (key < best[gi][h]) {
              best[gi][h] = key;
              at[gi][h][0] = a0;
              at[gi][h][1] = a1;
            }
          }
        }
      }
    }

#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      // lane q = 2 writes pixel p0, q = 3 pixel p0 + 8
      const int h = q & 1;
      const int p = pass + (warp * G + gi) * 16 + g + 8 * h;
      int value;
      if constexpr (EPI == U8_GOURAUD) {
        unsigned part[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const unsigned c0 = (unsigned)quant_u8(at[gi][hh][0]);
          const unsigned c1 = ep.opaque && q == 3
                                  ? 255u
                                  : (unsigned)quant_u8(at[gi][hh][1]);
          part[hh] = q == 2 ? (c0 | (c1 << 8)) : ((c0 << 16) | (c1 << 24));
        }
        const unsigned other0 = __shfl_xor_sync(FULL, part[0], 1);
        const unsigned other1 = __shfl_xor_sync(FULL, part[1], 1);
        const unsigned packed = h ? (part[1] | other1) : (part[0] | other0);
        value = best[gi][h] != SKY_KEY ? (int)packed : bgp;
      } else {
        // q = 2 holds u, v and q = 3 1/w, 1 of both pixels: q = 2 takes
        // 1/w of pixel p0, q = 3 takes u, v of pixel p0 + 8
        const float s0 = __shfl_xor_sync(FULL, at[gi][0][0], 1);
        const float s1 = __shfl_xor_sync(FULL, at[gi][1][0], 1);
        const float s2 = __shfl_xor_sync(FULL, at[gi][1][1], 1);
        const float u = h ? s1 : at[gi][0][0];
        const float v = h ? s2 : at[gi][0][1];
        const float den = h ? at[gi][1][0] : s0;
        value = best[gi][h] != SKY_KEY
                    ? __ldg(ep.tex + texel_of(u, v, den, ep.tex_w, ep.tex_h))
                    : bgp;
      }
      if (q >= 2 && p < P) ep.out[(size_t)b * P + p] = value;
    }
  }
}

template <int G, bool ZCLIP, int EPI>
__global__ void __launch_bounds__(THREADS)
tile_raster_mma_kernel(const Walk w, const Epi ep) {
  mma_tile<G, ZCLIP, EPI>(w, ep, blockIdx.x);
}

// ---- K1-wf: the persistent walk ----

// Blocks claim wf consecutive tiles (of nblocks = B * nt) at a time from
// *next and walk each with the FMA (K1) or the MMA (K1-mxu) tile body;
// N is that body's pixels a thread or groups a warp.
template <bool MMA, int N, bool ZCLIP>
__global__ void __launch_bounds__(THREADS)
tile_raster_wf_kernel(const Walk w, const Epi ep, int nblocks, int wf,
                      int* next) {
  __shared__ int s_first;
  for (;;) {
    __syncthreads();  // every thread has read the previous claim
    if (threadIdx.x == 0) s_first = atomicAdd(next, wf);
    __syncthreads();
    const int first = s_first;
    if (first >= nblocks) return;
    const int last = min(first + wf, nblocks);
    for (int b = first; b < last; ++b) {
      __syncthreads();  // the shared rows are reused by the next tile
      if constexpr (MMA)
        mma_tile<N, ZCLIP, U8_GOURAUD>(w, ep, b);
      else
        fma_tile<N, ZCLIP, U8_GOURAUD, PAIRS>(w, ep, b);
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

// The checks every launch makes first: an error left pending by an
// earlier launch is returned (the caller raises it); an out-of-range size
// gives cudaErrorInvalidValue.  Returns 0 when the launch may go ahead,
// -1 when there is nothing to launch (no tiles).
template <int EPI, int SRC>
int check(const Walk& w, const Epi& ep, int nblocks) {
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return (int)pending;
  if (nblocks == 0) return -1;
  const int P = w.tile_w * w.tile_h;
  if (P <= 0 || P > 16 * THREADS || w.nrows <= 0 || w.ntx <= 0 ||
      w.nt <= 0 || nblocks % w.nt != 0 || (SRC != ROWS && w.ids_len <= 0))
    return (int)cudaErrorInvalidValue;
  if ((EPI == TEX_U8 || EPI == TEX_IDX) && (ep.tex_w <= 0 || ep.tex_h <= 0))
    return (int)cudaErrorInvalidValue;
  if (ep.mxu < 0 || ep.mxu > 2) return (int)cudaErrorInvalidValue;
  return 0;
}

// pixels a thread of the FMA walk
int fma_ppt(int P) {
  const int ppt = (P + THREADS - 1) / THREADS;
  return ppt <= 1 ? 1 : ppt <= 2 ? 2 : ppt <= 4 ? 4 : ppt <= 8 ? 8 : 16;
}

// 16-pixel groups a warp of the MMA walk holds per pass
int mma_groups(int P) {
  const int g = (P + WARPS * 16 - 1) / (WARPS * 16);
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : MAX_GROUPS;
}

// Launches epilogue EPI on source SRC over nblocks = B * nt tiles on
// `stream`; returns the cudaError_t of the launch (0 on success).
template <int EPI, int SRC>
int launch(int nblocks, int z_clip, const Walk& w, const Epi& ep,
           void* stream) {
  if (const int e = check<EPI, SRC>(w, ep, nblocks)) return e < 0 ? 0 : e;
  cudaStream_t s = (cudaStream_t)stream;
  const bool zc = z_clip != 0;
  switch (fma_ppt(w.tile_w * w.tile_h)) {
    case 1: return (int)launch_ppt<EPI, SRC, 1>(nblocks, zc, w, ep, s);
    case 2: return (int)launch_ppt<EPI, SRC, 2>(nblocks, zc, w, ep, s);
    case 4: return (int)launch_ppt<EPI, SRC, 4>(nblocks, zc, w, ep, s);
    case 8: return (int)launch_ppt<EPI, SRC, 8>(nblocks, zc, w, ep, s);
    default: return (int)launch_ppt<EPI, SRC, 16>(nblocks, zc, w, ep, s);
  }
}

template <int EPI, int G>
cudaError_t launch_mma_g(int nblocks, bool z_clip, const Walk& w,
                         const Epi& ep, cudaStream_t s) {
  if (z_clip)
    tile_raster_mma_kernel<G, true, EPI><<<nblocks, THREADS, 0, s>>>(w, ep);
  else
    tile_raster_mma_kernel<G, false, EPI><<<nblocks, THREADS, 0, s>>>(w, ep);
  return cudaGetLastError();
}

// The MMA walk (K1-mxu) with epilogue EPI over nblocks = B * nt tiles.
template <int EPI>
int launch_mma(int nblocks, int z_clip, const Walk& w, const Epi& ep,
               void* stream) {
  if (const int e = check<EPI, PAIRS>(w, ep, nblocks)) return e < 0 ? 0 : e;
  if (ep.mxu != 1 && ep.mxu != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool zc = z_clip != 0;
  switch (mma_groups(w.tile_w * w.tile_h)) {
    case 1: return (int)launch_mma_g<EPI, 1>(nblocks, zc, w, ep, s);
    case 2: return (int)launch_mma_g<EPI, 2>(nblocks, zc, w, ep, s);
    case 4: return (int)launch_mma_g<EPI, 4>(nblocks, zc, w, ep, s);
    default: return (int)launch_mma_g<EPI, MAX_GROUPS>(nblocks, zc, w, ep, s);
  }
}

// The persistent grid: at most the blocks the card holds at once, never
// more than there are claims; the claim counter zeroed on the stream.
template <bool MMA, int N, bool ZCLIP>
cudaError_t launch_wf_n(int nblocks, int wf, int* next, const Walk& w,
                        const Epi& ep, cudaStream_t s) {
  const auto kernel = tile_raster_wf_kernel<MMA, N, ZCLIP>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (e == cudaSuccess) e = cudaMemsetAsync(next, 0, sizeof(int), s);
  if (e != cudaSuccess) return e;
  const int claims = (nblocks + wf - 1) / wf;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = claims < resident ? claims : resident;
  kernel<<<grid, THREADS, 0, s>>>(w, ep, nblocks, wf, next);
  return cudaGetLastError();
}

template <bool MMA, bool ZCLIP>
cudaError_t launch_wf_z(int nblocks, int wf, int* next, const Walk& w,
                        const Epi& ep, cudaStream_t s) {
  const int P = w.tile_w * w.tile_h;
  if constexpr (MMA) {
    switch (mma_groups(P)) {
      case 1: return launch_wf_n<true, 1, ZCLIP>(nblocks, wf, next, w, ep, s);
      case 2: return launch_wf_n<true, 2, ZCLIP>(nblocks, wf, next, w, ep, s);
      case 4: return launch_wf_n<true, 4, ZCLIP>(nblocks, wf, next, w, ep, s);
      default:
        return launch_wf_n<true, MAX_GROUPS, ZCLIP>(nblocks, wf, next, w, ep,
                                                    s);
    }
  } else {
    switch (fma_ppt(P)) {
      case 1: return launch_wf_n<false, 1, ZCLIP>(nblocks, wf, next, w, ep, s);
      case 2: return launch_wf_n<false, 2, ZCLIP>(nblocks, wf, next, w, ep, s);
      case 4: return launch_wf_n<false, 4, ZCLIP>(nblocks, wf, next, w, ep, s);
      case 8: return launch_wf_n<false, 8, ZCLIP>(nblocks, wf, next, w, ep, s);
      default:
        return launch_wf_n<false, 16, ZCLIP>(nblocks, wf, next, w, ep, s);
    }
  }
}

// K1-wf (ep.mxu 0) or its MMA walk (ep.mxu 1 or 2), u8 epilogue.
int launch_wf(int nblocks, int z_clip, int wf, int* next, const Walk& w,
              const Epi& ep, void* stream) {
  if (const int e = check<U8_GOURAUD, PAIRS>(w, ep, nblocks))
    return e < 0 ? 0 : e;
  if (wf < 1 || next == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ep.mxu)
    return (int)(z_clip ? launch_wf_z<true, true>(nblocks, wf, next, w, ep, s)
                        : launch_wf_z<true, false>(nblocks, wf, next, w, ep,
                                                   s));
  return (int)(z_clip ? launch_wf_z<false, true>(nblocks, wf, next, w, ep, s)
                      : launch_wf_z<false, false>(nblocks, wf, next, w, ep,
                                                  s));
}

// The split walk (K1, K3): the plan, then the persistent walk, its grid
// at most the blocks the card holds at once and never more than cap.
template <int EPI, int PPT, bool ZC>
cudaError_t launch_split_n(int nblocks, const Walk& w, const Epi& ep,
                           const Plan& pl, cudaStream_t s) {
  const auto kernel = tile_raster_split_kernel<PPT, ZC, EPI>;
  // the device's SMs and this kernel's resident blocks, asked once a
  // device (a launch then costs the host two kernel launches only)
  static int cached_dev = -1, sms = 0, per_sm = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != cached_dev) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
    if (e == cudaSuccess) cached_dev = dev;
  }
  if (e != cudaSuccess) return e;
  split_plan_kernel<<<min(nblocks, 4 * sms), THREADS, 0, s>>>(
      w, pl, ep.packed_bg, ep.out, nblocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<min(pl.cap, resident), THREADS, 0, s>>>(w, ep, pl);
  return cudaGetLastError();
}

template <int EPI, bool ZC>
cudaError_t launch_split_z(int nblocks, const Walk& w, const Epi& ep,
                           const Plan& pl, cudaStream_t s) {
  switch (fma_ppt(w.tile_w * w.tile_h)) {
    case 1: return launch_split_n<EPI, 1, ZC>(nblocks, w, ep, pl, s);
    case 2: return launch_split_n<EPI, 2, ZC>(nblocks, w, ep, pl, s);
    case 4: return launch_split_n<EPI, 4, ZC>(nblocks, w, ep, pl, s);
    case 8: return launch_split_n<EPI, 8, ZC>(nblocks, w, ep, pl, s);
    default: return launch_split_n<EPI, 16, ZC>(nblocks, w, ep, pl, s);
  }
}

template <int EPI>
int launch_split(int nblocks, int z_clip, const Walk& w, const Epi& ep,
                 const Plan& pl, void* stream) {
  if (const int e = check<EPI, PAIRS>(w, ep, nblocks)) return e < 0 ? 0 : e;
  if (pl.items == nullptr || pl.counters == nullptr || pl.cap < nblocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(z_clip ? launch_split_z<EPI, true>(nblocks, w, ep, pl, s)
                      : launch_split_z<EPI, false>(nblocks, w, ep, pl, s));
}

// Registers a thread and resident blocks an SM of K1's or K3's split walk,
// or of the fma_tile kernel it is timed beside: K1-wf's for K1, K2b's
// grid kernel for K3.
template <typename K>
int blocks_per_sm(K kernel, int* regs) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  *regs = a.numRegs;
  return n;
}

template <int EPI, bool ZC>
int occupancy_z(int split, int P, int* regs) {
#define OCC(N)                                                            \
  if (split) return blocks_per_sm(tile_raster_split_kernel<N, ZC, EPI>, regs); \
  if constexpr (EPI == TEX_U8)                                              \
    return blocks_per_sm(tile_raster_kernel<N, ZC, TEX_IDX, PAIRS>, regs);  \
  else                                                                      \
    return blocks_per_sm(tile_raster_wf_kernel<false, N, ZC>, regs)
  switch (fma_ppt(P)) {
    case 1: OCC(1);
    case 2: OCC(2);
    case 4: OCC(4);
    case 8: OCC(8);
    default: OCC(16);
  }
#undef OCC
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

// The split walk's scratch: items (cap int2, cap at least B * nt +
// (B * ids_len) / SEG for the split to be on), counters (3 + nblocks
// ints); none needs to be initialised.
#define SPLIT_ARGS int *items, int cap, int *counters
#define PLAN {reinterpret_cast<int2*>(items), cap, counters}

// K1: out (B * nt, P) packed u8 RGBA, rows from sorted pairs, through
// the split walk (two launches: the plan, the walk).
int tile_raster_u8(WALK_ARGS, const int* packed_bg, int opaque, int* out,
                   SPLIT_ARGS, void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, opaque, nullptr, 0, 0, out, nullptr, 0};
  const Plan pl = PLAN;
  return launch_split<U8_GOURAUD>(nblocks, z_clip, w, ep, pl, stream);
}

// K3: out (B * nt, P) packed u8 texels of the (tex_h x tex_w) packed
// texture, through the split walk.
int tile_raster_tex_u8(WALK_ARGS, const int* tex, int tex_w, int tex_h,
                       const int* packed_bg, int* out, SPLIT_ARGS,
                       void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, 0, tex, tex_w, tex_h, out, nullptr, 0};
  const Plan pl = PLAN;
  return launch_split<TEX_U8>(nblocks, z_clip, w, ep, pl, stream);
}

// Registers (*regs) and resident blocks an SM (returned; negative: a
// cudaError_t) of K1's (tex 0) or K3's (tex 1) kernel for tiles of
// tile_p pixels: the split walk (split 1) or the old walk, fma_tile, as
// K1-wf's kernel (tex 0) or K2b's (tex 1) runs it (split 0).
int tile_raster_occupancy(int split, int tex, int tile_p, int z_clip,
                          int* regs) {
  if (tex)
    return z_clip ? occupancy_z<TEX_U8, true>(split, tile_p, regs)
                  : occupancy_z<TEX_U8, false>(split, tile_p, regs);
  return z_clip ? occupancy_z<U8_GOURAUD, true>(split, tile_p, regs)
                : occupancy_z<U8_GOURAUD, false>(split, tile_p, regs);
}

// K2b: out (B * nt, P) texel indices, -1 for sky.
int tile_raster_tex_idx(WALK_ARGS, int tex_w, int tex_h, int* out,
                        void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, tex_w, tex_h, out, nullptr, 0};
  return launch<TEX_IDX, PAIRS>(nblocks, z_clip, w, ep, stream);
}

// K2a: keys (B * nt, P) int32 and rgba (B * nt, 4, P) float32.
int tile_raster_keys_f32(WALK_ARGS, int* keys, float* rgba, void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, 0, 0, keys, rgba, 0};
  return launch<KEYS_F32, PAIRS>(nblocks, z_clip, w, ep, stream);
}

// K5: K2a's outputs, rows from bins (ids (B * nt, K), starts unused).
int tile_raster_bins_f32(WALK_ARGS, int* keys, float* rgba, void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, 0, 0, keys, rgba, 0};
  return launch<KEYS_F32, BINS>(nblocks, z_clip, w, ep, stream);
}

// K6: K1's output, rows pre-gathered in pair order (table (B, nrows, 32),
// ids unused).
int tile_raster_rows_u8(WALK_ARGS, const int* packed_bg, int opaque,
                        int* out, void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, opaque, nullptr, 0, 0, out, nullptr, 0};
  return launch<U8_GOURAUD, ROWS>(nblocks, z_clip, w, ep, stream);
}

// K1-wf: K1's out from a persistent grid whose blocks claim wf
// consecutive tiles at a time from *next (one int, zeroed here on the
// stream); with mxu 1 or 2 (an affine table) each tile walks K1-mxu's
// MMA walk.
int tile_raster_u8_wf(WALK_ARGS, const int* packed_bg, int opaque, int mxu,
                      int wf, int* next, int* out, void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, opaque, nullptr, 0, 0, out, nullptr, mxu};
  return launch_wf(nblocks, z_clip, wf, next, w, ep, stream);
}

// K1-mxu: K1's out from the MMA walk over an affine table (mxu 1 or 2).
int tile_raster_u8_mxu(WALK_ARGS, const int* packed_bg, int opaque, int mxu,
                       int* out, void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, opaque, nullptr, 0, 0, out, nullptr, mxu};
  return launch_mma<U8_GOURAUD>(nblocks, z_clip, w, ep, stream);
}

// K3 over the MMA walk: K3's out from an affine textured table.
int tile_raster_tex_u8_mxu(WALK_ARGS, const int* tex, int tex_w, int tex_h,
                           const int* packed_bg, int mxu, int* out,
                           void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, 0, tex, tex_w, tex_h, out, nullptr, mxu};
  return launch_mma<TEX_U8>(nblocks, z_clip, w, ep, stream);
}

const char* tile_raster_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
