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
//                      :356-374, through the split walk;
//     KEYS_F32   (K2a) the f32 branch, raster_tiles_flat (:805), epilogue
//                      :597-599, through the split walk, with K5's warp
//                      boxes and cull at 128-wide tiles (below);
//   _make_kernel (:51-122), rows from a materialised bins row:
//     KEYS_F32   (K5)  raster_tiles (:1433), the z test always on, through
//                      the split walk with warp boxes and a cull (below);
//   _make_kernel_dynrows (:1176-1267), rows pre-gathered in pair order:
//     U8_GOURAUD (K6)  raster_tiles_dynrows (:1294), opaque, no z test,
//                      through the split walk;
//   the wf branch of raster_tiles_flat (:739, kernel_wf :624-655):
//     K1-wf, K1's split walk claiming wf items at a time (below);
//   the mxu branch of _make_kernel_flat (:242-250,285-301,326-327) over
//   build_table_mxu's affine table (:1474-1505), in the launches at :739,
//   :793 and :895: K1-mxu, the split walk with its planes on the tensor
//   cores (wgmma, below), with the U8_GOURAUD or TEX_U8 epilogue.
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
// The split walk (every kernel of the file: K1, K3, K2b, K2a, K5, K6,
// K1-wf, K1-mxu and K3's mxu walk).  The tail is inside a tile, so no
// order of claims cures it: the long run itself is cut.  One scheduler
// (the plan and the claim loop below) drives both walks of an item, the
// FMA walk and the MMA walk.  Each thread owns PPT = ceil(P / 256)
// pixels of a tile (fma_ppt; 4 at 32x32) and keeps their best keys in
// registers.
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
//     This holds for keys the tensor cores computed too: they are unique
//     in a tile for the same reason.
//   * Only the key a pixel during the walk.  The winner's row is
//     row_of(key & IDX_MASK) and its values are recomputed in the
//     epilogue in the plain version's rounding order at that pixel: the
//     edges with the walk's own __fmul_rn/__fadd_rn order (FMA walk), or
//     the affine attribute planes on the CUDA cores (MMA walk), so no
//     attribute goes through the tensor cores.
//   * Scheduling on the device.  A plan kernel (block 0: a scan of the
//     counts) lists the items, long tiles' first, in scratch sized by
//     static shapes (B nt + B ids_len / S items) and zeroes the counters;
//     its other blocks write the background into the tiles whose run is
//     empty (most of a frame: no walk claims them).  A persistent walk,
//     its grid the blocks the card holds at once (never more than
//     ceil(cap / wf)), claims wf consecutive items at a time from a
//     counter and walks them in list order: K1 and K3 are wf = 1, K1-wf
//     any wf (the TPU's programs each walked wf consecutive tiles; here
//     the grain is items, so a long run is still cut).  Whether a claim
//     is one item or wf is a template parameter, so K1 and K3 carry no
//     grain in their registers.  The values are the same for every wf
//     and every order of claims.  No host sync; one wrapper call.
//   * Staging.  Each row's columns 0..27 (FMA walk: the 12 walk columns
//     and the attributes) or 0..31 (MMA walk: planes 0..3 at 0..15, the
//     attribute planes 4..7 at 16..31) are 16-byte cp.async (rows are
//     128-byte aligned) into one of two shared buffers; while a block
//     walks one item, the next item's rows are in flight, so one
//     __syncthreads() guards an item, and a run staged at once finds its
//     winners' rows in shared memory for the epilogue.
//   * Settled by timing on an H100 (PERF.md): S = 64 and 5 blocks an SM
//     at 32x32 for the FMA walk.  At 32x32 only ~450 of 2040 runs are not
//     empty, so one frame is about one item a resident block.
//
// K5 on the split walk.  Its runs are bins rows: slot j of tile b is
// bins[b, j], a run walks min(counts[b], K) slots (run_count), so an
// overflowed tile reads nothing past its K; the plan's capacity is
// B nt ceil(K / S), every run's items, so the split is always on.  The
// plan writes SKY_KEY into long and empty tiles' keys and zeros into
// empty tiles' four planes; the last item of a tile writes the planes,
// each pixel's winner's edges recomputed from the key's slot with the
// walk's expression (split_keys_f32).  Keys are unique
// in a tile (their low bits are the bin slot), so the atomicMin merge is
// exact.  Box culling in the binning (raster3d.bin_triangles) leaves
// ~25.5k pairs a 1080p mesh_10k frame at 128x16, each tested by all 2048
// pixels of its tile, while a triangle of a few hundred pixels meets few
// 16x16 boxes of such a tile.  So K5's instantiation for 128-wide tiles
// (BOX; its entry's defaults are 128x16 and 128x32) lays its pixels out
// so that each warp owns a compact box (pixel_slot: a strip of 16
// columns, all rows, 16x16 at 128x16), and after a stage's
// rows land in shared memory each warp skips a row whose triangle cannot
// cover any pixel of its box (box_culled, exact by construction: it
// evaluates the walk's own rounded edge at the box's pixel where that
// edge is largest, so the winners and their bits are unchanged).  The lanes test the stage's
// rows together (two rows a lane, one ballot each), so the skip is
// decided once a warp and nothing diverges; the kept rows keep their
// slot in the key.  On the CPU, tile_raster.bins_cull_keep counts the
// kept (row, warp) pairs: ~0.27 of them at 128x16 on mesh_10k's 4
// cameras, ~0.37 at 128x32 (PERF.md), which with the cull's ~30
// operations a (row, warp) sets K5's operations bound.
//
// K2a on the split walk.  K2a computes K5's outputs (KEYS_F32) with
// its rows from the sorted pairs (PAIRS), so its item list is sized as
// K1's (B nt + B ids_len / S).  Runs that overlap (a flagged frame) may
// not fit; the plan then makes every tile one item of its whole run,
// which still writes SKY_KEY into a long tile's keys first, and the
// values are the plain version's.  Its three main paths (render_textured
// at 128x8, render_gouraud_pallas(flat=True) at 128x16, the batch
// entry's flat route at 128x32) are 128 wide, where it takes K5's warp
// boxes and cull (BOX); at other widths the split walk without them.
// On the CPU, tile_raster.pairs_cull_keep counts its kept (row, warp)
// pairs: ~0.23 at 128x8, ~0.29 at 128x16 and ~0.40 at 128x32 on
// mesh_10k's 4 cameras (PERF.md).  Its entry takes the z test on or off: with it off, a covered depth
// above 1 makes a key whose shifted level wraps negative, which the
// walk's signed `key < best` and the merge's signed atomicMin order as
// the sequential walk does.
//
// K2b and K6 on the split walk.  K2b is K3's walk with the TEX_IDX
// epilogue: the winner's texel index itself, -1 for sky (sky_value, a
// compile-time function of the epilogue: K2b passes no background).  K6
// is K1's walk (opaque, no z test) over ROWS: slot j of tile b is row
// starts[b] + j of the caller's rows, gathered in pair order and clamped
// below their count CAP, so the plan's capacity is B nt + B CAP / S (a
// frame whose runs end past CAP, which the caller flags, may not fit
// the list; the plan then makes every tile one item, and the values are
// still the plain version's).  Both take the FMA walk, one item a claim.
//
// The MMA walk (K1-mxu, K3's mxu walk).  The TPU kernel evaluated a
// chunk's 4 + nacc affine planes (a_x, a_y, c, 0) . (x, y, 1, 0) as
// (kcc, 4) x (4, P) products on its matrix unit.  Here a warpgroup (4
// warps) issues wgmma.mma_async m64n64k16 (bf16 operands, float32
// accumulators): M = 64 pixels, N = 4 walk planes (3 edges, depth) x 16
// triangles, K = 16 cross terms, waited for at once.  What bounds the
// walk is the lanes' key work, not the product (PERF.md: two half-width
// products in flight, or a deeper pipeline, ran no faster; a product in
// flight across a branch makes ptxas serialize every product of the
// function).  Pixel coordinates split exactly into bf16 parts, x = xh +
// xl (integers below 65536), and each coefficient into three, a = a0 +
// a1 + a2 (exact for a float32 away from underflow); K holds xh xl xh xl
// xh xl | yh yl .. | 1 1 1 | 0 against
// ax0 ax0 ax1 ax1 ax2 ax2 | ay0 ay0 .. | c0 c1 c2 | 0.  With mxu=1 every
// product is exact and only the accumulation rounds (near float32, the
// TPU's HIGHEST); with mxu=2 only the first parts remain, the TPU's one
// DEFAULT pass, which rounds the coordinates and coefficients to bf16
// themselves.  The tensor cores add the products in float32 in an order
// and with rounding that are not IEEE round-to-nearest per addition, so a
// plane can differ from the plain version's ((a_x x + a_y y) + c) by an
// ulp or so, and a coverage test or key with it: the walk is held to its
// plain version within a share of pixels (chip_smoke.py), not bit for
// bit.  -fmad=false governs the CUDA-core arithmetic only.
//   * A, the pixels, in registers: a warp's 16 rows in the m16n8k16
//     layout (lane 4g + q: rows g and g + 8, k 2q, 2q + 1 and + 8), built
//     from the tile's origin for each group of 64 pixels.
//   * B, the item's planes, in shared memory in the layout wgmma reads
//     (K-major, no swizzle: core matrices of 8 columns x 16 bytes, the
//     two K halves 128 bytes apart (LBO), column groups 256 (SBO)), one
//     2 KiB operand a 16 triangles, built once a stage: one thread a
//     (triangle, plane) splits its three coefficients once and writes its
//     column's two 16-byte halves.  Slots past the item, up to a multiple
//     of 16, are NaN columns and never cover.  One B serves every 64-pixel
//     group of the tile.
//   * Columns so that each lane holds whole triangles.  Lane 4g + q of
//     warp w holds accumulator rows 16w + g and + 8 at columns 8i + 2q
//     and + 1; B's column 8i + c is plane 2 (i % 2) + c % 2 of triangle
//     4 (i / 2) + c / 2, so a lane holds e0, e1, e2 and z of triangles
//     4k + q (k = 0..3) at its two pixels: coverage, z test, quantisation
//     and key run once a (pixel, triangle), on one lane, with no shuffle
//     in the walk; two shfl_xor (1, 2) take the minimum across the quad at
//     the end of a pixel group.  Keys are unique, so nothing is lost.
//   * A stage's best key a pixel goes to shared memory (its owner lane
//     keeps the minimum over a long run's stages); the merge and the
//     epilogue are the FMA walk's.
//   * Bound on an H100: 4 planes x 16 products x 2 = 128 tensor-core
//     operations a (pixel, triangle) against 989 T/s dense bf16, and ~9
//     CUDA-core operations (coverage, key, minimum) at 33.5 T/s; the
//     CUDA cores bound it, and the key loop is ~7 instructions a (pixel,
//     triangle) against the FMA walk's ~26 (key_min).  Blocks an SM: see
//     split_min_blocks.  Pixel coordinates by mask and shift where the
//     tile width is a power of two (pixel_xy).

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
constexpr int SEG = 64;         // split walk: slots an item walks at most
constexpr int STAGE_COLS = 28;  // FMA split walk: row columns staged (walk
                                // and attributes: 0..27)
constexpr int B_OPERAND = 2048; // MMA walk: bytes of one B operand (K 16 x
                                // N 64 bf16: 16 triangles x 4 planes)
constexpr int GROUP_PX = 64;    // MMA walk: pixels of one product (M)
constexpr int WARPGROUPS = THREADS / 128;
constexpr unsigned FULL = 0xffffffffu;
static_assert(SEG <= 64, "K5's cull keeps a stage's rows in a 64-bit mask");
constexpr int BOX_W = 16;       // K5's warp boxes: columns a warp owns, at
constexpr int BOX_TILE_W = BOX_W * WARPS;   // tiles this wide (128)

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
  int mxu;        // 0 the FMA walk; the MMA walk: 1 exact parts, 2 one
                  // bf16 pass
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

// Pixel (x, y) of slot p of the tile at (ox, oy), tile_w wide: a mask
// and a shift when tile_w is a power of two (every production shape),
// else a division (tile_w is the same for the whole launch).
__device__ __forceinline__ void pixel_xy(int p, int ox, int oy, int tile_w,
                                         float& x, float& y) {
  if ((tile_w & (tile_w - 1)) == 0) {
    x = (float)(ox + (p & (tile_w - 1)));
    y = (float)(oy + (p >> (__ffs(tile_w) - 1)));
  } else {
    x = (float)(ox + p % tile_w);
    y = (float)(oy + p / tile_w);
  }
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

// ---- The split walk: K1, K3, K2b, K2a, K5, K6, K1-wf, K1-mxu and K3's
// mxu walk ----

enum Walker { WALK_FMA, WALK_MMA };

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

// Slots of tile b's run the walk reads: a bins row holds at most K (an
// overflowed tile walks its K slots and reads nothing past them).
template <int SRC>
__device__ __forceinline__ int run_count(const Walk& w, int b) {
  return SRC == BINS ? min(w.counts[b], w.ids_len) : w.counts[b];
}

// Slots [lo, hi) of the run of tile b that item segment s walks, and the
// items of that tile (k); with the split off every tile is one item.
template <int SRC>
__device__ __forceinline__ void item_range(const Walk& w, bool split, int b,
                                           int s, int& lo, int& hi, int& k) {
  const int count = run_count<SRC>(w, b);
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

// Start copying columns 0..COLS-1 of the rows of slots [lo, lo + n) of
// tile b's run into rows: COLS / 4 16-byte cp.async a row (rows are
// 128-byte aligned), the pair or bin ids read once a row by neighbouring
// threads.  The caller waits (cp_async_wait_all) and syncs.
template <int COLS, int SRC>
__device__ __forceinline__ void stage_rows(const Walk& w, int b, int lo,
                                           int n, float (*rows)[COLS]) {
  constexpr int CHUNKS = COLS / 4;
  const int f = b / w.nt;
  const int start = SRC == BINS ? 0 : w.starts[b];
  for (int i = threadIdx.x; i < CHUNKS * n; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = i - CHUNKS * r;
    const int row = row_of<SRC>(w, b, f, start, lo + r);
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// (a_x x + a_y y) + c of the affine plane c[0..2] at (x, y), each
// operation rounded on its own; mxu=2 first rounds the coefficients to
// bf16 (the caller the coordinates), as the plain version rounds the table
__device__ __forceinline__ float affine(const float* c, float x, float y,
                                        int mxu) {
  float ax = c[0], ay = c[1], cc = c[2];
  if (mxu != 1) {
    ax = bf16_round(ax);
    ay = bf16_round(ay);
    cc = bf16_round(cc);
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, x), __fmul_rn(ay, y)), cc);
}

// The winner's row of key (not SKY_KEY) in tile b's run: in staged, the
// shared rows of the whole run, when it was staged at once, else in the
// table.
template <int SRC, int COLS>
__device__ __forceinline__ const float* winner_row(
    const Walk& w, int b, int key, const float (*staged)[COLS]) {
  if (staged) return staged[key & IDX_MASK];
  const int row = row_of<SRC>(w, b, b / w.nt, SRC == BINS ? 0 : w.starts[b],
                              key & IDX_MASK);
  return w.table + (size_t)row * ROW_W;
}

// The output of a pixel no triangle covers, a compile-time function of
// the epilogue: the packed background (K1, K3, K6), -1 (K2b) or the key
// SKY_KEY (K2a, K5; their attributes are 0).
template <int EPI>
__device__ __forceinline__ int sky_value(const Epi& ep) {
  if constexpr (EPI == TEX_IDX)
    return -1;
  else if constexpr (EPI == KEYS_F32)
    return SKY_KEY;
  else
    return *ep.packed_bg;
}

// K1's, K3's, K2b's or K6's value of pixel (x, y) of tile b whose winning
// key is key (sky: bgp): the winner's row is found again from the key's
// slot in the run of source SRC (in staged, the shared rows of the whole
// run, when it was staged at once; else in the table or rows) and its
// attributes recomputed on the CUDA cores in the plain version's order:
// the FMA walk's edges (the walk's own bits) and their interpolation, or
// the MMA walk's affine planes 4 + d.
template <int EPI, bool MMA, int COLS, int SRC>
__device__ __forceinline__ int split_value(const Walk& w, const Epi& ep,
                                           int b, int key, float x, float y,
                                           int bgp,
                                           const float (*staged)[COLS]) {
  if (key == SKY_KEY) return bgp;
  const float* r = winner_row<SRC, COLS>(w, b, key, staged);
  float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
  if constexpr (MMA) {
    if (ep.mxu != 1) {   // one bf16 pass rounds the coordinates too
      x = bf16_round(x);
      y = bf16_round(y);
    }
  } else {
    e0 = edge(r, 0, x, y);
    e1 = edge(r, 1, x, y);
    e2 = edge(r, 2, x, y);
  }
  // the winner's attribute d at (x, y)
  const auto value = [&](int d) {
    if constexpr (MMA)
      return affine(r + 4 * (4 + d), x, y, ep.mxu);
    else
      return attr(r + ATTR_COL, e0, e1, e2, d);
  };
  if constexpr (EPI == U8_GOURAUD) {
    // channel d in byte d; alpha 255 with opaque
    unsigned packed = ep.opaque ? 255u << 24 : 0u;
    for (int d = 0; d < (ep.opaque ? 3 : 4); ++d)
      packed |= (unsigned)quant_u8(value(d)) << (8 * d);
    return (int)packed;
  } else {
    // the texel of (u / den, v / den), the denominator (attribute 2) first
    const float den = value(2);
    const int texel = texel_of(value(0), value(1), den, ep.tex_w, ep.tex_h);
    if constexpr (EPI == TEX_IDX)
      return texel;
    else
      return __ldg(ep.tex + texel);
  }
}

// K2a's and K5's (KEYS_F32) outputs at slot p of tile b whose winning
// key is key:
// the key (when this item writes it: a long tile's merged keys are
// already in place) and the winner's four attributes, its edges
// recomputed with the walk's own expression at (x, y), 0 for sky.
template <int SRC, int COLS>
__device__ __forceinline__ void split_keys_f32(const Walk& w, const Epi& ep,
                                               int b, int p, int key,
                                               float x, float y,
                                               bool write_key,
                                               const float (*staged)[COLS]) {
  const int P = w.tile_w * w.tile_h;
  if (write_key) ep.out[(size_t)b * P + p] = key;
  float v[D] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (key != SKY_KEY) {
    const float* r = winner_row<SRC, COLS>(w, b, key, staged);
    const float e0 = edge(r, 0, x, y), e1 = edge(r, 1, x, y),
                e2 = edge(r, 2, x, y);
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = attr(r + ATTR_COL, e0, e1, e2, d);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) ep.rgba[((size_t)b * D + d) * P + p] = v[d];
}

// The plan: block 0 lists the items of the tiles whose run is not empty
// (long tiles' first, in tile order; with more items than cap, which runs
// that partition their frames' pairs or rows never need, every such tile
// becomes one whole item; bins runs of at most K slots never need it
// either) and zeroes the claim counter; every block zeroes the arrival
// counters of its tiles, fills the output rows of long tiles with
// SKY_KEY, the start of their atomicMin merge (the last item turns what
// is still SKY_KEY into sky_value), and those of empty tiles with
// sky_value (KEYS_F32: also zero attributes), their whole epilogue (no
// walk claims them).
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

template <int SRC, int EPI>
__global__ void __launch_bounds__(THREADS)
split_plan_kernel(const Walk w, const Plan pl, const Epi ep, int nblocks) {
  const int P = w.tile_w * w.tile_h;
  if (blockIdx.x == 0) {
    const int per = (nblocks + THREADS - 1) / THREADS;
    const int b0 = min((int)threadIdx.x * per, nblocks);
    const int b1 = min(b0 + per, nblocks);
    // items of long tiles, long tiles, short (non-empty) tiles
    long long n_items = 0, n_long = 0, n_short = 0;
    for (int b = b0; b < b1; ++b) {
      const int c = run_count<SRC>(w, b);
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
      const int c = run_count<SRC>(w, b);
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
  const int bgp = sky_value<EPI>(ep);
  for (int b = blockIdx.x; b < nblocks; b += gridDim.x) {
    if (threadIdx.x == 0) pl.counters[3 + b] = 0;
    const int c = run_count<SRC>(w, b);
    if (c > SEG || c <= 0)
      for (int p = threadIdx.x; p < P; p += THREADS)
        ep.out[(size_t)b * P + p] = c > 0 ? SKY_KEY : bgp;
    if constexpr (EPI == KEYS_F32)
      if (c <= 0)
        for (int i = threadIdx.x; i < D * P; i += THREADS)
          ep.rgba[(size_t)b * D * P + i] = 0.0f;
  }
}

// K5's cull: true when the edge row r cannot cover a pixel of the box
// [x0, x1] x [y0, y1] (pixel coordinates, bounds included) as the walk
// evaluates its edges: for some edge, the walk's own value (A x + B y) +
// C, each operation rounded, is negative at the box's pixel where the
// plane is largest (x1 if A > 0 else x0, y1 if B > 0 else y0).  Rounding
// to nearest is monotone (a <= b gives fl(a) <= fl(b)), so for A > 0
// fl(A x) grows with x, and so does each sum: that rounded value is the
// largest the walk computes at any pixel of the box, and the edge is
// negative at all of them.  Exact by construction, no margin needed.  A
// NaN coefficient culls by no edge it is in.  Plain version:
// tile_raster.cull_keep.
__device__ __forceinline__ bool box_culled(const float* r, float x0, float x1,
                                           float y0, float y1) {
  bool out = false;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out = out || edge(r, i, r[3 * i] > 0.0f ? x1 : x0,
                      r[3 * i + 1] > 0.0f ? y1 : y0) < 0.0f;
  return out;
}

// The FMA walk of one stage: slots base .. base + n - 1 (n <= SEG) of a
// run, their rows in rows; each thread keeps its PPT pixels' best keys.
// With BOX (K5, K2a) the warp walks only the rows box_culled keeps for its
// box: each lane tests rows lane and lane + 32 once, a ballot makes the
// warp's mask of kept rows, and the warp walks the mask's rows in order
// (the same rows in every lane, so nothing diverges).  A culled row
// covers no pixel of the warp, so the minimum is the same.
template <int PPT, bool ZCLIP, bool BOX>
__device__ __forceinline__ void fma_stage(const float (*rows)[STAGE_COLS],
                                          int n, int base, const float* px,
                                          const float* py, int* best,
                                          const float* box) {
  unsigned long long keep = 0;
  if constexpr (BOX) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < SEG / 32; ++h) {
      const int j = lane + 32 * h;
      const bool k = j < n && !box_culled(rows[j], box[0], box[1], box[2],
                                          box[3]);
      keep |= (unsigned long long)__ballot_sync(FULL, k) << (32 * h);
    }
  }
  for (int i = 0; BOX ? keep != 0 : i < n; ++i) {
    int j = i;
    if constexpr (BOX) {
      j = __ffsll((long long)keep) - 1;
      keep &= keep - 1;
    }
    // the 12 walk columns as three 16-byte shared loads
    const float4* v = reinterpret_cast<const float4*>(rows[j]);
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
}

// ---- the MMA walk's pieces ----

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

// Column k of A for the pixel x = xh + xl, y = yh + yl:
// xh xl xh xl xh xl | yh yl yh yl yh yl | 1 1 1 | 0
__device__ __forceinline__ float a_col(int k, float xh, float xl, float yh,
                                       float yl) {
  if (k < 6) return (k & 1) ? xl : xh;
  if (k < 12) return (k & 1) ? yl : yh;
  return k < 15 ? 1.0f : 0.0f;
}

// This lane's A registers for the pixels p0 and p0 + 8 of a tile at
// (ox, oy): rows g and g + 8, k 2q, 2q + 1 (registers 0, 1) and 2q + 8,
// 2q + 9 (registers 2, 3), the m16n8k16 layout a warp's rows of wgmma's
// A take.  One pass (mxu=2) multiplies the rounded coordinates alone.
__device__ __forceinline__ void a_frag(int p0, int ox, int oy, int tile_w,
                                       int mxu, unsigned a[4]) {
  const int k = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x, y;
    pixel_xy(p0 + 8 * h, ox, oy, tile_w, x, y);
    const float xh = bf16_round(x), yh = bf16_round(y);
    const float xl = mxu == 1 ? __fsub_rn(x, xh) : 0.0f;
    const float yl = mxu == 1 ? __fsub_rn(y, yh) : 0.0f;
    a[h] = bf16_pair(a_col(k, xh, xl, yh, yl), a_col(k + 1, xh, xl, yh, yl));
    a[2 + h] = bf16_pair(a_col(k + 8, xh, xl, yh, yl),
                         a_col(k + 9, xh, xl, yh, yl));
  }
}

// Writes the B column of plane pl (0..3: e0, e1, e2, z) of slot j of a
// stage, from its staged row (live) or as a NaN column that never covers
// (a slot past the stage): the coefficients (a_x, a_y, c) = row[4 pl ..]
// split once into bf16 parts, K rows ax0 ax0 ax1 ax1 ax2 ax2 ay0 ay0 |
// ay1 ay1 ay2 ay2 c0 c1 c2 0 as two 16-byte stores.  Slot j is triangle
// t = j % 16 of operand j / 16, column n = 8 i + c with i = 2 (t / 4) +
// pl / 2 and c = 2 (t % 4) + pl % 2; K-major without swizzle, so column n
// is row n % 8 of the core matrices (n / 8, K half), 128 bytes each, at
// (2 (n / 8) + half) x 128 bytes.
__device__ __forceinline__ void build_b(const float* row, int j, int pl,
                                        bool live, int mxu,
                                        unsigned char* s_b) {
  float ax[3], ay[3], c[3];
  if (live) {
    split3(row[4 * pl], mxu, ax);
    split3(row[4 * pl + 1], mxu, ay);
    split3(row[4 * pl + 2], mxu, c);
  } else {
    ax[0] = __int_as_float(0x7fc00000);
    ax[1] = ax[2] = ay[0] = ay[1] = ay[2] = c[0] = c[1] = c[2] = 0.0f;
  }
  const int t = j & 15;
  const int i = 2 * (t >> 2) + (pl >> 1);
  const int cc = 2 * (t & 3) + (pl & 1);
  unsigned char* col = s_b + (j >> 4) * B_OPERAND + 2 * i * 128 + cc * 16;
  *reinterpret_cast<uint4*>(col) =
      make_uint4(bf16_pair(ax[0], ax[0]), bf16_pair(ax[1], ax[1]),
                 bf16_pair(ax[2], ax[2]), bf16_pair(ay[0], ay[0]));
  *reinterpret_cast<uint4*>(col + 128) =
      make_uint4(bf16_pair(ay[1], ay[1]), bf16_pair(ay[2], ay[2]),
                 bf16_pair(c[0], c[1]), bf16_pair(c[2], 0.0f));
}

// wgmma's shared-memory descriptor of the B operand at s_b: start address
// >> 4, LBO 128 bytes (the two K halves), SBO 256 bytes (column groups of
// 8), no swizzle
__device__ __forceinline__ uint64_t b_desc(const unsigned char* s_b) {
  const uint64_t a = (unsigned)__cvta_generic_to_shared(s_b);
  return ((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// Stores of this thread to shared memory become visible to wgmma (the
// async proxy); then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The accumulators are pinned here: no read moves above the wait, no
// write below the issue.
__device__ __forceinline__ void fence_acc(float d[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16, this warpgroup's registers) x B (16 x 64, desc: 16
// triangles), from zero (scale-d 0): issued, committed and waited for.
// Lane 4g + q of warp w then holds d[4 i + 2 h + c] = row 16 w + g + 8 h,
// column 8 i + 2 q + c.
__device__ __forceinline__ void wgmma_64x64(float d[32], const unsigned a[4],
                                            uint64_t desc) {
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
}

// e0, e1, e2 and z of this lane's triangle 4k + q (k = 0..3) of a product
// at its pixel row g + 8h (columns 8 (2k) + 2q + c: planes c;
// 8 (2k + 1) + 2q + c: planes 2 + c)
__device__ __forceinline__ void lane_planes(const float d[32], int k, int h,
                                            float e[4]) {
  e[0] = d[8 * k + 2 * h];
  e[1] = d[8 * k + 2 * h + 1];
  e[2] = d[8 * k + 4 + 2 * h];
  e[3] = d[8 * k + 5 + 2 * h];
}

// K1's coverage test and key on a slot's planes, kept in best when it is
// covered and lower, in the fewest instructions (the key loop is what
// bounds the MMA walk): the slot is added to the shifted depth, one
// instruction with the same bits as K1's or (a slot is below
// 2^IDX_BITS, which the keys' uniqueness in a tile already needs), and
// the minimum is taken under the coverage predicate.
template <bool ZCLIP>
__device__ __forceinline__ void key_min(const float e[4], int slot,
                                        int& best) {
  bool cov = (e[0] >= 0.0f) && (e[1] >= 0.0f) && (e[2] >= 0.0f);
  if (ZCLIP) cov = cov && (e[3] >= 0.0f) && (e[3] <= 1.0f);
  const unsigned zq =
      (unsigned)__float2int_rz(__fmul_rn(e[3], (float)Z_LEVELS));
  const int key = (int)((zq << IDX_BITS) + (unsigned)slot);
  if (cov) best = min(best, key);
}

// The keys of this lane's triangles 4k + q (k = 0..3) of product j
// (slots 16 j ..) of a stage at its two pixels, kept in best0 (row g) and
// best1 (row g + 8); slots past the stage are NaN columns and never cover.
template <bool ZCLIP>
__device__ __forceinline__ void product_keys(const float d[32], int j,
                                             int base, int q, int& best0,
                                             int& best1) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int slot = base + 16 * j + 4 * k + q;
    float e[4];
    lane_planes(d, k, 0, e);
    key_min<ZCLIP>(e, slot, best0);
    lane_planes(d, k, 1, e);
    key_min<ZCLIP>(e, slot, best1);
  }
}

// The MMA walk of one stage: slots base .. base + n - 1 of a run, their
// affine rows in rows.  The block builds the stage's B operands (one
// thread a (slot, plane), NaN columns up to a multiple of 16 slots); each
// warpgroup takes every WARPGROUPS-th group of 64 pixels and multiplies
// it by each operand of 16 triangles, and each lane keys its triangles
// 4k + q at its two pixels; the quad's minimum goes to s_best[p] (kept
// as the minimum over the stages of a run when not first), by lane q = 0
// for row g and q = 1 for row g + 8.  Pixels of a group past P are
// computed and not stored.
template <bool ZCLIP>
__device__ __forceinline__ void mma_stage(const float (*rows)[ROW_W], int n,
                                          int base, bool first, int ox,
                                          int oy, int tile_w, int P, int mxu,
                                          unsigned char* s_b, int* s_best) {
  const int n16 = (n + 15) & ~15;
  for (int i = threadIdx.x; i < 4 * n16; i += THREADS)
    build_b(rows[i >> 2], i >> 2, i & 3, (i >> 2) < n, mxu, s_b);
  fence_proxy_async();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int p_lane = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const uint64_t desc = b_desc(s_b);
  constexpr int STEP = B_OPERAND >> 4;   // one operand, in the descriptor
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  for (int pg = threadIdx.x >> 7; pg * GROUP_PX < P; pg += WARPGROUPS) {
    const int p0 = pg * GROUP_PX + p_lane;
    unsigned a[4];
    a_frag(p0, ox, oy, tile_w, mxu, a);
    int best0 = SKY_KEY, best1 = SKY_KEY;
    for (int j = 0; 16 * j < n; ++j) {
      wgmma_64x64(d, a, desc + (uint64_t)(j * STEP));
      product_keys<ZCLIP>(d, j, base, q, best0, best1);
    }
    best0 = min(best0, __shfl_xor_sync(FULL, best0, 1));
    best0 = min(best0, __shfl_xor_sync(FULL, best0, 2));
    best1 = min(best1, __shfl_xor_sync(FULL, best1, 1));
    best1 = min(best1, __shfl_xor_sync(FULL, best1, 2));
    const int p = p0 + 8 * (q & 1);
    const int v = q & 1 ? best1 : best0;
    if (q < 2 && p < P) s_best[p] = first ? v : min(s_best[p], v);
  }
}

// Slot of this thread's pixel q of a tile: threadIdx.x + q THREADS
// (row-major), or with BOX (K5, K2a at tiles BOX_TILE_W wide) pixel (lane %
// 16, lane / 16 + 2 q) of its warp's strip of the BOX_W columns from
// BOX_W warp, every row (16x16 boxes at 128x16): P where that row is
// past the tile.  With BOX a thread's pixels share their column, so its
// x is one register.
template <bool BOX>
__device__ __forceinline__ int pixel_slot(int q, int tile_h) {
  if (!BOX) return threadIdx.x + q * THREADS;
  const int y = ((threadIdx.x & 31) >> 4) + 2 * q;
  return y < tile_h
             ? y * BOX_TILE_W + (threadIdx.x >> 5) * BOX_W + (threadIdx.x & 15)
             : BOX_TILE_W * tile_h;
}

// Blocks an SM the register budget is cut for, chosen by timing on an
// H100 (PERF.md).  FMA walk: 5 at up to 4 pixels a thread (48 registers;
// 6, at 40, spilled K1's epilogue and ran no faster on the card, 4 no
// faster either), 4 at 8 (64 registers).  MMA walk: 3 at up to 8 (80
// registers, no spill; 4 ran 128x16 tiles faster one frame a launch but
// spilled K1-mxu's, 2 ran no faster), 2 at 16.  K5 over bins at 16
// pixels a thread without its warp boxes (tiles over 2048 pixels and
// not 128 wide, no entry's default) spilled at 2 (128 registers): 1, and
// so K2a, whose epilogue is K5's, there too.  K6 at 8 pixels a thread
// (tiles of 1025-2048 pixels, not its entry's 32x32) spilled at 4 (64
// registers): 3.
template <int PPT, int EPI, int WALKER, int SRC, bool BOX>
constexpr int split_min_blocks() {
  if (WALKER == WALK_MMA) return PPT <= 8 ? 3 : 2;
  if (EPI == KEYS_F32 && !BOX && PPT > 8) return 1;
  if (SRC == ROWS && PPT == 8) return 3;
  return PPT <= 4 ? 5 : PPT <= 8 ? 4 : 2;
}

// The plan's split flag and item count, read again from its counters
// where a kernel keeps neither in a register through the walk (K2b's and
// K6's: see tile_raster_split_kernel).
__device__ __forceinline__ bool plan_split(const Plan& pl) {
  return *(const volatile int*)(pl.counters + 2) != 0;
}

__device__ __forceinline__ int plan_items(const Plan& pl) {
  return *(const volatile int*)(pl.counters + 1);
}

// The persistent split walk: blocks claim one item at a time, or with
// GRAIN wf consecutive items, and walk them in list order; while a block
// walks one item, the rows of the next are in flight to the other shared
// buffer.  Each thread keeps only its pixels' best keys (the MMA walk's
// pass through s_best).  A tile of one item runs its epilogue at once;
// the items of a long tile merge their keys into the tile's output row
// with atomicMin, and the last to finish (its arrival counter, after
// __threadfence) runs the epilogue.  GRAIN is a template parameter so
// that K1 and K3 (one item a claim) keep no claim's bounds in registers:
// at their 48-register budget the runtime grain's two registers spilled
// and slowed them on an H100 (PERF.md).  SRC is the row source (PAIRS:
// K1, K3, K2b, K2a and their variants; BINS: K5; ROWS: K6), BOX the
// warp boxes and cull of K5 and K2a (pixel_slot, fma_stage); K1 and K3
// compile without either.  K2b's and K6's kernels (LEAN) keep nothing of the claim in
// registers through the walk: the split flag is read again for each
// item, and the next claim, its item and the item count after the walk
// (s_claim, the list, the plan's counters; a load or two an item).  At
// 48 registers (4 pixels a thread) their epilogues spilled otherwise;
// K1's, K3's and K5's kernels keep them, as they were timed (PERF.md).
template <int PPT, bool ZCLIP, int EPI, int WALKER, bool GRAIN, int SRC,
          bool BOX>
__global__ void __launch_bounds__(THREADS,
                                  split_min_blocks<PPT, EPI, WALKER, SRC, BOX>())
tile_raster_split_kernel(const Walk w, const Epi ep, const Plan pl,
                         const int wf) {
  constexpr bool MMA = WALKER == WALK_MMA;
  constexpr int COLS = MMA ? ROW_W : STAGE_COLS;
  constexpr bool LEAN = EPI == TEX_IDX || SRC == ROWS;
  __shared__ __align__(128) float s_rows[2][SEG][COLS];
  __shared__ __align__(128) unsigned char s_b[MMA ? SEG / 16 * B_OPERAND : 16];
  __shared__ int s_best[MMA ? PPT * THREADS : 1];
  __shared__ int s_claim[2];
  __shared__ int s_last;
  const int n_items = pl.counters[1];
  const bool split = pl.counters[2] != 0;
  const int P = w.tile_w * w.tile_h;
  const int bgp = sky_value<EPI>(ep);

  int end = 0;   // GRAIN, thread 0: the end of its block's claim
  if (threadIdx.x == 0) {
    s_claim[0] = atomicAdd(pl.counters, GRAIN ? wf : 1);
    if constexpr (GRAIN) end = s_claim[0] + wf;
  }
  __syncthreads();
  int cur = s_claim[0];
  if (cur >= n_items) return;
  int2 it = pl.items[cur];
  {
    int lo, hi, k;
    item_range<SRC>(w, LEAN ? plan_split(pl) : split, it.x, it.y, lo, hi,
                    k);
    stage_rows<COLS, SRC>(w, it.x, lo, max(0, min(hi - lo, SEG)),
                          s_rows[0]);
  }
  for (int turn = 1, buf = 0;; ++turn, buf ^= 1) {
    if (threadIdx.x == 0) {
      int nxt = cur + 1;
      if (!GRAIN || nxt >= end) {   // the claim is walked: claim the next
        nxt = atomicAdd(pl.counters, GRAIN ? wf : 1);
        if constexpr (GRAIN) end = nxt + wf;
      }
      s_claim[turn & 1] = nxt;
    }
    cp_async_wait_all();
    __syncthreads();  // this item's rows are in; the other buffer is free
    const int nxt = s_claim[turn & 1];
    int2 nit = make_int2(0, 0);
    if (nxt < n_items) {
      nit = pl.items[nxt];
      int lo, hi, k;
      item_range<SRC>(w, LEAN ? plan_split(pl) : split, nit.x, nit.y, lo,
                      hi, k);
      stage_rows<COLS, SRC>(w, nit.x, lo, max(0, min(hi - lo, SEG)),
                            s_rows[buf ^ 1]);
    }

    const int b = it.x;
    int lo, hi, k;
    item_range<SRC>(w, LEAN ? plan_split(pl) : split, b, it.y, lo, hi,
                    k);
    const int t = b % w.nt;
    const int ox = (t % w.ntx) * w.tile_w;
    const int oy = (t / w.ntx) * w.tile_h;
    float px[PPT], py[PPT];   // the FMA walk's (the MMA walk's: below)
    int best[PPT];
    float box[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // BOX: this warp's box
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      if constexpr (BOX) {
        px[q] = (float)(ox + (threadIdx.x >> 5) * BOX_W + (threadIdx.x & 15));
        py[q] = (float)(oy + ((threadIdx.x & 31) >> 4) + 2 * q);
      } else {
        const int p = threadIdx.x + q * THREADS;
        px[q] = (float)(ox + p % w.tile_w);
        py[q] = (float)(oy + p / w.tile_w);
      }
      best[q] = SKY_KEY;
    }
    if constexpr (BOX) {
      const int x0 = ox + (threadIdx.x >> 5) * BOX_W;
      box[0] = (float)x0;
      box[1] = (float)(x0 + BOX_W - 1);
      box[2] = (float)oy;
      box[3] = (float)(oy + w.tile_h - 1);
    }
    // an item holds at most SEG slots unless the split is off
    for (int base = lo, n = max(0, min(hi - lo, SEG)); n > 0;) {
      if constexpr (MMA)
        mma_stage<ZCLIP>(s_rows[buf], n, base, base == lo, ox, oy, w.tile_w,
                         P, ep.mxu, s_b, s_best);
      else
        fma_stage<PPT, ZCLIP, BOX>(s_rows[buf], n, base, px, py, best,
                                   box);
      base += n;
      if (base >= hi) break;
      n = min(hi - base, SEG);
      __syncthreads();  // the buffer is no longer read
      stage_rows<COLS, SRC>(w, b, base, n, s_rows[buf]);
      cp_async_wait_all();
      __syncthreads();
    }
    if constexpr (MMA) {
      __syncthreads();  // every group's keys are in s_best
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int p = threadIdx.x + q * THREADS;
        if (p < P) best[q] = s_best[p];
        // the coordinates only now: not live through the walk
        pixel_xy(p, ox, oy, w.tile_w, px[q], py[q]);
      }
    }

    bool last = k == 1;
    if (!last) {
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int p = pixel_slot<BOX>(q, w.tile_h);
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
          const int p = pixel_slot<BOX>(q, w.tile_h);
          if (p < P) best[q] = __ldcg(ep.out + (size_t)b * P + p);
        }
      }
    }
    if (last) {
      // a run walked in one stage has every winner's row in s_rows
      const bool staged = k == 1 && hi <= SEG;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int p = pixel_slot<BOX>(q, w.tile_h);
        if (p < P) {
          if constexpr (EPI == KEYS_F32)
            split_keys_f32<SRC, COLS>(w, ep, b, p, best[q], px[q], py[q],
                                      k == 1,
                                      staged ? s_rows[buf] : nullptr);
          else
            ep.out[(size_t)b * P + p] = split_value<EPI, MMA, COLS, SRC>(
                w, ep, b, best[q], px[q], py[q], bgp,
                staged ? s_rows[buf] : nullptr);
        }
      }
    }
    if constexpr (LEAN) {
      const int again = s_claim[turn & 1];   // rewritten two turns on
      if (again >= plan_items(pl)) return;
      cur = again;
      it = pl.items[again];
    } else {
      if (nxt >= n_items) return;
      cur = nxt;
      it = nit;
    }
  }
}

// The MMA walk's layout probe: one warpgroup builds the B operand of the
// n (<= 16) affine rows with build_b and A of the tile's first 64 pixels
// (tile at (ox, oy), tile_w wide) with a_frag, as the walk does, runs the
// product and writes what lane_planes reads, out[(p * 16 + t) * 4 +
// plane], for pixel p and triangle t (slots past n: NaN columns).
__global__ void __launch_bounds__(128)
mma_probe_kernel(const float* rows, int n, int ox, int oy, int tile_w,
                 int mxu, float* out) {
  __shared__ __align__(128) float s_rows[16][ROW_W];
  __shared__ __align__(128) unsigned char s_b[B_OPERAND];
  for (int i = threadIdx.x; i < n * ROW_W; i += 128)
    s_rows[i / ROW_W][i % ROW_W] = rows[i];
  __syncthreads();
  if (threadIdx.x < 64)
    build_b(s_rows[threadIdx.x >> 2], threadIdx.x >> 2, threadIdx.x & 3,
            (threadIdx.x >> 2) < n, mxu, s_b);
  fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int p0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  unsigned a[4];
  a_frag(p0, ox, oy, tile_w, mxu, a);
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  wgmma_64x64(d, a, b_desc(s_b));
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float e[4];
      lane_planes(d, k, h, e);
      const int tri = 4 * k + (lane & 3);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[((p0 + 8 * h) * 16 + tri) * 4 + c] = e[c];
    }
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

// The split walk: the plan, then the persistent walk, its grid at most
// the blocks the card holds at once and never more than ceil(cap / wf),
// the claims the longest list could fill.
template <int EPI, int PPT, bool ZC, int WALKER, bool GRAIN, int SRC,
          bool BOX>
cudaError_t launch_split_n(int nblocks, const Walk& w, const Epi& ep,
                           const Plan& pl, int wf, cudaStream_t s) {
  const auto kernel =
      tile_raster_split_kernel<PPT, ZC, EPI, WALKER, GRAIN, SRC, BOX>;
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
  split_plan_kernel<SRC, EPI><<<min(nblocks, 4 * sms), THREADS, 0, s>>>(
      w, pl, ep, nblocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<min((pl.cap + wf - 1) / wf, resident), THREADS, 0, s>>>(w, ep, pl,
                                                                 wf);
  return cudaGetLastError();
}

template <int EPI, bool ZC, int WALKER, bool GRAIN, int SRC = PAIRS,
          bool BOX = false>
cudaError_t launch_split_z(int nblocks, const Walk& w, const Epi& ep,
                           const Plan& pl, int wf, cudaStream_t s) {
#define SPLIT_N(N)                                                   \
  launch_split_n<EPI, N, ZC, WALKER, GRAIN, SRC, BOX>(nblocks, w, ep, pl, \
                                                     wf, s)
  switch (fma_ppt(w.tile_w * w.tile_h)) {
    case 1: return SPLIT_N(1);
    case 2: return SPLIT_N(2);
    case 4: return SPLIT_N(4);
    case 8: return SPLIT_N(8);
    default: return SPLIT_N(16);
  }
#undef SPLIT_N
}

template <int EPI, bool GRAIN>
cudaError_t launch_split_g(int nblocks, bool z_clip, const Walk& w,
                           const Epi& ep, const Plan& pl, int wf,
                           cudaStream_t s) {
#define SPLIT_Z(Z, W) \
  launch_split_z<EPI, Z, W, GRAIN>(nblocks, w, ep, pl, wf, s)
  return ep.mxu
             ? (z_clip ? SPLIT_Z(true, WALK_MMA) : SPLIT_Z(false, WALK_MMA))
             : (z_clip ? SPLIT_Z(true, WALK_FMA) : SPLIT_Z(false, WALK_FMA));
#undef SPLIT_Z
}

// The FMA walk (ep.mxu 0) or the MMA walk (ep.mxu 1 or 2, an affine
// table) with epilogue EPI, wf items a claim (only K1's epilogue takes
// wf > 1, K1-wf); over BINS (K5) the FMA walk with the z test, with K5's
// warp boxes and cull at tiles BOX_TILE_W wide (the production shapes,
// 128x16 and 128x32), without them at other widths; over ROWS (K6) the
// FMA walk without the z test; TEX_IDX (K2b) the FMA walk; KEYS_F32 over
// PAIRS (K2a) the FMA walk, the z test on or off, with the warp boxes and
// cull at tiles BOX_TILE_W wide (each of its main paths' shapes).  Only
// those kernels are instantiated; any other request is refused.
template <int EPI, int SRC = PAIRS>
int launch_split(int nblocks, int z_clip, const Walk& w, const Epi& ep,
                 const Plan& pl, int wf, void* stream) {
  if (const int e = check<EPI, SRC>(w, ep, nblocks)) return e < 0 ? 0 : e;
  if (pl.items == nullptr || pl.counters == nullptr || pl.cap < nblocks ||
      wf < 1 || (EPI != U8_GOURAUD && wf != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (SRC == BINS) {
    if (!z_clip || ep.mxu) return (int)cudaErrorInvalidValue;
    if (w.tile_w == BOX_TILE_W)   // warp boxes and the cull
      return (int)launch_split_z<EPI, true, WALK_FMA, false, BINS, true>(
          nblocks, w, ep, pl, 1, s);
    return (int)launch_split_z<EPI, true, WALK_FMA, false, BINS, false>(
        nblocks, w, ep, pl, 1, s);
  } else if constexpr (SRC == ROWS) {
    if (z_clip || ep.mxu || wf != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_split_z<EPI, false, WALK_FMA, false, ROWS>(
        nblocks, w, ep, pl, 1, s);
  } else if constexpr (EPI == TEX_IDX) {
    if (ep.mxu) return (int)cudaErrorInvalidValue;
    return (int)(z_clip ? launch_split_z<EPI, true, WALK_FMA, false>(
                              nblocks, w, ep, pl, 1, s)
                        : launch_split_z<EPI, false, WALK_FMA, false>(
                              nblocks, w, ep, pl, 1, s));
  } else if constexpr (EPI == KEYS_F32) {
    if (ep.mxu) return (int)cudaErrorInvalidValue;
#define K2A(Z, BOX) \
  launch_split_z<EPI, Z, WALK_FMA, false, PAIRS, BOX>(nblocks, w, ep, pl, 1, s)
    if (w.tile_w == BOX_TILE_W)   // warp boxes and the cull
      return (int)(z_clip ? K2A(true, true) : K2A(false, true));
    return (int)(z_clip ? K2A(true, false) : K2A(false, false));
#undef K2A
  } else {
    if constexpr (EPI == U8_GOURAUD)
      if (wf > 1)
        return (int)launch_split_g<EPI, true>(nblocks, z_clip != 0, w, ep,
                                              pl, wf, s);
    return (int)launch_split_g<EPI, false>(nblocks, z_clip != 0, w, ep, pl,
                                           1, s);
  }
}

// Registers a thread and resident blocks an SM of a kernel.
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

// Registers and resident blocks an SM of the split walk's kernel at
// tiles of P pixels, without a claim grain.  Instantiate only what
// launch_split instantiates.
template <int EPI, int WALKER, int SRC, bool ZC, bool BOX>
int occupancy_n(int P, int* regs) {
#define OCC(N)                                                          \
  return blocks_per_sm(                                                 \
      tile_raster_split_kernel<N, ZC, EPI, WALKER, false, SRC, BOX>, regs)
  switch (fma_ppt(P)) {
    case 1: OCC(1);
    case 2: OCC(2);
    case 4: OCC(4);
    case 8: OCC(8);
    default: OCC(16);
  }
#undef OCC
}

template <int EPI, int WALKER, int SRC, bool BOX>
int occupancy_z(bool z_clip, int P, int* regs) {
  return z_clip ? occupancy_n<EPI, WALKER, SRC, true, BOX>(P, regs)
                : occupancy_n<EPI, WALKER, SRC, false, BOX>(P, regs);
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
// (B * ids_len) / SEG for the split to be on; K6: B * nt + (B * nrows) /
// SEG), counters (3 + nblocks ints); none needs to be initialised.
#define SPLIT_ARGS int *items, int cap, int *counters
#define PLAN {reinterpret_cast<int2*>(items), cap, counters}

// K1, K1-wf and K1-mxu: out (B * nt, P) packed u8 RGBA, rows from sorted
// pairs, through the split walk (two launches: the plan, the walk), wf
// items a claim (K1: 1); mxu 1 or 2 walks an affine table on the tensor
// cores (K1-mxu), 0 the edge table on the CUDA cores.
int tile_raster_u8(WALK_ARGS, const int* packed_bg, int opaque, int mxu,
                   int wf, int* out, SPLIT_ARGS, void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, opaque, nullptr, 0, 0, out, nullptr, mxu};
  const Plan pl = PLAN;
  return launch_split<U8_GOURAUD>(nblocks, z_clip, w, ep, pl, wf, stream);
}

// K3 and, with mxu 1 or 2 over an affine textured table, its MMA walk:
// out (B * nt, P) packed u8 texels of the (tex_h x tex_w) packed texture,
// through the split walk.
int tile_raster_tex_u8(WALK_ARGS, const int* tex, int tex_w, int tex_h,
                       const int* packed_bg, int mxu, int* out, SPLIT_ARGS,
                       void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, 0, tex, tex_w, tex_h, out, nullptr, mxu};
  const Plan pl = PLAN;
  return launch_split<TEX_U8>(nblocks, z_clip, w, ep, pl, 1, stream);
}

// Registers (*regs) and resident blocks an SM (returned; negative: a
// cudaError_t) of the kernel that a launch at tiles of tile_w x tile_h
// pixels runs, for each walk (its name in ops/_kernels.py's WALKS; the
// z test as z_clip):
int tile_raster_occupancy(int walk, int tex, int tile_w, int tile_h,
                          int z_clip, int* regs) {
  const int P = tile_w * tile_h;
  const bool zc = z_clip != 0, box = tile_w == BOX_TILE_W;
  switch (walk) {
    case 0:  // "split FMA": K1's (tex: K3's) split walk, the CUDA cores
      return tex ? occupancy_z<TEX_U8, WALK_FMA, PAIRS, false>(zc, P, regs)
                 : occupancy_z<U8_GOURAUD, WALK_FMA, PAIRS, false>(zc, P,
                                                                   regs);
    case 1:  // "split MMA": K1-mxu's (tex: K3's mxu walk), the tensor cores
      return tex ? occupancy_z<TEX_U8, WALK_MMA, PAIRS, false>(zc, P, regs)
                 : occupancy_z<U8_GOURAUD, WALK_MMA, PAIRS, false>(zc, P,
                                                                   regs);
    case 2:  // "split bins": K5's (the z test on; tex, z_clip not read)
      return box ? occupancy_n<KEYS_F32, WALK_FMA, BINS, true, true>(P, regs)
                 : occupancy_n<KEYS_F32, WALK_FMA, BINS, true, false>(P,
                                                                      regs);
    case 3:  // "split pairs f32": K2a's (tex not read)
      return box ? occupancy_z<KEYS_F32, WALK_FMA, PAIRS, true>(zc, P, regs)
                 : occupancy_z<KEYS_F32, WALK_FMA, PAIRS, false>(zc, P,
                                                                 regs);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

// K2b: out (B * nt, P) texel indices, -1 for sky, through the split walk
// (two launches: the plan, the walk).
int tile_raster_tex_idx(WALK_ARGS, int tex_w, int tex_h, int* out,
                        SPLIT_ARGS, void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, tex_w, tex_h, out, nullptr, 0};
  const Plan pl = PLAN;
  return launch_split<TEX_IDX>(nblocks, z_clip, w, ep, pl, 1, stream);
}

// K2a: keys (B * nt, P) int32 and rgba (B * nt, 4, P) float32, rows
// from sorted pairs, through the split walk with K5's warp boxes and
// cull at tiles BOX_TILE_W wide (two launches: the plan, the walk).
int tile_raster_keys_f32(WALK_ARGS, int* keys, float* rgba, SPLIT_ARGS,
                         void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, 0, 0, keys, rgba, 0};
  const Plan pl = PLAN;
  return launch_split<KEYS_F32>(nblocks, z_clip, w, ep, pl, 1, stream);
}

// K5: K2a's outputs, rows from bins (ids (B * nt, K), starts unused),
// through the split walk with K5's warp boxes and cull (two launches:
// the plan, the walk); z_clip must be 1.
int tile_raster_bins_f32(WALK_ARGS, int* keys, float* rgba, SPLIT_ARGS,
                         void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, 0, 0, keys, rgba, 0};
  const Plan pl = PLAN;
  return launch_split<KEYS_F32, BINS>(nblocks, z_clip, w, ep, pl, 1, stream);
}

// K6: K1's output, rows pre-gathered in pair order (table (B, nrows, 32),
// ids unused), through the split walk (two launches: the plan, the
// walk); z_clip must be 0.
int tile_raster_rows_u8(WALK_ARGS, const int* packed_bg, int opaque,
                        int* out, SPLIT_ARGS, void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, opaque, nullptr, 0, 0, out, nullptr, 0};
  const Plan pl = PLAN;
  return launch_split<U8_GOURAUD, ROWS>(nblocks, z_clip, w, ep, pl, 1,
                                        stream);
}

// The MMA walk's layout probe (mma_probe_kernel), which chip_smoke.py
// runs before any walk (its plain version: testing.mma_probe_plain):
// rows (n <= 16, 32) float32 affine rows, out (64, 16, 4) float32.
int tile_raster_mma_probe(const float* rows, int n, int ox, int oy,
                          int tile_w, int mxu, float* out, void* stream) {
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return (int)pending;
  if (n < 1 || n > 16 || tile_w < 1 || mxu < 1 || mxu > 2)
    return (int)cudaErrorInvalidValue;
  mma_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(rows, n, ox, oy,
                                                       tile_w, mxu, out);
  return (int)cudaGetLastError();
}

const char* tile_raster_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
