// Kernels K1, K3, K2b and K2a: per-tile triangle visibility, then one of
// four epilogues on the winner.
//
// Replaces the TPU kernel pallas_raster._make_kernel_flat
// (libnativecpurenderer_tpu/ops/pallas_raster.py:125-600) as its
// launchers use it:
//   U8_GOURAUD (K1)  u8=True, raster_tiles_flat (:793), epilogue :566-596;
//   TEX_U8     (K3)  tex_resolve=True, raster_tiles_tex (:895), epilogue
//                    :375-565, with raster3d._tex_resolve_finish after it;
//   TEX_IDX    (K2b) tex_dims, raster_tiles_flat (:793), epilogue :356-374;
//   KEYS_F32   (K2a) the f32 branch, raster_tiles_flat (:805), epilogue
//                    :597-599.
// Plain versions and wrappers: ops/tile_raster.py (raster_tiles_*).
//
// The walk.  For tile t, pixel slot p at integer coordinates
// (ox + p % tile_w, oy + p / tile_w): walk the tile's run of the sorted
// pair array, slots j = 0 .. counts[t]-1, triangle
// sorted_pad[starts[t] + j] & IDX_MASK, row table[tri] (32 floats).
// e_i = (A_i x + B_i y) + C_i; covered iff e0, e1, e2 >= 0 (and
// 0 <= zz <= 1 with z_clip); zz = (e0 zsc0 + e1 zsc1) + e2 zsc2;
// key = (trunc(zz * 8191) << 18) | j; the strict running minimum keeps
// the lower slot on a tie.  The winner's attribute d is
// (e0 a0d + e1 a1d) + e2 a2d.
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
// never through fminf, which would drop a NaN.  The TPU kernel's chunk
// walk also read up to kcc-1 slots past the run (spilling into the next
// tile's run); those can only lose ties, since a triangle covering a
// pixel of tile t sits in t's own run at a lower slot, so walking
// exactly counts[t] slots gives the same winner.  No TPU block windows
// are needed: the run is read straight from the sorted array.
//
// What bounds it on an H100.  At the 1080p production shape (2040 tiles
// of 32x32, 10k triangles) the binning emits ~26k (tile, triangle)
// pairs a frame, so the walk is ~27M pixel-triangle tests of ~26
// separate operations, ~0.7e9 operations (0.021 ms at 33.5 T/s without
// fused multiply-adds), against a 1.3 MB table and an 8.4 MB output
// (0.003 ms at 3.35 TB/s).  The epilogues add ~10 (K1) to ~20 (K3)
// operations and one output word (K2a: five) a pixel.  K1 measured
// ~0.1 ms a frame, ~0.2 of the operations bound.  The runs are skewed
// (the longest holds ~220-250 triangles against a mean of ~13), so the
// suspected bound is the tail of blocks that walk the longest runs.
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
constexpr int ATTR_COL = 14;    // vertex i, attribute d at ATTR_COL + 4 i + d
constexpr int D = 4;
constexpr int THREADS = 256;
constexpr int CHUNK = 32;       // triangle rows staged per pass

enum Epilogue { U8_GOURAUD, TEX_U8, TEX_IDX, KEYS_F32 };

// The run and its rows: what every epilogue walks.
struct Walk {
  const int* sorted_pad;
  int spad;
  const int* starts;
  const int* counts;
  const float* table;
  int nrows;
  int ntx, tile_w, tile_h;
};

// An epilogue's inputs and outputs; the fields it does not use are 0.
struct Epi {
  const int* packed_bg;
  int opaque;
  const int* tex;
  int tex_w, tex_h;
  int* out;       // packed u8, texel index or key: (nt, P)
  float* rgba;    // KEYS_F32: (nt, D, P)
};

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

template <int PPT, bool ZCLIP, int EPI>
__global__ void __launch_bounds__(THREADS)
tile_raster_kernel(const Walk w, const Epi ep) {
  __shared__ float s_rows[CHUNK][WALK_COLS];
  __shared__ int s_tri[CHUNK];

  const int t = blockIdx.x;
  const int P = w.tile_w * w.tile_h;
  const int ox = (t % w.ntx) * w.tile_w;
  const int oy = (t / w.ntx) * w.tile_h;
  const int start = w.starts[t];
  const int count = w.counts[t];

  float px[PPT], py[PPT], be0[PPT], be1[PPT], be2[PPT];
  int best[PPT], btri[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    px[k] = (float)(ox + p % w.tile_w);
    py[k] = (float)(oy + p / w.tile_w);
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
      const int slot = min(start + base + r, w.spad - 1);
      const int tri = min(w.sorted_pad[slot] & IDX_MASK, w.nrows - 1);
      s_rows[r][c] = w.table[(size_t)tri * ROW_W + c];
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

  const int bgp = (EPI == U8_GOURAUD || EPI == TEX_U8) ? *ep.packed_bg : 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    if (p >= P) break;
    const size_t o = (size_t)t * P + p;
    const bool hit = best[k] != SKY_KEY;
    const float* a = w.table + (size_t)btri[k] * ROW_W + ATTR_COL;
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
        ep.rgba[((size_t)t * D + d) * P + p] =
            hit ? attr(a, be0[k], be1[k], be2[k], d) : 0.0f;
    }
  }
}

template <int EPI, int PPT>
cudaError_t launch_ppt(int nt, bool z_clip, const Walk& w, const Epi& ep,
                       cudaStream_t s) {
  if (z_clip)
    tile_raster_kernel<PPT, true, EPI><<<nt, THREADS, 0, s>>>(w, ep);
  else
    tile_raster_kernel<PPT, false, EPI><<<nt, THREADS, 0, s>>>(w, ep);
  return cudaGetLastError();
}

// Launches epilogue EPI over nt tiles on `stream`; returns the
// cudaError_t of the launch (0 on success).  An error left pending by an
// earlier launch is returned without launching, so the caller raises it;
// an out-of-range size returns cudaErrorInvalidValue without launching.
template <int EPI>
int launch(int nt, int z_clip, const Walk& w, const Epi& ep, void* stream) {
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return (int)pending;
  if (nt == 0) return 0;
  const int P = w.tile_w * w.tile_h;
  if (P <= 0 || w.spad <= 0 || w.nrows <= 0 || w.ntx <= 0)
    return (int)cudaErrorInvalidValue;
  if ((EPI == TEX_U8 || EPI == TEX_IDX) && (ep.tex_w <= 0 || ep.tex_h <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool zc = z_clip != 0;
  const int ppt = (P + THREADS - 1) / THREADS;
  if (ppt <= 1) return (int)launch_ppt<EPI, 1>(nt, zc, w, ep, s);
  if (ppt <= 2) return (int)launch_ppt<EPI, 2>(nt, zc, w, ep, s);
  if (ppt <= 4) return (int)launch_ppt<EPI, 4>(nt, zc, w, ep, s);
  if (ppt <= 8) return (int)launch_ppt<EPI, 8>(nt, zc, w, ep, s);
  if (ppt <= 16) return (int)launch_ppt<EPI, 16>(nt, zc, w, ep, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every entry takes the walk's arguments first: the sorted pair array
// (spad int32), the runs' starts and counts (nt each), the row table
// (nrows x 32 float32), tiles a row of the frame, the tile size and
// z_clip; then its epilogue's; then the stream.
#define WALK_ARGS                                                       \
  const int *sorted_pad, int spad, const int *starts, const int *counts, \
      int nt, const float *table, int nrows, int ntx, int tile_w,        \
      int tile_h, int z_clip
#define WALK {sorted_pad, spad, starts, counts, table, nrows, ntx, tile_w, \
              tile_h}

extern "C" {

// K1: out (nt, P) packed u8 RGBA.
int tile_raster_u8(WALK_ARGS, const int* packed_bg, int opaque, int* out,
                   void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, opaque, nullptr, 0, 0, out, nullptr};
  return launch<U8_GOURAUD>(nt, z_clip, w, ep, stream);
}

// K3: out (nt, P) packed u8 texels of the (tex_h x tex_w) packed texture.
int tile_raster_tex_u8(WALK_ARGS, const int* tex, int tex_w, int tex_h,
                       const int* packed_bg, int* out, void* stream) {
  const Walk w = WALK;
  const Epi ep = {packed_bg, 0, tex, tex_w, tex_h, out, nullptr};
  return launch<TEX_U8>(nt, z_clip, w, ep, stream);
}

// K2b: out (nt, P) texel indices, -1 for sky.
int tile_raster_tex_idx(WALK_ARGS, int tex_w, int tex_h, int* out,
                        void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, tex_w, tex_h, out, nullptr};
  return launch<TEX_IDX>(nt, z_clip, w, ep, stream);
}

// K2a: keys (nt, P) int32 and rgba (nt, 4, P) float32.
int tile_raster_keys_f32(WALK_ARGS, int* keys, float* rgba, void* stream) {
  const Walk w = WALK;
  const Epi ep = {nullptr, 0, nullptr, 0, 0, keys, rgba};
  return launch<KEYS_F32>(nt, z_clip, w, ep, stream);
}

const char* tile_raster_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
