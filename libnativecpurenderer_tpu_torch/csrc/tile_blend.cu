// Kernel K7: textured triangles alpha-blended in draw order over each
// tile's run, z-tested against an opaque depth map, to packed u8 RGBA.
//
// Replaces no TPU kernel.  The JAX package draws BASELINE config 2
// ("textured quad batch with alpha blending + z-test at 1280x720") with
// raster3d.render_blended (raster3d.py:1575-1623 there), a scan over the
// triangles of full-frame XLA ops; the port's counterpart of that scan,
// raster3d.render_blended, stays as the per-triangle plain path.
// Wrapper and plain version: ops/tile_raster.py (raster_tiles_blend_u8,
// raster_tiles_blend_u8_reference); the prep: raster3d.
// prepare_blended_frame.
//
// What it computes.  Block b walks tile t = b % nt of frame f = b / nt.
// Its run is sorted_pad[f * ids_len + starts[b] ...][0 .. counts[b]),
// each id the low IDX_BITS of a packed (tile << 18) | step key, where
// step is the triangle's place in the frame's draw order (back to
// front), so the binning's sort lists a run in draw order.  Slot j's
// row is table row order[f * n_faces + step] of frame f (the face drawn
// at that step; the NaN pad row for a step past the faces).  Pixel slot
// p of the tile sits at (ox + p % tile_w, oy + p / tile_w) and starts at
// bg.  For each slot in run order:
//   e_i' = (A_i' x + B_i' y) + C_i' (sign folded); covered iff all >= 0;
//   w_i = e_i' (sign inv_area), which is e_i inv_area to the bit;
//   z = (w0 z0 + w1 z1) + w2 z2; drawn iff covered and
//     0 <= z <= depth[y * width + x] (a slot outside the frame: never);
//   u, v the same sums of the vertex (u, v); ui = clamp(trunc(u tw), 0,
//     tw - 1), vi likewise; the texel's channels c / 255 (IEEE);
//   rgb = rgb (1 - a) + texel a, alpha = max(alpha, a).
// Then each channel is quantised clip(v * 255, 0, 255) truncated and
// packed r | g << 8 | b << 16 | a << 24 into out[b * P + p].
//
// Bits.  Built with -fmad=false; every product and sum is __fmul_rn /
// __fadd_rn in the plain version's order, divisions __fdiv_rn, float ->
// int __float2int_rz (truncation, saturation, NaN -> 0, as
// sampling._to_i32).  Coverage compares each edge with 0, so a NaN row
// (an invalid triangle, the pad row) never covers.  The kernel equals
// its plain version bit for bit.
//
// Design.  A blend is not a minimum: the split walk of
// csrc/tile_raster.cu merges the pieces of a long run by their smallest
// key in any order, which cannot compose an ordered blend.  So one block
// walks a whole run, and the grid is every tile of every frame (B nt
// blocks; the hardware's block scheduler balances them).  Each thread
// owns PPT = ceil(P / 256) pixel slots (p = threadIdx.x + 256 k) and keeps
// their four channels in registers for the whole run.  The run is staged
// CHUNK rows at a time: the rows' faces first, then their 20 columns,
// into shared memory; every thread reads each staged row (a broadcast)
// and tests it at its pixels.  A texel is loaded only for a drawn
// fragment, through the read-only path (256 KiB at 256x256, resident in
// L2).
//
// What bounds it on an H100.  Per (pixel, run slot): the three edges
// (6 multiplies, 6 adds) and three compares; per drawn fragment the
// weights (3 + 1), depth, u and v (5 each), the texel index (~6), the
// unpack and four divides, the blend (~10): ~45 operations.  At the
// BASELINE config 2 cell's shape (4,096 quads, 1280x720, 32x32 tiles)
// the runs hold tens to ~1,700 triangles and a pixel is drawn ~30 times
// on average, so the edge tests outnumber the drawn fragments a few to
// one (PERF.md, the blend roofline).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IDX_BITS = 18;
constexpr int IDX_MASK = (1 << IDX_BITS) - 1;
constexpr int ROW_W = 32;       // the table's row stride (floats)
constexpr int COLS = 20;        // columns a row the walk reads
constexpr int THREADS = 256;
constexpr int CHUNK = 128;      // rows staged at a time

struct Args {
  const int* ids;      // B * ids_len sorted packed pairs
  int ids_len;
  const int* starts;   // B * nt
  const int* counts;   // B * nt
  int nt;
  const float* table;  // B * nrows rows of ROW_W
  int nrows;
  const int* order;    // B * n_faces: the face drawn at each step
  int n_faces;
  int ntx, tile_w, tile_h;
  const float* depth;  // height * width, shared by the frames
  int width, height;
  const int* tex;      // tex_h * tex_w packed texels
  int tex_w, tex_h;
  const float* bg;     // 4
  int* out;            // B * nt * P
};

__device__ __forceinline__ int quant(float v) {
  return __float2int_rz(fminf(fmaxf(__fmul_rn(v, 255.0f), 0.0f), 255.0f));
}

template <int PPT>
__global__ void __launch_bounds__(THREADS)
tile_blend_kernel(const Args a) {
  __shared__ float s_rows[CHUNK * COLS];
  __shared__ int s_face[CHUNK];
  const int b = blockIdx.x;
  const int f = b / a.nt, t = b - f * a.nt;
  const int P = a.tile_w * a.tile_h;
  const int ox = (t % a.ntx) * a.tile_w, oy = (t / a.ntx) * a.tile_h;

  float px[PPT], py[PPT], zmax[PPT], cr[PPT], cg[PPT], cb[PPT], ca[PPT];
  const float bg0 = a.bg[0], bg1 = a.bg[1], bg2 = a.bg[2], bg3 = a.bg[3];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    const int x = ox + p % a.tile_w, y = oy + p / a.tile_w;
    px[k] = (float)x;
    py[k] = (float)y;
    zmax[k] = (p < P && x < a.width && y < a.height)
                  ? a.depth[(long long)y * a.width + x] : -1.0f;
    cr[k] = bg0;
    cg[k] = bg1;
    cb[k] = bg2;
    ca[k] = bg3;
  }

  const int n = a.counts[b];
  const long long id0 = (long long)f * a.ids_len;
  const long long row0 = (long long)f * a.nrows;
  const float ftw = (float)a.tex_w, fth = (float)a.tex_h;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    __syncthreads();              // the last chunk's rows are read
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const int slot = min(a.starts[b] + c0 + i, a.ids_len - 1);
      const int step = a.ids[id0 + slot] & IDX_MASK;
      const int face = step < a.n_faces
                           ? a.order[(long long)f * a.n_faces + step]
                           : a.nrows - 1;
      s_face[i] = min(face, a.nrows - 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m * COLS; i += THREADS) {
      const int r = i / COLS, c = i - r * COLS;
      s_rows[i] = a.table[(row0 + s_face[r]) * ROW_W + c];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float* r = s_rows + j * COLS;
      const float ia = __fmul_rn(r[12], r[13]);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float e0 = __fadd_rn(__fadd_rn(__fmul_rn(r[0], px[k]),
                                             __fmul_rn(r[1], py[k])), r[2]);
        const float e1 = __fadd_rn(__fadd_rn(__fmul_rn(r[3], px[k]),
                                             __fmul_rn(r[4], py[k])), r[5]);
        const float e2 = __fadd_rn(__fadd_rn(__fmul_rn(r[6], px[k]),
                                             __fmul_rn(r[7], py[k])), r[8]);
        if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) continue;
        const float w0 = __fmul_rn(e0, ia), w1 = __fmul_rn(e1, ia),
                    w2 = __fmul_rn(e2, ia);
        const float z = __fadd_rn(__fadd_rn(__fmul_rn(w0, r[9]),
                                            __fmul_rn(w1, r[10])),
                                  __fmul_rn(w2, r[11]));
        if (!(z >= 0.0f && z <= zmax[k])) continue;
        const float u = __fadd_rn(__fadd_rn(__fmul_rn(w0, r[14]),
                                            __fmul_rn(w1, r[15])),
                                  __fmul_rn(w2, r[16]));
        const float v = __fadd_rn(__fadd_rn(__fmul_rn(w0, r[17]),
                                            __fmul_rn(w1, r[18])),
                                  __fmul_rn(w2, r[19]));
        const int ui = min(max(__float2int_rz(__fmul_rn(u, ftw)), 0),
                           a.tex_w - 1);
        const int vi = min(max(__float2int_rz(__fmul_rn(v, fth)), 0),
                           a.tex_h - 1);
        const int texel = __ldg(a.tex + (long long)vi * a.tex_w + ui);
        const float tr = __fdiv_rn((float)(texel & 255), 255.0f);
        const float tg = __fdiv_rn((float)((texel >> 8) & 255), 255.0f);
        const float tb = __fdiv_rn((float)((texel >> 16) & 255), 255.0f);
        const float ta = __fdiv_rn((float)((texel >> 24) & 255), 255.0f);
        const float keep = __fsub_rn(1.0f, ta);
        cr[k] = __fadd_rn(__fmul_rn(cr[k], keep), __fmul_rn(tr, ta));
        cg[k] = __fadd_rn(__fmul_rn(cg[k], keep), __fmul_rn(tg, ta));
        cb[k] = __fadd_rn(__fmul_rn(cb[k], keep), __fmul_rn(tb, ta));
        ca[k] = fmaxf(ca[k], ta);
      }
    }
  }

  int* out = a.out + (long long)b * P;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    if (p < P)
      out[p] = quant(cr[k]) | (quant(cg[k]) << 8) | (quant(cb[k]) << 16) |
               (quant(ca[k]) << 24);
  }
}

template <int PPT>
void launch(int nblocks, const Args& a, cudaStream_t s) {
  tile_blend_kernel<PPT><<<nblocks, THREADS, 0, s>>>(a);
}

}  // namespace

extern "C" {

// K7: out (B * nt, P) packed u8 RGBA, one block a tile (nblocks = B * nt).
int tile_blend_u8(const int* ids, int ids_len, const int* starts,
                  const int* counts, int nblocks, int nt, const float* table,
                  int nrows, const int* order, int n_faces, int ntx,
                  int tile_w, int tile_h, const float* depth, int width,
                  int height, const int* tex, int tex_w, int tex_h,
                  const float* bg, int* out, void* stream) {
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return (int)pending;
  if (nblocks == 0) return 0;
  const int P = tile_w * tile_h;
  if (P <= 0 || P > 16 * THREADS || nt <= 0 || nblocks % nt != 0 ||
      ids_len <= 0 || nrows <= 0 || n_faces < 0 || ntx <= 0 ||
      width <= 0 || height <= 0 || tex_w <= 0 || tex_h <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a = {ids, ids_len, starts, counts, nt, table, nrows, order,
                  n_faces, ntx, tile_w, tile_h, depth, width, height, tex,
                  tex_w, tex_h, bg, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (P + THREADS - 1) / THREADS;
  if (ppt <= 1) launch<1>(nblocks, a, s);
  else if (ppt <= 2) launch<2>(nblocks, a, s);
  else if (ppt <= 4) launch<4>(nblocks, a, s);
  else if (ppt <= 8) launch<8>(nblocks, a, s);
  else launch<16>(nblocks, a, s);
  return (int)cudaGetLastError();
}

const char* tile_blend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
