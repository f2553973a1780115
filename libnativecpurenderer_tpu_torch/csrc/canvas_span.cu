// Kernel K4: a run of canvas commands applied to the frame.
//
// Replaces the TPU kernel canvas_kernel._make_kernel
// (libnativecpurenderer_tpu/ops/canvas_kernel.py:52), launched by
// render_span_kernel (pl.pallas_call at :286), and the texture blits the
// TPU flush ran through its executor.  Wrapper and plain version:
// ops/canvas_kernel.py (render_span, render_span_reference); the
// per-kind semantics are those of ops/executor.py.
//
// What it computes.  For every pixel (X, Y) of the (H, W, 4) frame, in
// recorded order, each command of the run whose mask admits the pixel
// blends its colour in: rgb = fb*(1-a) + src*a (a raw store for
// SET_COLOR / SET_PIXEL), and the stored alpha is the source alpha (the
// reference quirk, cpp:543-546).  Kinds: NOOP, SET_COLOR, FILL, RECT,
// CIRCLE, LINE, VGRD, SET_PIXEL, APPLY_PIXEL, and the texture blits TEX,
// TEX_FAST and SPLIT_TEX, whose colour is a nearest texel of the
// (AH, AW, 4) atlas; the wrapper refuses HITEFFECT, whose noise shader
// stays in the executor.  Pixel coordinates are the integers X, Y (no
// +0.5).  The inverse-mapped point is (a*X + c*Y) + e, snapped to the
// 2^-20 grid with rint (half to even, as torch.round) times the exact
// 2^-20.  A texel is fetched as the executor's _sample_atlas fetches it:
// u, v clamped with the reference's quirk (below 0: 0; at or above
// size-1: size-2), converted to int32 as XLA converts (truncate,
// saturate, NaN: 0), offset by the region's origin, flattened to
// v * AW + u with int32 wraparound, a negative index counting from the
// end and one out of range reading a NaN texel.
//
// Bits.  Built with -fmad=false and written with the _rn intrinsics, so
// every product, sum, quotient and square root is rounded on its own in
// the plain version's order: the kernel equals render_span_reference bit
// for bit, in float and in double.  Never build it with
// --use_fast_math: IEEE division and sqrt are part of the result.
//
// Design.  One block of 32x8 threads per 32x32 tile of the frame that
// some command of the run may touch; each thread owns one column and 4
// rows of the tile and keeps their RGBA in registers.  Which tiles get a
// block is decided on the host, from the host copy of the params the
// flush already holds (canvas_kernel.touched_tiles: the kernel's own
// `touches` test below, vectorised over the run in the frame's type):
// the wrapper uploads that list with the kinds, in one pinned copy, and
// launches exactly as many blocks; a run with a FILL (every tile) takes
// the whole grid and no list, and a run that touches no tile launches
// nothing.  Chosen over a device-side claim loop because the host
// already holds the params (no sync), the list is exact, and a sparse
// run then costs one small launch: the grid of every tile launched and
// retired ~2,000 idle blocks for a run of 8 small rects (0.016 ms
// against a 0.00035 ms byte bound on an H100, PERF.md).  Every block of
// the grid is thus touched, so it issues its pixels' loads first, one
// 16-byte float4 a pixel (two 16-byte double2 in double; Hopper has no
// 32-byte load), all four in flight together while the run's first
// commands are staged; the stores at the end are 16 bytes a pixel too.
// A texel is one such load too, on the read-only path (__ldg): the
// atlas is not written during the launch.
// Every block walks all commands of the run in order, staged through
// shared memory CHUNK at a time (kind + 32 params in the frame's type),
// and skips a command whose mask cannot meet the tile.  That replaces the
// TPU kernel's per-tile bins (_bin_commands, its (NT, N) argsort and f32
// boxes): skipping a command whose mask is false on the whole tile
// changes nothing.  The test is made in the frame's own type (the JAX
// binning casts boxes to f32, which can round a fractional right edge
// down).  The command is the same for every thread, so branching on its
// kind does not diverge.  The frame is updated in place: no tiled
// layout, no transpose, no copy.  A tile that no command of the run
// touches gets no block, so it is neither read nor written.  Taking the
// blits into the run is what makes a recorded frame of notes and lines
// one launch: on the executor each blit was ~87 torch ops over its
// window.  One body, two kernels: a run with blits (the wrapper passes
// the atlas) takes canvas_span_blit_kernel, one without takes
// canvas_span_kernel, compiled without the blits' code and so as before
// they came in: at the blits' register budget the arithmetic kinds ran
// ~16 % slower on a dense frame on an H100 (3 blocks an SM, not 4).
//
// What bounds it on an H100.  A sparse run (small rects, lines, note
// blits) touches few tiles: its bound is bytes, the touched tiles read
// and written once (16 B a pixel each way in float) plus a texel (16 B)
// for each pixel a blit covers, at 3.35 TB/s.  A dense run (full-frame
// fills, gradients, large rotated shapes or blits) does ~25 float
// operations per covered pixel and command (a blit ~40: the snapped
// point, u and v, the clamps, the index, the colour transform and the
// blend): its bound is operations, covered pixels x commands x ~25 at
// 33.5 T operations/s (float32 outside the tensor cores: the data
// sheet's 67 TFLOP/s counts a fused multiply-add as two, and this kernel
// fuses none).  chip_smoke.py computes both from each run's inputs.
// Nothing here is a matrix product or a large tile copy, so no tensor
// cores or TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PARAM_W = 32;
constexpr int TILE = 32;        // tile width and height
constexpr int TX = 32;          // threads a row (one column each)
constexpr int TY = 8;           // thread rows
constexpr int ROWS = TILE / TY; // pixel rows a thread
constexpr int CHUNK = 32;       // commands staged per pass

enum Kind {
  NOOP = 0, SET_COLOR = 1, FILL = 2, RECT = 3, CIRCLE = 4, LINE = 5,
  VGRD = 6, TEX = 7, TEX_FAST = 8, SPLIT_TEX = 9, SET_PIXEL = 11,
  APPLY_PIXEL = 12
};

// rounded-once arithmetic in the frame's type
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float rint_(float a) { return rintf(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double rint_(double a) { return rint(a); }

template <typename T>
__device__ __forceinline__ T snap(T v) {
  return mul(rint_(mul(v, (T)1048576.0)), (T)(1.0 / 1048576.0));
}

// float -> int32 as XLA converts (raster3d._to_i32): truncate toward
// zero, saturate out of range, NaN -> 0
template <typename T>
__device__ __forceinline__ int to_i32(T x) {
  if (x != x) return 0;
  if (x >= (T)2147483648.0) return 2147483647;
  if (x <= (T)-2147483648.0) return (int)0x80000000u;
  return (int)x;
}

// sampling.clamp_coord: x < 0 -> 0, then x >= size-1 -> size-2
template <typename T>
__device__ __forceinline__ T clamp_coord(T x, T size) {
  if (x < (T)0) x = (T)0;
  return x >= sub(size, (T)1) ? sub(size, (T)2) : x;
}

// The quiet NaN the executor writes for a texel out of range (Python's
// float('nan') in the frame's type)
__device__ __forceinline__ void nan_px(float& r, float& g, float& b,
                                       float& a) {
  r = g = b = a = __int_as_float(0x7fc00000);
}
__device__ __forceinline__ void nan_px(double& r, double& g, double& b,
                                       double& a) {
  r = g = b = a = __longlong_as_double(0x7ff8000000000000ll);
}

// One pixel's RGBA at q (16-byte aligned): one float4 in float, two
// double2 in double.
__device__ __forceinline__ void load_px(const float* q, float& r, float& g,
                                        float& b, float& a) {
  const float4 v = *reinterpret_cast<const float4*>(q);
  r = v.x; g = v.y; b = v.z; a = v.w;
}
__device__ __forceinline__ void load_px(const double* q, double& r,
                                        double& g, double& b, double& a) {
  const double2 u = reinterpret_cast<const double2*>(q)[0];
  const double2 v = reinterpret_cast<const double2*>(q)[1];
  r = u.x; g = u.y; b = v.x; a = v.y;
}
// the same through the read-only path (the atlas)
__device__ __forceinline__ void ldg_px(const float* q, float& r, float& g,
                                       float& b, float& a) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(q));
  r = v.x; g = v.y; b = v.z; a = v.w;
}
__device__ __forceinline__ void ldg_px(const double* q, double& r,
                                       double& g, double& b, double& a) {
  const double2 u = __ldg(reinterpret_cast<const double2*>(q));
  const double2 v = __ldg(reinterpret_cast<const double2*>(q) + 1);
  r = u.x; g = u.y; b = v.x; a = v.y;
}
__device__ __forceinline__ void store_px(float* q, float r, float g, float b,
                                         float a) {
  *reinterpret_cast<float4*>(q) = make_float4(r, g, b, a);
}
__device__ __forceinline__ void store_px(double* q, double r, double g,
                                         double b, double a) {
  reinterpret_cast<double2*>(q)[0] = make_double2(r, g);
  reinterpret_cast<double2*>(q)[1] = make_double2(b, a);
}

// The nearest texel at float texel coordinates (u, v) of the atlas region
// p[20:24] = (ox, oy, tw, th) (executor._sample_atlas); NaN out of range.
// The flat index is int32 arithmetic with wraparound, done unsigned.
template <typename T>
__device__ __forceinline__ void sample(const T* __restrict__ atlas, int AH,
                                       int AW, const T* p, T u, T v, T& r,
                                       T& g, T& b, T& a) {
  const unsigned ui = (unsigned)to_i32(clamp_coord(u, p[22])) +
                      (unsigned)to_i32(p[20]);
  const unsigned vi = (unsigned)to_i32(clamp_coord(v, p[23])) +
                      (unsigned)to_i32(p[21]);
  const int n = AH * AW;
  int flat = (int)(vi * (unsigned)AW + ui);
  if (flat < 0) flat += n;
  if (flat >= 0 && flat < n)
    ldg_px(atlas + (size_t)flat * 4, r, g, b, a);
  else
    nan_px(r, g, b, a);
}

// Could the command's mask admit a pixel of the tile [ox, ox+TILE) x
// [oy, oy+TILE)?  A superset test in the frame's type: false only where
// the mask is false on every pixel of the tile (NaN bounds: false).  The
// instantiation without blits skips any blit it is given.
template <typename T, bool BLITS>
__device__ __forceinline__ bool touches(int kind, const T* p, T ox, T oy) {
  const T ex = ox + (T)TILE, ey = oy + (T)TILE;
  switch (kind) {
    case FILL:
      return true;
    case TEX: case TEX_FAST: case SPLIT_TEX:
      if (!BLITS) return false;
      [[fallthrough]];
    case SET_COLOR: case RECT: case CIRCLE: case LINE: case VGRD:
      return p[7] > ox && p[6] < ex && p[9] > oy && p[8] < ey;
    case SET_PIXEL: case APPLY_PIXEL:
      return p[14] >= ox && p[14] < ex && p[15] >= oy && p[15] < ey;
    default:
      return false;
  }
}

// The command's mask at (X, Y) and its source colour; store = raw store.
// Blits (BLITS only) sample the atlas.
template <typename T, bool BLITS>
__device__ __forceinline__ bool shade(int kind, const T* p, T X, T Y,
                                      const T* __restrict__ atlas, int AH,
                                      int AW, T& sr, T& sg, T& sb, T& sa,
                                      bool& store) {
  const bool box = X >= p[6] && X < p[7] && Y >= p[8] && Y < p[9];
  store = false;
  int c = 0;  // first colour slot
  bool m = false;
  switch (kind) {
    case SET_COLOR:
      sr = p[14]; sg = p[15]; sb = p[16]; sa = p[17];
      store = true;
      return box;
    case SET_PIXEL:
      sr = p[16]; sg = p[17]; sb = p[18]; sa = p[19];
      store = true;
      return X == p[14] && Y == p[15];
    case FILL:
      m = true; c = 14;
      break;
    case APPLY_PIXEL:
      m = X == p[14] && Y == p[15]; c = 16;
      break;
    case TEX_FAST: {
      // the axis-aligned fast path: raw pixel coordinates, no rect test
      if (!BLITS || !box) return false;
      sample(atlas, AH, AW, p, mul(sub(X, p[14]), p[18]),
             mul(sub(Y, p[15]), p[19]), sr, sg, sb, sa);
      m = true; c = -1;
      break;
    }
    default: {
      const T ix = snap(add(add(mul(p[0], X), mul(p[2], Y)), p[4]));
      const T iy = snap(add(add(mul(p[1], X), mul(p[3], Y)), p[5]));
      if (kind == CIRCLE) {
        const T dx = sub(ix, p[14]), dy = sub(iy, p[15]);
        m = sqrt_rn(add(mul(dx, dx), mul(dy, dy))) <= p[16] && box;
        c = 18;
      } else if (kind == LINE) {
        bool res = false;
        int j = 3;
        for (int i = 0; i < 4; ++i) {
          const T xi = p[14 + 2 * i], yi = p[15 + 2 * i];
          const T xj = p[14 + 2 * j], yj = p[15 + 2 * j];
          const T den = sub(yj, yi);
          const T safe = den != (T)0 ? den : (T)1;
          const bool crosses = (yi > iy) != (yj > iy);
          const T xint = add(dvd(mul(sub(xj, xi), sub(iy, yi)), safe), xi);
          res = res != (crosses && ix < xint);
          j = i;
        }
        m = res && box;
        c = 22;
      } else {  // RECT, VGRD, TEX, SPLIT_TEX
        m = ix >= p[14] && ix <= p[16] && iy >= p[15] && iy <= p[17] && box;
        if (kind == VGRD) {
          const T t = dvd(sub(iy, p[18]), p[19]);
          sr = add(p[20], mul(sub(p[24], p[20]), t));
          sg = add(p[21], mul(sub(p[25], p[21]), t));
          sb = add(p[22], mul(sub(p[26], p[22]), t));
          sa = add(p[23], mul(sub(p[27], p[23]), t));
          sr = mul(sr, p[10]); sg = mul(sg, p[11]);
          sb = mul(sb, p[12]); sa = mul(sa, p[13]);
          return m;
        }
        if (BLITS && (kind == TEX || kind == SPLIT_TEX)) {
          if (!m) return false;
          // u = (invX - x) * scaleX (executor._tex_uv)
          T u = mul(sub(ix, p[14]), p[18]);
          T v = mul(sub(iy, p[15]), p[19]);
          if (kind == SPLIT_TEX) {
            // the UV sub-range remap (cpp:812-813), an IEEE quotient
            const T tw = p[22], th = p[23];
            u = mul(add(p[24], dvd(mul(sub(p[25], p[24]), u), tw)), tw);
            v = mul(add(p[26], dvd(mul(sub(p[27], p[26]), v), th)), th);
          }
          sample(atlas, AH, AW, p, u, v, sr, sg, sb, sa);
          c = -1;
        } else {
          c = 18;
        }
      }
    }
  }
  if (c >= 0) {
    sr = p[c]; sg = p[c + 1]; sb = p[c + 2]; sa = p[c + 3];
  }
  sr = mul(sr, p[10]);
  sg = mul(sg, p[11]);
  sb = mul(sb, p[12]);
  sa = mul(sa, p[13]);
  return m;
}

// Block i walks tile tiles[i] (tiles null: tile i of the whole grid).
template <typename T, bool BLITS>
__device__ __forceinline__ void walk(T* __restrict__ fb, int W, int H,
                                     int ntx, const int* __restrict__ tiles,
                                     const int* __restrict__ kinds,
                                     const T* __restrict__ params, int n,
                                     const T* __restrict__ atlas, int AH,
                                     int AW) {
  __shared__ T s_p[CHUNK][PARAM_W];
  __shared__ int s_k[CHUNK];

  const int tile = tiles ? tiles[blockIdx.x] : (int)blockIdx.x;
  const int ox = (tile % ntx) * TILE;
  const int oy = (tile / ntx) * TILE;
  const int px = ox + threadIdx.x;
  const T X = (T)px;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // some command touches this tile: its pixels' loads go out first
  T r[ROWS], g[ROWS], b[ROWS], a[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int py = oy + threadIdx.y + k * TY;
    if (px < W && py < H)
      load_px(fb + ((size_t)py * W + px) * 4, r[k], g[k], b[k], a[k]);
  }

  for (int base = 0; base < n; base += CHUNK) {
    const int m = min(CHUNK, n - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < m * PARAM_W; i += TX * TY)
      s_p[i / PARAM_W][i % PARAM_W] = params[(size_t)base * PARAM_W + i];
    if (tid < m) s_k[tid] = kinds[base + tid];
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const int kind = s_k[j];
      const T* p = s_p[j];
      if (!touches<T, BLITS>(kind, p, (T)ox, (T)oy)) continue;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int py = oy + threadIdx.y + k * TY;
        if (px >= W || py >= H) continue;
        T sr, sg, sb, sa;
        bool store;
        if (!shade<T, BLITS>(kind, p, X, (T)py, atlas, AH, AW, sr, sg, sb,
                             sa, store))
          continue;
        if (store) {
          r[k] = sr; g[k] = sg; b[k] = sb;
        } else {
          const T keep = sub((T)1, sa);
          r[k] = add(mul(r[k], keep), mul(sr, sa));
          g[k] = add(mul(g[k], keep), mul(sg, sa));
          b[k] = add(mul(b[k], keep), mul(sb, sa));
        }
        a[k] = sa;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int py = oy + threadIdx.y + k * TY;
    if (px < W && py < H)
      store_px(fb + ((size_t)py * W + px) * 4, r[k], g[k], b[k], a[k]);
  }
}

// A run without blits: ptxas's own register budget, the kernel of the
// arithmetic kinds alone (64 registers in float, where the IEEE division
// and square root's slow-path calls spill 40 B, 4 blocks an SM).
template <typename T>
__global__ void __launch_bounds__(TX * TY)
canvas_span_kernel(T* __restrict__ fb, int W, int H, int ntx,
                   const int* __restrict__ tiles,
                   const int* __restrict__ kinds,
                   const T* __restrict__ params, int n) {
  walk<T, false>(fb, W, H, ntx, tiles, kinds, params, n, nullptr, 0, 0);
}

// A run with blits: the budget of 2 blocks an SM (~80 registers in
// float, 3 blocks, no spill; at ptxas's own 64 the blits' live values
// spill 52 B, and the blits run slower)
template <typename T>
__global__ void __launch_bounds__(TX * TY, 2)
canvas_span_blit_kernel(T* __restrict__ fb, int W, int H, int ntx,
                        const int* __restrict__ tiles,
                        const int* __restrict__ kinds,
                        const T* __restrict__ params, int n,
                        const T* __restrict__ atlas, int AH, int AW) {
  walk<T, true>(fb, W, H, ntx, tiles, kinds, params, n, atlas, AH, AW);
}

template <typename T>
cudaError_t launch(T* fb, int W, int H, const int* tiles, int n_tiles,
                   const int* kinds, const T* params, int n, const T* atlas,
                   int AH, int AW, cudaStream_t stream) {
  const int ntx = (W + TILE - 1) / TILE;
  const int nty = (H + TILE - 1) / TILE;
  const int blocks = tiles ? n_tiles : ntx * nty;
  if (atlas)
    canvas_span_blit_kernel<T><<<blocks, dim3(TX, TY), 0, stream>>>(
        fb, W, H, ntx, tiles, kinds, params, n, atlas, AH, AW);
  else
    canvas_span_kernel<T><<<blocks, dim3(TX, TY), 0, stream>>>(
        fb, W, H, ntx, tiles, kinds, params, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Applies the n commands (kinds: n int32, params: n x 32 of the frame's
// type, both on the card) to the contiguous (H, W, 4) frame in place, on
// `stream`, over the n_tiles 32x32 tiles listed in tiles (int32 ids
// ty * ceil(W / 32) + tx on the card, each touched by some command of the
// run), or over every tile when tiles is null (a run that touches every
// tile); the texture blits sample the contiguous (AH, AW, 4) atlas of
// the frame's type.  A run with blits passes the atlas and takes the blit
// kernel; a run without passes null (AH = AW = 0) and takes the kernel
// of the arithmetic kinds, which skips any blit.  is_double picks double
// over float.  fb and atlas
// must be 16-byte aligned and AH * AW must fit an int32.  Returns the
// cudaError_t of the launch (0 on success; no launch for an empty run or
// list).  An error left pending by an earlier launch is returned without
// launching, so the caller raises it.
int canvas_span(void* fb, int W, int H, const int* kinds,
                const void* params, int n, const int* tiles, int n_tiles,
                const void* atlas, int AH, int AW, int is_double,
                void* stream) {
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return (int)pending;
  if (n < 0 || W < 0 || H < 0 || (tiles && n_tiles < 0) ||
      ((uintptr_t)fb & 15) != 0 || AH < 0 || AW < 0 ||
      (long long)AH * AW > 2147483647ll || ((uintptr_t)atlas & 15) != 0 ||
      (!atlas && (long long)AH * AW != 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || W == 0 || H == 0 || (tiles && n_tiles == 0)) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return (int)launch<double>((double*)fb, W, H, tiles, n_tiles, kinds,
                               (const double*)params, n,
                               (const double*)atlas, AH, AW, s);
  return (int)launch<float>((float*)fb, W, H, tiles, n_tiles, kinds,
                            (const float*)params, n, (const float*)atlas, AH,
                            AW, s);
}

const char* canvas_span_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
