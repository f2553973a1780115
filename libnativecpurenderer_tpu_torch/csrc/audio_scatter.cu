// The audio scatter routes' executor: an ordered segment table added
// into the target in one launch.
//
// Replaces no TPU kernel.  The JAX package leaves the scatter route to
// XLA's scatter (AudioClip.overlay_groups, audio.py:420-465 of the JAX
// package, and the ops it calls); the port ran it as one eager slice add
// an event run, ~1,500 launches for a song of the MIDI mixer, and the
// host's enqueue of them set the mixer's pace on an H100 (PERF.md, the
// mixer cell).  Wrapper and plain version:
// ops/audio_ops.py (scatter_table, scatter_table_reference); the table is
// ops/audio_ops.segment_table's.
//
// What it computes.  The table's rows (dst_lo, len, src_lo, group), in
// table order: target rows [dst_lo, dst_lo + len) += rows
// [src_lo, src_lo + len) of the contiguous (L, C) source at ptrs[group].
// In elements of the contiguous (N, C) target a row's run is
// [dst_lo * C, (dst_lo + len) * C), reading the source's elements from
// src_lo * C on, so C needs no division.
//
// Bits.  Only additions, built with -fmad=false: every target element
// receives its contributions one rounded add at a time in table order,
// the order of the slice-add loop it replaces (the plain version), so the
// two are equal bit for bit, in float and in double.  No atomics: a float
// sum's bits depend on its order.
//
// Design.  The grid covers only the tiles of TILE consecutive target
// elements that the table's runs span (from the tile of the first run's
// first element to the last run's end), so an overlay of a short clip
// onto a long target moves the clip's rows, not the whole target.  One
// block of THREADS threads a tile; thread t holds elements t,
// t + THREADS, ... of its tile in registers (neighbouring threads on
// neighbouring addresses, for the target and for each source run).  The block walks the table in order,
// THREADS rows a pass: each thread tests one row against the tile, and a
// ballot and a prefix over the warps list the rows that hit the tile in
// shared memory, in table order; then every thread adds each listed run
// to the elements it holds.  The tile is loaded once and stored once.
//
// What bounds it on an H100.  Bytes: the target read and written once
// (8 B a float element) and each distinct clip a call plays read at least
// once, ~158 MB for a song of the mixer, 0.047 ms at 3.35 TB/s.  The
// clips' repeated reads (each event's rows, ~530 MB a song) were meant
// to come from the 50 MB L2, with the tile held in registers while its
// block walks the runs; they do not: a tile reads another part of a clip
// than its neighbours do, so a clip's rows are read again only by its
// next event, and the ~219 clips of a song (77 MB in float) outgrow L2.
// At the mixer's shape the kernel takes 0.184 ms on an H100 (80 GB HBM3,
// 700 W), against 0.182 ms for the 611 MB it moves at 3.35 TB/s: it is
// bound by those bytes.  The table is read once a block (32 B a row,
// from L2), and the test costs a few operations a row and thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 16;                 // target elements a thread
constexpr int TILE = THREADS * PER_THREAD;     // target elements a block
constexpr int ROW = 4;                         // int64 words a table row

template <typename T>
__global__ void __launch_bounds__(THREADS)
audio_scatter_kernel(T* __restrict__ target, long long elem_lo,
                     long long elem_hi, int C,
                     const long long* __restrict__ table, int n_runs,
                     const unsigned long long* __restrict__ ptrs) {
  __shared__ int s_lo[THREADS];
  __shared__ int s_hi[THREADS];
  __shared__ const T* s_src[THREADS];
  __shared__ int s_warp[WARPS];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tile_lo = elem_lo + (long long)blockIdx.x * TILE;
  const long long tile_hi = min(tile_lo + TILE, elem_hi);
  const int live = (int)(tile_hi - tile_lo);

  T acc[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = t + k * THREADS;
    acc[k] = i < live ? target[tile_lo + i] : (T)0;
  }

  for (int base = 0; base < n_runs; base += THREADS) {
    // this pass's row t: does its run meet the tile?
    const int j = base + t;
    bool hit = false;
    int lo = 0, hi = 0;
    const T* src = nullptr;
    if (j < n_runs) {
      const long long* r = table + (long long)ROW * j;
      const long long d_lo = r[0] * C, d_hi = (r[0] + r[1]) * C;
      if (d_lo < tile_hi && d_hi > tile_lo) {
        hit = true;
        lo = (int)(max(d_lo, tile_lo) - tile_lo);
        hi = (int)(min(d_hi, tile_hi) - tile_lo);
        // element tile_lo + i of the target reads src[i]; src is never
        // read outside [lo, hi), which lies inside the source
        src = reinterpret_cast<const T*>(ptrs[r[3]]) +
              (r[2] * C - d_lo + tile_lo);
      }
    }
    // the hits listed in table order: warp by warp, lane by lane
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int before = 0, hits = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      hits += c;
    }
    if (hit) {
      const int at = before + __popc(mask & ((1u << lane) - 1u));
      s_lo[at] = lo;
      s_hi[at] = hi;
      s_src[at] = src;
    }
    __syncthreads();
    for (int h = 0; h < hits; ++h) {
      const int run_lo = s_lo[h], run_hi = s_hi[h];
      const T* run_src = s_src[h];
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int i = t + k * THREADS;
        if (i >= run_lo && i < run_hi) acc[k] = acc[k] + __ldg(run_src + i);
      }
    }
    __syncthreads();  // the list is read before the next pass writes it
  }

#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = t + k * THREADS;
    if (i < live) target[tile_lo + i] = acc[k];
  }
}

template <typename T>
cudaError_t launch(T* target, long long elem_lo, long long elem_hi, int C,
                   const long long* table, int n_runs,
                   const unsigned long long* ptrs, cudaStream_t stream) {
  const long long blocks = (elem_hi - elem_lo + TILE - 1) / TILE;
  audio_scatter_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      target, elem_lo, elem_hi, C, table, n_runs, ptrs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Adds the n_runs rows of table (int64 (n_runs, 4): dst_lo, len, src_lo,
// group, on the card, each run inside the target and its source) into
// the contiguous (rows, C) target in table order, in place, on `stream`;
// ptrs (n_groups uint64 on the card) holds each group's contiguous
// (L, C) source of the target's type, which must not overlap the target.
// [row_lo, row_hi) holds every run's target rows (the least dst_lo, the
// largest dst_lo + len); the launch covers those rows' tiles alone.
// is_double picks double over float.  Returns the cudaError_t of the
// launch (0 on success; no launch for an empty table or span).  An
// error left pending by an earlier launch is returned without launching,
// so the caller raises it.
int audio_scatter(void* target, long long rows, int C, long long row_lo,
                  long long row_hi, const void* table, int n_runs,
                  const void* ptrs, int is_double, void* stream) {
  const cudaError_t pending = cudaGetLastError();
  if (pending != cudaSuccess) return (int)pending;
  if (rows < 0 || C < 1 || n_runs < 0 || row_lo < 0 || row_hi > rows ||
      (rows * C + TILE - 1) / TILE > 2147483647ll)
    return (int)cudaErrorInvalidValue;
  if (row_lo >= row_hi || n_runs == 0) return 0;
  const long long lo = row_lo * C / TILE * TILE, hi = row_hi * C;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* tab = (const long long*)table;
  const unsigned long long* p = (const unsigned long long*)ptrs;
  if (is_double)
    return (int)launch<double>((double*)target, lo, hi, C, tab, n_runs, p,
                               s);
  return (int)launch<float>((float*)target, lo, hi, C, tab, n_runs, p, s);
}

const char* audio_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
