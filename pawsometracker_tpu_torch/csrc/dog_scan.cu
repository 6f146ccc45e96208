// dog_scan.cu: the DoG tracker recurrence over a chunk of frames, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pawsometracker_tpu/ops/pallas_tracker.py::_scan_fn_cached
// (its pl.pallas_call at :342) in all its configurations: unbatched (grid (T,)) and batched
// (grid (B, T), :103-108, :126-131, :161-162, :277-304), each unbounded, or bounded with or
// without subpixel offsets. Lane b of a launch is one chain of T steps; the unbatched call is
// the case B = 1. Per step t of lane b:
//   1. p = pos (+ deltas[b,t] when bounded); the patch origin is p clamped to [0,H-1]x[0,W-1],
//      as lax.dynamic_slice clamps in the XLA engine;
//   2. the (2ri+L)x(2rj+L) patch at that padded origin is read straight from the unpadded
//      u8 frame of lane b (at frames + b * lane_stride; lane_stride 0 when every lane tracks
//      its own target through the same frames), out-of-frame cells taking the lane's fill
//      value (no padded copy of the chunk);
//   3. resp = dir * (Gc_r P Gc_c^T - Gs_r P Gs_c^T), rows first, then columns, each output a
//      sequential f32 FMA sum over the L direct taps from tap 0 (no TF32, no tensor cores);
//   4. the first maximum in column-major order: a larger value wins, an equal value with the
//      smaller col*wh+row wins;
//   5. new pos = clamp(p - r + (row, col), lo[b,t], hi[b,t]) (the frame box when unbounded),
//      carried to step t+1. It starts from p, not from the clamped origin, as the XLA engine
//      does (the Pallas kernel starts from the origin); the two differ only for a p outside
//      the frame, such as a start location off the frame;
//   6. with out_off set, per-axis parabolic offsets in [-0.5, 0.5] from the four neighbours
//      of the maximum, 0 at the window edge or where the response is not concave.
//
// What bounds it: at the bench shape (41x41 window, L = 65, patch 105x105) one step is about
// 1.56 MFLOP of direct taps (rows 2*2*41*105*65, columns 2*2*41*41*65) on about 11 KB of
// patch. The recurrence is sequential, so one chain is one CTA on one SM: what bounds a chain
// is one SM's f32 FMA rate (about 3.1 us a step at 67/132 TFLOP/s) plus the latency of the
// per-step argmax and its barriers, not the card's memory or its 132-SM peak. Lanes are
// independent: one CTA per lane (blockIdx.x = b), in waves when B exceeds what the SMs hold.
//
// dog_scan_kernel, the kernel for windows whose working set fits shared memory, is built
// around that bound:
//   - register-blocked passes: a thread computes kR adjacent outputs along the pass, keeping
//     the kR inputs they share as a sliding window in registers (the tap loop is unrolled by
//     kR, so the window's rotation is static). Per tap it makes one tap-pair load (centre and
//     surround interleaved as float2) and one input load (converted once) for 2*kR FMAs. The
//     row-pass sums are stored as (centre, surround) float2 pairs, so the column pass loads
//     both with one instruction;
//   - the next frame's patch is prefetched while this step computes: every quantity that
//     decides it (p, lo[t], hi[t], deltas[t+1]) is known at the start of the step, so the
//     superset of rows clamp(g(p-ri)+d', 0, H-1)-pad_i .. clamp(g(p+ri)+d', 0, H-1)-pad_i+ph-1
//     (g = clamp to [lo, hi]; columns alike, at most (2ri+ph) x (2rj+pw)) is copied with
//     cp.async into the other half of a double buffer. Each row starts at a 16-byte boundary
//     of the frame, so frames of any width or lane base work; when the width and the lane
//     base are multiples of 16 every row starts at the same offset (the kAligned variant),
//     otherwise each row's offset is kept beside the buffer. Out-of-frame cells are written
//     with the fill. Step 0 loads its patch synchronously, the last step prefetches nothing;
//   - the response stays in shared memory, and the subpixel neighbours are read from it: the
//     values the argmax saw;
//   - the step boundary is two __syncthreads: one after the row pass, one after the column
//     pass and the per-warp maxima; every warp then reduces the warp maxima itself, every
//     thread computes the new position, and thread 0 writes the outputs.
// Shared memory: two u8 supersets, the row-pass sums, the response, the taps (about 91 KB of
// the 227 KB at the bench shape; dog_scan_smem_bytes). On an H100 a bench-shape step takes
// about 8 us, 2.6x one SM's FMA bound: the row pass issues ~19 instructions per 14 FMAs on
// 20 warps, the column pass runs on 8 warps, and the argmax and barriers cost ~1 us
// (tools/dog_scan_split.py; PERF.md).
//
// dog_scan_tiled_kernel takes windows whose working set does not fit (the quarter-frame
// autodetect snap, 271x481 at 1080p): it walks the window in output tiles, each with its apron,
// keeping a running (max, column-major index), and recomputes the subpixel neighbours with the
// same FMA sequence. The wrapper picks between the two by shape (ops/tracker_kernel.py).
//
// Summation order decides argmax ties, so the plain PyTorch version
// (ops/filters.py::separable_correlate_valid) emulates this FMA sequence exactly; both kernels
// agree with it bit for bit on any input, lane by lane. Keep them in step.
//
// Built with nvcc into a shared library with a plain C interface and bound with ctypes
// (pawsometracker_tpu_torch/ops/_build.py, ops/tracker_kernel.py). The kernels allocate nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- shared by both kernels ----------------------------------------------------------------

__device__ __forceinline__ void keep_better(float v, int k, float& bv, int& bk) {
  if (v > bv || (v == bv && k < bk)) {
    bv = v;
    bk = k;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bk) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int ok = __shfl_down_sync(0xffffffffu, bk, o);
    keep_better(ov, ok, bv, bk);
  }
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// ---- dog_scan_kernel: register-blocked passes, prefetched next patch -------------------------

constexpr int kR = 7;           // outputs per thread along each pass (41 = 6 * 7 - 1)
constexpr int kThreads = 640;   // 20 warps: the 6 x 105 row-pass items of the bench shape
constexpr int kWarps = kThreads / 32;

// Shared-memory layout of dog_scan_kernel, from (L, ri, rj); the host sizes the launch with it.
struct ScanLayout {
  int nbv, nbh;    // row-pass blocks of kR rows, column-pass blocks of kR columns
  int brows;       // rows of one superset buffer: 2ri + nbv*kR + L (the row-blocked reads' slack)
  int pitch;       // bytes of one buffer row: the 4rj + L superset columns, up to 15 bytes of
                   // row offset, in whole 16-byte chunks
  int pitch2;      // float2 pairs of one row-pass row: nbh*kR + L, odd (no bank conflicts)
  long long off_rows, off_taps, off_resp, off_shift, bytes;
};

__host__ __device__ inline ScanLayout scan_layout(int L, int ri, int rj) {
  ScanLayout s;
  const int wh = 2 * ri + 1, ww = 2 * rj + 1;
  s.nbv = (wh + kR - 1) / kR;
  s.nbh = (ww + kR - 1) / kR;
  s.brows = 2 * ri + s.nbv * kR + L;
  s.pitch = 16 * ((4 * rj + L + 30) / 16);
  s.pitch2 = (s.nbh * kR + L) | 1;
  s.off_rows = 2LL * s.brows * s.pitch;                // [2][brows][pitch] u8 supersets
  s.off_taps = s.off_rows + 8LL * wh * s.pitch2;       // [wh][pitch2] float2 row-pass sums
  s.off_resp = s.off_taps + 8LL * L;                   // [L] float2 (centre, surround) taps
  s.off_shift = s.off_resp + 4LL * wh * ww;            // [wh][ww] f32 response
  s.bytes = s.off_shift + 8LL * s.brows;               // [2][brows] i32 row offsets
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copy of frame rows [r0, r0+nrows) x columns [c0, c0+ncols) into `buf` (row pitch
// `pitch`), cells outside the frame taking `fill`. Buffer row u holds frame row r0+u from the
// 16-byte boundary at or before column c0, so column c lies at byte c - c0 + shift of the row:
// one shift (c0 mod 16) for the whole buffer when kAligned (frame rows and the lane base
// 16-byte aligned), else each row's own, written to shift[u]. Whole 16-byte chunks inside the
// frame go by cp.async (the caller commits and waits); chunks wholly outside are stored as
// fill; a chunk across the frame's edge is copied byte by byte.
template <bool kAligned>
__device__ __forceinline__ void load_region(uint8_t* buf, int* shift, const uint8_t* frame, int H,
                                            int W, int r0, int nrows, int c0, int ncols,
                                            int pitch, int fill, int tid) {
  const int nch = pitch >> 4;
  const unsigned f4 = 0x01010101u * (unsigned)fill;
  const uint4 f16 = make_uint4(f4, f4, f4, f4);
  for (int idx = tid; idx < nrows * nch; idx += kThreads) {
    const int u = idx / nch, j = idx - u * nch;
    const int r = r0 + u;
    const long long roff = (long long)r * W;
    const int sh = kAligned ? (c0 & 15)
                            : (int)((reinterpret_cast<uintptr_t>(frame) +
                                     (uintptr_t)(roff + c0)) & 15);
    if (!kAligned && j == 0) shift[u] = sh;
    if (16 * j >= sh + ncols) continue;
    const int cb = c0 - sh + 16 * j;  // frame column of the chunk's first byte
    uint8_t* dst = buf + u * pitch + 16 * j;
    if (r < 0 || r >= H || cb + 16 <= 0 || cb >= W) {
      *reinterpret_cast<uint4*>(dst) = f16;
    } else if (cb >= 0 && cb + 16 <= W) {
      cp_async16(dst, frame + roff + cb);
    } else {
      for (int b = 0; b < 16; ++b) {
        const int c = cb + b;
        dst[b] = (c >= 0 && c < W) ? frame[roff + c] : (uint8_t)fill;
      }
    }
  }
}

// One tap of the kR register-blocked outputs: output i takes window slot (i + kk) % kR, with
// kk the tap's index mod kR, a constant once the caller's loop is unrolled.
__device__ __forceinline__ void taps_step(const float2 g, const float (&win)[kR], int kk,
                                          float (&ac)[kR], float (&as)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    ac[i] = __fmaf_rn(g.x, win[(i + kk) % kR], ac[i]);
    as[i] = __fmaf_rn(g.y, win[(i + kk) % kR], as[i]);
  }
}

// The same on (centre, surround) pairs: the column pass.
__device__ __forceinline__ void taps_step(const float2 g, const float2 (&win)[kR], int kk,
                                          float (&ac)[kR], float (&as)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    ac[i] = __fmaf_rn(g.x, win[(i + kk) % kR].x, ac[i]);
    as[i] = __fmaf_rn(g.y, win[(i + kk) % kR].y, as[i]);
  }
}

// The sequential FMA over the L taps for kR adjacent outputs; load(m) gives input m (0 <= m <
// L + kR: the last load reads one input past the window, which the layout leaves room for).
// Before tap k, slot m % kR holds input m for m in [k, k + kR); after it, slot k % kR takes
// input k + kR.
template <class V, class Load>
__device__ __forceinline__ void blocked_taps(const float2* tp, int L, Load load, float (&ac)[kR],
                                             float (&as)[kR]) {
  V win[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    ac[i] = 0.f;
    as[i] = 0.f;
    win[i] = load(i);
  }
  int k0 = 0;
  for (; k0 + kR <= L; k0 += kR) {
#pragma unroll
    for (int kk = 0; kk < kR; ++kk) {
      taps_step(tp[k0 + kk], win, kk, ac, as);
      win[kk] = load(k0 + kk + kR);
    }
  }
#pragma unroll
  for (int kk = 0; kk < kR; ++kk) {
    if (k0 + kk < L) {
      taps_step(tp[k0 + kk], win, kk, ac, as);
      win[kk] = load(k0 + kk + kR);
    }
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
dog_scan_kernel(const uint8_t* __restrict__ frames, long long lane_stride, int T, int H, int W,
                const int32_t* __restrict__ pos0, const uint8_t* __restrict__ fills,
                const int32_t* __restrict__ deltas, const int32_t* __restrict__ lo,
                const int32_t* __restrict__ hi, const float* __restrict__ taps, int L, int ri,
                int rj, float direction, int32_t* __restrict__ out_pos,
                float* __restrict__ out_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  // this CTA's lane: its frames [T,H,W] at chain * lane_stride, pos0 [2], fill, and
  // deltas, lo, hi, out_pos and out_off [T,2]
  const int chain = blockIdx.x;
  const long long lane_steps = 2LL * T * chain;
  frames += chain * lane_stride;
  pos0 += 2 * chain;
  const int fill = fills[chain];
  if (deltas) deltas += lane_steps;
  if (lo) lo += lane_steps;
  if (hi) hi += lane_steps;
  out_pos += lane_steps;
  if (out_off) out_off += lane_steps;

  const ScanLayout ly = scan_layout(L, ri, rj);
  const int wh = 2 * ri + 1, ww = 2 * rj + 1;
  const int ph = wh + L - 1, pw = ww + L - 1;
  const int pad_i = ri + L / 2, pad_j = rj + L / 2;
  const int buf_bytes = ly.brows * ly.pitch;
  uint8_t* bufs = smem;                                          // [2][brows][pitch]
  float2* rows = reinterpret_cast<float2*>(smem + ly.off_rows);  // [wh][pitch2]
  float2* tp = reinterpret_cast<float2*>(smem + ly.off_taps);    // [L] (centre, surround)
  float* resp = reinterpret_cast<float*>(smem + ly.off_resp);    // [wh][ww]
  int* shifts = reinterpret_cast<int*>(smem + ly.off_shift);     // [2][brows]
  __shared__ float s_v[kWarps];
  __shared__ int s_k[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < L; k += kThreads) tp[k] = make_float2(taps[k], taps[L + k]);
  if (!kAligned)
    for (int k = tid; k < 2 * ly.brows; k += kThreads) shifts[k] = 0;
  __syncthreads();

  // Every thread carries the position and this step's box in registers: p, deltas[t], lo[t],
  // hi[t] and deltas[t+1] (the prefetch needs it), the next step's read one step ahead.
  int pi = pos0[0], pj = pos0[1];
  int d0i = 0, d0j = 0, d1i = 0, d1j = 0;
  int lo_i = 0, lo_j = 0, hi_i = H - 1, hi_j = W - 1;
  if (deltas) {
    d0i = deltas[0];
    d0j = deltas[1];
    if (T > 1) {
      d1i = deltas[2];
      d1j = deltas[3];
    }
    lo_i = lo[0];
    lo_j = lo[1];
    hi_i = hi[0];
    hi_j = hi[1];
  }

  // step 0's patch, loaded synchronously; (sr0, sc0) is where the current buffer's region
  // starts in the frame
  int sr0 = clampi(pi + d0i, 0, H - 1) - pad_i, sc0 = clampi(pj + d0j, 0, W - 1) - pad_j;
  load_region<kAligned>(bufs, shifts, frames, H, W, sr0, ph, sc0, pw, ly.pitch, fill, tid);
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const uint8_t* bcur = bufs + cur * buf_bytes;
    const int* shcur = shifts + cur * ly.brows;
    const int qi = pi + d0i, qj = pj + d0j;  // p
    const int oi = clampi(qi, 0, H - 1) - pad_i, oj = clampi(qj, 0, W - 1) - pad_j;

    // Prefetch the superset of step t+1's patch into the other buffer, and read step t+1's
    // box and step t+2's rebase.
    int nsr0 = 0, nsc0 = 0;
    int d2i = 0, d2j = 0, nlo_i = 0, nlo_j = 0, nhi_i = H - 1, nhi_j = W - 1;
    if (t + 1 < T) {
      nsr0 = clampi(clampi(qi - ri, lo_i, hi_i) + d1i, 0, H - 1) - pad_i;
      nsc0 = clampi(clampi(qj - rj, lo_j, hi_j) + d1j, 0, W - 1) - pad_j;
      const int r1 = clampi(clampi(qi + ri, lo_i, hi_i) + d1i, 0, H - 1) - pad_i + ph;
      const int c1 = clampi(clampi(qj + rj, lo_j, hi_j) + d1j, 0, W - 1) - pad_j + pw;
      load_region<kAligned>(bufs + (cur ^ 1) * buf_bytes, shifts + (cur ^ 1) * ly.brows,
                            frames + (size_t)(t + 1) * H * W, H, W, nsr0, r1 - nsr0, nsc0,
                            c1 - nsc0, ly.pitch, fill, tid);
      cp_async_commit();
      if (deltas) {
        nlo_i = lo[2 * t + 2];
        nlo_j = lo[2 * t + 3];
        nhi_i = hi[2 * t + 2];
        nhi_j = hi[2 * t + 3];
        if (t + 2 < T) {
          d2i = deltas[2 * t + 4];
          d2j = deltas[2 * t + 5];
        }
      }
    }

    // Row pass: rows[a][x] = (sum_k gc[k] P[a+k][x], sum_k gs[k] P[a+k][x]), kR rows a thread.
    const int orow = oi - sr0;
    const int ocol = oj - sc0 + (kAligned ? (sc0 & 15) : 0);
    for (int it = tid; it < ly.nbv * pw; it += kThreads) {
      const int blk = it / pw, x = it - blk * pw;
      const int a0 = blk * kR;
      const uint8_t* col = bcur + (orow + a0) * ly.pitch + ocol + x;
      const int* sh = shcur + orow + a0;
      const int pitch = ly.pitch;
      float ac[kR], as[kR];
      blocked_taps<float>(tp, L, [&](int m) {
        return (float)col[m * pitch + (kAligned ? 0 : sh[m])];
      }, ac, as);
#pragma unroll
      for (int i = 0; i < kR; ++i)
        if (a0 + i < wh) rows[(a0 + i) * ly.pitch2 + x] = make_float2(ac[i], as[i]);
    }
    __syncthreads();

    // Column pass, kR columns a thread (lanes along the rows), the response kept in shared
    // memory, and each thread's first maximum in column-major order.
    float bv = -INFINITY;
    int bk = INT_MAX;
    for (int it = tid; it < wh * ly.nbh; it += kThreads) {
      const int blk = it / wh, a = it - blk * wh;
      const int b0 = blk * kR;
      const float2* rp = rows + a * ly.pitch2 + b0;
      float rc[kR], rs[kR];
      blocked_taps<float2>(tp, L, [&](int m) { return rp[m]; }, rc, rs);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int b = b0 + i;
        if (b < ww) {
          const float v = direction * (rc[i] - rs[i]);
          resp[a * ww + b] = v;
          keep_better(v, b * wh + a, bv, bk);
        }
      }
    }
    warp_argmax(bv, bk);
    if (lane == 0) {
      s_v[warp] = bv;
      s_k[warp] = bk;
    }
    cp_async_wait_all();  // the next patch has landed (this thread's copies)
    __syncthreads();      // ... and everyone's; the warp maxima and the response are written

    // Every warp reduces the warp maxima; every lane ends with the block's.
    bv = lane < kWarps ? s_v[lane] : -INFINITY;
    bk = lane < kWarps ? s_k[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, o);
      keep_better(ov, ok, bv, bk);
    }
    const int row = bk % wh, col = bk / wh;
    const int ni = clampi(qi - ri + row, lo_i, hi_i);
    const int nj = clampi(qj - rj + col, lo_j, hi_j);
    if (tid == 0) {
      out_pos[2 * t] = ni;
      out_pos[2 * t + 1] = nj;
      if (out_off) {
        const float m0 = bv;
        const float rm = resp[max(row - 1, 0) * ww + col], rp = resp[min(row + 1, wh - 1) * ww + col];
        const float cm = resp[row * ww + max(col - 1, 0)], cp = resp[row * ww + min(col + 1, ww - 1)];
        const float den_r = rm - 2.0f * m0 + rp;
        const float den_c = cm - 2.0f * m0 + cp;
        const bool int_r = row > 0 && row < wh - 1 && den_r < 0.f;
        const bool int_c = col > 0 && col < ww - 1 && den_c < 0.f;
        out_off[2 * t] = int_r ? 0.5f * (rm - rp) / den_r : 0.f;
        out_off[2 * t + 1] = int_c ? 0.5f * (cm - cp) / den_c : 0.f;
      }
    }
    pi = ni;
    pj = nj;
    d0i = d1i;
    d0j = d1j;
    d1i = d2i;
    d1j = d2j;
    lo_i = nlo_i;
    lo_j = nlo_j;
    hi_i = nhi_i;
    hi_j = nhi_j;
    sr0 = nsr0;
    sc0 = nsc0;
  }
}

// ---- dog_scan_tiled_kernel: windows whose working set does not fit shared memory ------------

constexpr int kTiledMaxThreads = 512;
constexpr int kTiledMaxWarps = kTiledMaxThreads / 32;

__device__ __forceinline__ float pixel(const uint8_t* frame, int H, int W, int r, int c,
                                       int fill) {
  return (r >= 0 && r < H && c >= 0 && c < W) ? (float)frame[(size_t)r * W + c]
                                              : (float)fill;
}

__global__ void __launch_bounds__(kTiledMaxThreads)
dog_scan_tiled_kernel(const uint8_t* __restrict__ frames, long long lane_stride, int T, int H,
                      int W, const int32_t* __restrict__ pos0, const uint8_t* __restrict__ fills,
                      const int32_t* __restrict__ deltas, const int32_t* __restrict__ lo,
                      const int32_t* __restrict__ hi, const float* __restrict__ taps, int L,
                      int ri, int rj, float direction, int32_t* __restrict__ out_pos,
                      float* __restrict__ out_off, int tile_h, int tile_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  // this CTA's lane: its frames [T,H,W] at chain * lane_stride, pos0 [2], fill, and
  // deltas, lo, hi, out_pos and out_off [T,2]
  const int chain = blockIdx.x;
  const long long lane_steps = 2LL * T * chain;
  frames += chain * lane_stride;
  pos0 += 2 * chain;
  const int fill = fills[chain];
  if (deltas) deltas += lane_steps;
  if (lo) lo += lane_steps;
  if (hi) hi += lane_steps;
  out_pos += lane_steps;
  if (out_off) out_off += lane_steps;

  const int wh = 2 * ri + 1, ww = 2 * rj + 1;
  const int pad_i = ri + L / 2, pad_j = rj + L / 2;
  const int tpw = tile_w + L - 1;
  float* gc = reinterpret_cast<float*>(smem);  // [L] centre taps
  float* gs = gc + L;                          // [L] surround taps
  float* nb = gs + L;                          // [8L] neighbour row sums (centre, surround)
  float* tmp_c = nb + 8 * L;                   // [tile_h, tpw] row pass, centre
  float* tmp_s = tmp_c + tile_h * tpw;         // [tile_h, tpw] row pass, surround
  uint8_t* patch = reinterpret_cast<uint8_t*>(tmp_s + tile_h * tpw);  // [tile_h+L-1, tpw]

  __shared__ int s_pos[2];
  __shared__ float s_v[kTiledMaxWarps];
  __shared__ int s_k[kTiledMaxWarps];
  __shared__ float s_best_v;
  __shared__ int s_best_k;
  __shared__ float s_nb[4];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nthr + 31) >> 5;
  for (int k = tid; k < 2 * L; k += nthr) gc[k] = taps[k];
  if (tid == 0) {
    s_pos[0] = pos0[0];
    s_pos[1] = pos0[1];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const uint8_t* frame = frames + (size_t)t * H * W;
    int pi = s_pos[0], pj = s_pos[1];
    if (deltas) {
      pi += deltas[2 * t];
      pj += deltas[2 * t + 1];
    }
    const int r0 = min(max(pi, 0), H - 1) - pad_i;  // frame row of the patch origin
    const int c0 = min(max(pj, 0), W - 1) - pad_j;

    float bv = -INFINITY;
    int bk = INT_MAX;
    for (int tr = 0; tr < wh; tr += tile_h) {
      const int th = min(tile_h, wh - tr);
      const int ph = th + L - 1;
      for (int tc = 0; tc < ww; tc += tile_w) {
        const int tw = min(tile_w, ww - tc);
        const int pw = tw + L - 1;
        for (int idx = tid; idx < ph * pw; idx += nthr) {
          const int u = idx / pw, v = idx - u * pw;
          const int r = r0 + tr + u, c = c0 + tc + v;
          patch[idx] = (r >= 0 && r < H && c >= 0 && c < W) ? frame[(size_t)r * W + c]
                                                            : (uint8_t)fill;
        }
        __syncthreads();
        for (int idx = tid; idx < th * pw; idx += nthr) {
          const int a = idx / pw, x = idx - a * pw;
          const uint8_t* col = patch + a * pw + x;
          float sc = 0.f, ss = 0.f;
          for (int k = 0; k < L; ++k) {
            const float p = (float)col[k * pw];
            sc = __fmaf_rn(gc[k], p, sc);
            ss = __fmaf_rn(gs[k], p, ss);
          }
          tmp_c[idx] = sc;
          tmp_s[idx] = ss;
        }
        __syncthreads();
        for (int idx = tid; idx < th * tw; idx += nthr) {
          const int a = idx / tw, b = idx - a * tw;
          const float* rc_row = tmp_c + a * pw + b;
          const float* rs_row = tmp_s + a * pw + b;
          float rc = 0.f, rs = 0.f;
          for (int k = 0; k < L; ++k) {
            rc = __fmaf_rn(gc[k], rc_row[k], rc);
            rs = __fmaf_rn(gs[k], rs_row[k], rs);
          }
          keep_better(direction * (rc - rs), (tc + b) * wh + (tr + a), bv, bk);
        }
      }
    }

    warp_argmax(bv, bk);
    if (lane == 0) {
      s_v[warp] = bv;
      s_k[warp] = bk;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? s_v[lane] : -INFINITY;
      bk = lane < nwarps ? s_k[lane] : INT_MAX;
      warp_argmax(bv, bk);
      if (lane == 0) {
        s_best_v = bv;
        s_best_k = bk;
      }
    }
    __syncthreads();
    const int row = s_best_k % wh, col = s_best_k / wh;

    if (out_off) {
      // The four neighbours of the maximum, recomputed with the same FMA sequence as the
      // tile passes, so they equal the response values the argmax saw bit for bit.
      for (int idx = tid; idx < 4 * L; idx += nthr) {
        const int n = idx / L, m = idx - n * L;
        const int a = min(max(row + (n == 0 ? -1 : n == 1 ? 1 : 0), 0), wh - 1);
        const int b = min(max(col + (n == 2 ? -1 : n == 3 ? 1 : 0), 0), ww - 1);
        float sc = 0.f, ss = 0.f;
        for (int k = 0; k < L; ++k) {
          const float p = pixel(frame, H, W, r0 + a + k, c0 + b + m, fill);
          sc = __fmaf_rn(gc[k], p, sc);
          ss = __fmaf_rn(gs[k], p, ss);
        }
        nb[idx] = sc;
        nb[4 * L + idx] = ss;
      }
      __syncthreads();
      if (tid < 4) {
        float rc = 0.f, rs = 0.f;
        for (int m = 0; m < L; ++m) {
          rc = __fmaf_rn(gc[m], nb[tid * L + m], rc);
          rs = __fmaf_rn(gs[m], nb[4 * L + tid * L + m], rs);
        }
        s_nb[tid] = direction * (rc - rs);
      }
      __syncthreads();
    }

    if (tid == 0) {
      const int lo0 = lo ? lo[2 * t] : 0, lo1 = lo ? lo[2 * t + 1] : 0;
      const int hi0 = hi ? hi[2 * t] : H - 1, hi1 = hi ? hi[2 * t + 1] : W - 1;
      const int ni = min(max(pi - ri + row, lo0), hi0);
      const int nj = min(max(pj - rj + col, lo1), hi1);
      out_pos[2 * t] = ni;
      out_pos[2 * t + 1] = nj;
      s_pos[0] = ni;
      s_pos[1] = nj;
      if (out_off) {
        const float m0 = s_best_v;
        const float rm = s_nb[0], rp = s_nb[1], cm = s_nb[2], cp = s_nb[3];
        const float den_r = rm - 2.0f * m0 + rp;
        const float den_c = cm - 2.0f * m0 + cp;
        const bool int_r = row > 0 && row < wh - 1 && den_r < 0.f;
        const bool int_c = col > 0 && col < ww - 1 && den_c < 0.f;
        out_off[2 * t] = int_r ? 0.5f * (rm - rp) / den_r : 0.f;
        out_off[2 * t + 1] = int_c ? 0.5f * (cm - cp) / den_c : 0.f;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one dog_scan_kernel launch, in bytes (scan_layout above).
long long dog_scan_smem_bytes(int L, int ri, int rj) { return scan_layout(L, ri, rj).bytes; }

// Dynamic shared memory of one dog_scan_tiled_kernel launch, in bytes.
long long dog_scan_tiled_smem_bytes(int L, int tile_h, int tile_w) {
  const long long tpw = tile_w + L - 1;
  return 4LL * (10LL * L + 2LL * tile_h * tpw) + (long long)(tile_h + L - 1) * tpw;
}

// Both launchers run B chains of T steps on `stream`, one CTA per lane. Device pointers:
// frames u8 contiguous, lane b's [T,H,W] at frames + b * lane_stride (lane_stride 0: all lanes
// read the same frames), pos0 [B,2] i32, fills [B] u8, taps [2L] f32 (centre then surround),
// out_pos [B,T,2] i32; deltas, lo and hi ([B,T,2] i32) and out_off ([B,T,2] f32) may be null.
// They return cudaGetLastError() after launch.

// dog_scan_kernel: for windows with dog_scan_smem_bytes within the card's limit.
int dog_scan_launch(const void* frames, long long lane_stride, int B, int T, int H, int W,
                    const void* pos0, const void* fills, const void* deltas, const void* lo,
                    const void* hi, const void* taps, int L, int ri, int rj, float direction,
                    void* out_pos, void* out_off, void* stream) {
  if (B <= 0 || lane_stride < 0) return (int)cudaErrorInvalidValue;
  const long long smem = dog_scan_smem_bytes(L, ri, rj);
  const bool aligned = reinterpret_cast<uintptr_t>(frames) % 16 == 0 && W % 16 == 0 &&
                       lane_stride % 16 == 0;
  auto kernel = aligned ? dog_scan_kernel<true> : dog_scan_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, lane_stride, T, H, W, (const int32_t*)pos0, (const uint8_t*)fills,
      (const int32_t*)deltas, (const int32_t*)lo, (const int32_t*)hi, (const float*)taps, L, ri,
      rj, direction, (int32_t*)out_pos, (float*)out_off);
  return (int)cudaGetLastError();
}

// dog_scan_tiled_kernel: any window, in output tiles of tile_h x tile_w.
int dog_scan_tiled_launch(const void* frames, long long lane_stride, int B, int T, int H, int W,
                          const void* pos0, const void* fills, const void* deltas,
                          const void* lo, const void* hi, const void* taps, int L, int ri,
                          int rj, float direction, void* out_pos, void* out_off, int tile_h,
                          int tile_w, int threads, void* stream) {
  if (threads <= 0 || threads > kTiledMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || lane_stride < 0) return (int)cudaErrorInvalidValue;
  const long long smem = dog_scan_tiled_smem_bytes(L, tile_h, tile_w);
  cudaError_t e = cudaFuncSetAttribute(dog_scan_tiled_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dog_scan_tiled_kernel<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, lane_stride, T, H, W, (const int32_t*)pos0,
      (const uint8_t*)fills, (const int32_t*)deltas, (const int32_t*)lo, (const int32_t*)hi,
      (const float*)taps, L, ri, rj, direction, (int32_t*)out_pos, (float*)out_off, tile_h,
      tile_w);
  return (int)cudaGetLastError();
}

const char* dog_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
