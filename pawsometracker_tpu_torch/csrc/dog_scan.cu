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
// patch. The recurrence is sequential: a step needs the last step's argmax, so the card's
// 132-SM peak and its memory are far off (about 0.02 us a step). What bounds one chain is
// the SMs it is spread over: on one SM the FMA rate alone is about 3.1 us a step (67/132
// TFLOP/s), and a step that spreads over C SMs pays one cluster barrier and one exchange of
// the maxima through distributed shared memory instead.
//
// dog_scan_kernel, the kernel for windows whose working set fits shared memory, is one
// thread-block cluster a lane: grid (C, B), cluster dims (C, 1, 1), C <= 16 (above 8 a
// non-portable size). The window's output rows are cut into row blocks of kR = 7 rows (41 =
// 6 * 7 - 1); CTA r owns the contiguous blocks [r * slots, (r + 1) * slots), slots = ceil(nbv
// / C), so C = 6 gives one block a CTA at 41x41 and C = 1 is the whole window on one CTA. A
// CTA's threads are sized to its work: its row-pass or column-pass items, or a quarter of the
// 16-byte chunks of its copy, whichever are more, in whole warps (288 at the bench window with
// C = 6, 640 with C = 1). Per step each CTA:
//   - prefetches its share of the next step's patch while this step computes: every quantity
//     that decides it (p, lo[t], hi[t], deltas[t+1]) is known at the start of the step, and
//     every CTA computes them alike, so each copies the superset of the rows its own blocks
//     can need, clamp(g(p-ri)+d', 0, H-1)-pad_i+a_lo .. clamp(g(p+ri)+d', 0, H-1)-pad_i+a_lo+
//     rows+L-1 (g = clamp to [lo, hi]; a_lo its first output row; at most 2ri + slots*kR + L
//     rows by 4rj + L columns) with cp.async into the other half of a double buffer. No step
//     waits on a synchronous load. Each row starts at a 16-byte boundary of the frame, so
//     frames of any width or lane base work; when the width and the lane base are multiples of
//     16 every row starts at the same offset (the kAligned variant), otherwise each row's
//     offset is kept beside the buffer. Out-of-frame cells are written with the fill; a chunk
//     across the frame's left or right edge is read whole by one 16-byte load inside the frame
//     and its outside bytes replaced (ROI crops are narrow, so most rows have one; load_region).
//     Step 0 loads its rows synchronously, the last step prefetches nothing;
//   - runs register-blocked passes over its blocks: a thread computes kR adjacent outputs
//     along the pass, keeping the kR inputs they share as a sliding window in registers (the
//     tap loop is unrolled by kR, so the window's rotation is static). Per tap it makes one
//     tap-pair load (centre and surround interleaved as float2) and one input load (converted
//     once) for 2*kR FMAs. The row-pass sums are stored as (centre, surround) float2 pairs, so
//     the column pass loads both with one instruction. One __syncthreads between the passes;
//   - reduces its (max, column-major index) per warp with keep_better, a total order, so the
//     result does not depend on C; after one cluster barrier every warp of every CTA reads
//     the pair of every warp that can hold a column item through distributed shared memory
//     and computes the same new position: no round trip through global memory, no second
//     kernel, no second barrier. The pairs and
//     (with subpixel offsets) each CTA's responses are double-buffered by step parity, so the
//     next step's writes wait for this step's reads behind the next cluster barrier; CTA 0
//     reads the four neighbours of the maximum from the CTAs that own them (the values the
//     argmax saw).
// Shared memory a CTA: two u8 supersets, its row-pass sums, the taps, its responses by parity
// (about 45 KB at the bench window with C = 6; dog_scan_smem_bytes). The wrapper picks C from
// the block count and cudaOccupancyMaxActiveClusters with the launch's lanes in view
// (ops/tracker_kernel.py::scan_plan); a launch that cannot be scheduled fails and raises.
// On an H100 a bench-shape step takes about 5.2 us with C = 6 (8.0 us on one CTA before this
// design), 6.0 us on the 185x185 crop, against a cluster bound of 0.5 us: the passes take about
// 2.7 us, run by one or two warps a scheduler, too few to hide the latency of one thread's
// long FMA chain; the cluster barrier and the exchange about 0.7 us; the copy 0.6 us (1.6 on
// the crop, whose rows are not 16-byte aligned); the rest of the step's fixed work about 1 us
// (tools/dog_scan_split.py; PERF.md).
//
// dog_scan_tiled_kernel takes every window: by the shape rule those that do not fit one of
// dog_scan's CTAs whole, the quarter-frame autodetect snap (271x481 at 1080p) and every chunk
// scan from target_width 36 up at the default window (65x65 with L = 89 and larger; dog_scan
// runs them up to 63 over a cluster, but its CTAs' copies grow with the window's full width
// and it is no faster there on an H100, PERF.md). A step there is 20-100 MFLOP, too
// much for one SM, so a lane is one thread-block cluster of C <= 16 CTAs (grid (C, B), cluster
// dims (C,1,1)):
//   - the window is cut into output tiles of 7 rows (one kR block) by the whole window's width,
//     or by a few column tiles when that does not fit, so a tile's row pass recomputes at most
//     the L - 1 apron columns of its column tiles (tile_plan in ops/tracker_kernel.py counts the
//     work against the direct taps); CTA r owns tiles r, r + C, ...;
//   - per tile, dog_scan's register-blocked passes (kR outputs a thread in each), on a CTA of
//     as many threads as its row-pass or column-pass items, in whole warps (256 at the large
//     target's 7x105 tile, where 640 spent a step's scalar work on 20 warps); the step's first
//     tile's patch is copied with cp.async after the exchange that places it (load_tile: each
//     thread one chunk column of the rows, no division a chunk; load_region at the frame's
//     edges, where out-of-frame cells take the fill), and a CTA's next tile (slots > 1) is
//     copied into the same buffer while the column pass runs, since the row pass is done with
//     it by then. The copy costs its issue, not its latency: warming L2 with the next step's
//     rows a step ahead, copying each row as one bulk copy, and giving a thread fewer outputs
//     in either pass (3 or 5 columns, 4 + 3 rows) were measured and each was slower (PERF.md,
//     tools/dog_scan_split.py);
//   - per step, each warp reduces its (max, column-major index) with two warp reductions on
//     a key that orders as keep_better and sends the pair by st.async into every CTA's shared
//     memory, counted on that CTA's transaction barrier (an mbarrier) of the step's parity;
//     every warp waits until its own CTA holds all the cluster's pairs and computes the same
//     new position: no barrier of the whole cluster on the step's path, no round trip through
//     global memory, no second kernel. The order is a total one, so the result does not depend on the tiling.
//     The pairs are double-buffered by step parity: a CTA sends parity p's pairs again two
//     steps on, after a wait that needs every CTA's pairs of the step between, which each
//     sends after it has read these;
//   - with subpixel offsets each CTA keeps its tiles' responses (double-buffered by step
//     parity), and CTA 0 reads the four neighbours of the maximum from the CTAs that own them,
//     the values the argmax saw, made visible by the senders' release on the barrier.
// A step has two CTA barriers (the first tile landed, the row sums written; a third where a
// CTA has a next tile) and no barrier of the whole cluster. On an H100 a step at the large
// target's window (105x105, L = 149, C = 15) takes about 9.1 us against a cluster FMA bound of
// 2.9 us: the passes about 5.5, each thread's 149-tap chain on one or two warps a scheduler
// (fewer outputs a thread were bound by I2F or shared memory), the first copy 1.3, the rest
// 1.0 (tools/dog_scan_split.py --kernel dog_scan_tiled; PERF.md).
// The wrapper picks between the two kernels by shape (ops/tracker_kernel.py::kernel_for: dog_scan
// where the whole window fits one CTA), and picks C from the tile count and
// cudaOccupancyMaxActiveClusters before the launch; a launch that cannot be scheduled fails and
// raises.
//
// Segments: a launch may run S chunk scans of T steps each, one after the other in every lane,
// as the JAX package's group dispatch runs S scans in one program (pawsometracker_tpu/
// pipeline.py: make_super_chain :199-230, make_chained_batch :248-277, make_super_chain_batch
// :280-309, make_super_full :2173-2190). Segment s of lane b reads its frames at
// s * frame_stride + b * lane_stride and its deltas, lo, hi, ks and origins at s * arg_stride;
// its outputs go to [s][b]. Between segments the lane's start is, as SegmentChain says: where
// the last step left it (no ks: the full-frame chain), the position of the segment's step
// max(ks-1, 0) (ks without a carry: the single-lane chain, which the next segment's deltas[0]
// rebases), or carry - origin0 of the next segment, the absolute carry becoming the position
// of step ks-1 plus origin_last at the end of each segment with ks > 0 (a carry: the batched
// chain; with S = 1 that is make_chained_batch). The chain lives in registers: every thread
// computes every step's position from the cluster's exchange of maxima, so
// every thread holds the same chain and the host sees no position between segments. A step's
// arithmetic does not change. In dog_scan each CTA's prefetch of a segment's first patch is the
// superset over the last step's outcomes shifted by the rebase, or the exact rows where the
// chain already holds the start (a segment with ks < T). Both kernels are compiled twice: a
// launch of one segment without a chain takes the instantiation without segments (kSeg
// false), so a chunk scan carries no segment state in its registers (both kernels compile for
// up to 640 threads a CTA, at a register cap where that state cost 4% a step).
//
// Summation order decides argmax ties, so the plain PyTorch version
// (ops/filters.py::separable_correlate_valid) emulates this FMA sequence exactly; both kernels
// agree with it bit for bit on any input, lane by lane, however the window is tiled. Keep them
// in step.
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

// A launch's segments (see the note above). S = 1 with no ks and no carry is a plain chunk scan.
struct Segments {
  int S;                   // segments of T steps each lane runs, one after the other
  long long frame_stride;  // bytes from one segment's frames to the next's
  long long arg_stride;    // int32 elements from one segment's deltas, lo, hi, ks, origins to
                           // the next's
  const int32_t* ks;       // [S][B] real steps of each segment, or null (the full-frame chain)
  const int32_t* origin0;      // [S][B][2] with a carry: each segment's first crop origin
  const int32_t* origin_last;  // [S][B][2] with a carry: the origin of its step ks-1
  const int32_t* carry_in;     // [B][2] absolute carry at the launch, or null
  int32_t* carry_out;          // [B][2] absolute carry after the last segment (may alias
                               // carry_in), or null
};

// One lane's chain from a segment to the next, kept alike by every thread. The launch's
// Segments stay in the kernel's parameter space; each call reads what it needs.
struct SegmentChain {
  int lane, T;
  int cap;     // the segment's step whose position the chain keeps, -1 for none
  int ci, cj;  // that position (ks without a carry), or the absolute carry

  __device__ __forceinline__ SegmentChain(const Segments& sg, int lane_, int T_)
      : lane(lane_), T(T_), cap(-1), ci(0), cj(0) {
    if (sg.carry_in) {
      ci = sg.carry_in[2 * lane];
      cj = sg.carry_in[2 * lane + 1];
    }
  }
  // Enter segment s: set what it captures and, with a carry or past segment 0 without one,
  // its start p (before deltas[0]); without ks p stays where the last step left it.
  __device__ __forceinline__ void begin(const Segments& sg, int s, int& pi, int& pj) {
    if (!sg.ks) return;
    const long long a = s * sg.arg_stride;
    const int k = min(sg.ks[a + lane], T);
    if (sg.carry_in) {
      cap = k > 0 ? k - 1 : -1;
      pi = ci - sg.origin0[a + 2 * lane];
      pj = cj - sg.origin0[a + 2 * lane + 1];
    } else {
      cap = max(k - 1, 0);
      if (s > 0) {
        pi = ci;
        pj = cj;
      }
    }
  }
  // Step t of segment s ended at (ni, nj). (origin_last is read here, not kept: dog_scan
  // runs at its register cap.)
  __device__ __forceinline__ void step(const Segments& sg, int s, int t, int ni, int nj) {
    if (t != cap) return;
    const long long a = s * sg.arg_stride + 2 * lane;
    ci = ni + (sg.carry_in ? sg.origin_last[a] : 0);
    cj = nj + (sg.carry_in ? sg.origin_last[a + 1] : 0);
  }
  // At the last step of segment s (s + 1 < S): true with the next segment's start in (fi, fj)
  // when the chain already holds it; else the start is this step's position plus (oi, oj).
  __device__ __forceinline__ bool next_start(const Segments& sg, int s, int& fi, int& fj,
                                             int& oi, int& oj) const {
    oi = oj = 0;
    if (!sg.ks) return false;
    int bi = 0, bj = 0;
    if (sg.carry_in) {
      const long long a = (s + 1) * sg.arg_stride;
      bi = -sg.origin0[a + 2 * lane];
      bj = -sg.origin0[a + 2 * lane + 1];
    }
    if (cap == T - 1) {
      if (sg.carry_in) {
        const long long a = s * sg.arg_stride + 2 * lane;
        bi += sg.origin_last[a];
        bj += sg.origin_last[a + 1];
      }
      oi = bi;
      oj = bj;
      return false;
    }
    fi = ci + bi;
    fj = cj + bj;
    return true;
  }
};

// ---- the cluster and the copies, shared by both kernels -------------------------------------

constexpr int kR = 7;            // outputs per thread along each pass (41 = 6 * 7 - 1)
constexpr int kThreads = 640;    // the largest CTA of either kernel: 20 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;  // CTAs of one cluster; above 8 a non-portable size

// The cluster's barrier: every thread of every CTA arrives (its shared-memory writes released
// to the cluster) and waits (the others' acquired).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The same barrier in halves: arrive (nothing released), and later wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Address of `p` (this CTA's shared memory) in CTA `rank`'s shared memory, and loads from it.
__device__ __forceinline__ unsigned dsmem_addr(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ float dsmem_f32(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ int dsmem_s32(unsigned addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
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
// fill; a chunk across the frame's left or right edge is read whole by one 16-byte load when
// all its bytes lie inside the frame's H*W bytes (the bytes past a row's end are the next row's)
// and its bytes outside the row replaced by the fill: one load's latency, not sixteen in a row.
// Only the frame's first chunk and its last, whose block may start before the frame or end past
// it, go byte by byte, so no load leaves the frame. Thread tid of nthreads.
template <bool kAligned>
__device__ __forceinline__ void load_region(uint8_t* buf, int* shift, const uint8_t* frame, int H,
                                            int W, int r0, int nrows, int c0, int ncols,
                                            int pitch, int fill, int tid, int nthreads) {
  const int nch = pitch >> 4;
  const unsigned f4 = 0x01010101u * (unsigned)fill;
  const uint4 f16 = make_uint4(f4, f4, f4, f4);
  for (int idx = tid; idx < nrows * nch; idx += nthreads) {
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
    } else if (roff + cb < 0 || roff + cb + 16 > (long long)H * W) {
      for (int b = 0; b < 16; ++b) {
        const int c = cb + b;
        dst[b] = (c >= 0 && c < W) ? frame[roff + c] : (uint8_t)fill;
      }
    } else {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(frame + roff + cb));
      unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = cb + 4 * q + b;
          if (c < 0 || c >= W) w[q] = (w[q] & ~(0xffu << (8 * b))) | ((unsigned)fill << (8 * b));
        }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
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

// ---- dog_scan_kernel: one cluster a lane, row blocks split over its CTAs, prefetched rows ----

// Shared-memory layout and block size of one CTA of dog_scan_kernel, from (L, ri, rj) and the
// cluster's C CTAs; the host sizes the launch with it (ops/tracker_kernel.py::scan_plan mirrors
// it).
struct ScanLayout {
  int nbv, nbh;  // row blocks of kR output rows in the window, column blocks of kR columns
  int slots;     // row blocks of one CTA: ceil(nbv / C); CTA r owns [r * slots, (r + 1) * slots)
  int threads;   // the CTA's threads: its row-pass (slots * pw) or column-pass (slots * kR * nbh)
                 // items or a quarter of the chunks of its copy (brows * pitch / 16), whichever
                 // are more, in whole warps, at most kThreads
  int brows;     // rows of one superset buffer: 2ri + slots*kR + L (the row-blocked reads' slack)
  int pitch;     // bytes of one buffer row: the 4rj + L superset columns, up to 15 bytes of
                 // row offset, in whole 16-byte chunks
  int pitch2;    // float2 pairs of one row-pass row: nbh*kR + L, odd (no bank conflicts)
  long long off_rows, off_taps, off_resp, off_shift, bytes;
};

__host__ __device__ inline ScanLayout scan_layout(int L, int ri, int rj, int cluster) {
  ScanLayout s;
  const int wh = 2 * ri + 1, ww = 2 * rj + 1, pw = ww + L - 1;
  s.nbv = (wh + kR - 1) / kR;
  s.nbh = (ww + kR - 1) / kR;
  s.slots = (s.nbv + cluster - 1) / cluster;
  s.brows = 2 * ri + s.slots * kR + L;
  s.pitch = 16 * ((4 * rj + L + 30) / 16);
  const int items = max(max(s.slots * pw, s.slots * kR * s.nbh), s.brows * (s.pitch / 16) / 4);
  s.threads = min(kThreads, 32 * ((items + 31) / 32));
  s.pitch2 = (s.nbh * kR + L) | 1;
  s.off_rows = 2LL * s.brows * s.pitch;                     // [2][brows][pitch] u8 supersets
  s.off_taps = s.off_rows + 8LL * s.slots * kR * s.pitch2;  // [slots*kR][pitch2] float2 row sums
  s.off_resp = s.off_taps + 8LL * L;                        // [L] float2 (centre, surround) taps
  s.off_shift = s.off_resp + 8LL * s.slots * kR * ww;       // [2][slots*kR][ww] f32 responses
  s.bytes = s.off_shift + 8LL * s.brows;                    // [2][brows] i32 row offsets
  return s;
}

// Lane b is the cluster of the C CTAs with blockIdx.y = b; CTA r (blockIdx.x) owns the window's
// output rows [a_lo, a_lo + nrow): row blocks r * slots .. (r + 1) * slots - 1.
template <bool kAligned, bool kSeg>
__global__ void __launch_bounds__(kThreads)
dog_scan_kernel(const uint8_t* __restrict__ frames, long long lane_stride, int T, int H, int W,
                const int32_t* __restrict__ pos0, const uint8_t* __restrict__ fills,
                const int32_t* __restrict__ deltas, const int32_t* __restrict__ lo,
                const int32_t* __restrict__ hi, const float* __restrict__ taps, int L, int ri,
                int rj, float direction, int32_t* __restrict__ out_pos,
                float* __restrict__ out_off, Segments sg) {
  extern __shared__ __align__(16) unsigned char smem[];
  // this cluster's lane: in segment s its frames [T,H,W] at s * frame_stride + chain *
  // lane_stride, its rows [T,2] of deltas, lo, hi at s * arg_stride + chain * 2T and of out_pos
  // and out_off at (s * B + chain) * 2T; pos0 [2] and its fill. Without kSeg (a chunk scan:
  // S = 1, no chain) s stays 0 and the segment terms compile away.
  const int chain = blockIdx.y, B = gridDim.y;
  const int rank = blockIdx.x, C = gridDim.x;  // the grid's x dimension is one cluster
  const long long lane_rows = 2LL * T * chain;
  frames += chain * lane_stride;
  const int fill = fills[chain];
  const int G = kSeg ? sg.S * T : T;  // the lane's steps, segment after segment
  // step (s, t)'s row of deltas, lo and hi, of the outputs, and its frame; and the step after
  auto arg_row = [&](int s, int t) {
    return (kSeg ? s * sg.arg_stride : 0LL) + lane_rows + 2 * t;
  };
  auto out_row = [&](int s, int t) {
    return 2LL * T * ((kSeg ? (long long)s * B : 0LL) + chain) + 2 * t;
  };
  auto frame_of = [&](int s, int t) {
    return frames + (kSeg ? s * sg.frame_stride : 0LL) + (size_t)t * H * W;
  };
  auto next = [&](int& s, int& t) {
    if (++t == T) {
      t = 0;
      ++s;
    }
  };

  const ScanLayout ly = scan_layout(L, ri, rj, C);
  const int wh = 2 * ri + 1, ww = 2 * rj + 1;
  const int pw = ww + L - 1;
  const int pad_i = ri + L / 2, pad_j = rj + L / 2;
  const int band = ly.slots * kR;              // output rows a CTA owns at most
  const int a_lo = min(rank * band, wh);       // this CTA's first output row
  const int nrow = min(band, wh - a_lo);       // its output rows (0 for a CTA past the window)
  const int nblk = (nrow + kR - 1) / kR;       // its row blocks
  const int prow = nrow + L - 1;               // the patch rows they read
  const int buf_bytes = ly.brows * ly.pitch;
  uint8_t* bufs = smem;                                          // [2][brows][pitch]
  float2* rows = reinterpret_cast<float2*>(smem + ly.off_rows);  // [band][pitch2]
  float2* tp = reinterpret_cast<float2*>(smem + ly.off_taps);    // [L] (centre, surround)
  float* resp = reinterpret_cast<float*>(smem + ly.off_resp);    // [2][band][ww]
  int* shifts = reinterpret_cast<int*>(smem + ly.off_shift);     // [2][brows]
  __shared__ float s_v[2][kWarps];  // each warp's (max, column-major index), by step parity
  __shared__ int s_k[2][kWarps];

  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  // the warps that can hold a column-pass item, in any CTA of the cluster: only their maxima
  // are exchanged
  const int nwx = min(nthreads >> 5, (band * ly.nbh + 31) / 32);
  for (int k = tid; k < L; k += nthreads) tp[k] = make_float2(taps[k], taps[L + k]);
  if (!kAligned)
    for (int k = tid; k < 2 * ly.brows; k += nthreads) shifts[k] = 0;
  __syncthreads();

  // Every thread of every CTA carries the position and this step's box in registers: p,
  // deltas[g], lo[g], hi[g] and deltas[g+1] (the prefetch needs it), the next step's read one
  // step ahead; and the chain between segments. All compute them alike.
  SegmentChain sc(sg, chain, T);
  int pi = 0, pj = 0;
  if (pos0) {
    pi = pos0[2 * chain];
    pj = pos0[2 * chain + 1];
  }
  if constexpr (kSeg) sc.begin(sg, 0, pi, pj);
  int d0i = 0, d0j = 0, d1i = 0, d1j = 0;
  int lo_i = 0, lo_j = 0, hi_i = H - 1, hi_j = W - 1;
  if (deltas) {
    int s1 = 0, t1 = 0;
    next(s1, t1);
    d0i = deltas[arg_row(0, 0)];
    d0j = deltas[arg_row(0, 0) + 1];
    if (G > 1) {
      d1i = deltas[arg_row(s1, t1)];
      d1j = deltas[arg_row(s1, t1) + 1];
    }
    lo_i = lo[arg_row(0, 0)];
    lo_j = lo[arg_row(0, 0) + 1];
    hi_i = hi[arg_row(0, 0)];
    hi_j = hi[arg_row(0, 0) + 1];
  }

  // step 0's rows of this CTA, loaded synchronously; (sr0, sc0) is where the current buffer's
  // region starts in the frame
  int sr0 = clampi(pi + d0i, 0, H - 1) - pad_i + a_lo, sc0 = clampi(pj + d0j, 0, W - 1) - pad_j;
  if (nrow > 0)
    load_region<kAligned>(bufs, shifts, frame_of(0, 0), H, W, sr0, prow, sc0, pw, ly.pitch, fill,
                          tid, nthreads);
  cp_async_wait_all();
  __syncthreads();

  int s = 0, t = 0;  // this step's segment and step in it
  for (int g = 0; g < G; ++g) {
    int sn = s, tn = t;  // step g+1's
    next(sn, tn);
    const int par = g & 1;
    const uint8_t* bcur = bufs + par * buf_bytes;
    const int* shcur = shifts + par * ly.brows;
    const int qi = pi + d0i, qj = pj + d0j;  // p
    const int oi = clampi(qi, 0, H - 1) - pad_i, oj = clampi(qj, 0, W - 1) - pad_j;

    // Prefetch this CTA's superset of step g+1's rows into the other buffer, and read step
    // g+1's box and step g+2's rebase. Step g+1 starts from this step's position (plus the
    // rebase of a segment boundary), or, at a boundary, from a position the chain already
    // holds.
    int nsr0 = 0, nsc0 = 0;
    int d2i = 0, d2j = 0, nlo_i = 0, nlo_j = 0, nhi_i = H - 1, nhi_j = W - 1;
    if (g + 1 < G) {
      int fi = 0, fj = 0, ofi = 0, ofj = 0;
      const bool fixed = kSeg && t == T - 1 && sc.next_start(sg, s, fi, fj, ofi, ofj);
      const int ai = fixed ? fi : clampi(qi - ri, lo_i, hi_i) + ofi;
      const int aj = fixed ? fj : clampi(qj - rj, lo_j, hi_j) + ofj;
      const int bi = fixed ? fi : clampi(qi + ri, lo_i, hi_i) + ofi;
      const int bj = fixed ? fj : clampi(qj + rj, lo_j, hi_j) + ofj;
      nsr0 = clampi(ai + d1i, 0, H - 1) - pad_i + a_lo;
      nsc0 = clampi(aj + d1j, 0, W - 1) - pad_j;
      if (nrow > 0) {
        const int r1 = clampi(bi + d1i, 0, H - 1) - pad_i + a_lo + prow;
        const int c1 = clampi(bj + d1j, 0, W - 1) - pad_j + pw;
        load_region<kAligned>(bufs + (par ^ 1) * buf_bytes, shifts + (par ^ 1) * ly.brows,
                              frame_of(sn, tn), H, W, nsr0, r1 - nsr0, nsc0, c1 - nsc0, ly.pitch,
                              fill, tid, nthreads);
      }
      cp_async_commit();
      if (deltas) {
        nlo_i = lo[arg_row(sn, tn)];
        nlo_j = lo[arg_row(sn, tn) + 1];
        nhi_i = hi[arg_row(sn, tn)];
        nhi_j = hi[arg_row(sn, tn) + 1];
        if (g + 2 < G) {
          int s2 = sn, t2 = tn;
          next(s2, t2);
          d2i = deltas[arg_row(s2, t2)];
          d2j = deltas[arg_row(s2, t2) + 1];
        }
      }
    }

    // Row pass over this CTA's blocks: rows[a][x] = (sum_k gc[k] P[a_lo+a+k][x], sum_k gs[k]
    // P[a_lo+a+k][x]), kR rows a thread.
    const int orow = oi + a_lo - sr0;
    const int ocol = oj - sc0 + (kAligned ? (sc0 & 15) : 0);
    for (int it = tid; it < nblk * pw; it += nthreads) {
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
        if (a0 + i < nrow) rows[(a0 + i) * ly.pitch2 + x] = make_float2(ac[i], as[i]);
    }
    __syncthreads();

    // Column pass over this CTA's rows, kR columns a thread (lanes along the rows), the
    // response kept by step parity with subpixel offsets, and each thread's first maximum in
    // column-major order.
    float bv = -INFINITY;
    int bk = INT_MAX;
    float* rcur = resp + par * band * ww;
    for (int it = tid; it < nrow * ly.nbh; it += nthreads) {
      const int blk = it / nrow, a = it - blk * nrow;
      const int b0 = blk * kR;
      const float2* rp = rows + a * ly.pitch2 + b0;
      float rc[kR], rs[kR];
      blocked_taps<float2>(tp, L, [&](int m) { return rp[m]; }, rc, rs);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int b = b0 + i;
        if (b < ww) {
          const float v = direction * (rc[i] - rs[i]);
          if (out_off) rcur[a * ww + b] = v;
          keep_better(v, b * wh + a_lo + a, bv, bk);
        }
      }
    }
    warp_argmax(bv, bk);
    if (lane == 0 && warp < nwx) {
      s_v[par][warp] = bv;
      s_k[par][warp] = bk;
    }
    cp_async_wait_all();  // this thread's copies of the next rows have landed

    // The exchange: one cluster barrier, then every warp of every CTA reads the pair of every
    // warp with column items through distributed shared memory (its own CTA's first) and
    // reduces them. keep_better is a total order, so the result does not depend on C.
    cluster_sync();
    bv = -INFINITY;
    bk = INT_MAX;
    for (int i = lane; i < C * nwx; i += 32) {
      const unsigned cta = (rank + i / nwx) % C, w = i % nwx;
      keep_better(dsmem_f32(dsmem_addr(&s_v[par][w], cta)),
                  dsmem_s32(dsmem_addr(&s_k[par][w], cta)), bv, bk);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, o);
      keep_better(ov, ok, bv, bk);
    }
    const int row = bk % wh, col = bk / wh;
    const int ni = clampi(qi - ri + row, lo_i, hi_i);
    const int nj = clampi(qj - rj + col, lo_j, hi_j);
    if (rank == 0 && warp == 0) {
      float nv = 0.f;
      if (out_off && lane < 4) {
        // the four neighbours of the maximum, read from the responses of the CTAs that own
        // their rows: the values the argmax saw
        const int a = lane == 0 ? max(row - 1, 0) : lane == 1 ? min(row + 1, wh - 1) : row;
        const int b = lane == 2 ? max(col - 1, 0) : lane == 3 ? min(col + 1, ww - 1) : col;
        const int owner = a / band;
        nv = dsmem_f32(dsmem_addr(resp + (par * band + a - owner * band) * ww + b, owner));
      }
      const float rm = __shfl_sync(0xffffffffu, nv, 0), rp = __shfl_sync(0xffffffffu, nv, 1);
      const float cm = __shfl_sync(0xffffffffu, nv, 2), cp = __shfl_sync(0xffffffffu, nv, 3);
      if (lane == 0) {
        const long long o = out_row(s, t);
        out_pos[o] = ni;
        out_pos[o + 1] = nj;
        if (out_off) {
          const float m0 = bv;
          const float den_r = rm - 2.0f * m0 + rp;
          const float den_c = cm - 2.0f * m0 + cp;
          const bool int_r = row > 0 && row < wh - 1 && den_r < 0.f;
          const bool int_c = col > 0 && col < ww - 1 && den_c < 0.f;
          out_off[o] = int_r ? 0.5f * (rm - rp) / den_r : 0.f;
          out_off[o + 1] = int_c ? 0.5f * (cm - cp) / den_c : 0.f;
        }
      }
    }
    pi = ni;
    pj = nj;
    if constexpr (kSeg) {
      sc.step(sg, s, t, ni, nj);
      if (t == T - 1 && s + 1 < sg.S) sc.begin(sg, s + 1, pi, pj);
    }
    s = sn;
    t = tn;
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
  // every CTA read carry_in before the first cluster barrier, so it may be overwritten now
  if (kSeg && sg.carry_out && rank == 0 && tid == 0) {
    sg.carry_out[2 * chain] = sc.ci;
    sg.carry_out[2 * chain + 1] = sc.cj;
  }
  cluster_sync();  // no CTA leaves while another may still read its shared memory
}

// ---- dog_scan_tiled_kernel: one thread-block cluster per lane --------------------------------

// (max, column-major index) as two words that order as keep_better does: the larger key
// (the response's bits made monotone) wins, then the smaller index. Every response of a launch
// is dir * (a difference of sums of non-negative products from +0.0), so its zeros all carry
// one sign and the order is keep_better's.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned h) {
  return __uint_as_float((h & 0x80000000u) ? (h & 0x7fffffffu) : ~h);
}
__device__ __forceinline__ void keep_better_key(unsigned h, unsigned k, unsigned& bh,
                                                unsigned& bk) {
  if (h > bh || (h == bh && k < bk)) {
    bh = h;
    bk = k;
  }
}
// The warp's best pair in every lane: two warp reductions, not five rounds of shuffles.
__device__ __forceinline__ void warp_best(unsigned& h, unsigned& k) {
  const unsigned m = __reduce_max_sync(0xffffffffu, h);
  k = __reduce_min_sync(0xffffffffu, h == m ? k : 0xffffffffu);
  h = m;
}

// The exchange's transaction barriers (mbarriers in this CTA's shared memory): each step's
// pairs arrive by st.async, which counts their bytes on the receiver's barrier, so a CTA waits
// for exactly the data it reads and no CTA waits on a barrier of the whole cluster.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// One arrival of this CTA on `bar`, announcing `bytes` to come for the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of `bar` with this parity completes; what the senders wrote before their
// st.async is then visible (acquire at cluster scope).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(smem_u32(bar)), "r"(parity)
                 : "memory");
}
// Store 8 bytes at `addr` in another CTA's shared memory (addresses from dsmem_addr), counted on
// its barrier at `bar_addr`; the count releases this thread's earlier writes at cluster scope.
__device__ __forceinline__ void st_async_b64(unsigned addr, unsigned long long v,
                                             unsigned bar_addr) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "l"(v), "r"(bar_addr)
               : "memory");
}

// load_region for a step's first tile: where the region lies inside the frame (rows and
// columns, and the chunks of its first and last row inside the frame's bytes, so no load
// leaves the frame), every chunk is one cp.async and each thread keeps one chunk column and
// steps down the rows, with no division in the loop (a CTA sized to its passes issues ten
// chunks a thread, PERF.md); elsewhere load_region's chunks and fills. Thread tid of nthreads.
template <bool kAligned>
__device__ __forceinline__ void load_tile(uint8_t* buf, int* shift, const uint8_t* frame, int H,
                                          int W, int r0, int nrows, int c0, int ncols, int pitch,
                                          int fill, int tid, int nthreads) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(frame);
  const uintptr_t first = base + (uintptr_t)((long long)r0 * W + c0);
  const uintptr_t end = base + (uintptr_t)((long long)(r0 + nrows - 1) * W + c0 + ncols);
  const bool inside = r0 >= 0 && r0 + nrows <= H && c0 >= 0 && c0 + ncols <= W &&
                      (first & ~(uintptr_t)15) >= base &&
                      ((end + 15) & ~(uintptr_t)15) <= base + (uintptr_t)((long long)H * W);
  if (!inside) {
    load_region<kAligned>(buf, shift, frame, H, W, r0, nrows, c0, ncols, pitch, fill, tid,
                          nthreads);
    return;
  }
  const int nch = pitch >> 4, per = nthreads / nch;
  if (tid >= per * nch) return;
  const int j = tid % nch;
  for (int u = tid / nch; u < nrows; u += per) {
    const uintptr_t a = first + (uintptr_t)((long long)u * W);
    const int sh = (int)(a & 15);
    if (!kAligned && j == 0) shift[u] = sh;
    if (16 * j < sh + ncols)
      cp_async16(buf + u * pitch + 16 * j, reinterpret_cast<const void*>(a - sh + 16 * j));
  }
}

// Shared-memory layout of one CTA of dog_scan_tiled_kernel, from L, the output tile (th x tw,
// both multiples of kR) and the response slots (tiles a CTA owns; 0 without subpixel offsets).
struct TiledLayout {
  int brows;   // patch rows: th + L (the row-blocked reads' slack row included)
  int pitch;   // bytes of one patch row: its tw + L - 1 columns, up to 15 bytes of row offset,
               // in whole 16-byte chunks
  int pitch2;  // float2 pairs of one row-sum row: tw + L, odd (no bank conflicts)
  long long off_rows, off_taps, off_pairs, off_resp, off_shift, bytes;
};

__host__ __device__ inline TiledLayout tiled_layout(int L, int th, int tw, int resp_slots) {
  TiledLayout s;
  s.brows = th + L;
  s.pitch = 16 * ((tw + L + 29) / 16);
  s.pitch2 = (tw + L) | 1;
  s.off_rows = (long long)s.brows * s.pitch;                 // [brows][pitch] u8 tile patch
  s.off_taps = s.off_rows + 8LL * th * s.pitch2;             // [th][pitch2] float2 row sums
  s.off_pairs = s.off_taps + 8LL * L;                        // [L] float2 (centre, surround) taps
  s.off_resp = s.off_pairs + 16LL * kMaxCluster * kWarps;    // [2][16 * 20] (key, index) pairs
  s.off_shift = s.off_resp + 8LL * resp_slots * th * tw;     // [2][slots][th][tw] f32 response
  s.bytes = s.off_shift + 4LL * s.brows;                     // [brows] i32 row offsets
  return s;
}

// Lane b is the cluster of the C CTAs with blockIdx.y = b; CTA r (blockIdx.x) owns output tiles
// r, r + C, r + 2C, ... of the window (row-major over the ntr x ntc tiles of th x tw outputs).
template <bool kAligned, bool kSeg>
__global__ void __launch_bounds__(kThreads)
dog_scan_tiled_kernel(const uint8_t* __restrict__ frames, long long lane_stride, int T, int H,
                      int W, const int32_t* __restrict__ pos0, const uint8_t* __restrict__ fills,
                      const int32_t* __restrict__ deltas, const int32_t* __restrict__ lo,
                      const int32_t* __restrict__ hi, const float* __restrict__ taps, int L,
                      int ri, int rj, float direction, int32_t* __restrict__ out_pos,
                      float* __restrict__ out_off, int th, int tw, Segments sg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chain = blockIdx.y, B = gridDim.y;
  const int rank = blockIdx.x, C = gridDim.x;  // the grid's x dimension is one cluster
  // the lane's rows and frames of step (s, t), as in dog_scan_kernel; without kSeg the lane's
  // pointers move to its rows once, as the plain chunk scan had them
  const long long lane_rows = 2LL * T * chain;
  frames += chain * lane_stride;
  const int fill = fills[chain];
  if constexpr (!kSeg) {
    if (deltas) deltas += lane_rows;
    if (lo) lo += lane_rows;
    if (hi) hi += lane_rows;
    out_pos += lane_rows;
    if (out_off) out_off += lane_rows;
  }
  const int G = kSeg ? sg.S * T : T;  // the lane's steps, segment after segment
  auto arg_row = [&](int s, int t) {
    return kSeg ? s * sg.arg_stride + lane_rows + 2 * t : 2LL * t;
  };
  auto out_row = [&](int s, int t) {
    return kSeg ? 2LL * T * ((long long)s * B + chain) + 2 * t : 2LL * t;
  };
  auto next = [&](int& s, int& t) {
    if (++t == T) {
      t = 0;
      ++s;
    }
  };

  const int wh = 2 * ri + 1, ww = 2 * rj + 1;
  const int pad_i = ri + L / 2, pad_j = rj + L / 2;
  const int ntc = (ww + tw - 1) / tw, nt = ((wh + th - 1) / th) * ntc;
  const int slots = (nt + C - 1) / C;
  const int pw = tw + L - 1;  // row sums a tile needs per row
  const int nbv = th / kR, nbh = tw / kR;
  // the warps that can hold a column-pass item: only their maxima are exchanged
  const int nthreads = blockDim.x;
  const int nwx = min(nthreads >> 5, (th * nbh + 31) / 32);
  const TiledLayout ly = tiled_layout(L, th, tw, out_off ? slots : 0);
  uint8_t* patch = smem;                                           // [brows][pitch]
  float2* rows = reinterpret_cast<float2*>(smem + ly.off_rows);    // [th][pitch2]
  float2* tp = reinterpret_cast<float2*>(smem + ly.off_taps);      // [L] (centre, surround)
  uint2* pairs = reinterpret_cast<uint2*>(smem + ly.off_pairs);    // [2][16 * 20], C * nwx used
  float* resp = reinterpret_cast<float*>(smem + ly.off_resp);      // [2][slots][th][tw]
  int* shifts = reinterpret_cast<int*>(smem + ly.off_shift);       // [brows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < L; k += nthreads) tp[k] = make_float2(taps[k], taps[L + k]);
  __shared__ uint64_t s_bar[2];  // the exchange's barriers, by step parity
  if (tid == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive_relaxed();  // this CTA runs; the first step's exchange waits for all of them

  // every thread of every CTA computes each step's position from the cluster's exchange, so
  // every thread holds the same chain between segments; and this step's deltas and box, the
  // next step's read while this one runs
  SegmentChain sc(sg, chain, T);
  int pi = 0, pj = 0;
  if (!kSeg || pos0) {  // (a carry replaces pos0)
    pi = pos0[2 * chain];
    pj = pos0[2 * chain + 1];
  }
  if constexpr (kSeg) sc.begin(sg, 0, pi, pj);
  int d0i = 0, d0j = 0, lo_i = 0, lo_j = 0, hi_i = H - 1, hi_j = W - 1;
  if (deltas) {
    const long long a = arg_row(0, 0);
    d0i = deltas[a];
    d0j = deltas[a + 1];
    lo_i = lo[a];
    lo_j = lo[a + 1];
    hi_i = hi[a];
    hi_j = hi[a + 1];
  }

  int s = 0, t = 0;  // this step's segment and step in it
  for (int g = 0; g < G; ++g) {
    int sn = s, tn = t;  // step g+1's
    next(sn, tn);
    const uint8_t* frame = frames + (kSeg ? s * sg.frame_stride : 0LL) + (size_t)t * H * W;
    const int qi = pi + d0i, qj = pj + d0j;  // p
    const int r0 = clampi(qi, 0, H - 1) - pad_i;  // frame row and column of the patch origin
    const int c0 = clampi(qj, 0, W - 1) - pad_j;
    const int par = g & 1;
    float* rcur = resp + par * slots * th * tw;
    int d1i = 0, d1j = 0, nlo_i = 0, nlo_j = 0, nhi_i = H - 1, nhi_j = W - 1;
    if (deltas && g + 1 < G) {  // step g+1's, read now, off the step's path
      const long long a = arg_row(sn, tn);
      d1i = deltas[a];
      d1j = deltas[a + 1];
      nlo_i = lo[a];
      nlo_j = lo[a + 1];
      nhi_i = hi[a];
      nhi_j = hi[a + 1];
    }

    // the first tile's patch, loaded synchronously; each next one is copied while the current
    // tile's column pass runs (the row pass is done with the patch by then)
    if (rank < nt) {
      const int tr = rank / ntc, tc = rank - tr * ntc;
      load_tile<kAligned>(patch, shifts, frame, H, W, r0 + tr * th, ly.brows, c0 + tc * tw, pw,
                          ly.pitch, fill, tid, nthreads);
    }
    cp_async_wait_all();
    __syncthreads();

    float bv = -INFINITY;
    int bk = INT_MAX;
    for (int sl = 0; sl < slots; ++sl) {
      const int id = rank + sl * C;
      if (id >= nt) break;
      const int tr = id / ntc, tc = id - tr * ntc;

      // Row pass: rows[a][x] = (sum_k gc[k] P[a+k][x], sum_k gs[k] P[a+k][x]), kR rows a thread.
      const int ocol = kAligned ? ((c0 + tc * tw) & 15) : 0;
      for (int it = tid; it < nbv * pw; it += nthreads) {
        const int blk = it / pw, x = it - blk * pw;
        const int a0 = blk * kR;
        const uint8_t* col = patch + a0 * ly.pitch + ocol + x;
        const int* sh = shifts + a0;
        const int pitch = ly.pitch;
        float ac[kR], as[kR];
        blocked_taps<float>(tp, L, [&](int m) {
          return (float)col[m * pitch + (kAligned ? 0 : sh[m])];
        }, ac, as);
#pragma unroll
        for (int i = 0; i < kR; ++i) rows[(a0 + i) * ly.pitch2 + x] = make_float2(ac[i], as[i]);
      }
      __syncthreads();

      const int nid = id + C;
      const bool more = sl + 1 < slots && nid < nt;
      if (more) {
        const int nr = nid / ntc, nc = nid - nr * ntc;
        load_region<kAligned>(patch, shifts, frame, H, W, r0 + nr * th, ly.brows, c0 + nc * tw,
                              pw, ly.pitch, fill, tid, nthreads);
        cp_async_commit();
      }

      // Column pass, kR columns a thread, each output inside the window kept in this CTA's
      // running first maximum in column-major order (and in its response slot). Neighbouring
      // threads take neighbouring column blocks of one row: float2 reads 7 pairs apart, which
      // fall in distinct banks (a tile has too few rows to spread a warp along them).
      for (int it = tid; it < th * nbh; it += nthreads) {
        const int a = it / nbh, blk = it - a * nbh;
        const int b0 = blk * kR;
        const float2* rp = rows + a * ly.pitch2 + b0;
        float rc[kR], rs[kR];
        blocked_taps<float2>(tp, L, [&](int m) { return rp[m]; }, rc, rs);
        const int gr = tr * th + a;
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int gc = tc * tw + b0 + i;
          if (gr < wh && gc < ww) {
            const float v = direction * (rc[i] - rs[i]);
            if (out_off) rcur[(sl * th + a) * tw + b0 + i] = v;
            keep_better(v, gc * wh + gr, bv, bk);
          }
        }
      }
      if (more) {
        cp_async_wait_all();  // the next tile's patch has landed (this thread's copies)
        __syncthreads();      // ... and everyone's; the row sums are free again
      }
    }

    // The exchange: each warp that can hold a column item sends its pair into every CTA's
    // slot for it by st.async, counted on that CTA's barrier of this parity; every warp waits
    // for its own CTA's C * nwx pairs and reduces them from its own shared memory. The order
    // is a total one, so the result does not depend on which CTA held which tile. A CTA writes
    // parity p's slots again two steps on, after a wait that needs every CTA's next pairs,
    // which each sends after it has read these.
    unsigned h = order_key(bv), k = (unsigned)bk;
    warp_best(h, k);
    if (g == 0) cluster_wait();  // every CTA of the cluster runs: its barriers are there
    __syncwarp();                // the warp's responses are written before its sends release
    if (warp < nwx && lane < C)
      st_async_b64(dsmem_addr(&pairs[par * kMaxCluster * kWarps + rank * nwx + warp], lane),
                   ((unsigned long long)k << 32) | h, dsmem_addr(&s_bar[par], lane));
    if (tid == 0) mbar_expect_tx(&s_bar[par], 8u * C * nwx);
    mbar_wait(&s_bar[par], (g >> 1) & 1);
    h = 0;
    k = 0xffffffffu;
    for (int i = lane, n = C * nwx; i < n; i += 32) {
      const uint2 p = pairs[par * kMaxCluster * kWarps + i];
      keep_better_key(p.x, p.y, h, k);
    }
    warp_best(h, k);
    bv = key_value(h);
    bk = (int)k;
    const int row = bk % wh, col = bk / wh;
    const int ni = clampi(qi - ri + row, lo_i, hi_i);
    const int nj = clampi(qj - rj + col, lo_j, hi_j);

    if (rank == 0 && warp == 0) {
      float nv = 0.f;
      if (out_off && lane < 4) {
        // the four neighbours of the maximum, read from the response slots of the CTAs that
        // own them: the values the argmax saw
        const int a = lane == 0 ? max(row - 1, 0) : lane == 1 ? min(row + 1, wh - 1) : row;
        const int b = lane == 2 ? max(col - 1, 0) : lane == 3 ? min(col + 1, ww - 1) : col;
        const int tr = a / th, tc = b / tw, id = tr * ntc + tc;
        const float* cell =
            resp + ((par * slots + id / C) * th + (a - tr * th)) * tw + (b - tc * tw);
        nv = dsmem_f32(dsmem_addr(cell, id % C));
      }
      const float rm = __shfl_sync(0xffffffffu, nv, 0), rp = __shfl_sync(0xffffffffu, nv, 1);
      const float cm = __shfl_sync(0xffffffffu, nv, 2), cp = __shfl_sync(0xffffffffu, nv, 3);
      if (lane == 0) {
        const long long o = out_row(s, t);
        out_pos[o] = ni;
        out_pos[o + 1] = nj;
        if (out_off) {
          const float m0 = bv;
          const float den_r = rm - 2.0f * m0 + rp;
          const float den_c = cm - 2.0f * m0 + cp;
          const bool int_r = row > 0 && row < wh - 1 && den_r < 0.f;
          const bool int_c = col > 0 && col < ww - 1 && den_c < 0.f;
          out_off[o] = int_r ? 0.5f * (rm - rp) / den_r : 0.f;
          out_off[o + 1] = int_c ? 0.5f * (cm - cp) / den_c : 0.f;
        }
      }
    }
    pi = ni;
    pj = nj;
    if constexpr (kSeg) {
      sc.step(sg, s, t, ni, nj);
      if (t == T - 1 && s + 1 < sg.S) sc.begin(sg, s + 1, pi, pj);
    }
    s = sn;
    t = tn;
    d0i = d1i;
    d0j = d1j;
    lo_i = nlo_i;
    lo_j = nlo_j;
    hi_i = nhi_i;
    hi_j = nhi_j;
  }
  // every CTA read carry_in before the first cluster barrier, so it may be overwritten now
  if (kSeg && sg.carry_out && rank == 0 && threadIdx.x == 0) {
    sg.carry_out[2 * chain] = sc.ci;
    sg.carry_out[2 * chain + 1] = sc.cj;
  }
  cluster_sync();  // no CTA leaves while another may still read its shared memory
}

// Set a cluster kernel's attributes for `smem` bytes of dynamic shared memory and clusters of
// `cluster` CTAs (a non-portable size above 8).
template <class Kernel>
cudaError_t cluster_attributes(Kernel kernel, long long smem, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// A launch of grid (cluster, B) in clusters of (cluster, 1, 1), `threads` a CTA.
void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cluster, int B,
                    int threads, long long smem, void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, B, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The segments of a launch, or an error for arguments the kernels do not take.
cudaError_t make_segments(Segments* sg, int S, long long frame_stride, long long arg_stride,
                          const void* pos0, const void* ks, const void* origin0,
                          const void* origin_last, const void* carry_in, void* carry_out) {
  const bool carry = carry_in != nullptr;
  if (S <= 0 || frame_stride < 0 || arg_stride < 0) return cudaErrorInvalidValue;
  if (carry != (carry_out != nullptr) || carry != (origin0 != nullptr) ||
      carry != (origin_last != nullptr) || (carry && ks == nullptr) || (!carry && !pos0))
    return cudaErrorInvalidValue;
  *sg = Segments{S, frame_stride, arg_stride, (const int32_t*)ks, (const int32_t*)origin0,
                 (const int32_t*)origin_last, (const int32_t*)carry_in, (int32_t*)carry_out};
  return cudaSuccess;
}

// Whether a launch needs the kernels' segment path (kSeg): more than one segment, or a chain.
bool segmented(const Segments& sg) { return sg.S > 1 || sg.ks || sg.carry_in; }

bool aligned_frames(const void* frames, int W, long long lane_stride, long long frame_stride) {
  return reinterpret_cast<uintptr_t>(frames) % 16 == 0 && W % 16 == 0 && lane_stride % 16 == 0 &&
         frame_stride % 16 == 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of a dog_scan_kernel launch of `cluster` CTAs a lane, in
// bytes (scan_layout above).
long long dog_scan_smem_bytes(int L, int ri, int rj, int cluster) {
  return scan_layout(L, ri, rj, cluster).bytes;
}

// Dynamic shared memory of one CTA of a dog_scan_tiled_kernel launch, in bytes (tiled_layout
// above): tiles of tile_h x tile_w, `cluster` CTAs a lane, the response kept with `subpixel`.
long long dog_scan_tiled_smem_bytes(int L, int ri, int rj, int tile_h, int tile_w, int cluster,
                                    int subpixel) {
  const int nt = ((2 * ri + tile_h) / tile_h) * ((2 * rj + tile_w) / tile_w);
  return tiled_layout(L, tile_h, tile_w, subpixel ? (nt + cluster - 1) / cluster : 0).bytes;
}

// Both launchers run B lanes of S segments of T steps on `stream`, one thread-block cluster of
// `cluster` CTAs a lane (grid (cluster, B)). Device pointers:
// frames u8, segment s of lane b [T,H,W] contiguous at frames + s * frame_stride +
// b * lane_stride (lane_stride 0: all lanes read the same frames), fills [B] u8, taps [2L] f32
// (centre then surround), out_pos [S,B,T,2] i32; pos0 [B,2] i32, which a carry replaces and may
// then be null; deltas, lo and hi (segment s's [B,T,2] i32 at s * arg_stride) and out_off
// ([S,B,T,2] f32) may be null. The segments' chain (see the note above): ks ([S][B] at
// s * arg_stride) may be null; carry_in and carry_out ([B,2]) need ks, origin0 and origin_last
// ([S][B][2] at s * arg_stride) and come together; S = 1 with none of them is one chunk scan.
// They return cudaGetLastError() after launch.

// How many clusters of dog_scan_kernel with `cluster` CTAs a lane (its layout for L, ri, rj)
// the card runs at once (cudaOccupancyMaxActiveClusters), into *n_active; 0 means such a launch
// cannot be scheduled. The wrapper picks the cluster size from it before it launches.
int dog_scan_active_clusters(int L, int ri, int rj, int cluster, int* n_active) {
  *n_active = 0;
  if (cluster < 1 || cluster > kMaxCluster || L <= 0 || ri < 0 || rj < 0)
    return (int)cudaErrorInvalidValue;
  const ScanLayout ly = scan_layout(L, ri, rj, cluster);
  auto kernel = dog_scan_kernel<true, true>;
  cudaError_t e = cluster_attributes(kernel, ly.bytes, cluster);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, cluster, 1, ly.threads, ly.bytes, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(n_active, (const void*)kernel, &cfg);
}

// dog_scan_kernel: a window whose dog_scan_smem_bytes at `cluster` CTAs fit the card's limit,
// one cluster of `cluster` CTAs a lane (grid (cluster, B)). A launch the card cannot schedule
// returns its error; nothing runs in its place.
int dog_scan_launch(const void* frames, long long lane_stride, int B, int T, int H, int W,
                    const void* pos0, const void* fills, const void* deltas, const void* lo,
                    const void* hi, const void* taps, int L, int ri, int rj, float direction,
                    void* out_pos, void* out_off, int S, long long frame_stride,
                    long long arg_stride, const void* ks, const void* origin0,
                    const void* origin_last, const void* carry_in, void* carry_out, int cluster,
                    void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || lane_stride < 0 || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  Segments sg;
  cudaError_t e = make_segments(&sg, S, frame_stride, arg_stride, pos0, ks, origin0, origin_last,
                                carry_in, carry_out);
  if (e != cudaSuccess) return (int)e;
  const ScanLayout ly = scan_layout(L, ri, rj, cluster);
  const bool al = aligned_frames(frames, W, lane_stride, frame_stride);
  auto kernel = segmented(sg) ? (al ? dog_scan_kernel<true, true> : dog_scan_kernel<false, true>)
                              : (al ? dog_scan_kernel<true, false> : dog_scan_kernel<false, false>);
  e = cluster_attributes(kernel, ly.bytes, cluster);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, cluster, B, ly.threads, ly.bytes, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)frames, lane_stride, T, H, W,
                         (const int32_t*)pos0, (const uint8_t*)fills, (const int32_t*)deltas,
                         (const int32_t*)lo, (const int32_t*)hi, (const float*)taps, L, ri, rj,
                         direction, (int32_t*)out_pos, (float*)out_off, sg);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs, each with `smem` bytes of dynamic shared memory, the card
// runs at once (cudaOccupancyMaxActiveClusters), into *n_active; 0 means such a launch cannot be
// scheduled. The wrapper picks the cluster size from it before it launches.
int dog_scan_tiled_active_clusters(int cluster, long long smem, int* n_active) {
  *n_active = 0;
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  auto kernel = dog_scan_tiled_kernel<true, true>;
  cudaError_t e = cluster_attributes(kernel, smem, cluster);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, cluster, 1, kThreads, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(n_active, (const void*)kernel, &cfg);
}

// dog_scan_tiled_kernel: any window, one cluster of `cluster` CTAs a lane (grid (cluster, B)),
// in output tiles of tile_h x tile_w (multiples of 7). A launch the card cannot schedule
// returns its error; nothing runs in its place.
int dog_scan_tiled_launch(const void* frames, long long lane_stride, int B, int T, int H, int W,
                          const void* pos0, const void* fills, const void* deltas,
                          const void* lo, const void* hi, const void* taps, int L, int ri,
                          int rj, float direction, void* out_pos, void* out_off, int S,
                          long long frame_stride, long long arg_stride, const void* ks,
                          const void* origin0, const void* origin_last, const void* carry_in,
                          void* carry_out, int tile_h, int tile_w, int cluster, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || lane_stride < 0) return (int)cudaErrorInvalidValue;
  if (tile_h <= 0 || tile_w <= 0 || tile_h % kR != 0 || tile_w % kR != 0 || cluster < 1 ||
      cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  Segments sg;
  cudaError_t e = make_segments(&sg, S, frame_stride, arg_stride, pos0, ks, origin0, origin_last,
                                carry_in, carry_out);
  if (e != cudaSuccess) return (int)e;
  const long long smem =
      dog_scan_tiled_smem_bytes(L, ri, rj, tile_h, tile_w, cluster, out_off != nullptr);
  const bool al = aligned_frames(frames, W, lane_stride, frame_stride);
  auto kernel = segmented(sg)
                    ? (al ? dog_scan_tiled_kernel<true, true> : dog_scan_tiled_kernel<false, true>)
                    : (al ? dog_scan_tiled_kernel<true, false>
                          : dog_scan_tiled_kernel<false, false>);
  e = cluster_attributes(kernel, smem, cluster);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  // threads a CTA: its row-pass or column-pass items, whichever are more, in whole warps
  // (dog_scan_tiled_active_clusters counts kThreads, the most a launch takes)
  const int items = max(tile_h / kR * (tile_w + L - 1), tile_h * (tile_w / kR));
  cluster_config(&cfg, &attr, cluster, B, min(kThreads, 32 * ((items + 31) / 32)), smem, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)frames, lane_stride, T, H, W,
                         (const int32_t*)pos0, (const uint8_t*)fills, (const int32_t*)deltas,
                         (const int32_t*)lo, (const int32_t*)hi, (const float*)taps, L, ri, rj,
                         direction, (int32_t*)out_pos, (float*)out_off, tile_h, tile_w, sg);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* dog_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
