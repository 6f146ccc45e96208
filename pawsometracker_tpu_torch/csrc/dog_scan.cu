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
//      sequential f32 FMA sum over the L direct taps (no TF32, no tensor cores);
//   4. the first maximum in column-major order: a larger value wins, an equal value with the
//      smaller col*wh+row wins;
//   5. new pos = clamp(p - r + (row, col), lo[b,t], hi[b,t]) (the frame box when unbounded),
//      carried in shared memory to step t+1. It starts from p, not from the clamped origin, as
//      the XLA engine does (the Pallas kernel starts from the origin); the two differ only for
//      a p outside the frame, such as a start location off the frame;
//   6. with out_off set, per-axis parabolic offsets in [-0.5, 0.5] from the four neighbours
//      of the maximum, 0 at the window edge or where the response is not concave.
//
// What bounds it: at the bench shape (41x41 window, L = 65, patch 105x105) one step is about
// 1.56 MFLOP of direct taps (rows 2*2*41*105*65, columns 2*2*41*41*65) on about 11 KB of
// patch. The recurrence is sequential, so one chain is one CTA on one SM: the bound that
// matters is one SM's f32 FMA rate and the latency of the per-step argmax and its
// __syncthreads, not the card's memory or its 132-SM peak. Lanes are independent, so the grid
// is one CTA per lane (blockIdx.x = b) and lanes run on separate SMs: a launch of B <= 132
// lanes should take about the time of one chain. The design keeps the patch (as u8) and both
// row-pass sums in shared memory, so the frame is read once per step and nothing intermediate
// touches device memory. A window too large for shared memory (the quarter-frame autodetect
// snap, 271x481 at 1080p) is walked in output tiles, each with its apron, keeping a running
// (max, column-major index). Spreading one step over a cluster, TMA loads and tensor cores are
// left for later work.
//
// Summation order decides argmax ties, so the plain PyTorch version
// (ops/filters.py::separable_correlate_valid) emulates this FMA sequence exactly; the two agree
// bit for bit on any input, lane by lane. Keep them in step.
//
// Built with nvcc into a shared library with a plain C interface and bound with ctypes
// (pawsometracker_tpu_torch/ops/_build.py, ops/tracker_kernel.py). The kernel allocates nothing.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

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

__device__ __forceinline__ float pixel(const uint8_t* frame, int H, int W, int r, int c,
                                       int fill) {
  return (r >= 0 && r < H && c >= 0 && c < W) ? (float)frame[(size_t)r * W + c]
                                              : (float)fill;
}

__global__ void __launch_bounds__(kMaxThreads)
dog_scan_kernel(const uint8_t* __restrict__ frames, long long lane_stride, int T, int H, int W,
                const int32_t* __restrict__ pos0, const uint8_t* __restrict__ fills,
                const int32_t* __restrict__ deltas, const int32_t* __restrict__ lo,
                const int32_t* __restrict__ hi, const float* __restrict__ taps, int L, int ri,
                int rj, float direction, int32_t* __restrict__ out_pos,
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
  __shared__ float s_v[kMaxWarps];
  __shared__ int s_k[kMaxWarps];
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

// Dynamic shared memory of one launch, in bytes.
long long dog_scan_smem_bytes(int L, int tile_h, int tile_w) {
  const long long tpw = tile_w + L - 1;
  return 4LL * (10LL * L + 2LL * tile_h * tpw) + (long long)(tile_h + L - 1) * tpw;
}

// Launches B chains of T steps on `stream`, one CTA per lane. Device pointers: frames u8
// contiguous, lane b's [T,H,W] at frames + b * lane_stride (lane_stride 0: all lanes read the
// same frames), pos0 [B,2] i32, fills [B] u8, taps [2L] f32 (centre then surround), out_pos
// [B,T,2] i32; deltas, lo and hi ([B,T,2] i32) and out_off ([B,T,2] f32) may be null. Returns
// cudaGetLastError() after launch.
int dog_scan_launch(const void* frames, long long lane_stride, int B, int T, int H, int W,
                    const void* pos0, const void* fills, const void* deltas, const void* lo,
                    const void* hi, const void* taps, int L, int ri, int rj, float direction,
                    void* out_pos, void* out_off, int tile_h, int tile_w, int threads,
                    void* stream) {
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || lane_stride < 0) return (int)cudaErrorInvalidValue;
  const long long smem = dog_scan_smem_bytes(L, tile_h, tile_w);
  cudaError_t e = cudaFuncSetAttribute(dog_scan_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dog_scan_kernel<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, lane_stride, T, H, W, (const int32_t*)pos0,
      (const uint8_t*)fills, (const int32_t*)deltas, (const int32_t*)lo, (const int32_t*)hi,
      (const float*)taps, L, ri, rj, direction, (int32_t*)out_pos, (float*)out_off, tile_h,
      tile_w);
  return (int)cudaGetLastError();
}

const char* dog_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
