// detect.cu: the whole-frame detectors' DoG response and the rounds of non-maximum
// suppression, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes the whole-frame response with banded
// matmuls under XLA (pawsometracker_tpu/parallel/mesh.py::_frame_response) and its rounds as
// a lax.fori_loop. The port wrote both as direct taps and rounds in plain PyTorch, one torch
// launch a tap and ~16 a round (about 1,900 for a 96-peak detection at 33 taps), so the host
// issuing them set the pace. Here they are two launches whatever the taps and the peaks:
//
// response_kernel: out = dir * (Gc_r X Gc_c^T - Gs_r X Gs_c^T) of a frame X, the vertical pass
//   first (rows[r][c] = sum_k g[k] * x[r+k][c]), then the horizontal one (out[r][c] = sum_k
//   g[k] * rows[r][c+k]), for the centre and the surround each in its own accumulator, every
//   tap __fadd_rn(acc, __fmul_rn(g[k], x)) with k ascending from acc = 0, then
//   __fmul_rn(dir, __fsub_rn(c, s)): the plain version's arithmetic, operation for operation
//   (no FMA contraction), so the card, the CPU and the NumPy reference agree bit for bit. The
//   input is either a u8 frame, read with the fill outside it (the pad fused in), or a padded
//   float32 slab (the space-sharded detector's rows and halo), through one code path; each
//   output element reads only its own rows of the input, so slabs give the whole frame's bits.
//   One CTA an output tile of kTH = 32 rows by tile_w columns: the tile's patch ((kTH+L-1) x
//   (tile_w+L-1) floats) and the vertical pass's sums (kTH x (tile_w+L-1) pairs) live in shared
//   memory, sized from L (detect_response_tile_w picks the widest tile of 128, 64 or 32 that
//   fits; a larger L is refused). Both passes are register-blocked: a thread keeps kRB = 8
//   adjacent outputs along its pass and the kRB inputs they share as a sliding window, so a
//   tap is one input load and one tap-pair load for 4 * kRB float ops. In the horizontal pass
//   a warp's lanes are the tile's 32 rows, so the CTA also writes each column's maximum over
//   its rows and the first row holding it (a warp reduction), the partials the rounds start
//   from.
//   What bounds it: at 1080p and L = 33, 2 x (1080 x 1952 + 1080 x 1920) x 33 taps, each a
//   multiply and an add, 0.55 GFLOP, against 2 MB in and 8 MB out: the float pipes, 8.2 us at
//   67 TFLOP/s, 16.5 us at the issue rate of separate multiplies and adds (no FMA). On an
//   H100 it takes 54 us, the partials included.
//
// rounds_kernel: N rounds of suppression on one frame's response, one CTA of 1024 threads.
//   It keeps every column's (maximum, first row) in shared memory, made from the response's
//   partials (each 32-row tile's column maxima), which it keeps up to date in device memory.
//   A round takes the first column, in order, whose maximum is the frame's: its first row
//   and the column are the first maximum in column-major order, the tracker's tie-break. If
//   that maximum is not finite (the discs cover the frame), it and every later round repeat
//   the previous peak, as the plain rounds do. Otherwise it writes the peak and sets the cells
//   with float((i-pi)^2 + (j-pj)^2) <= r2 (int64 distances rounded to float32, as the plain
//   version's comparison promotes them) to -inf in the response, recomputing on the way the
//   partials of the (tile, column) pairs the disc touches (rows and columns within D of the
//   peak), then the maxima of its <= 2D+1 columns from their partials.
//   No host read, no grid-wide sync: one CTA walks the rounds, since a round needs the last.
//   What bounds it: the latency of a round's few dependent steps (its block barriers and two
//   reads of L2), not bytes: at 1080p and D = 25 a round reads ~3 x 32 x 51 response cells
//   and 34 x 51 partials. On an H100 96 rounds take 0.48 ms, ~5 us a round (1.08 ms when each
//   round rescanned its 51 columns whole).
//
// Both return cudaGetLastError() after launch; the wrapper (ops/detect_kernel.py) raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kTH = 32;            // output rows of a response tile: a warp's lanes
constexpr int kRB = 8;             // outputs a thread keeps along a pass
constexpr int kThreads = 256;      // threads of a response CTA
constexpr int kRoundThreads = 1024;
constexpr int kDepth = 8;          // rows a rounds thread loads before it compares them

struct Peak {
  float v;
  int idx;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, d);
    const int oi = __shfl_xor_sync(0xffffffffu, i, d);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// (v, vi) made the best of itself and the `count` pairs at p[first], p[first + stride], ...
__device__ __forceinline__ void best_of(const Peak* p, int first, int stride, int count, float& v,
                                        int& vi) {
  for (int q = 0; q < count; ++q) {
    const Peak o = p[first + q * stride];
    if (better(o.v, o.idx, v, vi)) {
      v = o.v;
      vi = o.idx;
    }
  }
}

__host__ __device__ inline int odd_pitch(int n) { return n | 1; }

__host__ __device__ inline long long response_smem_bytes(int L, int tile_w) {
  const int xw = tile_w + L - 1;
  return 8LL * L + 8LL * kTH * odd_pitch(xw) + 4LL * (kTH + L - 1) * xw;
}

// T: the input's element type (uint8_t frames, float slabs). The input of image b is
// src + b * batch_stride, in_rows x in_cols with row_stride elements a row; output cell (i, j)
// reads input rows i + offset .. i + offset + L - 1 and the same for columns, where a cell
// outside the input reads the fill (fills[b], or `fill` where fills is null).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    response_kernel(const T* __restrict__ src, long long batch_stride, int row_stride,
                    int in_rows, int in_cols, int offset, const uint8_t* __restrict__ fills,
                    float fill, const float2* __restrict__ taps, int L, float direction, int R,
                    int W, int tile_w, float* __restrict__ out, Peak* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xw = tile_w + L - 1, xh = kTH + L - 1, rp = odd_pitch(xw);
  float2* g = reinterpret_cast<float2*>(smem);
  float2* rows = g + L;                                  // [kTH][rp] (centre, surround)
  float* xs = reinterpret_cast<float*>(rows + kTH * rp);  // [xh][xw]
  const int b = blockIdx.z, y0 = blockIdx.y * kTH, x0 = blockIdx.x * tile_w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < L; k += kThreads) g[k] = taps[k];
  const T* s = src + b * batch_stride;
  const float f = fills ? (float)fills[b] : fill;
  for (int pr = warp; pr < xh; pr += kThreads / 32) {
    const int i = y0 + pr + offset;
    const bool row_in = i >= 0 && i < in_rows;
    const T* srow = s + (long long)i * row_stride;
    for (int pc = lane; pc < xw; pc += 32) {
      const int j = x0 + pc + offset;
      xs[pr * xw + pc] = (row_in && j >= 0 && j < in_cols) ? (float)srow[j] : f;
    }
  }
  __syncthreads();

  // the vertical pass: item (rb, c) sums rows rb*kRB .. rb*kRB+kRB-1 of column c; the window
  // slot (u + m) % kRB holds the input row that output m needs at tap k0 + u
  const int nv = (kTH / kRB) * xw;
  for (int it = tid; it < nv; it += kThreads) {
    const int rb = it / xw, c = it - rb * xw;
    const float* x = xs + rb * kRB * xw + c;
    float win[kRB], ac[kRB], as[kRB];
#pragma unroll
    for (int m = 0; m < kRB; ++m) {
      win[m] = x[m * xw];
      ac[m] = 0.0f;
      as[m] = 0.0f;
    }
    for (int k0 = 0; k0 < L; k0 += kRB) {
#pragma unroll
      for (int u = 0; u < kRB; ++u) {
        const int k = k0 + u;
        if (k < L) {
          const float2 t = g[k];
#pragma unroll
          for (int m = 0; m < kRB; ++m) {
            const float v = win[(u + m) % kRB];
            ac[m] = __fadd_rn(ac[m], __fmul_rn(t.x, v));
            as[m] = __fadd_rn(as[m], __fmul_rn(t.y, v));
          }
          if (k + 1 < L) win[u] = x[(k + kRB) * xw];
        }
      }
    }
    float2* o = rows + rb * kRB * rp + c;
#pragma unroll
    for (int m = 0; m < kRB; ++m) o[m * rp] = make_float2(ac[m], as[m]);
  }
  __syncthreads();

  // the horizontal pass: item (r, cb), r the lane, sums columns cb*kRB .. cb*kRB+kRB-1 of row r
  const int nh = kTH * (tile_w / kRB);  // a multiple of 32: whole warps iterate together
  for (int it = tid; it < nh; it += kThreads) {
    const int r = it & (kTH - 1), c0 = (it / kTH) * kRB;
    const float2* x = rows + r * rp + c0;
    float2 win[kRB];
    float ac[kRB], as[kRB];
#pragma unroll
    for (int m = 0; m < kRB; ++m) {
      win[m] = x[m];
      ac[m] = 0.0f;
      as[m] = 0.0f;
    }
    for (int k0 = 0; k0 < L; k0 += kRB) {
#pragma unroll
      for (int u = 0; u < kRB; ++u) {
        const int k = k0 + u;
        if (k < L) {
          const float2 t = g[k];
#pragma unroll
          for (int m = 0; m < kRB; ++m) {
            const float2 v = win[(u + m) % kRB];
            ac[m] = __fadd_rn(ac[m], __fmul_rn(t.x, v.x));
            as[m] = __fadd_rn(as[m], __fmul_rn(t.y, v.y));
          }
          if (k + 1 < L) win[u] = x[k + kRB];
        }
      }
    }
    const int i = y0 + r, j0 = x0 + c0;
    float o[kRB];
#pragma unroll
    for (int m = 0; m < kRB; ++m) o[m] = __fmul_rn(direction, __fsub_rn(ac[m], as[m]));
    if (i < R) {
      float* orow = out + ((long long)b * R + i) * W;
      if ((W & 3) == 0 && j0 + kRB <= W) {
        reinterpret_cast<float4*>(orow + j0)[0] = make_float4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<float4*>(orow + j0)[1] = make_float4(o[4], o[5], o[6], o[7]);
      } else {
#pragma unroll
        for (int m = 0; m < kRB; ++m)
          if (j0 + m < W) orow[j0 + m] = o[m];
      }
    }
    Peak* prow = part + ((long long)b * gridDim.y + blockIdx.y) * W;
#pragma unroll
    for (int m = 0; m < kRB; ++m) {
      float v = i < R ? o[m] : -INFINITY;
      int vi = i < R ? i : INT_MAX;
      warp_best(v, vi);
      if (lane == 0 && j0 + m < W) prow[j0 + m] = Peak{v, vi};
    }
  }
}

__global__ void __launch_bounds__(kRoundThreads)
    rounds_kernel(float* __restrict__ resp, Peak* __restrict__ part, int H, int W, int P, int N,
                  float r2, int D, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* colv = reinterpret_cast<float*>(smem);  // [W] each column's maximum
  int* colr = reinterpret_cast<int*>(colv + W);   // [W] and the first row holding it
  __shared__ Peak red[kRoundThreads / 32];
  __shared__ Peak merge[kRoundThreads];
  __shared__ int peak[3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int c = tid; c < W; c += kRoundThreads) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    best_of(part, c, W, P, bv, bi);
    colv[c] = bv;
    colr[c] = bi;
  }
  __syncthreads();

  for (int k = 0; k < N; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = tid; c < W; c += kRoundThreads)
      if (better(colv[c], c, bv, bi)) {
        bv = colv[c];
        bi = c;
      }
    warp_best(bv, bi);
    if (lane == 0) red[warp] = Peak{bv, bi};
    __syncthreads();
    if (warp == 0) {
      bv = red[lane].v;
      bi = red[lane].idx;
      warp_best(bv, bi);
      if (lane == 0) {
        const bool exhausted = k > 0 && !isfinite(bv);
        const int pi = exhausted ? peak[0] : colr[bi], pj = exhausted ? peak[1] : bi;
        out[2 * k] = pi;
        out[2 * k + 1] = pj;
        peak[0] = pi;
        peak[1] = pj;
        peak[2] = exhausted;
      }
    }
    __syncthreads();
    const int pi = peak[0], pj = peak[1];
    if (peak[2]) {  // the discs cover the frame: every later round repeats this peak
      for (int q = k + 1 + tid; q < N; q += kRoundThreads) {
        out[2 * q] = pi;
        out[2 * q + 1] = pj;
      }
      break;
    }
    // the disc's rows and columns: |i - pi| <= D and |j - pj| <= D
    const int c_lo = max(0, pj - D), nb = min(W - 1, pj + D) - c_lo + 1;
    const int r_lo = max(0, pi - D), t_lo = r_lo / kTH;
    const int nt = min(H - 1, pi + D) / kTH - t_lo + 1;
    // the partials of the (tile, column) pairs the disc touches, its cells set to -inf on the
    // way: S threads a pair, kTH / S rows each, consecutive threads on consecutive columns
    const int pairs = nt * nb;
    int S = kTH;
    while (S > 1 && pairs * S > kRoundThreads) S >>= 1;
    const int per_pass = kRoundThreads / S, rows = kTH / S;
    for (int base = 0; base < pairs; base += per_pass) {
      const int q = base + tid % per_pass, sub = tid / per_pass;
      const int t = t_lo + q / nb, c = c_lo + q % nb;
      float v = -INFINITY;
      int vi = INT_MAX;
      if (q < pairs) {
        const long long dj2 = (long long)(c - pj) * (c - pj);
        const int r0 = t * kTH + sub * rows;
        for (int i0 = 0; i0 < rows; i0 += kDepth) {
          float x[kDepth];
#pragma unroll
          for (int u = 0; u < kDepth; ++u) {
            const int r = r0 + i0 + u;
            x[u] = (i0 + u < rows && r < H) ? resp[(long long)r * W + c] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kDepth; ++u) {
            const int r = r0 + i0 + u;
            if (i0 + u < rows && r < H) {
              const long long di = r - pi;
              if (__ll2float_rn(di * di + dj2) <= r2) {
                if (x[u] != -INFINITY) resp[(long long)r * W + c] = -INFINITY;
                x[u] = -INFINITY;
              }
              if (better(x[u], r, v, vi)) {
                v = x[u];
                vi = r;
              }
            }
          }
        }
      }
      merge[tid] = Peak{v, vi};
      __syncthreads();
      if (sub == 0 && q < pairs) {
        best_of(merge, tid + per_pass, per_pass, S - 1, v, vi);
        part[(long long)t * W + c] = Peak{v, vi};
      }
      __syncthreads();
    }
    // each band column's maximum over its P partials: G threads a column
    const int NB = min(nb, kRoundThreads), G = kRoundThreads / NB;
    const int cs = tid % NB, grp = tid / NB;
    for (int cb = 0; cb < nb; cb += NB) {
      const int c = c_lo + cb + cs;
      float v = -INFINITY;
      int vi = INT_MAX;
      if (grp < G && cb + cs < nb)
        for (int p = grp; p < P; p += G) {
          const Peak o = part[(long long)p * W + c];
          if (better(o.v, o.idx, v, vi)) {
            v = o.v;
            vi = o.idx;
          }
        }
      merge[tid] = Peak{v, vi};
      __syncthreads();
      if (tid < NB && cb + tid < nb) {
        best_of(merge, tid + NB, NB, G - 1, v, vi);
        colv[c] = v;
        colr[c] = vi;
      }
      __syncthreads();
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Output rows of a response tile: the partials hold one row of column maxima a tile row.
int detect_tile_rows() { return kTH; }

// The widest response tile (128, 64 or 32 columns) whose shared memory for L taps is at most
// smem_limit bytes, or 0 where none fits.
int detect_response_tile_w(int L, long long smem_limit) {
  if (L <= 0) return 0;
  for (int tw = 128; tw >= 32; tw /= 2)
    if (response_smem_bytes(L, tw) <= smem_limit) return tw;
  return 0;
}

// The response of B images into out [B, R, W] f32, on `stream`, in tiles of kTH x tile_w
// (detect_response_tile_w). u8 != 0: src is uint8 frames [B, R, W] (batch_stride elements
// apart, rows W apart), read with half = L / 2 cells of fill (fills [B] u8, or `fill` for
// every image where fills is null) on every side. u8 == 0: src is float32 slabs
// [B, R + L - 1, W + L - 1] whose rows are row_stride elements apart. taps: [L] pairs f32
// (centre, surround). part: [B, ceil(R / kTH), W] (f32 value, i32 row) pairs, each tile's
// column maxima and the first row holding each.
int detect_response_launch(const void* src, int u8, long long batch_stride, int row_stride,
                           int B, int R, int W, const void* fills, int fill, const void* taps,
                           int L, float direction, int tile_w, void* out, void* part,
                           void* stream) {
  if (B <= 0 || B > 65535 || R <= 0 || W <= 0 || L <= 0 || L % 2 == 0 || tile_w <= 0 ||
      tile_w % kRB != 0 || batch_stride < 0 || row_stride <= 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = response_smem_bytes(L, tile_w);
  const dim3 grid((W + tile_w - 1) / tile_w, (R + kTH - 1) / kTH, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (u8) {
    if ((e = allow_smem(response_kernel<uint8_t>, smem)) != cudaSuccess) return (int)e;
    response_kernel<uint8_t><<<grid, kThreads, smem, st>>>(
        (const uint8_t*)src, batch_stride, row_stride, R, W, -(L / 2), (const uint8_t*)fills,
        (float)fill, (const float2*)taps, L, direction, R, W, tile_w, (float*)out, (Peak*)part);
  } else {
    if ((e = allow_smem(response_kernel<float>, smem)) != cudaSuccess) return (int)e;
    response_kernel<float><<<grid, kThreads, smem, st>>>(
        (const float*)src, batch_stride, row_stride, R + L - 1, W + L - 1, 0, nullptr, 0.0f,
        (const float2*)taps, L, direction, R, W, tile_w, (float*)out, (Peak*)part);
  }
  return (int)cudaGetLastError();
}

// N rounds of suppression on one response resp [H, W] f32, from its partials part [P, W]
// (detect_response_launch's, P = ceil(H / kTH)), into out [N, 2] i32, on `stream`. Both are
// overwritten: each disc set to -inf, and the partials it touched recomputed. r2: the disc's
// squared radius in float32; D: the largest distance d with float(d * d) <= r2, so the disc
// touches rows pi - D .. pi + D and columns pj - D .. pj + D alone.
int detect_rounds_launch(void* resp, void* part, int H, int W, int P, int N, float r2,
                         int D, void* out, void* stream) {
  if (H <= 0 || W <= 0 || P != (H + kTH - 1) / kTH || N <= 0 || D < 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = 8LL * W;
  cudaError_t e = allow_smem(rounds_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  rounds_kernel<<<1, kRoundThreads, smem, (cudaStream_t)stream>>>(
      (float*)resp, (Peak*)part, H, W, P, N, r2, D, (int*)out);
  return (int)cudaGetLastError();
}

const char* detect_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
