// Host-side ROI crops of the port's speculative pipeline
// (pawsometracker_tpu_torch/pipeline.py, through ops/roi_crop.py).
//
// Each chunk of K frames goes to the card as crops: lane b's frame i cut at
// its origin (oi, oj), which may lie partly or wholly outside the frame, to
// ch x cw, the cells outside the frame set to the lane's fill (the mode of its
// first frame). This is the numpy `crop_with_fill` of ops/roi_crop.py, which
// stays the CPU path and the oracle, as one call a chunk for all its lanes:
//
// - the cells inside the frame are copied row by row and only the border is
//   filled;
// - a crop reads its rows from a frame that is usually not in any cache (a
//   1080p row lies 1920 bytes from the next), so each row's lines are
//   prefetched a few rows ahead, and the crops of a chunk are spread over a
//   small pool of threads, each crop on one;
// - the call runs without Python's lock (ctypes releases it), so a decoding
//   thread goes on while the crops are cut.
//
// A lane's frames past its real count repeat its last crop; a lane with none
// holds fill.
//
// The full-frame engine's staging copy of frames served as views into a
// pinned buffer (ops/roi_crop.py::copy_frames_native) is a call of its own,
// copy_frames, which shares only the pool: a 64-frame 1080p chunk is 132.7 MB
// read once and next read by the card's DMA, so it goes out as long byte
// ranges split evenly over the threads, in non-temporal stores that skip the
// read for ownership of every destination line and keep the ranges out of
// the caches. The crops, small, strided and read again soon, keep plain stores.
//
// Built with nvcc like the kernels (ops/_build.py), host code only, with a
// plain C interface bound by ctypes.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <emmintrin.h>
#endif

namespace {

// rows a row's cache lines are prefetched ahead of its copy
constexpr int64_t kAhead = 6;
constexpr int64_t kLine = 64;

void prefetch_row(const uint8_t* p, int64_t n) {
  for (int64_t c = 0; c < n; c += kLine) __builtin_prefetch(p + c, 0, 0);
  __builtin_prefetch(p + n - 1, 0, 0);
}

// One crop: `frame` is H x W with rows `row_stride` bytes apart.
void crop_one(const uint8_t* frame, int64_t row_stride, int64_t H, int64_t W, int64_t oi,
              int64_t oj, int64_t ch, int64_t cw, uint8_t fill, uint8_t* out) {
  // the crop's rows [r0, r1) and columns [c0, c1) that lie inside the frame
  const int64_t r0 = std::clamp<int64_t>(-oi, 0, ch), r1 = std::clamp<int64_t>(H - oi, r0, ch);
  const int64_t c0 = std::clamp<int64_t>(-oj, 0, cw), c1 = std::clamp<int64_t>(W - oj, c0, cw);
  if (r1 == r0 || c1 == c0) {
    std::memset(out, fill, static_cast<size_t>(ch * cw));
    return;
  }
  const int64_t width = c1 - c0;
  const uint8_t* src = frame + (oi + r0) * row_stride + (oj + c0);
  for (int64_t r = r0; r < std::min(r1, r0 + kAhead); ++r)
    prefetch_row(src + (r - r0) * row_stride, width);
  if (r0 > 0) std::memset(out, fill, static_cast<size_t>(r0 * cw));
  for (int64_t r = r0; r < r1; ++r, src += row_stride) {
    if (r + kAhead < r1) prefetch_row(src + kAhead * row_stride, width);
    uint8_t* dst = out + r * cw;
    if (c0 > 0) std::memset(dst, fill, static_cast<size_t>(c0));
    std::memcpy(dst + c0, src, static_cast<size_t>(width));
    if (c1 < cw) std::memset(dst + c1, fill, static_cast<size_t>(cw - c1));
  }
  if (r1 < ch) std::memset(out + r1 * cw, fill, static_cast<size_t>((ch - r1) * cw));
}

// A pool of worker threads for one parallel loop at a time. It is made at
// the first call that asks for more than one thread and never destroyed: its
// threads sleep on a condition variable between calls and are detached, so
// the process exits without joining them.
class Pool {
 public:
  static Pool& get() {
    static Pool* pool = new Pool();
    return *pool;
  }

  // fn(i) for every i in [0, n), on the caller and up to threads - 1 workers
  void run(int n, int threads, const std::function<void(int)>& fn) {
    std::lock_guard<std::mutex> one_at_a_time(call_mu_);
    const int helpers = std::max(0, std::min(threads, n) - 1);
    {
      std::lock_guard<std::mutex> lk(mu_);
      while (static_cast<int>(started_) < helpers) {
        std::thread(&Pool::loop, this, static_cast<int>(started_)).detach();
        ++started_;
      }
      fn_ = &fn;
      n_ = n;
      next_.store(0);
      helpers_ = helpers;
      pending_ = helpers;
      ++gen_;
    }
    cv_.notify_all();
    work();
    std::unique_lock<std::mutex> lk(mu_);
    done_.wait(lk, [&] { return pending_ == 0; });
    fn_ = nullptr;
  }

 private:
  void work() {
    for (int i = next_.fetch_add(1); i < n_; i = next_.fetch_add(1)) (*fn_)(i);
  }

  void loop(int id) {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      // a loop that needs this worker and that it has not yet joined
      cv_.wait(lk, [&] { return gen_ != seen && id < helpers_; });
      seen = gen_;
      lk.unlock();
      work();
      lk.lock();
      if (--pending_ == 0) done_.notify_one();
    }
  }

  std::mutex call_mu_, mu_;
  std::condition_variable cv_, done_;
  const std::function<void(int)>* fn_ = nullptr;
  int n_ = 0, helpers_ = 0, pending_ = 0;
  std::atomic<int> next_{0};
  uint64_t gen_ = 0, started_ = 0;
};

// Pieces of a staging copy a thread: a helper that wakes late leaves its
// pieces to the others
constexpr int kPiecesPerThread = 4;
// bytes a staging copy's loads are prefetched ahead: 32 lines in flight a
// thread, past what the hardware's streamer keeps (a 64-frame 1080p chunk
// on 6 threads: 4.1-4.6 ms against 4.9-5.5 without, H100 host)
constexpr int64_t kCopyAhead = 2048;

// Copy n bytes from src to dst in non-temporal stores: the head up to dst's
// first 16-byte boundary and the tail past its last one in plain stores, the
// loads unaligned (the caller's array has any alignment) and prefetched
// kCopyAhead bytes ahead. Plain memcpy where the host is not x86-64.
void stream_copy(const uint8_t* src, uint8_t* dst, int64_t n) {
#if defined(__x86_64__)
  const int64_t head = std::min<int64_t>(n, (16 - reinterpret_cast<uintptr_t>(dst) % 16) % 16);
  std::memcpy(dst, src, static_cast<size_t>(head));
  src += head, dst += head, n -= head;
  for (; n >= 64; src += 64, dst += 64, n -= 64) {
    _mm_prefetch(reinterpret_cast<const char*>(src) + kCopyAhead, _MM_HINT_T0);
    const __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src));
    const __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + 16));
    const __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + 32));
    const __m128i d = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + 48));
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst), a);
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + 16), b);
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + 32), c);
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst + 48), d);
  }
  for (; n >= 16; src += 16, dst += 16, n -= 16)
    _mm_stream_si128(reinterpret_cast<__m128i*>(dst),
                     _mm_loadu_si128(reinterpret_cast<const __m128i*>(src)));
#endif
  std::memcpy(dst, src, static_cast<size_t>(n));
}

// Make this thread's non-temporal stores visible before it reports its part done
void store_fence() {
#if defined(__x86_64__)
  _mm_sfence();
#endif
}

}  // namespace

extern "C" {

// Crop the chunks of `lanes` lanes into `out` [lanes, K, ch, cw] (contiguous).
// `meta` [lanes, 4] per lane: the address of its first frame, the bytes from
// one frame to the next and from one row to the next (columns 1 byte apart),
// and its real frame count n (0 <= n <= K). `origins` [lanes, K, 2]: frame
// i's crop origin (row, col) in frame coordinates; `fills` [lanes]. Frames
// i >= n of a lane repeat crop n - 1; a lane with n = 0 is all fill. The
// crops run on up to `threads` threads. Returns 0, or 1 on an argument it
// does not take.
int roi_crop_lanes(int lanes, const int64_t* meta, int K, int H, int W, const int64_t* origins,
                   int ch, int cw, const uint8_t* fills, uint8_t* out, int threads) {
  if (lanes < 0 || K < 1 || H < 1 || W < 1 || ch < 1 || cw < 1 || threads < 1) return 1;
  for (int b = 0; b < lanes; ++b)
    if (meta[4 * b + 3] < 0 || meta[4 * b + 3] > K) return 1;
  const int64_t crop = static_cast<int64_t>(ch) * cw;
  std::vector<int> items;  // b * K + i of each real frame
  for (int b = 0; b < lanes; ++b)
    for (int64_t i = 0; i < meta[4 * b + 3]; ++i) items.push_back(b * K + static_cast<int>(i));
  auto one = [&](int item) {
    const int b = item / K, i = item % K;
    const int64_t* m = meta + 4 * b;
    const auto* frame = reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(m[0])) + i * m[1];
    crop_one(frame, m[2], H, W, origins[2 * item], origins[2 * item + 1], ch, cw, fills[b],
             out + item * crop);
  };
  const int n = static_cast<int>(items.size());
  if (threads == 1 || n < 2) {
    for (int item : items) one(item);
  } else {
    const std::function<void(int)> fn = [&](int j) { one(items[j]); };
    Pool::get().run(n, threads, fn);
  }
  for (int b = 0; b < lanes; ++b) {
    const int64_t k = meta[4 * b + 3];
    uint8_t* lane = out + static_cast<int64_t>(b) * K * crop;
    if (k == 0) {
      std::memset(lane, fills[b], static_cast<size_t>(K * crop));
      continue;
    }
    for (int64_t i = k; i < K; ++i)
      std::memcpy(lane + i * crop, lane + (k - 1) * crop, static_cast<size_t>(crop));
  }
  return 0;
}

// Copy k frames H x W (columns 1 byte apart) from `src`, the address of
// frame 0's row 0, its frames `frame_stride` and its rows `row_stride` bytes
// apart (either may be negative), into `dst` [k, H, W] (contiguous), on up to
// `threads` threads. The form follows from the strides: 0, block, where the k
// frames are one contiguous run; 1, frames, where each frame is contiguous
// but they lie apart; 2, rows, where rows lie apart. The k * H * W bytes of
// dst are split into equal pieces on 64-byte boundaries, each copied as the
// runs of the form (the block, a frame, a row) it covers. Returns the form,
// or -1 on an argument it does not take.
int copy_frames(const uint8_t* src, int64_t frame_stride, int64_t row_stride, int k, int H,
                int W, uint8_t* dst, int threads) {
  if (src == nullptr || dst == nullptr || k < 1 || H < 1 || W < 1 || threads < 1) return -1;
  const int64_t frame = static_cast<int64_t>(H) * W, total = frame * k;
  const bool frame_whole = H == 1 || row_stride == W;
  const int form = !frame_whole ? 2 : (k == 1 || frame_stride == frame) ? 0 : 1;
  // the run each form copies whole, and the runs a frame holds
  const int64_t run = form == 0 ? total : form == 1 ? frame : W;
  const int64_t runs_per_frame = form == 2 ? H : 1;
  auto copy_range = [&](int64_t a, int64_t b) {  // dst bytes [a, b)
    while (a < b) {
      const int64_t r = a / run, off = a % run, n = std::min(run - off, b - a);
      const uint8_t* from =
          src + (r / runs_per_frame) * frame_stride + (r % runs_per_frame) * row_stride + off;
      stream_copy(from, dst + a, n);
      a += n;
    }
    store_fence();
  };
  const int pieces = std::max<int64_t>(1, std::min<int64_t>(static_cast<int64_t>(threads) *
                                                                kPiecesPerThread, total / kLine));
  if (threads == 1 || pieces == 1) {
    copy_range(0, total);
    return form;
  }
  // piece i's first byte: i / pieces of the way, down to a 64-byte boundary of dst's address
  const auto at = reinterpret_cast<uintptr_t>(dst);
  auto bound = [&](int i) -> int64_t {
    if (i == pieces) return total;
    const int64_t even = total / pieces * i + total % pieces * i / pieces;
    return std::clamp<int64_t>(static_cast<int64_t>((at + even) / kLine * kLine - at), 0, total);
  };
  const std::function<void(int)> fn = [&](int i) { copy_range(bound(i), bound(i + 1)); };
  Pool::get().run(pieces, threads, fn);
  return form;
}

}  // extern "C"
