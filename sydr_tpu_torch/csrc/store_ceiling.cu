// The store ceiling of K3 (block_cumsum_streams.cu): a kernel with K3's
// grid, block and stores and none of its arithmetic. A block owns one
// channel and a segment of seg_chunks chunks of 1024 samples; in each
// chunk a thread writes one 16-byte group of 4 consecutive samples to each
// of the n_streams rows (scalar stores where n_win is no multiple of 4).
// Its device time is what K3's output costs to write with this access
// pattern at this size, the part of K3's time that no change to its
// stream build or scan can remove; the smoke test prints it beside K3's
// time. It is a yardstick only: the receiver never calls it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;
constexpr int kChunk = kThreads * kGroup;

__global__ void __launch_bounds__(kThreads) store_ceiling_kernel(
    int n_streams, int n_win, int seg_chunks, float* __restrict__ out) {
  const int seg = blockIdx.x;
  const int c = blockIdx.y;
  const bool vec_out = n_win % kGroup == 0;
  float* row0 = out + static_cast<size_t>(c) * n_streams * n_win;
  const int seg_start = seg * seg_chunks * kChunk;
  int m0 = seg_start + threadIdx.x * kGroup;
  for (int k = 0; k < seg_chunks && seg_start + k * kChunk < n_win; ++k) {
    const float x = static_cast<float>(m0);
    for (int s = 0; s < n_streams; ++s) {
      float* dst = row0 + static_cast<size_t>(s) * n_win + m0;
      if (vec_out && m0 + kGroup <= n_win) {
        *reinterpret_cast<float4*>(dst) = make_float4(x, x, x, x);
      } else {
        for (int i = 0; i < kGroup; ++i) {
          if (m0 + i < n_win) dst[i] = x;
        }
      }
    }
    m0 += kChunk;
  }
}

}  // namespace

extern "C" const char* sydr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [n_ch, n_streams, n_win] float32, 16-byte aligned; grid (n_seg,
// n_ch) with n_seg = ceil(n_win / (1024 seg_chunks)).
extern "C" int store_ceiling_launch(int n_ch, int n_streams, int n_win,
                                    int seg_chunks, int n_seg, void* out,
                                    void* stream) {
  if (n_ch < 1 || n_streams < 1 || n_win < 1 || seg_chunks < 1 ||
      n_seg != (n_win + seg_chunks * kChunk - 1) / (seg_chunks * kChunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  store_ceiling_kernel<<<dim3(n_seg, n_ch), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      n_streams, n_win, seg_chunks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
