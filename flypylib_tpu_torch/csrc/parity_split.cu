// Parity relayout of the packed ConvStack's stage-A -> stage-B boundary
// (sm_90a).
//
// Replaces the TPU kernel flypylib_tpu/ops/pallas_split.py::parity_split_pallas
// (its four variants, "slices", "moveaxis", "dma" and "hbm", are one kernel
// here).  For x (B, d, h, w, 8c), contiguous, it writes
//
//   out[b*8 + p, z, y, x, :] = x[b, z, y, x, p*c : (p+1)*c]
//
// of shape (8B, d, h, w, c): a pure copy, bit-exact in any dtype, so only
// the element size matters.
//
// What bounds it on an H100: bytes.  It does no arithmetic and moves each
// byte once in and once out (2 x 191 MB at the packed baseline's boundary,
// (8, 36^3, 256) bf16), so its floor is that traffic over the 3.35 TB/s of
// device memory.  The design keeps both sides in whole 32-byte sectors:
// one block per (b, z, y) row of the input, whose (w, 8c) values are one
// contiguous run, and which feeds eight output rows, one per parity, each
// a contiguous (w, c) run.  Threads walk the block's output in order, so
// the stores of a warp are consecutive in each parity row, and the loads
// are runs of c values (64 bytes at the main path's c = 32 in bf16).  Each
// thread moves 16 bytes when the channel run and both pointers allow it,
// else 8, 4 or 2 (elements are 2 or 4 bytes).  The TPU's lane-alignment
// walls (pallas_split.py:11-21) have no counterpart here.
//
// C entry: fpl_parity_split(...) launches on the given stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// U: the unit one thread moves (uint4, uint2, uint32_t or uint16_t);
// cu: units in one parity's channel run; run = w * cu: units in an output row
template <typename U>
__global__ void __launch_bounds__(kThreads)
parity_split_kernel(const U* __restrict__ x, U* __restrict__ out, int dh,
                    int run, int cu) {
  const long long row = blockIdx.x;  // (b, z, y) of the input
  const long long b = row / dh;
  const long long zy = row - b * dh;
  const U* src = x + row * 8LL * run;
  for (int u = threadIdx.x; u < 8 * run; u += kThreads) {
    const int p = u / run;          // parity: the output row
    const int r = u - p * run;      // unit within the output row
    const int xi = r / cu;          // x position
    const int k = r - xi * cu;      // unit within the channel run
    out[((b * 8 + p) * dh + zy) * run + r] = src[(xi * 8 + p) * cu + k];
  }
}

template <typename U>
void launch(const void* x, void* out, long long rows, int dh, int w,
            long long c_bytes, cudaStream_t stream) {
  const int cu = (int)(c_bytes / sizeof(U));
  parity_split_kernel<U><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<U*>(out), dh, w * cu, cu);
}

}  // namespace

// x (B, d, h, w, 8c) -> out (8B, d, h, w, c), both contiguous, elements of
// elem_bytes (2 or 4) bytes.  Shapes are checked by the Python wrapper
// (flypylib_tpu_torch/ops/split.py).
extern "C" int fpl_parity_split(const void* x, void* out, int B, int d, int h,
                                int w, int c, int elem_bytes, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  if (B < 1 || d < 1 || h < 1 || w < 1 || c < 1 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * d * h;
  const long long c_bytes = (long long)c * elem_bytes;
  if (rows > 0x7fffffffLL || 8LL * w * c_bytes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(c_bytes);
  if (align % 16 == 0)
    launch<uint4>(x, out, rows, d * h, w, c_bytes, s);
  else if (align % 8 == 0)
    launch<uint2>(x, out, rows, d * h, w, c_bytes, s);
  else if (align % 4 == 0)
    launch<uint32_t>(x, out, rows, d * h, w, c_bytes, s);
  else
    launch<uint16_t>(x, out, rows, d * h, w, c_bytes, s);
  return (int)cudaGetLastError();
}
