// Fused valid dilated 3x3x3 conv + bias + ReLU over NDHWC volumes (sm_90a).
//
// Replaces the TPU kernel flypylib_tpu/ops/pallas_conv.py::conv3d_bias_relu.
// For x (B,D,H,W,Ci), w (3,3,3,Ci,Co) and b (Co,), all of one dtype T (float
// or bfloat16), it computes
//
//   out[n,z,y,x,o] = T(relu(sum_{tz,ty,tx,c} f32(x[n, z+tz*d, y+ty*d, x+tx*d, c])
//                                            * f32(w[tz,ty,tx,c,o]) + f32(b[o])))
//
// of shape (B, D-2d, H-2d, W-2d, Co): f32 accumulation, f32 bias add, ReLU,
// then one rounding to T -- the TPU kernel's rounding point.
//
// What bounds it on an H100, at the baseline model's four body layers:
// - Layer 0 has Ci = 1, so K = 27: each output value costs 54 FLOP and 2
//   bytes written in bf16, about 27 FLOP per byte, far under the card's
//   ridge of ~295.  It is memory-bound on writing the (B, 74^3, 24) map.
//   conv_ci1_kernel gives it its own path: one thread per output value,
//   the 27 taps read through L1 (the threads of one voxel share them),
//   the (27, Co) weights in shared memory, and writes that are coalesced
//   along the channel axis.  Tensor cores would not help it.
// - Layers 1-3 contract K = 27*Ci = 648..1296 into Co = 32..64 channels.
//   Every input value is reused 27*Co times, so they are compute-bound.
//   They run as an implicit GEMM: M = output voxels, N = Co, K = 27*Ci.
//   A block owns a 64 x BN output tile and streams K through shared
//   memory one chunk at a time -- A as an im2col gather of the halo, B as
//   a (chunk, BN) slice of the weights -- so neither the whole weight
//   tensor (332 KB in f32 at layer 3) nor a full W-row halo has to fit in
//   the 227 KB a block may hold.
//   * bf16 (the model's default) runs, where Ci and Co are multiples of 8
//     and x is 16-byte aligned, the wgmma/TMA kernel of conv3d_wgmma.cu
//     (the Python wrapper picks it; see ops/conv.py::k1_route).  Every
//     other bf16 call runs conv_wmma_kernel here: 16x16x16 WMMA products
//     on the tensor cores with f32 accumulators, gathered element by
//     element.
//   * f32 runs conv_gemm_kernel on CUDA-core FMAs (TF32 tensor cores would
//     round the inputs): each thread keeps a 4 x (BN/16) tile of f32
//     accumulators in registers.
//
// These are simple first versions: one chunk in flight per block, no
// software pipeline.
//
// Blocks run in parallel and in no order, so the ragged edge is masked
// (rows past M and channels past Co load zeros and store nothing) instead
// of shifting the last block inward as the TPU kernel does.
//
// C entry: fpl_conv3d_bias_relu(...) launches on the given stream and
// returns cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kMaxCo = 128;  // output channels per launch of the Ci = 1 kernel

// ---------------------------------------------------------------- Ci == 1
// One launch computes Cn <= kMaxCo output channels of the Co the layer has:
// w, b and out point at the first of them, and Co is the stride of a weight
// row and of an output voxel.  total = M * Cn.
template <typename T>
__global__ void __launch_bounds__(256)
conv_ci1_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ b, T* __restrict__ out, int D, int H,
                int W, int Co, int Cn, int d, int Do, int Ho, int Wo,
                long long total) {
  __shared__ float ws[27 * kMaxCo];
  __shared__ float bs[kMaxCo];
  for (int i = threadIdx.x; i < 27 * Cn; i += blockDim.x)
    ws[i] = to_f32(w[(i / Cn) * Co + i % Cn]);
  for (int i = threadIdx.x; i < Cn; i += blockDim.x) bs[i] = to_f32(b[i]);
  __syncthreads();

  const long long plane = (long long)H * W;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int o = (int)(e % Cn);
    const long long row = e / Cn;
    long long p = row;
    const int xo = (int)(p % Wo);
    p /= Wo;
    const int yo = (int)(p % Ho);
    p /= Ho;
    const int zo = (int)(p % Do);
    const long long n = p / Do;
    const T* src = x + ((n * D + zo) * H + yo) * (long long)W + xo;
    float acc = 0.f;
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int tz = tap / 9, ty = (tap / 3) % 3, tx = tap % 3;
      const long long off = (long long)tz * d * plane + (long long)ty * d * W + tx * d;
      acc = fmaf(to_f32(src[off]), ws[tap * Cn + o], acc);
    }
    out[row * Co + o] = from_f32<T>(fmaxf(acc + bs[o], 0.f));
  }
}

// ------------------------------------------------------- implicit GEMM
constexpr int kBM = 64;   // output voxels per block
constexpr int kKC = 16;   // K chunk staged in shared memory (f32)
constexpr int kThreads = 256;

// offset in x of output row p's receptive-field origin, or -1 past M
__device__ __forceinline__ long long row_base(long long p, long long M, int D,
                                              int H, int W, int Ci, int Do,
                                              int Ho, int Wo) {
  if (p >= M) return -1;
  const int xo = (int)(p % Wo);
  p /= Wo;
  const int yo = (int)(p % Ho);
  p /= Ho;
  const int zo = (int)(p % Do);
  const long long n = p / Do;
  return (((n * D + zo) * H + yo) * (long long)W + xo) * Ci;
}

// offset of column k = tap * Ci + c of the im2col matrix from a row's
// origin, or -1 past K
__device__ __forceinline__ long long k_offset(int k, int K, int Ci, int d,
                                              int H, int W) {
  if (k >= K) return -1;
  const int tap = k / Ci;
  const int c = k - tap * Ci;
  const int tz = tap / 9, ty = (tap / 3) % 3, tx = tap % 3;
  return (((long long)tz * d * H + (long long)ty * d) * W +
          (long long)tx * d) * Ci + c;
}

// f32 on CUDA-core FMAs
template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ out, int D,
                 int H, int W, int Ci, int Co, int d, int Do, int Ho, int Wo,
                 long long M) {
  constexpr int TM = 4;        // rows per thread (contiguous)
  constexpr int TN = BN / 16;  // channels per thread (contiguous)
  static_assert(TN == 2 || TN == 4, "BN must be 32 or 64");
  static_assert(16 * TM == kBM, "16 thread rows x TM rows == kBM");

  // +4 floats of row padding: the A stores spread over banks, and rows
  // stay 16-byte aligned for the float4 reads
  __shared__ __align__(16) float As[kKC][kBM + 4];
  __shared__ __align__(16) float Bs[kKC][BN];
  __shared__ long long rowbase[kBM];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int K = 27 * Ci;

  if (tid < kBM)  // a row past M loads zeros and stores nothing
    rowbase[tid] = row_base(m0 + tid, M, D, H, W, Ci, Do, Ho, Wo);

  const int tc = tid % 16, tr = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // each thread always loads the same column kk of the A chunk
  const int kk_ld = tid % kKC;
  const int m_ld = tid / kKC;
  constexpr int kRowStep = kThreads / kKC;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const long long koff = k_offset(k0 + kk_ld, K, Ci, d, H, W);
    __syncthreads();  // rowbase written / previous chunk consumed
#pragma unroll
    for (int r = 0; r < kBM / kRowStep; ++r) {
      const int m = m_ld + r * kRowStep;
      const long long rb = rowbase[m];
      As[kk_ld][m] = (koff >= 0 && rb >= 0) ? x[rb + koff] : 0.f;
    }
    for (int e = tid; e < kKC * BN; e += kThreads) {
      const int nn = e % BN, kk = e / BN;
      const int kg = k0 + kk, ng = n0 + nn;
      Bs[kk][nn] = (kg < K && ng < Co) ? w[(long long)kg * Co + ng] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][tr * TM]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      float bv[TN];
      if constexpr (TN == 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tc * TN]);
        bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
      } else {
        const float2 b2 = *reinterpret_cast<const float2*>(&Bs[kk][tc * TN]);
        bv[0] = b2.x; bv[1] = b2.y;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long p = m0 + tr * TM + i;
    if (p >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tc * TN + j;
      if (n < Co)
        out[p * Co + n] = fmaxf(acc[i][j] + b[n], 0.f);
    }
  }
}

// ------------------------------------- implicit GEMM, bf16 on tensor cores
// The same implicit GEMM for bf16, with 16x16x16 bf16 WMMA products (f32
// accumulators) in place of the FMAs, for the bf16 calls the wgmma kernel
// does not take (Ci or Co off the multiples of 8, or x off a 16-byte
// boundary).  A block owns a 64 x BN output tile; each of its 8 warps
// holds BN/32 accumulator tiles of 16 x 16.  K streams through shared
// memory 32 at a time, gathered element by element.  The f32 tile goes
// through shared memory for the bias, ReLU and rounding epilogue, which
// stores along the channel axis.
constexpr int kWKC = 32;          // K chunk staged in shared memory
constexpr int kALd = kWKC + 8;    // A row pitch in bf16 (80 bytes)

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ b,
                 __nv_bfloat16* __restrict__ out, int D, int H, int W, int Ci,
                 int Co, int d, int Do, int Ho, int Wo, long long M) {
  using namespace nvcuda;
  constexpr int BLd = BN + 8;  // B row pitch in bf16
  constexpr int CLd = BN + 4;  // C row pitch in f32
  constexpr int FN = BN / 32;  // accumulator tiles per warp along N
  static_assert(BN == 32 || BN == 64, "BN must be 32 or 64");

  // pitches keep every fragment pointer 32-byte aligned, as WMMA requires
  __shared__ __align__(32) __nv_bfloat16 As[kBM][kALd];
  __shared__ __align__(32) __nv_bfloat16 Bs[kWKC][BLd];
  __shared__ __align__(32) float Cs[kBM][CLd];
  __shared__ long long rowbase[kBM];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int K = 27 * Ci;

  if (tid < kBM)  // a row past M loads zeros and stores nothing
    rowbase[tid] = row_base(m0 + tid, M, D, H, W, Ci, Do, Ho, Wo);

  const int warp = tid / 32;
  const int wr = warp >> 1;         // 16-row band of the tile
  const int wc = (warp & 1) * FN;   // first 16-column tile of the warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN];
#pragma unroll
  for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kWKC) {
    const int kk_ld = tid % kWKC;
    const long long koff = k_offset(k0 + kk_ld, K, Ci, d, H, W);
    __syncthreads();  // rowbase written / previous chunk consumed
    for (int m = tid / kWKC; m < kBM; m += kThreads / kWKC) {
      const long long rb = rowbase[m];
      As[m][kk_ld] = (koff >= 0 && rb >= 0) ? x[rb + koff]
                                            : __float2bfloat16_rn(0.f);
    }
    for (int e = tid; e < kWKC * BN; e += kThreads) {
      const int nn = e % BN, kk = e / BN;
      const int kg = k0 + kk, ng = n0 + nn;
      Bs[kk][nn] = (kg < K && ng < Co) ? w[(long long)kg * Co + ng]
                                       : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kWKC; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[wr * 16][ks], kALd);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &Bs[ks][(wc + j) * 16], BLd);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < FN; ++j)
    wmma::store_matrix_sync(&Cs[wr * 16][(wc + j) * 16], acc[j], CLd,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * BN; e += kThreads) {
    const int m = e / BN, nn = e % BN;
    const long long p = m0 + m;
    const int n = n0 + nn;
    if (p < M && n < Co)
      out[p * Co + n] = __float2bfloat16_rn(
          fmaxf(Cs[m][nn] + __bfloat162float(b[n]), 0.f));
  }
}

// Ci > 1: f32 on CUDA-core FMAs (TF32 tensor cores would round the
// inputs), bf16 on the tensor cores
template <int BN>
void launch_gemm(const float* x, const float* w, const float* b, float* out,
                 dim3 grid, int D, int H, int W, int Ci, int Co, int d,
                 int Do, int Ho, int Wo, long long M, cudaStream_t stream) {
  conv_gemm_kernel<BN><<<grid, kThreads, 0, stream>>>(
      x, w, b, out, D, H, W, Ci, Co, d, Do, Ho, Wo, M);
}

template <int BN>
void launch_gemm(const __nv_bfloat16* x, const __nv_bfloat16* w,
                 const __nv_bfloat16* b, __nv_bfloat16* out, dim3 grid,
                 int D, int H, int W, int Ci, int Co, int d, int Do, int Ho,
                 int Wo, long long M, cudaStream_t stream) {
  conv_wmma_kernel<BN><<<grid, kThreads, 0, stream>>>(
      x, w, b, out, D, H, W, Ci, Co, d, Do, Ho, Wo, M);
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* out, int B,
            int D, int H, int W, int Ci, int Co, int d, cudaStream_t stream) {
  const int Do = D - 2 * d, Ho = H - 2 * d, Wo = W - 2 * d;
  const long long M = (long long)B * Do * Ho * Wo;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  if (Ci == 1) {
    for (int c0 = 0; c0 < Co; c0 += kMaxCo) {  // one launch when Co <= kMaxCo
      const int Cn = Co - c0 < kMaxCo ? Co - c0 : kMaxCo;
      const long long total = M * Cn;
      long long blocks = (total + 255) / 256;
      if (blocks > 8192) blocks = 8192;  // grid-stride; amortises the weight load
      conv_ci1_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
          xt, wt + c0, bt + c0, ot + c0, D, H, W, Co, Cn, d, Do, Ho, Wo, total);
    }
    return;
  }
  const unsigned gm = (unsigned)((M + kBM - 1) / kBM);
  if (Co <= 32) {
    launch_gemm<32>(xt, wt, bt, ot, dim3(gm, 1), D, H, W, Ci, Co, d, Do, Ho,
                    Wo, M, stream);
  } else {
    launch_gemm<64>(xt, wt, bt, ot, dim3(gm, (Co + 63) / 64), D, H, W, Ci, Co,
                    d, Do, Ho, Wo, M, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes are checked by the Python
// wrapper (flypylib_tpu_torch/ops/conv.py); x, w, b and out are contiguous.
extern "C" int fpl_conv3d_bias_relu(const void* x, const void* w,
                                    const void* b, void* out, int B, int D,
                                    int H, int W, int Ci, int Co, int d,
                                    int dtype, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  if (Co < 1 || Ci < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, b, out, B, D, H, W, Ci, Co, d, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, b, out, B, D, H, W, Ci, Co, d, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
