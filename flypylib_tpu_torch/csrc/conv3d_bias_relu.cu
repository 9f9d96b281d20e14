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
// then one rounding to T -- the TPU kernel's rounding point.  Every kernel
// takes a relu flag: 0 leaves the clamp out (a BatchNorm layer's conv, whose
// ReLU follows the normalisation).
//
// What bounds it on an H100, at the baseline model's four body layers:
// - Layer 0 has Ci = 1, so K = 27: each output value costs 54 FLOP and 2
//   bytes written in bf16, about 27 FLOP per byte, far under the card's
//   ridge of ~295: its floor is writing the (B, 74^3, 24) map, 0.05 ms.
//   conv_ci1_kernel gives it its own path, built so that neither the
//   load/store units nor index arithmetic stand before that floor.  A block
//   owns a box of up to 1024 output voxels (the wrapper picks it,
//   ops/conv.py::ci1_plan) and stages the box's (bz+2d)(by+2d)(bx+2d) input
//   halo in shared memory once, as f32.  Each thread owns 4 voxels (box
//   voxels t, t+256, ..., so a warp's loads and stores run along x) and a
//   chunk of 24 or 16 output channels: per tap it reads its 4 inputs and
//   the chunk's weights as 16-byte broadcasts from shared memory, 8-10
//   loads for 64-96 FMAs, and keeps the 64-96 f32 sums in registers (under
//   128 registers a thread, so that two blocks share an SM and one block's
//   staging and stores run under the other's FMAs).  Voxel
//   coordinates are taken once per voxel, in 32 bits inside the box.  The
//   results leave as 16-byte stores (8 bf16 or 4 f32 channels), 32-48
//   contiguous bytes a voxel and chunk; a Co that is no multiple of 8 (4 in f32)
//   stores value by value.  The 27-term sums run on FMAs, not on
//   mma.sync.m16n8k16 padded to K = 32: the 4.2 GFLOP of layer 0 are 0.07
//   ms of the card's f32 FMA rate, within 1.5x of the byte floor, the f32
//   dtype needs the FMAs anyway (TF32 would round the inputs), and the
//   im2col fragments of a one-channel input would have to be gathered
//   value by value, which is the load traffic the design removes.  A halo
//   too large for shared memory (a large dilation) is read through L1
//   instead.
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
//   * f32, where Ci is a multiple of 4, x is 16-byte aligned and the
//     dilation at most 7, runs the FMA/TMA kernel of conv3d_f32.cu (the
//     halo staged once per 4-channel slice, 8 voxels x 8 channels a
//     thread; route "simt").  Every other f32 call runs conv_gemm_kernel
//     here (route "fma") on CUDA-core FMAs (TF32 tensor cores would round
//     the inputs): each thread keeps a 4 x (BN/16) tile of f32
//     accumulators in registers.
//
// The two implicit-GEMM kernels here are simple first versions: one chunk
// in flight per block, no software pipeline.  They take only the calls the
// redesigned kernels' rules leave (ops/conv.py::k1_route), none of which a
// model of the zoo makes.
//
// Blocks run in parallel and in no order, so the ragged edge is masked
// (rows past M and channels past Co load zeros and store nothing) instead
// of shifting the last block inward as the TPU kernel does.
//
// C entries: fpl_conv3d_bias_relu(...) (Ci > 1) and fpl_conv3d_ci1(...)
// launch on the given stream and return cudaGetLastError(); they allocate
// nothing and do not synchronise.

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

// the epilogue's activation: ReLU, or nothing where relu == 0
__device__ __forceinline__ float act(float v, int relu) {
  return relu ? fmaxf(v, 0.f) : v;
}

// ---------------------------------------------------------------- Ci == 1
constexpr int kCi1Threads = 256;
constexpr int kCi1Run = 4;  // output voxels per thread
constexpr int kCi1Voxels = kCi1Threads * kCi1Run;  // most voxels of a box

struct Ci1Args {
  int D, H, W, Co, Cn, d, Do, Ho, Wo;
  int bz, by, bx, tiles_z, tiles_y, tiles_x;
  int vec;  // 16-byte stores: the output rows and channel chunks allow them
  int relu;
};

__device__ __forceinline__ void store8(float* o, const float* v) {
  reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* o, const float* v) {
  __nv_bfloat162 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(p);
}

// One launch computes Cn <= kMaxCo output channels of the Co the layer has:
// w, b and out point at the first of them, and Co is the stride of a weight
// row and of an output voxel.  blockIdx.x is the output box, blockIdx.y the
// chunk of 8 NG channels.  STAGED: the halo goes through shared memory.
template <typename T, int NG, bool STAGED>
__global__ void __launch_bounds__(kCi1Threads, 2)
conv_ci1_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ b, T* __restrict__ out, Ci1Args a) {
  constexpr int CH = 8 * NG;
  extern __shared__ __align__(16) float ci1_smem[];
  float* ws = ci1_smem;      // [27][CH], zero past Cn
  float* bs = ws + 27 * CH;  // [CH]
  float* xs = bs + CH;       // the halo, [hz][hy][hx]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * CH;
  for (int i = tid; i < 27 * CH; i += kCi1Threads) {
    const int tap = i / CH, c = c0 + i % CH;
    ws[i] = c < a.Cn ? to_f32(w[tap * a.Co + c]) : 0.f;
  }
  if (tid < CH) bs[tid] = c0 + tid < a.Cn ? to_f32(b[c0 + tid]) : 0.f;

  int t = blockIdx.x;
  const int x0 = (t % a.tiles_x) * a.bx;
  t /= a.tiles_x;
  const int y0 = (t % a.tiles_y) * a.by;
  t /= a.tiles_y;
  const int z0 = (t % a.tiles_z) * a.bz;
  const int n = t / a.tiles_z;
  const int hx = a.bx + 2 * a.d, hy = a.by + 2 * a.d, hz = a.bz + 2 * a.d;
  const T* xn = x + (long long)n * a.D * a.H * a.W;
  if (STAGED) {
    // halo values e = (zz * hy + yy) * hx + xx, zeros past the input; eight
    // loads a thread are issued before the first is stored, so that their
    // latencies overlap
    const int hv = hz * hy * hx;
    constexpr int kBatch = 8;
    for (int e0 = tid; e0 < hv; e0 += kBatch * kCi1Threads) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kCi1Threads;
        const int r = e / hx, xx = e - r * hx;
        const int zz = z0 + r / hy, yy = y0 + r % hy;
        const bool in = e < hv && zz < a.D && yy < a.H && x0 + xx < a.W;
        v[k] = in ? to_f32(xn[((long long)zz * a.H + yy) * a.W + x0 + xx]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (e0 + k * kCi1Threads < hv) xs[e0 + k * kCi1Threads] = v[k];
    }
  }
  __syncthreads();

  // the thread's voxels: where their taps start, and where they are stored
  // (-1: past the box or the output; such a voxel reads the box's first)
  int base[kCi1Run];
  long long dst[kCi1Run];
#pragma unroll
  for (int j = 0; j < kCi1Run; ++j) {
    const int v = tid + j * kCi1Threads;
    int xx = v % a.bx, r = v / a.bx;
    int yy = r % a.by, zz = r / a.by;
    const bool live = zz < a.bz && x0 + xx < a.Wo && y0 + yy < a.Ho &&
                      z0 + zz < a.Do;
    if (!live) xx = yy = zz = 0;
    base[j] = STAGED ? (zz * hy + yy) * hx + xx
                     : ((z0 + zz) * a.H + y0 + yy) * a.W + x0 + xx;
    dst[j] = live ? ((((long long)n * a.Do + z0 + zz) * a.Ho + y0 + yy) * a.Wo +
                     x0 + xx) * a.Co + c0
                  : -1;
  }

  float acc[kCi1Run][CH];
#pragma unroll
  for (int j = 0; j < kCi1Run; ++j)
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[j][c] = 0.f;

#pragma unroll
  for (int tap = 0; tap < 27; ++tap) {
    const int tz = tap / 9, ty = (tap / 3) % 3, tx = tap % 3;
    const int off = STAGED ? (tz * a.d * hy + ty * a.d) * hx + tx * a.d
                           : (tz * a.d * a.H + ty * a.d) * a.W + tx * a.d;
    float xv[kCi1Run];
#pragma unroll
    for (int j = 0; j < kCi1Run; ++j)
      xv[j] = STAGED ? xs[base[j] + off] : to_f32(xn[base[j] + off]);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 w0 = *reinterpret_cast<const float4*>(ws + tap * CH + 8 * g);
      const float4 w1 =
          *reinterpret_cast<const float4*>(ws + tap * CH + 8 * g + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < kCi1Run; ++j)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[j][8 * g + c] = fmaf(xv[j], wv[c], acc[j][8 * g + c]);
    }
  }

#pragma unroll
  for (int j = 0; j < kCi1Run; ++j) {
    if (dst[j] < 0) continue;
    T* o = out + dst[j];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = act(acc[j][8 * g + c] + bs[8 * g + c], a.relu);
      if (a.vec && c0 + 8 * g + 8 <= a.Cn) {
        store8(o + 8 * g, v);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c0 + 8 * g + c < a.Cn) o[8 * g + c] = from_f32<T>(v[c]);
      }
    }
  }
}

template <typename T, int NG, bool STAGED>
cudaError_t launch_ci1(const T* x, const T* w, const T* b, T* out, int B,
                       const Ci1Args& a, int smem, cudaStream_t stream) {
  auto kernel = conv_ci1_kernel<T, NG, STAGED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)B * a.tiles_z * a.tiles_y * a.tiles_x;
  const int chunks = (a.Cn + 8 * NG - 1) / (8 * NG);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)tiles, chunks), kCi1Threads, smem, stream>>>(
      x, w, b, out, a);
  return cudaGetLastError();
}

template <typename T>
int launch_ci1_all(const void* x, const void* w, const void* b, void* out,
                   int B, int D, int H, int W, int Co, int d, int bz, int by,
                   int bx, int staged, int relu, cudaStream_t stream) {
  Ci1Args a;
  a.relu = relu;
  a.D = D; a.H = H; a.W = W; a.Co = Co; a.d = d;
  a.Do = D - 2 * d; a.Ho = H - 2 * d; a.Wo = W - 2 * d;
  a.bz = bz; a.by = by; a.bx = bx;
  a.tiles_z = (a.Do + bz - 1) / bz;
  a.tiles_y = (a.Ho + by - 1) / by;
  a.tiles_x = (a.Wo + bx - 1) / bx;
  a.vec = (long long)Co * sizeof(T) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  for (int c0 = 0; c0 < Co; c0 += kMaxCo) {  // one launch when Co <= kMaxCo
    a.Cn = Co - c0 < kMaxCo ? Co - c0 : kMaxCo;
    // chunks of 24 channels where they divide Cn, else of 16
    const bool ng3 = a.Cn % 24 == 0;
    const int ch = ng3 ? 24 : 16;
    const long long halo =
        staged ? (long long)(bz + 2 * d) * (by + 2 * d) * (bx + 2 * d) : 0;
    const long long smem = (28 * ch + halo) * (long long)sizeof(float);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (staged)
      e = ng3 ? launch_ci1<T, 3, true>(xt, wt + c0, bt + c0, ot + c0, B, a,
                                       (int)smem, stream)
              : launch_ci1<T, 2, true>(xt, wt + c0, bt + c0, ot + c0, B, a,
                                       (int)smem, stream);
    else
      e = ng3 ? launch_ci1<T, 3, false>(xt, wt + c0, bt + c0, ot + c0, B, a,
                                        (int)smem, stream)
              : launch_ci1<T, 2, false>(xt, wt + c0, bt + c0, ot + c0, B, a,
                                        (int)smem, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
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
                 long long M, int relu) {
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
        out[p * Co + n] = act(acc[i][j] + b[n], relu);
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
                 int Co, int d, int Do, int Ho, int Wo, long long M, int relu) {
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
          act(Cs[m][nn] + __bfloat162float(b[n]), relu));
  }
}

// Ci > 1: f32 on CUDA-core FMAs (TF32 tensor cores would round the
// inputs), bf16 on the tensor cores
template <int BN>
void launch_gemm(const float* x, const float* w, const float* b, float* out,
                 dim3 grid, int D, int H, int W, int Ci, int Co, int d,
                 int Do, int Ho, int Wo, long long M, int relu,
                 cudaStream_t stream) {
  conv_gemm_kernel<BN><<<grid, kThreads, 0, stream>>>(
      x, w, b, out, D, H, W, Ci, Co, d, Do, Ho, Wo, M, relu);
}

template <int BN>
void launch_gemm(const __nv_bfloat16* x, const __nv_bfloat16* w,
                 const __nv_bfloat16* b, __nv_bfloat16* out, dim3 grid,
                 int D, int H, int W, int Ci, int Co, int d, int Do, int Ho,
                 int Wo, long long M, int relu, cudaStream_t stream) {
  conv_wmma_kernel<BN><<<grid, kThreads, 0, stream>>>(
      x, w, b, out, D, H, W, Ci, Co, d, Do, Ho, Wo, M, relu);
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* out, int B,
            int D, int H, int W, int Ci, int Co, int d, int relu,
            cudaStream_t stream) {
  const int Do = D - 2 * d, Ho = H - 2 * d, Wo = W - 2 * d;
  const long long M = (long long)B * Do * Ho * Wo;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  const unsigned gm = (unsigned)((M + kBM - 1) / kBM);
  if (Co <= 32) {
    launch_gemm<32>(xt, wt, bt, ot, dim3(gm, 1), D, H, W, Ci, Co, d, Do, Ho,
                    Wo, M, relu, stream);
  } else {
    launch_gemm<64>(xt, wt, bt, ot, dim3(gm, (Co + 63) / 64), D, H, W, Ci, Co,
                    d, Do, Ho, Wo, M, relu, stream);
  }
}

}  // namespace

// Ci > 1.  dtype: 0 = float32, 1 = bfloat16; relu = 0 leaves the clamp
// out.  Shapes are checked by the Python wrapper
// (flypylib_tpu_torch/ops/conv.py); x, w, b and out are contiguous.
extern "C" int fpl_conv3d_bias_relu(const void* x, const void* w,
                                    const void* b, void* out, int B, int D,
                                    int H, int W, int Ci, int Co, int d,
                                    int dtype, int relu, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  if (Co < 1 || Ci < 2 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, b, out, B, D, H, W, Ci, Co, d, relu, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, b, out, B, D, H, W, Ci, Co, d, relu, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Ci = 1: x (B,D,H,W,1), w (27,Co), b (Co,), out (B,D-2d,H-2d,W-2d,Co).  The
// output box (bz, by, bx) of a block holds at most 1024 voxels; staged != 0
// puts its halo through shared memory (ops/conv.py::ci1_plan picks both);
// relu = 0 leaves the clamp out.
extern "C" int fpl_conv3d_ci1(const void* x, const void* w, const void* b,
                              void* out, int B, int D, int H, int W, int Co,
                              int d, int bz, int by, int bx, int staged,
                              int dtype, int relu, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  if (Co < 1 || d < 1 || bz < 1 || by < 1 || bx < 1 ||
      (long long)bz * by * bx > kCi1Voxels || D <= 2 * d || H <= 2 * d ||
      W <= 2 * d || (long long)D * H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ci1_all<float>(x, w, b, out, B, D, H, W, Co, d, bz, by, bx,
                                 staged, relu, s);
  if (dtype == 1)
    return launch_ci1_all<__nv_bfloat16>(x, w, b, out, B, D, H, W, Co, d, bz,
                                         by, bx, staged, relu, s);
  return (int)cudaErrorInvalidValue;
}
