// The packed U-Net's level-0 decoder tail over NDHWC volumes (sm_90a):
// valid 2x2x2 conv stages, and the hi/lo logits dot.
//
// Replaces the TPU kernels flypylib_tpu/ops/pallas_tail.py::packed_tail (K2)
// and ::packed_tail2 (K3) for f32 (the "fma" route of flypylib_tpu_torch/
// ops/tail.py::tail_route) and for the bf16 stages that
// packed_tail_wgmma.cu does not take (the "wmma" route: a channel count
// off the multiples of 8, Co > 192, an operand off a 16-byte boundary).
// The Python wrappers run a chain as one launch per stage, with the
// intermediates in device memory, and one launch of fpl_tail_logits when
// the last stage did not compute the logits in its epilogue (only the
// wgmma kernel does).
//
// fpl_tail_stage: for xa (B,D,H,W,Ca), optional xb (B,D,H,W,Cb) (K3's first
// stage; Cb = 0 for one operand), wa (2,2,2,Ca,Co), wb (2,2,2,Cb,Co) and
// b (Co,), all of one dtype T (float or bfloat16):
//
//   out[n,z,y,x,o] = relu(T(T(sum_{taps,c} f32(xa[..]) * f32(wa[..])
//                                + sum_{taps,c} f32(xb[..]) * f32(wb[..]))
//                              + b[o]))
//
// of shape (B, D-1, H-1, W-1, Co): both operands' products summed in f32,
// one rounding to T, the T bias added with the sum rounded to T, ReLU --
// the TPU kernel's rounding points, not K1's (which adds the bias in f32).
//
// fpl_tail_logits: for a (M, Cn) and wl (Cn, 2L) of dtype T and bl (L,) f32,
//   out[m, j] = (sum_c f32(a[m,c]) * f32(wl[c,j]) + sum_c ... wl[c,L+j]) + bl[j]
// in f32: the hi and lo halves of a weight split into two T columns.
//
// What bounds it on an H100, at the main path's shapes (the 256^3 volume in
// one covering tile, 132^3 cells): stage 0 contracts K = 8 * 240 = 1920 into
// Co = 192 channels and stage 1 K = 1536 into 192, 1.66 and 1.30 TFLOP.
// Each input value is reused 8 * 192 times, so the stages are bound by the
// tensor cores, not by memory.  They run as an implicit GEMM (M = output
// voxels, N = Co, K = 8 * (Ca + Cb)), streaming K through shared memory in
// chunks: A as an im2col gather of 8 taps of each row's 2^3 window, from xa
// for the first 8 * Ca columns and from xb for the rest, so the concat of
// the two operands never exists; B as the matching rows of wa, then wb.
// - bf16 runs stage_wmma_kernel: a 128 x BN output tile per block, 16x16x16
//   WMMA products on the tensor cores with f32 accumulators, 16-byte runs of
//   8 channels when every channel count is a multiple of 8.
// - f32 runs stage_gemm_kernel on CUDA-core FMAs (TF32 would round the
//   inputs), K1's 64 x BN tiling.
// The logits read each stage output once and are memory-bound: one thread
// per output value, the row and the (Cn, 2L) weights read through L1.
//
// These are the simple kernels of the first port: one shared-memory buffer,
// loads and MMAs in turn, N in blocks of 64 or 32 so A is gathered once
// per N block.  At the main path's widths bf16 runs the wgmma/TMA kernel
// of packed_tail_wgmma.cu instead, about 4.5 times faster.  The TPU
// kernel's point -- the chain's intermediates never leave fast memory --
// is carried over by neither: on this card the chain is bound by the
// tensor cores and the L2, not by device memory, so each stage writes its
// output to device memory and the next reads it back.
//
// 64-bit offsets throughout: at the reference's largest tile the tail input
// holds ~1.8e9 values.  Rows past M and channels past Co load zeros and
// store nothing.
//
// C entries launch on the given stream and return cudaGetLastError(); they
// allocate nothing and do not synchronise.

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

constexpr int kThreads = 256;

// One stage's operands and geometry.
struct Stage {
  const void* xa;  // (B, D, H, W, Ca)
  const void* xb;  // (B, D, H, W, Cb), or null when Cb == 0
  const void* wa;  // (8, Ca, Co)
  const void* wb;  // (8, Cb, Co)
  const void* b;   // (Co,)
  void* out;       // (B, Do, Ho, Wo, Co)
  int D, H, W, Ca, Cb, Co;
  int Do, Ho, Wo;
  int Ka, K;       // 8 * Ca, 8 * (Ca + Cb)
  long long M;     // B * Do * Ho * Wo
};

// voxel index of output row p's window origin in the input, or -1 past M
__device__ __forceinline__ long long row_origin(long long p, const Stage& s) {
  if (p >= s.M) return -1;
  const int xo = (int)(p % s.Wo);
  p /= s.Wo;
  const int yo = (int)(p % s.Ho);
  p /= s.Ho;
  const int zo = (int)(p % s.Do);
  const long long n = p / s.Do;
  return ((n * s.D + zo) * s.H + yo) * (long long)s.W + xo;
}

// Column k of the im2col matrix: which operand, its channel count, the
// tap's offset in voxels from a row's origin, and the channel.  False past K.
struct Col {
  bool valid;
  bool second;     // read xb / wb
  int C, c;
  long long tap;
};

__device__ __forceinline__ Col col_of(int k, const Stage& s) {
  Col col{false, false, 1, 0, 0};
  if (k >= s.K) return col;
  col.valid = true;
  col.C = s.Ca;
  if (k >= s.Ka) {
    k -= s.Ka;
    col.C = s.Cb;
    col.second = true;
  }
  const int t = k / col.C;
  col.c = k - t * col.C;
  col.tap = ((long long)(t >> 2) * s.H + ((t >> 1) & 1)) * s.W + (t & 1);
  return col;
}

template <typename T>
__device__ __forceinline__ const T* col_ptr(const Col& col, long long origin,
                                            const Stage& s) {
  const T* base = static_cast<const T*>(col.second ? s.xb : s.xa);
  return base + (origin + col.tap) * col.C + col.c;
}

// row k of the stacked weights [wa; wb]
template <typename T>
__device__ __forceinline__ const T* w_row(int k, const Stage& s) {
  if (k < s.Ka) return static_cast<const T*>(s.wa) + (long long)k * s.Co;
  return static_cast<const T*>(s.wb) + (long long)(k - s.Ka) * s.Co;
}

// ------------------------------------------ f32: implicit GEMM on FMAs
constexpr int kBM = 64;   // output rows per block
constexpr int kKC = 16;   // K chunk staged in shared memory

template <int BN>
__global__ void __launch_bounds__(kThreads) stage_gemm_kernel(Stage s) {
  constexpr int TM = 4;        // rows per thread (contiguous)
  constexpr int TN = BN / 16;  // channels per thread (contiguous)
  static_assert(TN == 2 || TN == 4, "BN must be 32 or 64");
  static_assert(16 * TM == kBM, "16 thread rows x TM rows == kBM");

  __shared__ __align__(16) float As[kKC][kBM + 4];
  __shared__ __align__(16) float Bs[kKC][BN];
  __shared__ long long origin[kBM];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  if (tid < kBM) origin[tid] = row_origin(m0 + tid, s);

  const int tc = tid % 16, tr = tid / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int kk_ld = tid % kKC;  // each thread always loads this A column
  const int m_ld = tid / kKC;
  constexpr int kRowStep = kThreads / kKC;

  for (int k0 = 0; k0 < s.K; k0 += kKC) {
    const Col col = col_of(k0 + kk_ld, s);
    __syncthreads();  // origin written / previous chunk consumed
#pragma unroll
    for (int r = 0; r < kBM / kRowStep; ++r) {
      const int m = m_ld + r * kRowStep;
      const long long o = origin[m];
      As[kk_ld][m] = (col.valid && o >= 0) ? *col_ptr<float>(col, o, s) : 0.f;
    }
    for (int e = tid; e < kKC * BN; e += kThreads) {
      const int nn = e % BN, kk = e / BN;
      const int kg = k0 + kk, ng = n0 + nn;
      Bs[kk][nn] = (kg < s.K && ng < s.Co) ? w_row<float>(kg, s)[ng] : 0.f;
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

  const float* b = static_cast<const float*>(s.b);
  float* out = static_cast<float*>(s.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long p = m0 + tr * TM + i;
    if (p >= s.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tc * TN + j;
      // in f32 the rounding to T is the identity
      if (n < s.Co) out[p * s.Co + n] = fmaxf(acc[i][j] + b[n], 0.f);
    }
  }
}

// --------------------------------- bf16: implicit GEMM on tensor cores
// A block owns a 128 x BN output tile; its 8 warps hold 16 x 16 WMMA
// accumulator tiles, (128 / WM) x 32 each.  K streams through shared memory
// 32 at a time.  With VEC every thread moves 16-byte runs of 8 channels;
// otherwise elements are gathered one by one.  The f32 tile then goes
// through shared memory (reusing the A and B buffers) for the epilogue,
// which stores along the channel axis.
constexpr int kTBM = 128;
constexpr int kTKC = 32;
constexpr int kALd = kTKC + 8;  // A row pitch in bf16 (80 bytes)

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads) stage_wmma_kernel(Stage s) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  constexpr int BLd = BN + 8;            // B row pitch in bf16
  constexpr int CLd = BN + 4;            // C row pitch in f32
  constexpr int WN = BN / 32;            // warps along N
  constexpr int WM = 8 / WN;             // warps along M
  constexpr int FM = kTBM / (WM * 16);   // accumulator tiles per warp, M
  constexpr int FN = 2;                  // accumulator tiles per warp, N
  static_assert(BN == 32 || BN == 64, "BN must be 32 or 64");
  constexpr int kInBytes = kTBM * kALd * 2 + kTKC * BLd * 2;
  constexpr int kOutBytes = kTBM * CLd * 4;
  constexpr int kBytes = kInBytes > kOutBytes ? kInBytes : kOutBytes;

  // every fragment pointer stays 32-byte aligned, as WMMA requires: the
  // pitches are 80 and 144 (or 80) bytes, 16-row steps are multiples of 32
  __shared__ __align__(128) unsigned char smem[kBytes];
  __shared__ long long origin[kTBM];
  auto As = reinterpret_cast<bf16(*)[kALd]>(smem);
  auto Bs = reinterpret_cast<bf16(*)[BLd]>(smem + kTBM * kALd * 2);
  auto Cs = reinterpret_cast<float(*)[CLd]>(smem);

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kTBM;
  const int n0 = blockIdx.y * BN;
  if (tid < kTBM) origin[tid] = row_origin(m0 + tid, s);

  const int warp = tid / 32;
  const int wm = (warp / WN) * FM * 16;  // first row of the warp's band
  const int wn = (warp % WN) * FN * 16;  // first column of the warp's band
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int k0 = 0; k0 < s.K; k0 += kTKC) {
    if constexpr (VEC) {
      // A: 128 rows x 4 runs; B: 32 rows x BN / 8 runs
      constexpr int kARuns = kTBM * kTKC / 8 / kThreads;
      Col col[kARuns];
#pragma unroll
      for (int i = 0; i < kARuns; ++i)
        col[i] = col_of(k0 + ((tid + i * kThreads) & 3) * 8, s);
      __syncthreads();  // origin written / previous chunk consumed
#pragma unroll
      for (int i = 0; i < kARuns; ++i) {
        const int r = tid + i * kThreads;
        const int m = r >> 2, q = (r & 3) * 8;
        const long long o = origin[m];
        *reinterpret_cast<uint4*>(&As[m][q]) =
            (col[i].valid && o >= 0)
                ? *reinterpret_cast<const uint4*>(col_ptr<bf16>(col[i], o, s))
                : zero4;
      }
      for (int e = tid; e < kTKC * BN / 8; e += kThreads) {
        const int kk = e / (BN / 8), nq = (e % (BN / 8)) * 8;
        const int kg = k0 + kk, ng = n0 + nq;
        *reinterpret_cast<uint4*>(&Bs[kk][nq]) =
            (kg < s.K && ng < s.Co)
                ? *reinterpret_cast<const uint4*>(w_row<bf16>(kg, s) + ng)
                : zero4;
      }
    } else {
      const int kk_ld = tid % kTKC;  // each thread always loads this column
      const Col col = col_of(k0 + kk_ld, s);
      __syncthreads();  // origin written / previous chunk consumed
      for (int m = tid / kTKC; m < kTBM; m += kThreads / kTKC) {
        const long long o = origin[m];
        As[m][kk_ld] = (col.valid && o >= 0) ? *col_ptr<bf16>(col, o, s) : zero;
      }
      for (int e = tid; e < kTKC * BN; e += kThreads) {
        const int nn = e % BN, kk = e / BN;
        const int kg = k0 + kk, ng = n0 + nn;
        Bs[kk][nn] = (kg < s.K && ng < s.Co) ? w_row<bf16>(kg, s)[ng] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTKC; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], &As[wm + i * 16][ks], kALd);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, &Bs[ks][wn + j * 16], BLd);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
  }

  __syncthreads();  // every warp is done with As and Bs, which Cs reuses
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j], CLd,
                              wmma::mem_row_major);
  __syncthreads();
  const bf16* b = static_cast<const bf16*>(s.b);
  bf16* out = static_cast<bf16*>(s.out);
  for (int e = tid; e < kTBM * BN; e += kThreads) {
    const int m = e / BN, nn = e % BN;
    const long long p = m0 + m;
    const int n = n0 + nn;
    if (p < s.M && n < s.Co) {
      // round the sum, add the bf16 bias (rounded), ReLU
      const float v = __bfloat162float(__float2bfloat16_rn(Cs[m][nn]));
      const float y = __bfloat162float(
          __float2bfloat16_rn(v + __bfloat162float(b[n])));
      out[p * s.Co + n] = __float2bfloat16_rn(fmaxf(y, 0.f));
    }
  }
}

// --------------------------------------------------------------- logits
template <typename T>
__global__ void __launch_bounds__(kThreads)
logits_kernel(const T* __restrict__ a, const T* __restrict__ wl,
              const float* __restrict__ bl, float* __restrict__ out,
              long long M, int Cn, int L) {
  const long long total = M * L;
  const int ld = 2 * L;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e % L);
    const T* row = a + (e / L) * Cn;
    float hi = 0.f, lo = 0.f;
    for (int c = 0; c < Cn; ++c) {
      const float v = to_f32(row[c]);
      hi = fmaf(v, to_f32(wl[(long long)c * ld + j]), hi);
      lo = fmaf(v, to_f32(wl[(long long)c * ld + L + j]), lo);
    }
    out[e] = (hi + lo) + bl[j];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

void launch_stage_f32(const Stage& s, cudaStream_t stream) {
  const unsigned gm = (unsigned)((s.M + kBM - 1) / kBM);
  if (s.Co <= 32)
    stage_gemm_kernel<32><<<dim3(gm, 1), kThreads, 0, stream>>>(s);
  else
    stage_gemm_kernel<64><<<dim3(gm, (s.Co + 63) / 64), kThreads, 0, stream>>>(s);
}

template <int BN>
void launch_wmma(const Stage& s, bool vec, cudaStream_t stream) {
  const dim3 grid((unsigned)((s.M + kTBM - 1) / kTBM), (s.Co + BN - 1) / BN);
  if (vec)
    stage_wmma_kernel<BN, true><<<grid, kThreads, 0, stream>>>(s);
  else
    stage_wmma_kernel<BN, false><<<grid, kThreads, 0, stream>>>(s);
}

void launch_stage_bf16(const Stage& s, cudaStream_t stream) {
  const bool vec = s.Ca % 8 == 0 && s.Cb % 8 == 0 && s.Co % 8 == 0 &&
                   aligned16(s.xa) && aligned16(s.wa) &&
                   (s.Cb == 0 || (aligned16(s.xb) && aligned16(s.wb)));
  if (s.Co <= 32)
    launch_wmma<32>(s, vec, stream);
  else
    launch_wmma<64>(s, vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes are checked by the Python
// wrappers (flypylib_tpu_torch/ops/tail.py); every buffer is contiguous.
extern "C" int fpl_tail_stage(const void* xa, const void* xb, const void* wa,
                              const void* wb, const void* b, void* out, int B,
                              int D, int H, int W, int Ca, int Cb, int Co,
                              int dtype, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  if (B < 1 || D < 2 || H < 2 || W < 2 || Ca < 1 || Cb < 0 || Co < 1 ||
      (Cb > 0 && (xb == nullptr || wb == nullptr)))
    return (int)cudaErrorInvalidValue;
  Stage s;
  s.xa = xa;
  s.xb = xb;
  s.wa = wa;
  s.wb = wb;
  s.b = b;
  s.out = out;
  s.D = D;
  s.H = H;
  s.W = W;
  s.Ca = Ca;
  s.Cb = Cb;
  s.Co = Co;
  s.Do = D - 1;
  s.Ho = H - 1;
  s.Wo = W - 1;
  s.Ka = 8 * Ca;
  s.K = 8 * (Ca + Cb);
  s.M = (long long)B * s.Do * s.Ho * s.Wo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_stage_f32(s, st);
  else if (dtype == 1)
    launch_stage_bf16(s, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int fpl_tail_logits(const void* a, const void* wl, const void* bl,
                               void* out, long long M, int Cn, int L,
                               int dtype, void* stream) {
  cudaGetLastError();  // clear any earlier, unrelated error
  if (M < 1 || Cn < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (M * L + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride over the rest
  const float* blf = static_cast<const float*>(bl);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    logits_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(wl), blf, o, M,
        Cn, L);
  else if (dtype == 1)
    logits_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(wl), blf, o, M, Cn, L);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
